"""Serving fleet — replica pool, prefix-aware router, fleet rollup (port
of ``deepspeed_tpu/serving``).

The layer above a single ``InferenceEngineV2``: a :class:`ReplicaPool`
owns N engine replicas (on one card they share it) behind one
engine-shaped surface, a
:class:`Router` places each request by cached-prefix overlap / queue
depth / SLO headroom (``random`` and ``round_robin`` as controls), and
elastic membership drains preempted replicas through the drain manifest
onto survivors whose warm prefix caches absorb the re-prefill. Fleet
telemetry rolls up through the exact histogram merge with stable
``source=<replica id>`` labels.

Disaggregated serving (docs/serving.md "Disaggregated serving"):
replicas may declare a phase specialism (``REPLICA_ROLES`` —
``prefill`` / ``decode`` / ``mixed``, via ``ReplicaPool(roles=...)`` or
``DSTPU_FLEET_ROLES``). Fresh requests land on prefill-capable
replicas; after the first token each sequence on a prefill SPECIALIST
migrates to a decode-capable replica through a streamed KV handoff the
pool splices invisibly — caller token streams stay byte-identical to
colocated serving. ``DSTPU_DISAGG=0`` forces every replica ``mixed``
(the exact pre-disagg path).

Overload robustness (docs/serving.md "Overload control"): an
:class:`AdmissionController` holds offered load at the capacity knee —
AIMD over the door's admission window on windowed queue-wait p99
evidence — and degrades quality-of-service through the ordered
brownout ladder instead of collapsing. Build one through
:func:`build_admission` (None when ``DSTPU_ADMISSION=0``).
"""

from .admission import (BROWNOUT_LEVELS, AdmissionController,
                        admission_enabled, build_admission)
from .pool import (REPLICA_ROLES, Replica, ReplicaPool,
                   build_replica_engines, fleet_prefix_stats,
                   single_stream_oracle, slo_report_from_registry)
from .router import ROUTING_POLICIES, NoServingReplicaError, Router

__all__ = [
    "AdmissionController", "BROWNOUT_LEVELS", "NoServingReplicaError",
    "REPLICA_ROLES", "ROUTING_POLICIES", "Replica", "ReplicaPool",
    "Router",
    "admission_enabled", "build_admission", "build_replica_engines",
    "fleet_prefix_stats", "single_stream_oracle",
    "slo_report_from_registry",
]
