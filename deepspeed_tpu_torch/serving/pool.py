"""Replica pool — the serving layer above ``InferenceEngineV2``.

Port of ``deepspeed_tpu/serving/pool.py``, host code that the port keeps its
own copy of (it imports nothing of the JAX package).

One :class:`ReplicaPool` owns N v2 ragged engines over disjoint device
sets and presents ONE engine-shaped serving surface (``put`` /
``decode_pipelined`` / ``flush`` / ``state`` / ``rejections`` /
``slo_report``), so every driver written against a single engine — the
open-loop loadgen (:func:`~deepspeed_tpu.telemetry.loadgen.run_open_loop`
and its capacity sweep), the fault drills, the benches — drives a whole
fleet unchanged. This is the DeepSpeed-MII/FastGen deployment shape
(PAPER.md: a load-balanced pool of engine replicas behind one endpoint)
composed from pieces the engine already has:

  * **Routing** (:mod:`.router`): each fresh request is placed by a
    pluggable policy; ``prefix_aware`` scores replicas by cached-prefix
    overlap (the prefix cache's chain keys), queue depth and SLO
    headroom (per-engine registries).
  * **Elastic membership**: a preempted replica (SIGTERM →
    ``PreemptionHandler`` → ``engine.draining``) is absorbed
    transparently — the pool drains it through the drain manifest,
    routes every manifested sequence onto survivors (whose warm prefix
    caches eat most of the re-prefill), and splices the survivors'
    replay tokens into the caller's streams so they stay gapless and
    token-identical. Late joiners ``add_replica`` and start taking
    traffic on the next routing decision.
  * **Fleet rollup**: per-replica registries merge into one fleet
    snapshot through the exact histogram merge, with ``source``
    labels keyed by STABLE replica ids (each replica's registry is
    renamed to its id at registration), so repeated rollups of the same
    fleet are idempotent. The cross-process path is unchanged: each
    replica process exports its snapshot file and
    ``telemetry.merge_snapshots`` (or ``bin/dstpu_top file1 file2`` /
    a glob) rolls them up without shared memory.

Deployment shapes (docs/serving.md "Replica pool"):

  * **in-process** (this module's direct mode): N engines in one
    process. On the port every replica of a one-card host shares that
    card (``build_replica_engines``); their work interleaves on it in
    stream order, and the pool drives them from one worker thread each.
    Replicas spanning several cards are A8.
  * **multi-host**: one engine per process; the pool abstraction runs
    degenerate (N=1) in each process and the FLEET view exists only in
    telemetry — snapshot files rolled up via ``merge_snapshots``.

Everything here is host-side bookkeeping (dict lookups, list grouping)
around the engines' own overlapped pipelines; the pool's ``put`` /
``decode_pipelined`` and the replica scoring accessors are hot
paths — a blocking device sync in the dispatch path would
serialize every replica behind one readback.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..inference.v2.blocked_allocator import OutOfBlocksError
from ..inference.v2.drain import EngineDrainingError
from ..telemetry.flight_recorder import (FlightRecorder,
                                         atomic_json_dump,
                                         merge_chrome_traces,
                                         register_recorder)
from ..telemetry.registry import Histogram, MetricsRegistry, \
    telemetry_enabled
from ..telemetry.serve import slo_report_from_registry
from .router import NoServingReplicaError, Router

#: replica lifecycle states (docs/serving.md "Membership protocol")
REPLICA_SERVING = "serving"
REPLICA_DRAINING = "draining"
REPLICA_DEAD = "dead"

#: phase-specialist roles (docs/serving.md "Disaggregated serving"):
#: ``mixed`` replicas serve both phases (the pre-disagg behavior and
#: the default), ``prefill`` specialists take fresh admissions and hand
#: each sequence off after its first token, ``decode`` specialists
#: adopt the handoffs and run the decode stream
REPLICA_ROLES = ("prefill", "decode", "mixed")


class Replica:
    """One pool member: an ``InferenceEngineV2`` plus its fleet
    identity and lifecycle state. The scoring accessors below are the
    router's only view of the engine — all pure host reads."""

    __slots__ = ("replica_id", "engine", "state", "joined_at", "manifest",
                 "pending_routed", "slot_frac", "admission_headroom",
                 "role", "lock")

    def __init__(self, replica_id: str, engine, role: str = "mixed"):
        if role not in REPLICA_ROLES:
            raise ValueError(
                f"replica role must be one of {REPLICA_ROLES}, "
                f"got {role!r}")
        self.replica_id = replica_id
        self.engine = engine
        self.state = REPLICA_SERVING
        self.joined_at = time.time()
        #: phase specialism (docs/serving.md "Disaggregated serving");
        #: the router's ``phase`` filter reads it, the pool's post-put
        #: migration moves fresh sequences OFF ``prefill`` replicas
        self.role = role
        #: advertised-slots scale in (0, 1] — the AdmissionController
        #: shrinks it while this replica is browned out, so
        #: :meth:`queue_frac`'s denominator contracts and the router's
        #: full-replica gate trips earlier (1.0 = full slots)
        self.slot_frac = 1.0
        #: 1 - windowed queue-wait p99 / SLO, written by the admission
        #: controller's tick (None = controller off or no evidence) —
        #: an additive routing-score term steering toward replicas with
        #: door headroom
        self.admission_headroom: Optional[float] = None
        #: requests routed here in the CURRENT admission batch but not
        #: yet admitted by the engine — counted into :meth:`queue_frac`
        #: so consecutive placements in one batch see each other (a
        #: burst of arrivals must spread by the post-batch load, not
        #: all score the same stale pre-batch state and pile onto one
        #: replica past its slots)
        self.pending_routed = 0
        #: serializes every engine call on this replica — the pool's
        #: concurrency contract (docs/serving.md "Disaggregated
        #: serving"): independent driver threads may call ``put`` and
        #: ``decode_pipelined`` concurrently; each engine is
        #: single-threaded, so the pool takes this lock around every
        #: engine entry point. Reentrant because drain/replay paths
        #: nest engine calls under one holder.
        self.lock = threading.RLock()
        #: the drain manifest once this replica died (None while alive);
        #: ``manifest["pool"]["fully_recovered"]`` is the leak oracle the
        #: fleet drill asserts on
        self.manifest: Optional[Dict[str, Any]] = None
        m = engine.metrics
        if m is not None:
            # stable rollup identity: the engine's registry takes the
            # replica id as its name, so fleet merges label gauges
            # source=<replica id> (idempotent across repeated rollups)
            # and the engine's own snapshot exports self-identify
            m.name = replica_id

    @property
    def available(self) -> bool:
        """Routable: serving and not already unwinding toward a drain
        (the engine's drain flag flips on SIGTERM before the pool hears
        about it — the router must see it immediately)."""
        return self.state == REPLICA_SERVING and not self.engine.draining

    # ------------- routing signals (host-only) ---------------- #

    def prefix_overlap(self, tokens: Sequence[int]) -> int:
        """Prompt tokens this replica's prefix cache would serve from
        already-written KV blocks: full matched chain blocks plus the
        copy-on-write tail span. A pure (side-effect-free) trie walk —
        ``PrefixCache.match`` neither acquires nor stats-bumps."""
        dev, host = self.prefix_overlap_tiered(tokens)
        return dev + host

    def prefix_overlap_tiered(self, tokens: Sequence[int]
                              ) -> Tuple[int, int]:
        """(device_tokens, host_tokens) split of :meth:`prefix_overlap`
        — the router scores demoted (host-tier) overlap at a discount:
        a demoted hit still skips the prefill FLOPs but pays the
        promotion copies, so a replica holding the chain on DEVICE
        should win the placement over one that would have to promote
        it. Same pure trie walk."""
        pc = self.engine._prefix
        if pc is None:
            return 0, 0
        entries, cow, cow_len = pc.match(tokens)
        bs = pc.block_size
        dev = sum(bs for e in entries if e.tier == "device")
        host = sum(bs for e in entries if e.tier != "device")
        if cow is not None:
            if cow.tier == "device":
                dev += cow_len
            else:
                host += cow_len
        return dev, host

    def queue_frac(self) -> float:
        """(Live + batch-routed) sequences over ADVERTISED slots — the
        load half of the routing score (can exceed 1.0 when the engine
        oversubscribes its pool with paused/queued sequences, which is
        exactly when the replica should repel traffic). Browned-out
        replicas advertise ``slot_frac`` of their physical slots, so
        pressure here rises and the router's full gate trips earlier."""
        ms = self.engine.config.max_seqs * self.slot_frac
        if ms <= 0:
            return 0.0
        return (len(self.engine.state.sequences)
                + self.pending_routed) / ms

    def slo_headroom(self, slo_ttft_s: float) -> float:
        """1 − (this replica's TTFT p99 / the fleet target), clamped to
        [−1, 1]: positive while the replica meets its SLO, negative once
        it violates. Neutral (1.0) with telemetry off or before any
        request completed."""
        m = self.engine.metrics
        if m is None or not m.enabled:
            return 1.0
        p99 = m.histogram("serve_ttft_s").quantile(0.99)
        if p99 is None:
            return 1.0
        h = 1.0 - p99 / slo_ttft_s
        return h if h > -1.0 else -1.0

    def describe(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "role": self.role,
            # the replica's seq-parallel mesh width (1 = single-chip):
            # long-context pools give prefill specialists a wider seq
            # axis than decode ones (docs/serving.md "Long-context
            # serving"), and the fleet drills assert the shape took
            "seq_size": max(1, int(getattr(
                self.engine.config, "seq_size", 1) or 1)),
            "live_sequences": len(self.engine.state.sequences),
            "queue_frac": round(self.queue_frac(), 4),
            "free_blocks": self.engine.kv_cache.free_blocks,
            "draining": bool(self.engine.draining),
        }


class _FleetStateView:
    """The pool's ``.state`` facade — just enough of ``StateManager``'s
    read surface (``sequences``, ``get``) for single-engine drivers
    (the loadgen, the drills) to run against the fleet unchanged."""

    __slots__ = ("_pool",)

    def __init__(self, pool: "ReplicaPool"):
        # weak: the pool owns its view, and a cycle would keep every
        # replica's device memory alive until a garbage collection
        self._pool = weakref.ref(pool)

    @property
    def sequences(self) -> Dict[int, Any]:
        out: Dict[int, Any] = {}
        for rep in self._pool().replicas():
            if rep.state != REPLICA_DEAD:
                out.update(rep.engine.state.sequences)
        return out

    def get(self, uid: int):
        rep = self._pool().owner_of(uid)
        return rep.engine.state.get(uid) if rep is not None else None


class ReplicaPool:
    """N engine replicas behind one router (module docstring has the
    architecture; docs/serving.md "Replica pool" the protocol)."""

    def __init__(self, engines: Sequence[Any] = (),
                 policy: Optional[str] = None,
                 seed: Optional[int] = None,
                 slo_ttft_s: Optional[float] = None,
                 ledger: Any = None, name: str = "fleet",
                 replica_ids: Optional[Sequence[str]] = None,
                 roles: Optional[Sequence[str]] = None,
                 role_mesh: Optional[Dict[str, int]] = None):
        # env knobs read with LITERAL names:
        # DSTPU_FLEET_POLICY is the operational routing kill-switch
        # (prefix_aware -> round_robin/random without a rebuild),
        # DSTPU_FLEET_SEED pins tie-break reproducibility,
        # DSTPU_FLEET_SLO_TTFT_S arms the router's headroom term,
        # DSTPU_FLEET_ROLES assigns per-replica phase specialisms
        # (comma list, e.g. "prefill,decode" — docs/serving.md
        # "Disaggregated serving"), DSTPU_DISAGG=0 is the kill switch
        # that forces every replica mixed (the exact pre-disagg pool
        # path: no phase filter, no migration)
        if policy is None:
            policy = os.environ.get("DSTPU_FLEET_POLICY") \
                or "prefix_aware"
        if seed is None:
            seed = int(os.environ.get("DSTPU_FLEET_SEED") or "0")
        if slo_ttft_s is None:
            slo_ttft_s = float(
                os.environ.get("DSTPU_FLEET_SLO_TTFT_S") or "0")
        if roles is None:
            rv = os.environ.get("DSTPU_FLEET_ROLES")
            if rv:
                roles = [r.strip() for r in rv.split(",")]
        # per-role mesh shapes (docs/serving.md "Long-context serving"):
        # DSTPU_FLEET_ROLE_MESH = "prefill=2,decode=1" gives each ROLE its
        # seq-parallel width — prefill specialists take a wide seq axis
        # for context-parallel prefill, decode ones stay narrow. Advisory
        # to engine builders (build_replica_engines hands out matching
        # device slices); the pool validates and publishes it.
        if role_mesh is None:
            rmv = os.environ.get("DSTPU_FLEET_ROLE_MESH")
            if rmv:
                role_mesh = {}
                for part in rmv.split(","):
                    rname, _, width = part.partition("=")
                    role_mesh[rname.strip()] = int(width)
        self.role_mesh: Dict[str, int] = dict(role_mesh or {})
        for rname, width in self.role_mesh.items():
            if rname not in REPLICA_ROLES:
                raise ValueError(
                    f"role_mesh role must be one of {REPLICA_ROLES}, "
                    f"got {rname!r}")
            if width < 1:
                raise ValueError(
                    f"role_mesh width for {rname!r} must be >= 1, "
                    f"got {width}")
            if width > 1:
                raise NotImplementedError(
                    f"role_mesh width {width} for {rname!r}: a replica "
                    f"over several cards (sequence parallelism) is not "
                    f"ported yet (queue item A8)")
        self._disagg = os.environ.get("DSTPU_DISAGG", "1") != "0"
        if not self._disagg:
            roles = None
        self.name = name
        self.router = Router(policy=policy, seed=seed,
                             slo_ttft_s=slo_ttft_s)
        self._replicas: Dict[str, Replica] = {}
        self._owner: Dict[int, str] = {}          # uid -> replica id
        #: replay tokens a drained replica's sequences earned on their
        #: new survivor before the caller's next decode call — spliced
        #: into that call's result so caller streams stay gapless
        self._replayed: Dict[int, List[int]] = {}
        #: drain manifests still owed a survivor (every replica died
        #: before a replay target existed) — replayed as soon as a
        #: joiner registers; until then fresh work gets the structured
        #: no_serving_replica rejection, never a crash
        self._orphans: List[Dict[str, Any]] = []
        #: pool-level structured rejections (no serving replica); the
        #: engines' own rejection records merge in via :attr:`rejections`
        self._pool_rejections: Dict[int, Dict[str, Any]] = {}
        self._executor = None        # lazy per-replica worker threads
        self._exec_lock = threading.Lock()
        #: serializes :meth:`absorb_draining` across concurrent driver
        #: threads — exactly one caller runs the drain→replay sweep;
        #: the loser sees the flags already cleared and returns
        self._absorb_lock = threading.Lock()
        #: guards the shared routing maps (_owner, _replayed,
        #: _trace_ids/_trace_n, _pool_rejections) — mutated from the
        #: admission path (put), the absorb sweep and the decode driver
        #: concurrently. Leaf lock by construction:
        #: critical sections are dict/list splices only, NEVER an engine
        #: call or another lock acquisition, so the only nesting is
        #: _absorb_lock -> _route_lock (one direction, no inversion).
        self._route_lock = threading.Lock()
        #: fleet-wide trace contexts (docs/observability.md "Distributed
        #: tracing"): uid -> the trace id minted at admission. A monotone
        #: counter disambiguates uid reuse, so a retried uid starts a
        #: FRESH logical track instead of splicing onto the old one.
        self._trace_ids: Dict[int, str] = {}
        self._trace_n = 0
        #: the pool's own flight ring — routing-decision spans
        #: (``req_route`` with the per-replica scores) land here, on the
        #: same clock discipline as the engines' rings, so a merged
        #: fleet trace shows WHY a request went where it went. None when
        #: telemetry is off (zero overhead, like the engines).
        self.flight: Optional[FlightRecorder] = None
        if telemetry_enabled():
            self.flight = FlightRecorder()
            register_recorder(self.flight)
        self.state = _FleetStateView(self)
        if ledger is None and os.environ.get("DSTPU_RESTART_LEDGER"):
            from ..resilience.ledger import RestartLedger
            ledger = RestartLedger(os.environ["DSTPU_RESTART_LEDGER"])
        self._ledger = ledger
        ids = list(replica_ids) if replica_ids is not None else [
            f"r{i}" for i in range(len(engines))]
        if len(ids) != len(engines):
            raise ValueError(
                f"{len(ids)} replica_ids for {len(engines)} engines")
        rls = list(roles) if roles is not None \
            else ["mixed"] * len(engines)
        if len(rls) != len(engines):
            raise ValueError(
                f"{len(rls)} roles for {len(engines)} engines")
        for rid, eng, role in zip(ids, engines, rls):
            self.add_replica(eng, replica_id=rid, role=role)

    # ------------------------------------------------------------------ #
    # membership
    # ------------------------------------------------------------------ #

    def replicas(self) -> List[Replica]:
        """Members in join order (the router's candidate order)."""
        return list(self._replicas.values())

    def replica(self, replica_id: str) -> Replica:
        return self._replicas[replica_id]

    def owner_of(self, uid: int) -> Optional[Replica]:
        rid = self._owner.get(uid)
        return self._replicas.get(rid) if rid is not None else None

    @property
    def serving_count(self) -> int:
        return sum(1 for r in self._replicas.values() if r.available)

    @property
    def _phase_routing(self) -> bool:
        """Disaggregated placement is live: the kill switch is on AND at
        least one member declares a specialism. An all-``mixed`` fleet
        (or ``DSTPU_DISAGG=0``) short-circuits to the exact pre-disagg
        path — no phase filter, no post-put migration."""
        return self._disagg and any(
            r.role != "mixed" for r in self._replicas.values())

    def add_replica(self, engine, replica_id: Optional[str] = None,
                    role: str = "mixed") -> Replica:
        """Register a (late-)joining replica: it becomes a routing
        candidate immediately — a fresh joiner has an empty queue, so
        the score's load term starts steering traffic its way on the
        very next placement. ``role`` declares a phase specialism
        (docs/serving.md "Disaggregated serving"); with
        ``DSTPU_DISAGG=0`` it is forced to ``mixed`` so the pool runs
        the exact pre-disagg path."""
        if replica_id is None:
            replica_id = f"r{len(self._replicas)}"
        if replica_id in self._replicas:
            raise ValueError(f"replica id {replica_id!r} already joined")
        if not self._disagg:
            role = "mixed"
        rep = Replica(replica_id, engine, role=role)
        self._replicas[replica_id] = rep
        if self._ledger is not None:
            self._ledger.record("fleet_join", replica=replica_id,
                                pool=self.name, role=role,
                                serving=self.serving_count)
        return rep

    def drain_replica(self, replica_id: str,
                      path: Optional[str] = None) -> Dict[str, Any]:
        """Cooperatively drain one replica through the drain protocol:
        its live sequences land in a replay manifest, ALL its engine
        state is released (``manifest["pool"]["fully_recovered"]`` is
        the exactness verdict), and the replica leaves the routing set
        for good. Idempotent on an already-dead replica (returns its
        manifest). Does NOT replay — pair with
        :meth:`replay_manifest`, or let :meth:`absorb_draining` do both."""
        rep = self._replicas[replica_id]
        if rep.state == REPLICA_DEAD:
            return rep.manifest or {}
        rep.state = REPLICA_DRAINING
        with rep.lock:
            rep.engine.request_drain()
            manifest = rep.engine.drain(path)
        rep.manifest = manifest
        rep.state = REPLICA_DEAD
        if self._ledger is not None:
            self._ledger.record(
                "fleet_drain", replica=replica_id, pool=self.name,
                sequences=len(manifest.get("sequences", ())),
                fully_recovered=manifest.get("pool", {}).get(
                    "fully_recovered"),
                survivors=self.serving_count)
        return manifest

    def replay_manifest(self, manifest: Dict[str, Any]
                        ) -> Dict[int, Any]:
        """Route a dead replica's manifested sequences onto survivors —
        each sequence is placed by the router scoring its FULL chain
        (prompt + generated), so on shared-prefix workloads the replica
        already holding the preamble's blocks wins and the re-prefill is
        mostly cache hits. Returns {uid: next committed greedy token}
        (the same continuation the dead replica would have emitted —
        replay parity is the drain's oracle). Raises
        :class:`NoServingReplicaError` with no survivors."""
        recs = manifest.get("sequences", [])
        if not recs:
            return {}
        groups: Dict[str, List[Dict[str, Any]]] = {}
        try:
            for rec in recs:
                chain = list(rec["prompt"]) + list(rec["generated"])
                # the re-placement is itself a traced routing decision:
                # the request's track shows the drain-time hop and the
                # scores that picked its survivor
                rep = self._route(int(rec["uid"]), chain,
                                  replay_rec=rec)
                rep.pending_routed += 1
                groups.setdefault(rep.replica_id, []).append(rec)
        finally:
            for rep in self._replicas.values():
                rep.pending_routed = 0
        out: Dict[int, Any] = {}
        for rid, rs in groups.items():
            rep = self._replicas[rid]
            sub = {"version": manifest.get("version", 1),
                   "source": "fleet_replay", "sequences": rs}
            with rep.lock:
                res = rep.engine.replay(sub)
            for rec in rs:
                uid = int(rec["uid"])
                with self._route_lock:
                    self._owner[uid] = rid
                if uid in res:
                    out[uid] = res[uid]
        if self._ledger is not None:
            self._ledger.record(
                "fleet_replay", pool=self.name, sequences=len(recs),
                placement={rid: len(rs) for rid, rs in groups.items()})
        return out

    def absorb_draining(self) -> None:
        """Drain-and-replay every replica whose engine has flipped its
        drain flag (SIGTERM between engine calls): survivors absorb the
        manifested sequences, and the replay tokens are stashed for the
        caller's next :meth:`decode_pipelined`, which splices them into
        its result. With NO survivor the manifests wait as orphans —
        published to disk by the drain as usual — and replay onto the
        first joiner. Called automatically at every pool entry point;
        cheap (one flag read per replica) when nothing is draining.
        Serialized pool-wide (``_absorb_lock``) so concurrent driver
        threads cannot double-drain one victim."""
        with self._absorb_lock:
            for rep in list(self._replicas.values()):
                if rep.state == REPLICA_SERVING and rep.engine.draining:
                    self._orphans.append(
                        self.drain_replica(rep.replica_id))
            if not self._orphans \
                    or not any(r.available
                               for r in self._replicas.values()):
                return
            orphans, self._orphans = self._orphans, []
            for manifest in orphans:
                for uid, tok in self.replay_manifest(manifest).items():
                    self._stash_replay(uid, tok)

    # ------------------------------------------------------------------ #
    # request tracing (docs/observability.md "Distributed tracing")
    # ------------------------------------------------------------------ #

    def _mint_trace(self, uid: int) -> str:
        """Mint the fleet-wide trace context for one admitted request —
        the id every lifecycle span (router decision, replica execution,
        spec rounds, drain→replay continuation) carries so a merged
        multi-replica flight dump reconstructs one gapless track per
        request. A hot path: a counter and two dict
        stores."""
        with self._route_lock:
            self._trace_n += 1
            tid = f"{self.name}/{uid}#{self._trace_n}"
            self._trace_ids[uid] = tid
        return tid

    def _route(self, uid: int, toks: Sequence[int],
               replay_rec: Optional[Dict[str, Any]] = None,
               phase: Optional[str] = None):
        """One routing decision, traced: select a replica and — with
        telemetry on — record the ``req_route`` decision span carrying
        the per-replica scores the router saw, tagged with the request's
        trace context (minted here for fresh requests; a replayed or
        handed-off sequence keeps the trace its record carried).
        ``phase`` applies the router's role filter (disaggregated
        serving — fresh work to prefill-capable replicas, migrations to
        decode-capable ones). A hot path — pure host
        scoring plus one ring append."""
        if self.flight is None:
            return self.router.select(self.replicas(), toks,
                                      phase=phase)
        ex: Dict[str, Any] = {}
        t0 = time.perf_counter()
        rep = self.router.select(self.replicas(), toks, explain=ex,
                                 phase=phase)
        if replay_rec is not None:
            trace = replay_rec.get("trace")
            if trace is not None:
                with self._route_lock:
                    self._trace_ids[uid] = trace
            ex["handoff" if phase == "decode" else "replay"] = True
        else:
            trace = self._mint_trace(uid)
        args = {"uid": uid, **ex}
        if trace is not None:
            args["trace"] = trace
        self.flight.record("req_route", t0, time.perf_counter(),
                           args=args)
        return rep

    def dump_merged_trace(self, path: str) -> Optional[str]:
        """Merge the pool's routing spans with EVERY member's engine
        flight ring — dead replicas included: their pre-drain spans are
        the first half of a drained request's track — into one fleet
        Chrome trace (:func:`~..telemetry.flight_recorder.
        merge_chrome_traces` namespaces tracks by source and stitches
        trace-context spans), atomically published at ``path``. None
        when telemetry is off."""
        if self.flight is None:
            return None
        dumps = [self.flight.to_chrome_trace(reason="fleet")]
        srcs = [f"{self.name}.router"]
        for rid, rep in self._replicas.items():
            fl = rep.engine.flight
            if fl is not None:
                dumps.append(fl.to_chrome_trace(reason="fleet"))
                srcs.append(rid)
        atomic_json_dump(path, merge_chrome_traces(dumps, srcs))
        return path

    # ------------------------------------------------------------------ #
    # the engine-shaped serving surface (A hot paths)
    # ------------------------------------------------------------------ #

    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[Sequence[int]],
            _greedy: bool = False,
            arrivals: Optional[Dict[int, float]] = None,
            deadlines: Optional[Dict[int, float]] = None,
            sampling: Optional[Dict[int, Any]] = None
            ) -> Dict[int, Any]:
        """Fleet admission. Placement is SEQUENTIAL per request (pure
        host scoring — each decision sees the queue/ownership state the
        previous one created), then the routed per-replica prompt
        batches PREFILL CONCURRENTLY, one worker thread per replica,
        exactly like the decode rounds — admission wall time stays that
        of the busiest replica, not the sum. Continuations go to their
        owner. Returns the merged {uid: result} map; refusals surface
        through :attr:`rejections` exactly like a single engine's.
        ``sampling`` ({uid: SamplingParams}) passes through to each
        owning engine unchanged-shape — per-request sampling and
        speculative decode work identically behind the fleet surface."""
        self.absorb_draining()
        done: Dict[int, Any] = {}
        groups: Dict[str, List[int]] = {}
        fresh: Dict[str, List[int]] = {}
        toks_of: Dict[int, Sequence[int]] = {}
        # disaggregated placement (docs/serving.md): fresh requests go
        # to prefill-capable replicas; after the batch prefills, the
        # migration step below moves each sequence that landed on a
        # prefill SPECIALIST onto a decode-capable replica, invisibly
        # to the caller (results are computed before the move)
        phase = "prefill" if self._phase_routing else None
        try:
            for uid, toks in zip(batch_uids, batch_tokens):
                rep = self.owner_of(uid)
                live = rep is not None \
                    and rep.engine.state.get(uid) is not None
                if not live:
                    # fresh request (or a reused/stale uid): route it.
                    # A LIVE continuation stays with its owner even
                    # mid-drain — the sequence rides that replica's
                    # manifest; rerouting its tokens would re-admit
                    # them as a bogus new prompt elsewhere
                    try:
                        rep = self._route(uid, toks, phase=phase)
                    except NoServingReplicaError:
                        self._reject(uid, "no_serving_replica")
                        continue
                    with self._route_lock:
                        self._owner[uid] = rep.replica_id
                    rep.pending_routed += 1
                    fresh.setdefault(rep.replica_id, []).append(uid)
                    # a uid retried after an earlier refusal sheds its
                    # stale records EVERYWHERE — a present record must
                    # only ever mean THIS admission failed. The engine
                    # clears only its own on re-admission, but a retry
                    # may land on a different replica while the old
                    # record (possibly on a now-dead replica) would
                    # keep polluting the merged :attr:`rejections` view
                    with self._route_lock:
                        self._pool_rejections.pop(uid, None)
                    for other in self._replicas.values():
                        other.engine.rejections.pop(uid, None)
                groups.setdefault(rep.replica_id, []).append(uid)
                toks_of[uid] = toks
        finally:
            for rep in self._replicas.values():
                rep.pending_routed = 0

        def run_one(rid: str) -> Dict[int, Any]:
            rep = self._replicas[rid]
            members = groups[rid]
            tr = {u: self._trace_ids[u] for u in members
                  if u in self._trace_ids}
            with rep.lock:
                return rep.engine.put(
                    members, [toks_of[u] for u in members],
                    _greedy=_greedy, arrivals=arrivals,
                    deadlines=deadlines, sampling=sampling,
                    traces=tr or None)

        results = self._run_groups(run_one, groups)
        for res in results:
            done.update(res)
        if phase is not None and fresh:
            self._migrate_prefill(fresh)
        return done

    def _run_groups(self, fn, groups: Dict[str, Any]) -> List[Any]:
        """Run ``fn(replica_id)`` for every routed group — concurrently
        on the pool's persistent per-replica worker threads when more
        than one replica is involved (each worker blocks only on ITS
        engine's device, GIL released, so replica device work overlaps);
        inline for a single group."""
        if len(groups) <= 1:
            return [fn(rid) for rid in groups]
        with self._exec_lock:
            # creation is serialized (concurrent driver threads must
            # not race two executors into existence); the map itself
            # runs unlocked — the workers serialize per replica on the
            # replica locks, which is the intended contention surface
            if self._executor is None \
                    or self._executor._max_workers < len(groups):
                from concurrent.futures import ThreadPoolExecutor
                if self._executor is not None:
                    self._executor.shutdown(wait=False)
                self._executor = ThreadPoolExecutor(
                    max_workers=max(len(groups), len(self._replicas)),
                    thread_name_prefix=f"{self.name}-replica")
            ex = self._executor
        return list(ex.map(fn, groups))

    def _migrate_prefill(self, fresh: Dict[str, List[int]]) -> None:
        """The disaggregated handoff splice (docs/serving.md
        "Disaggregated serving"): every sequence the admission batch
        landed on a PREFILL specialist migrates to a decode-capable
        replica before the caller's next decode call. The move is
        invisible — the caller's first tokens were computed before it,
        ownership flips underneath, and the destination continues the
        stream from the exact same KV content and committed token
        chain, so per-uid streams stay byte-identical to colocated
        serving.

        Shape of the move: the source's :meth:`handoff_out` dispatches
        one non-blocking exact-length gather per sequence and releases
        its state; each record's destination is a traced routing
        decision (``phase="decode"`` — prefix affinity and load still
        score the candidates); ALL payloads then materialize in ONE
        batched copy to host memory whose wall is the handoff's EXPOSED
        transfer cost (the gathers themselves overlapped the batch's
        remaining device work — observed into
        ``serve_handoff_exposed_s``); the destination's
        :meth:`handoff_in` scatters and adopts. Records the
        destination cannot cover (block pressure) or that a dying
        destination refuses fall back to drain-style replay from the
        SAME records — token-identical, just paying a re-prefill
        (counted in ``serve_handoff_fallback_replays``). Each adopted
        sequence's ``req_handoff`` span lands on the pool ring tagged
        with its trace context, joining the prefill- and decode-side
        lanes in the merged fleet trace. A hot path —
        dispatch plus the one materialize wait."""
        t0 = time.perf_counter()
        routed: Dict[str, List[Dict[str, Any]]] = {}
        src_of: Dict[int, str] = {}
        fallback: List[Dict[str, Any]] = []
        for rid, uids in fresh.items():
            src = self._replicas[rid]
            if src.role != "prefill" or src.state != REPLICA_SERVING:
                continue
            live = [u for u in uids
                    if src.engine.state.get(u) is not None]
            if not live:
                continue
            try:
                with src.lock:
                    manifest = src.engine.handoff_out(live)
            except Exception:
                # a fault mid-gather (the during_handoff_gather drill
                # site, or a SIGTERM unwinding the source) aborts the
                # whole handoff BEFORE any source state was released:
                # every sequence is still live on the prefill replica —
                # it decodes colocated, or rides the source's drain
                # manifest onto a survivor token-identically
                continue
            for rec in manifest.get("sequences", ()):
                uid = int(rec["uid"])
                src_of[uid] = rid
                chain = list(rec["prompt"]) + list(rec["generated"])
                dst = self._route(uid, chain, replay_rec=rec,
                                  phase="decode")
                routed.setdefault(dst.replica_id, []).append(rec)
        if not routed:
            return
        recs_flat = [r for rs in routed.values() for r in rs]
        tg = time.perf_counter()
        # the ONE sanctioned blocking materialize of the handoff: every
        # destination's payloads copied to host memory together (the
        # first copy waits for the gathers), timed as the migration's
        # exposed cost (serve_handoff_exposed_s)
        host = [_kv_to_host(r["kv"]) for r in recs_flat]
        exposed_s = time.perf_counter() - tg
        for r, h in zip(recs_flat, host):
            r["kv"] = h
        observed = False
        for rid, rs in routed.items():
            dst = self._replicas[rid]
            try:
                with dst.lock:
                    res = dst.engine.handoff_in(
                        {"version": 1, "source": "handoff",
                         "sequences": rs},
                        # the one batched materialize covered EVERY
                        # destination's payloads: observe its wall once
                        exposed_s=0.0 if observed else exposed_s)
            except EngineDrainingError:
                # destination flipped draining between the routing
                # decision and the adopt (refused BEFORE any state
                # change): replay these records on a survivor
                fallback.extend(rs)
                continue
            observed = True
            acc = set(res["accepted"])
            t1 = time.perf_counter()
            for rec in rs:
                uid = int(rec["uid"])
                if uid not in acc:
                    fallback.append(rec)
                    continue
                with self._route_lock:
                    self._owner[uid] = rid
                if self.flight is not None:
                    args: Dict[str, Any] = {
                        "uid": uid, "src": src_of.get(uid), "dst": rid,
                        "blocks": rec.get("blocks"),
                        "exposed_s": round(exposed_s, 6)}
                    if rec.get("trace") is not None:
                        args["trace"] = rec["trace"]
                    self.flight.record("req_handoff", t0, t1,
                                       args=args)
        if fallback:
            for rec in fallback:
                rec.pop("kv", None)     # replay needs only the chain
            replayed = self.replay_manifest(
                {"version": 1, "sequences": fallback})
            for uid, tok in replayed.items():
                self._stash_replay(uid, tok)
                rep = self.owner_of(uid)
                if rep is not None and rep.engine._obs is not None:
                    rep.engine._obs.on_handoff_replay(1)

    def decode_pipelined(self, batch_uids: Sequence[int],
                         first_tokens: Sequence[int], n,
                         eos_token_id: Optional[int] = None
                         ) -> Dict[int, List[int]]:
        """One fleet decode round: group uids by owning replica and run
        every replica's overlapped ``decode_pipelined`` batch
        CONCURRENTLY — one worker thread per replica, because that is
        what replicas over disjoint device sets are: each thread blocks
        only on ITS engine's commit readbacks (releasing the GIL), so
        the replicas' device work overlaps instead of serializing
        behind one host loop, and fleet throughput scales with replica
        count on the in-process path too. Engines share no mutable
        state (each owns its pool, scheduler and staging buffers), and
        per-engine token streams stay deterministic — thread
        interleaving can reorder nothing inside one engine.

        A replica SIGTERMed before or during the round is absorbed
        (drain → survivor replay) and the replay tokens are spliced
        into this round's result — the caller's per-uid stream stays
        gapless and token-identical through the membership change."""
        self.absorb_draining()
        if isinstance(n, (list, tuple)):
            budgets = {u: b for u, b in zip(batch_uids, n)}
        else:
            budgets = {u: n for u in batch_uids}
        out: Dict[int, List[int]] = {u: [] for u in batch_uids}
        rem: Dict[int, int] = {}
        last: Dict[int, int] = {}
        for u, t in zip(batch_uids, first_tokens):
            took = self._take_stash(u, budgets[u], out)
            rem[u] = budgets[u] - took
            last[u] = out[u][-1] if out[u] else t
        groups: Dict[str, List[int]] = {}
        for u in batch_uids:
            if rem[u] <= 0:
                continue
            rep = self.owner_of(u)
            if rep is None or not rep.available:
                continue              # absorbed: the stash carries it
            groups.setdefault(rep.replica_id, []).append(u)

        def run_one(rid: str) -> Dict[int, List[int]]:
            with self._replicas[rid].lock:
                return run_locked(rid)

        def run_locked(rid: str) -> Dict[int, List[int]]:
            eng = self._replicas[rid].engine
            members = groups[rid]
            if getattr(eng, "spec_enabled", False) or any(
                    (s := eng.state.get(u)) is not None
                    and s.sampling is not None
                    and not s.sampling.greedy for u in members):
                # speculative / sampled members ride decode_pipelined,
                # which routes to decode_spec (greedy batches) or the
                # per-slot sampler pipeline — both budget-exact
                return eng.decode_pipelined(
                    members, [last[u] for u in members],
                    [rem[u] for u in members],
                    eos_token_id=eos_token_id)
            if eos_token_id is None and hasattr(eng.runner,
                                               "decode_loop"):
                # fused fleet decode: bucket the replica's batch by
                # budget and run ONE device program per bucket
                # (token-identical to the per-step path, the decode
                # loop's parity oracle). Host python per token drops to ~one
                # dispatch per burst, so N replicas' decode rounds
                # genuinely overlap instead of contending for the
                # interpreter; block-pressure falls back to the
                # incremental pipelined path, which can shed.
                res: Dict[int, List[int]] = {}
                by_budget: Dict[int, List[int]] = {}
                for u in members:
                    by_budget.setdefault(rem[u], []).append(u)
                for b, us in by_budget.items():
                    if len(us) <= eng.config.max_seqs:
                        try:
                            res.update(eng.decode_batch(
                                us, [last[u] for u in us], b))
                            continue
                        except (OutOfBlocksError, ValueError):
                            # pool pressure / paused member / oversized
                            # batch: the incremental path paces it
                            pass
                    res.update(eng.decode_pipelined(
                        us, [last[u] for u in us], b))
                return res
            return eng.decode_pipelined(
                members, [last[u] for u in members],
                [rem[u] for u in members], eos_token_id=eos_token_id)

        results = self._run_groups(run_one, groups)
        for rid, res in zip(groups, results):
            for u in groups[rid]:
                got = res.get(u) or []
                out[u].extend(got)
                rem[u] -= len(got)
        # a SIGTERM mid-round: the victim unwound with partial output —
        # absorb now so its replay tokens land in THIS result (budget
        # permitting; the rest waits in the stash)
        self.absorb_draining()
        for u in batch_uids:
            if rem[u] > 0:
                self._take_stash(u, rem[u], out)
        return out

    def _stash_replay(self, uid: int, tok: int) -> None:
        """Append one replayed token to the stash under ``_route_lock``
        — the absorb sweep and the handoff fallback both feed the stash
        while a decode driver may be splicing it out via
        :meth:`_take_stash`; an unlocked setdefault().append() here
        loses tokens to the pop/reinsert window."""
        with self._route_lock:
            self._replayed.setdefault(uid, []).append(tok)

    def _take_stash(self, uid: int, budget: int,
                    out: Dict[int, List[int]]) -> int:
        """Move up to ``budget`` stashed replay tokens for ``uid`` into
        ``out``; leftovers stay stashed. Pure host list work; the whole
        pop/splice/reinsert is one ``_route_lock`` critical section so
        a concurrent :meth:`_stash_replay` cannot land between the pop
        and the reinsert and be lost."""
        with self._route_lock:
            stash = self._replayed.pop(uid, None)
            if not stash:
                return 0
            if budget <= 0:
                self._replayed[uid] = stash
                return 0
            take = stash[:budget]
            if stash[budget:]:
                self._replayed[uid] = stash[budget:]
        out[uid].extend(take)
        return len(take)

    def flush(self, uid: int) -> None:
        with self._route_lock:
            self._replayed.pop(uid, None)
            self._trace_ids.pop(uid, None)
            rid = self._owner.pop(uid, None)
        rep = self._replicas.get(rid) if rid is not None else None
        if rep is not None:
            with rep.lock:
                if rep.engine.state.get(uid) is not None:
                    rep.engine.flush(uid)

    def _reject(self, uid: int, reason: str, **fields) -> None:
        # same record shape as the engine's _reject — retry_after_s is
        # a first-class (if usually None) field so door rejections can
        # carry the admission controller's backoff hint and report
        # readers never need a reason-specific schema
        with self._route_lock:
            self._pool_rejections[uid] = {
                "uid": uid, "reason": reason, "time": time.time(),
                "retry_after_s": fields.pop("retry_after_s", None),
                **fields}

    @property
    def rejections(self) -> Dict[int, Dict[str, Any]]:
        """Merged structured-rejection view: pool-level refusals plus
        every replica's engine records (a uid lives on exactly one
        replica, so the union is collision-free)."""
        out = dict(self._pool_rejections)
        for rep in self._replicas.values():
            out.update(rep.engine.rejections)
        return out

    # ------------------------------------------------------------------ #
    # fleet telemetry rollup
    # ------------------------------------------------------------------ #

    def fleet_registry(self) -> Optional[MetricsRegistry]:
        """Merge live replicas' per-engine registries into one fleet
        registry: counters sum, gauges keep per-replica identity via
        ``source=<replica id>`` labels (STABLE — keyed by id, not
        insertion index, so re-rolling the same fleet is idempotent),
        histograms merge bucket-wise exactly. None when telemetry is
        off. The dead replicas' final stats live in their drain
        manifests (``manifest["telemetry"]``), not here."""
        regs: List[MetricsRegistry] = []
        srcs: List[str] = []
        for rid, rep in self._replicas.items():
            if rep.state == REPLICA_DEAD:
                continue
            m = rep.engine.metrics
            if m is not None:
                # pool/prefix gauges refresh on export boundaries; a
                # rollup must not read stale (or never-set) values
                rep.engine._obs.sync_gauges()
                regs.append(m)
                srcs.append(rid)
        if not regs:
            return None
        return MetricsRegistry.merge(regs, name=self.name, sources=srcs)

    def fleet_snapshot(self) -> Dict[str, Any]:
        """One merged, export-shaped snapshot of the whole pool (the
        in-process analogue of ``telemetry.merge_snapshots`` over
        per-process export files), plus per-replica membership detail
        and the router's dispatch stats."""
        reg = self.fleet_registry()
        snap: Dict[str, Any] = reg.snapshot() if reg is not None else {
            "counters": {}, "gauges": {}, "histograms": {}}
        snap["time"] = time.time()
        snap["registry"] = f"{self.name}({self.serving_count})"
        snap["replicas"] = {rid: rep.describe()
                            for rid, rep in self._replicas.items()}
        snap["router"] = self.router.describe()
        return snap

    def export(self, path: str) -> None:
        """Atomic fleet-snapshot publish (tmp + rename) — same torn-read
        discipline as ``MetricsRegistry.export``; ``bin/dstpu_top``
        renders the file like any single-engine export."""
        atomic_json_dump(path, self.fleet_snapshot())

    def slo_report(self) -> Dict[str, Any]:
        """Fleet-wide SLO summary in the same shape as a single
        engine's ``slo_report()`` — computed from the merged registry,
        so the percentiles are EXACTLY what one stream over every
        replica's requests would report ({} when telemetry is off)."""
        reg = self.fleet_registry()
        if reg is None:
            return {}
        return slo_report_from_registry(reg)


def fleet_prefix_stats(pool: ReplicaPool) -> Dict[str, Any]:
    """Summed host-side prefix-cache counters across live replicas plus
    the fleet-wide skipped-prefill fraction — the number the routing
    bench gates on (prefix-aware must beat random here)."""
    keys = ("matched_tokens", "prefill_tokens", "cow_tokens",
            "matched_blocks", "cow_copies")
    out: Dict[str, Any] = {k: 0 for k in keys}
    for rep in pool.replicas():
        if rep.state == REPLICA_DEAD:
            continue
        st = rep.engine.prefix_stats
        for k in keys:
            out[k] += st.get(k, 0)
    hit, ran = out["matched_tokens"], out["prefill_tokens"]
    out["prefill_chunks_skipped_frac"] = \
        hit / (hit + ran) if hit + ran else 0.0
    return out


def build_replica_engines(engine_factory, n: int,
                          devices: Optional[Sequence[Any]] = None,
                          devices_per_replica: Optional[
                              Sequence[int]] = None) -> List[Any]:
    """Build ``n`` engines for a pool: ``engine_factory(i, device)``
    returns replica ``i``'s engine on ``device``, cycling ``devices``
    (default ``[torch.device("cuda")]``: every replica shares the one
    card, its weights and KV pool its own; ``["cpu", ...]`` in tests).
    ``devices_per_replica`` above 1 (a replica over several cards, the
    JAX package's seq-parallel prefill specialists) is A8."""
    import torch
    if devices_per_replica is not None and any(
            int(k) > 1 for k in devices_per_replica):
        raise NotImplementedError(
            "build_replica_engines(devices_per_replica=...): a replica "
            "over several cards is not ported yet (queue item A8)")
    devs = [torch.device(d) for d in devices] if devices is not None \
        else [torch.device("cuda")]
    if not devs:
        raise ValueError("build_replica_engines: no devices")
    return [engine_factory(i, devs[i % len(devs)]) for i in range(n)]


def _kv_to_host(kv):
    """A handoff record's KV payload (rows, or (rows, scales) for an int8
    pool) in host memory."""
    if isinstance(kv, tuple):
        return tuple(t.cpu() for t in kv)
    return kv.cpu()


def single_stream_oracle(values: Sequence[float],
                         alpha: float = 0.05) -> Histogram:
    """One histogram fed the union of ``values`` in a single stream —
    the oracle the fleet drill compares the merged rollup against
    (``Histogram.merge`` exactness means the two must agree bucket for
    bucket, hence quantile for quantile)."""
    h = Histogram(alpha=alpha)
    for v in values:
        h.observe(v)
    return h
