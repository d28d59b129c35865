"""Telemetry — metrics registry, phase flight recorder, trace hooks (port
of ``deepspeed_tpu/telemetry``, its serving half).

Counters, gauges and log-bucketed streaming histograms with
Prometheus/JSON export (:mod:`.registry`), a bounded ring of
plan/dispatch/commit/drain/replay spans dumped as Chrome-trace JSON on
watchdog fire / fault crash / drain (:mod:`.flight_recorder`),
per-request SLO instrumentation and step-time attribution for the v2
serve engine (:mod:`.serve`, :mod:`.attribution`), the open-loop load
generator and capacity sweep (:mod:`.loadgen`), a monitor bridge
(:mod:`.monitor_bridge`), the snapshot renderer
(``python -m deepspeed_tpu_torch.telemetry.top``, :mod:`.top`) and
optional ``torch.profiler`` capture (:mod:`.trace`).

Kill switch: ``DSTPU_TELEMETRY=0`` — every registry call becomes a
shared no-op and the serve engine skips instrumentation entirely.

Not ported yet, and raising ``NotImplementedError`` when imported from
here: goodput and the training observer (A7.6), and the program-audited
collective share (A9).
"""

from .attribution import (ATTRIBUTION_COMPONENTS, STEP_WALL_COMPONENTS,
                          attribution_report, comm_share,
                          component_totals, step_wall_total)
from .flight_recorder import (FlightRecorder, atomic_json_dump, auto_dump,
                              flight_dir, merge_chrome_traces,
                              register_recorder, request_tracks)
from .loadgen import (LoadResult, PoissonArrivals, Request,
                      TraceArrivals, UniformArrivals, WorkloadMix,
                      build_requests, run_open_loop, sweep_capacity)
from .monitor_bridge import MonitorBridge, attach_monitor
from .registry import (COMM_CANONICAL_KINDS, REGISTERED_METRICS, Counter,
                       Gauge, Histogram, MetricsRegistry, NullRegistry,
                       comm_counter, get_registry, merge_snapshots,
                       new_registry, record_phase_tflops, set_registry,
                       telemetry_enabled)
from .serve import ServeObserver, serve_observer, slo_report_from_registry
from .trace import annotate, maybe_trace, trace_dir, trace_path

__all__ = [
    "ATTRIBUTION_COMPONENTS", "COMM_CANONICAL_KINDS", "Counter",
    "FlightRecorder", "Gauge", "Histogram", "LoadResult",
    "MetricsRegistry", "MonitorBridge", "NullRegistry",
    "PoissonArrivals", "REGISTERED_METRICS", "Request",
    "STEP_WALL_COMPONENTS", "ServeObserver", "TraceArrivals", "UniformArrivals", "WorkloadMix", "annotate",
    "atomic_json_dump", "attach_monitor", "attribution_report",
    "auto_dump", "build_requests", "comm_counter", "comm_share",
    "component_totals", "flight_dir", "get_registry", "maybe_trace",
    "merge_chrome_traces", "merge_snapshots", "new_registry",
    "record_phase_tflops", "register_recorder", "request_tracks",
    "run_open_loop", "serve_observer", "set_registry",
    "slo_report_from_registry", "step_wall_total", "sweep_capacity",
    "telemetry_enabled", "trace_dir", "trace_path",
]

#: names the JAX package's telemetry exports that the port has not yet,
#: and the queue item each waits for
_NOT_PORTED = {
    **dict.fromkeys(("goodput_from_ledgers", "goodput_report",
                     "load_ledger_events"), "A7.6 (telemetry/goodput.py)"),
    **dict.fromkeys(("TrainObserver", "train_comm_share", "train_observer",
                     "train_skew_report", "TRAIN_ATTRIBUTION_COMPONENTS",
                     "train_attribution_report"),
                    "A7.6 (telemetry/train.py)"),
}


def __getattr__(name: str):
    item = _NOT_PORTED.get(name)
    if item is not None:
        raise NotImplementedError(
            f"telemetry.{name} is not ported yet (queue item {item})")
    raise AttributeError(name)
