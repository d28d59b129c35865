"""Registry -> MonitorMaster bridge.

Port of ``deepspeed_tpu/telemetry/monitor_bridge.py``, host code that the
port keeps its own copy of (it imports nothing of the JAX package). The
monitor writers themselves (``monitor/``) are not ported yet (ROADMAP
A9): any object with ``write_events`` is a master here.

``telemetry.attach_monitor(master, interval_steps)`` makes every writer
a monitor layer multiplexes (TensorBoard/CSV/W&B/Comet in the JAX
package's ``monitor/monitor.py``) receive periodic registry snapshots:
counters and gauges as scalars, histograms as their p50/p99/count
triple. The registry's ``tick(step)`` (called by the serve observer at
commit boundaries, or by any train loop) drives the cadence; nothing is
emitted between intervals, so the monitor write amplification is
bounded regardless of request rate.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from .registry import MetricsRegistry, get_registry

Event = Tuple[str, float, int]


class MonitorBridge:
    def __init__(self, master, interval_steps: int = 100,
                 registry: Optional[MetricsRegistry] = None,
                 prefix: str = "telemetry"):
        self.master = master
        self.interval_steps = max(1, int(interval_steps))
        self.registry = registry if registry is not None else get_registry()
        self.prefix = prefix
        self._last_step: Optional[int] = None

    def step(self, step: int) -> None:
        """Emit iff ``interval_steps`` have elapsed since the last emit
        (the first call always emits)."""
        if self._last_step is not None \
                and step - self._last_step < self.interval_steps:
            return
        self._last_step = step
        self.emit(step)

    def emit(self, step: int) -> None:
        snap = self.registry.snapshot()
        events: List[Event] = []
        p = self.prefix
        for name, value in snap.get("counters", {}).items():
            events.append((f"{p}/{name}", float(value), step))
        for name, value in snap.get("gauges", {}).items():
            events.append((f"{p}/{name}", float(value), step))
        for name, summ in snap.get("histograms", {}).items():
            events.append((f"{p}/{name}/count",
                           float(summ.get("count", 0)), step))
            for q in ("p50", "p99"):
                if summ.get(q) is not None:
                    events.append((f"{p}/{name}/{q}", float(summ[q]),
                                   step))
        if events:
            self.master.write_events(events)


def attach_monitor(master, interval_steps: int = 100,
                   registry: Optional[MetricsRegistry] = None,
                   prefix: str = "telemetry") -> MonitorBridge:
    """Attach ``master`` (a MonitorMaster or any object with
    ``write_events``) to ``registry`` (default: the process registry):
    a snapshot is written every ``interval_steps`` registry ticks."""
    reg = registry if registry is not None else get_registry()
    bridge = MonitorBridge(master, interval_steps, reg, prefix)
    reg._bridges.append(bridge)
    return bridge
