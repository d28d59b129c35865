"""Phase flight recorder — a bounded ring of serve-loop spans.

Port of ``deepspeed_tpu/telemetry/flight_recorder.py``, host code that the port keeps its
own copy of (it imports nothing of the JAX package).

Postmortems of a wedged or preempted replica keep asking the same
question: *what was the engine doing right before it died?* The watchdog
names the last phase and collective; this module keeps the last N
plan/dispatch/commit/drain/replay spans (reusing the exact phase names
the watchdog brackets carry) in a fixed-size ring and dumps them as
Chrome-trace JSON (``chrome://tracing`` / Perfetto "Load trace") when
something goes wrong:

  * **watchdog fire** — ``StepWatchdog.check_once`` auto-dumps on a
    diagnosed stall, so the trace shows the seconds leading into it;
  * **fault-drill crash** — ``FaultInjector.maybe_fire`` dumps before it
    raises or ``os._exit``s, so every drill leaves a trace artifact the
    drill result asserts on;
  * **drain** — the engine dumps at cooperative preemption, pairing the
    replay manifest with the timeline that led to it.

Dumps land under ``DSTPU_FLIGHT_DIR`` (unset = auto-dump disabled; the
ring itself is always recording — append cost is a lock + tuple). The
ring is bounded (``DSTPU_FLIGHT_CAPACITY``, default 512 spans) so a
month-long serving process holds a constant-size recorder.

Span times use ``time.perf_counter`` (monotonic, sub-µs); the dump
carries a wall-clock anchor so traces can be correlated across replicas.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

#: every live recorder, for crash-path auto-dumps (weak: a flushed
#: engine's recorder must not be kept alive by the dump hook)
_RECORDERS: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()


def flight_dir() -> Optional[str]:
    return os.environ.get("DSTPU_FLIGHT_DIR") or None


def flight_capacity() -> int:
    return int(os.environ.get("DSTPU_FLIGHT_CAPACITY", "512") or "512")


def register_recorder(rec: "FlightRecorder") -> None:
    _RECORDERS.add(rec)


def auto_dump(reason: str) -> List[str]:
    """Dump every live recorder to DSTPU_FLIGHT_DIR (no-op when unset).
    Crash-path safe: never raises — a failed dump must not mask the
    fault being reported. Returns the paths written."""
    d = flight_dir()
    if not d:
        return []
    paths: List[str] = []
    for rec in list(_RECORDERS):
        name = f"flight_{reason}_{os.getpid()}_{id(rec) & 0xffff:04x}.json"
        path = os.path.join(d, name)
        try:
            rec.dump(path, reason=reason)
            paths.append(path)
        except Exception:
            # never-raises contract: a failed dump (disk, or a span arg
            # json.dump rejects) must not mask the crash/drain being
            # reported — drain() calls this with state already released
            pass
    return paths


class FlightRecorder:
    """Bounded ring of (name, t0, t1, step, args) spans.

    Two recording styles share the ring:

      * :meth:`phase` — watchdog-style transitions: starting phase B
        closes the open phase A span; ``phase("idle")`` closes without
        opening (the serve loop's step_end). This is the hot path — the
        engine calls it at its existing plan/dispatch/commit brackets.
      * :meth:`span` / :meth:`record` — explicit bracketed spans for
        long operations (drain, replay, checkpoint save).
    """

    def __init__(self, capacity: Optional[int] = None):
        cap = flight_capacity() if capacity is None else int(capacity)
        self.capacity = max(1, cap)
        self._ring: deque = deque(maxlen=self.capacity)
        self._open: Optional[Tuple[str, float, Optional[int]]] = None
        self._lock = threading.Lock()
        #: spans silently evicted by ring wrap — monotone; surfaced as
        #: the ``flight_spans_dropped`` registry counter and in every
        #: dump header, so a trace that only shows the last N spans
        #: SAYS how much history it lost
        self.dropped = 0
        # wall-clock anchor: perf_counter t=anchor_perf corresponds to
        # wall time anchor_wall (cross-replica correlation)
        self.anchor_perf = time.perf_counter()
        self.anchor_wall = time.time()

    # --------------------------- recording ---------------------------- #

    def phase(self, name, step=None):
        """Transition to ``name`` (closing any open span); "idle" only
        closes. A hot path — lock + tuple append."""
        now = time.perf_counter()
        with self._lock:
            if self._open is not None:
                n0, t0, s0 = self._open
                if len(self._ring) == self.capacity:
                    self.dropped += 1
                self._ring.append((n0, t0, now, s0, None))
            self._open = None if name == "idle" else (name, now, step)

    def record(self, name, t0, t1, step=None, args=None):
        """Append a completed span. A hot path."""
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append((name, t0, t1, step, args))

    def event(self, name, step=None, duration=0.0, **args):
        """Instant (or ``duration``-long, ending now) span — the
        request-lifecycle marks (admit/first-token/finish) the serve
        observer tags with ``uid`` so one request's life reads off a
        single dump. A hot path."""
        t1 = time.perf_counter()
        self.record(name, t1 - duration, t1, step=step,
                    args=args or None)

    @contextmanager
    def span(self, name: str, step: Optional[int] = None, **args):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.record(name, t0, time.perf_counter(), step=step,
                        args=args or None)

    # ---------------------------- reading ----------------------------- #

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def spans(self) -> List[Tuple]:
        """Snapshot copy of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def to_chrome_trace(self, reason: Optional[str] = None
                        ) -> Dict[str, Any]:
        """Chrome-trace JSON ("Trace Event Format"): complete ("X")
        events in µs relative to the oldest span, one pid per process.
        Loadable directly in chrome://tracing or Perfetto."""
        spans = self.spans
        base = spans[0][1] if spans else self.anchor_perf
        events = []
        for name, t0, t1, step, args in spans:
            ev: Dict[str, Any] = {
                "name": name,
                "ph": "X",
                "ts": round((t0 - base) * 1e6, 1),
                "dur": round((t1 - t0) * 1e6, 1),
                "pid": os.getpid(),
                # uid-tagged request spans land on a per-request track
                # (tid = uid + 1; track 0 stays the engine phase lane)
                # so one request's admit->...->finish life reads as one
                # row in chrome://tracing / Perfetto
                "tid": int(args["uid"]) + 1
                if args and "uid" in args else 0,
            }
            a = dict(args) if args else {}
            if step is not None:
                a["step"] = step
            if a:
                ev["args"] = a
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "source": "dstpu.flight_recorder",
                "reason": reason,
                "capacity": self.capacity,
                "spans_dropped": self.dropped,
                "wall_time_base": self.anchor_wall
                + (base - self.anchor_perf),
            },
        }

    def dump(self, path: str, reason: Optional[str] = None) -> None:
        """Atomic Chrome-trace publish (tmp + rename)."""
        atomic_json_dump(path, self.to_chrome_trace(reason=reason))


def atomic_json_dump(path: str, obj: Any) -> None:
    """The one copy of the atomic JSON publish (makedirs + tmp.{pid} +
    rename) the trace/snapshot writers share — a reader never sees a
    torn file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


# ---------------------------------------------------------------------- #
# fleet trace merge (docs/observability.md "Distributed tracing")
# ---------------------------------------------------------------------- #


def merge_chrome_traces(dumps: List[Dict[str, Any]],
                        sources: List[str]) -> Dict[str, Any]:
    """Merge N replicas' Chrome-trace flight dumps into ONE fleet
    timeline, on one clock and with collision-free tracks.

    * **Clock alignment**: each dump's timestamps are µs relative to its
      own oldest span; its ``otherData.wall_time_base`` anchors that
      origin on the wall clock. The merge rebases every event onto the
      earliest dump's origin, so spans from different replicas land in
      true fleet order.
    * **Track namespacing** (the tid-collision fix): a single dump gives
      each uid the track ``tid = uid + 1`` — concatenating dumps would
      therefore fold DIFFERENT requests that happen to share a uid
      number on two replicas onto one track. Here every uid track is
      keyed by ``(source, uid)`` instead, and every engine phase lane by
      its source, each getting a fresh merged tid plus a ``thread_name``
      metadata row naming it.
    * **Trace-context stitching**: spans carrying a ``trace`` arg (the
      fleet trace context minted at ``ReplicaPool.put``) key their track
      on the TRACE ID alone — so one request's spans from the router,
      the replica that first served it, and the survivor that replayed
      it after a drain all land on ONE gapless track, while untraced
      same-uid requests stay apart.

    ``sources`` names each dump (replica ids / file basenames); a short
    list is refused rather than silently mislabelling."""
    if len(sources) != len(dumps):
        raise ValueError(
            f"{len(sources)} sources for {len(dumps)} dumps — every "
            f"dump needs its replica id (tracks are namespaced by it)")
    bases = []
    for d, src in zip(dumps, sources):
        base = d.get("otherData", {}).get("wall_time_base")
        if base is None:
            # a foreign/hand-trimmed trace without the anchor would
            # default to wall 0 and shift every REAL dump by ~50 years
            # of microseconds — refuse instead of silently producing a
            # garbage timeline
            raise ValueError(
                f"dump {src!r} has no otherData.wall_time_base — not a "
                f"FlightRecorder dump; merge needs the wall anchor to "
                f"align clocks")
        bases.append(float(base))
    base0 = min(bases) if bases else 0.0
    tids: Dict[Tuple, int] = {}
    names: Dict[int, str] = {}
    # engine phase lanes first, in source order, so lane k is replica k
    for i, src in enumerate(sources):
        tids[("engine", src)] = i
        names[i] = f"engine {src}"

    def tid_of(key: Tuple, label: str) -> int:
        t = tids.get(key)
        if t is None:
            t = len(tids)
            tids[key] = t
            names[t] = label
        return t

    events: List[Dict[str, Any]] = []
    dropped = 0
    for dump, src, wtb in zip(dumps, sources, bases):
        off_us = (wtb - base0) * 1e6
        dropped += int(dump.get("otherData", {}).get("spans_dropped", 0))
        for ev in dump.get("traceEvents", []):
            if ev.get("ph") == "M":
                continue                      # re-derived below
            args = ev.get("args") or {}
            trace = args.get("trace")
            uid = args.get("uid")
            if trace is not None:
                t = tid_of(("trace", trace), f"req {trace}")
            elif uid is not None:
                t = tid_of(("uid", src, uid), f"req {src}/uid{uid}")
            elif ev.get("tid", 0) == 0:
                t = tids[("engine", src)]
            else:
                t = tid_of(("t", src, ev["tid"]),
                           f"{src} t{ev['tid']}")
            out = dict(ev)
            out["pid"] = 0
            out["tid"] = t
            out["ts"] = round(ev.get("ts", 0.0) + off_us, 1)
            a = dict(args)
            a["source"] = src
            out["args"] = a
            events.append(out)
    events.sort(key=lambda e: (e["ts"], e["tid"]))
    meta = [{"ph": "M", "pid": 0, "tid": t, "name": "thread_name",
             "args": {"name": names[t]}} for t in sorted(names)]
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "dstpu.flight_recorder/merge",
            "sources": list(sources),
            "spans_dropped": dropped,
            "wall_time_base": base0,
        },
    }


def request_tracks(merged: Dict[str, Any]
                   ) -> Dict[str, List[Dict[str, Any]]]:
    """{track name: [events, ts-ordered]} for every request track of a
    merged trace (``req ...`` thread names) — what the fleet tests and
    the ``dstpu_top --merge-trace`` summary walk to assert a drained
    request reconstructs gapless end-to-end."""
    names: Dict[int, str] = {}
    for ev in merged.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev["args"]["name"]
    out: Dict[str, List[Dict[str, Any]]] = {}
    for ev in merged.get("traceEvents", []):
        if ev.get("ph") == "M":
            continue
        name = names.get(ev.get("tid"))
        if name is not None and name.startswith("req "):
            out.setdefault(name, []).append(ev)
    for evs in out.values():
        evs.sort(key=lambda e: e["ts"])
    return out
