"""Knee-seeking admission control + brownout degradation ladder.

Port of ``deepspeed_tpu/serving/admission.py``, host code that the port keeps its
own copy of (it imports nothing of the JAX package).

The measurement half of the stack (windowed series rates, queue-wait /
TTFT histograms, the goodput ledger) exists so something can ACT on it.
This module is that actor: an :class:`AdmissionController` that holds
offered load at the capacity knee — shedding at the door *before* SLOs
blow — and degrades quality-of-service in ordered, hysteresis-gated
brownout levels instead of collapsing past the knee the way
``serve_capacity`` shows the uncontrolled engine does.

Three cooperating pieces:

  * **Knee-seeking door (AIMD).** The controller owns an admission
    window ``W`` — the ``max_live``-style concurrency bound the
    open-loop driver already understands. Evidence is ONLY existing
    registry state: the windowed ``rate()`` of admitted/completed
    requests and tokens, plus a *windowed* queue-wait p99 recovered
    from the cumulative streaming histograms by bucket-delta snapshots
    (:class:`_WindowQuantile` — two same-gamma DDSketches subtract
    exactly, so the delta sketch IS the last window's distribution).
    While the windowed queue-wait p99 exceeds the SLO the window
    multiplicatively decreases (``md``); after ``hysteresis_s`` of
    continuous health it additively recovers (``ai``) back toward the
    slot capacity. Offers beyond ``W`` are rejected AT THE DOOR with a
    TYPED rejection record (reason ``admission_overload``) carrying a
    computed ``retry_after_s`` hint — never queued into a collapse.
  * **Brownout ladder.** Ordered pressure levels, each trading a little
    quality for stability, entered at most one rung per control tick
    and exited one rung per ``hysteresis_s`` of continuous health (the
    no-flap discipline):

      ====  ==============  ==============================================
      L0    ``normal``      nothing actuated
      L1    ``defer_promote``  hierarchical-KV promote-ahead head start
                              stretched (``StateManager.promote_defer_
                              ticks``) — token-stream-invariant
      L2    ``spec_brownout``  speculative decoding bypassed and
                              ``spec_k`` shrunk — spec decode is
                              token-identical to greedy, so toggling it
                              preserves parity while freeing verify
                              FLOPs for committed tokens
      L3    ``throughput_cap`` decode burst depth capped (driver-side)
                              and the prefill chunk cap SHRUNK
                              (compile-safe: the scheduler already
                              emits every chunk length below
                              ``chunk_size``)
      L4    ``shed_lowclass``  lowest-class traffic (``Request.klass >
                              0``, e.g. batch) shed at the door first,
                              preserving interactive goodput
      ====  ==============  ==============================================

    Every transition is a flight-recorder event plus a catalogued
    ``brownout_transitions`` counter, and the current level/window ride
    the ``admission_level`` / ``admission_window`` gauges — so
    ``dstpu_top`` shows which level the fleet is in and why.
  * **Retry contract.** Door rejections carry ``retry_after_s`` ≈
    ``tick_s · 2^level · overload_ratio`` (capped at ``retry_cap_s``).
    The loadgen client honors it with jittered exponential backoff
    under a bounded retry budget; retries keep their ORIGINAL arrival
    identity so goodput accounting stays honest (docs/serving.md
    "Overload control" has the full contract).

Fleet integration: against a :class:`~.pool.ReplicaPool` the controller
reads every live replica's registry, feeds the router a per-replica
``admission_headroom`` term and makes browned-out replicas advertise
reduced slots (``Replica.slot_frac`` scales ``queue_frac``'s
denominator, so the router's full-replica gate trips earlier).

``DSTPU_ADMISSION=0`` (or telemetry off — the controller is blind
without registry evidence) disables everything: :func:`build_admission`
returns None, no actuation attribute is ever written, and the serving
path is bit-identical to pre-controller behavior (tier-1 asserts token
parity and zero fresh compiles either way).

The driver-facing hooks (:meth:`AdmissionController.poll`,
:meth:`~AdmissionController.door`, :meth:`~AdmissionController.reject`)
are hot paths: they run on the admission path between
the engines' overlapped pipelines and must stay pure host arithmetic —
one device sync there would serialize the very pipeline the controller
exists to protect.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry.registry import (Histogram, MetricsRegistry,
                                  new_registry, telemetry_enabled)

#: ladder level -> name (docs/serving.md "Overload control")
BROWNOUT_LEVELS = ("normal", "defer_promote", "spec_brownout",
                   "throughput_cap", "shed_lowclass")

#: overload-ratio thresholds: level L is warranted while the windowed
#: queue-wait p99 exceeds threshold[L] x the SLO (entered one rung per
#: tick, exited one rung per hysteresis window — never instantly)
_LEVEL_RATIOS = (0.0, 1.0, 1.5, 2.0, 3.0)


def admission_enabled() -> bool:
    """The controller kill switch: ``DSTPU_ADMISSION=0`` (or
    ``false``/``off``) disables admission control entirely — the exact
    pre-controller serving path."""
    return os.environ.get("DSTPU_ADMISSION", "1") \
        not in ("0", "false", "off")


def build_admission(target, **kwargs) -> Optional["AdmissionController"]:
    """The serving layer's attach point: an :class:`AdmissionController`
    over ``target`` (an ``InferenceEngineV2`` or a ``ReplicaPool``), or
    None when ``DSTPU_ADMISSION=0`` **or** telemetry is off — the
    controller consumes only registry evidence, so without a registry
    it would be flying blind; None keeps the path bit-identical to the
    uncontrolled engine."""
    if not admission_enabled() or not telemetry_enabled():
        return None
    return AdmissionController(target, **kwargs)


class _WindowQuantile:
    """Windowed quantiles over a CUMULATIVE streaming histogram.

    The registry's histograms only ever grow, so their p99 never
    recovers after a spike — useless as a control signal. This helper
    keeps a rotating bucket snapshot of the source sketch and answers
    quantiles over the *delta* since that snapshot: two same-gamma
    DDSketches hold integer counts on one bucket lattice, so the
    bucket-wise difference is EXACTLY the sketch a stream of only the
    window's observations would have built. The snapshot rotates every
    ``window_s``, so the delta always covers between 1x and 2x the
    window — recent enough to steer on, wide enough to hold a p99.

    Pure host arithmetic over dict copies; no registry mutation.
    """

    __slots__ = ("window_s", "_t_snap", "_buckets", "_zero", "_count",
                 "_sum")

    def __init__(self, window_s: float):
        self.window_s = float(window_s)
        self._t_snap = 0.0
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self._count = 0
        self._sum = 0.0

    def observe(self, src: Histogram, q: float,
                now: float) -> Optional[float]:
        """Quantile ``q`` of ``src``'s observations since the previous
        snapshot (None when the window saw nothing), rotating the
        snapshot when ``window_s`` has elapsed."""
        buckets = getattr(src, "buckets", None)
        if buckets is None:          # NullRegistry handle: no evidence
            return None
        dcount = src.count - self._count
        val: Optional[float] = None
        if dcount > 0:
            delta = Histogram(alpha=src.alpha)
            db = {i: n - self._buckets.get(i, 0)
                  for i, n in buckets.items()
                  if n - self._buckets.get(i, 0) > 0}
            delta.buckets = db
            delta.zero = max(0, src.zero - self._zero)
            delta.count = dcount
            delta.sum = src.sum - self._sum
            # min/max are not windowable on a cumulative sketch; the
            # source's envelope is the conservative clamp (quantile()
            # only uses them to bound the bucket-midpoint estimate)
            delta.min = src.min
            delta.max = src.max
            val = delta.quantile(q)
        if now - self._t_snap >= self.window_s:
            self._t_snap = now
            self._buckets = dict(buckets)
            self._zero = src.zero
            self._count = src.count
            self._sum = src.sum
        return val


class AdmissionController:
    """Knee-seeking admission window + brownout ladder over one engine
    or a replica pool (module docstring has the control law).

    Built through :func:`build_admission`; all knobs are env-mirrored
    with LITERAL names:

      * ``DSTPU_ADMISSION``               on/off kill switch (default 1)
      * ``DSTPU_ADMISSION_WINDOW_S``      evidence window (default 2.0 s)
      * ``DSTPU_ADMISSION_QW_SLO_S``      queue-wait p99 SLO (default 0.5 s)
      * ``DSTPU_ADMISSION_TICK_S``        control-loop period (default 0.25 s)
      * ``DSTPU_ADMISSION_MIN_LIVE``      window floor (default 1)
      * ``DSTPU_ADMISSION_AI``            additive increase (default 1)
      * ``DSTPU_ADMISSION_MD``            multiplicative decrease (default 0.7)
      * ``DSTPU_ADMISSION_HYSTERESIS_S``  health dwell before recovery
        (default 2.0 s)
      * ``DSTPU_ADMISSION_RETRY_CAP_S``   retry-hint ceiling (default 5.0 s)
    """

    def __init__(self, target,
                 window_s: Optional[float] = None,
                 qw_slo_s: Optional[float] = None,
                 tick_s: Optional[float] = None,
                 min_live: Optional[int] = None,
                 ai: Optional[int] = None,
                 md: Optional[float] = None,
                 hysteresis_s: Optional[float] = None,
                 retry_cap_s: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None):
        def _env(name: str, default: str) -> str:
            return os.environ.get(name, default) or default

        self.target = target
        self._is_pool = hasattr(target, "replicas")
        self.window_s = float(_env("DSTPU_ADMISSION_WINDOW_S", "2.0")) \
            if window_s is None else float(window_s)
        self.qw_slo_s = float(_env("DSTPU_ADMISSION_QW_SLO_S", "0.5")) \
            if qw_slo_s is None else float(qw_slo_s)
        self.tick_s = float(_env("DSTPU_ADMISSION_TICK_S", "0.25")) \
            if tick_s is None else float(tick_s)
        self.min_live = max(1, int(
            _env("DSTPU_ADMISSION_MIN_LIVE", "1"))
            if min_live is None else int(min_live))
        self.ai = max(1, int(_env("DSTPU_ADMISSION_AI", "1"))
                      if ai is None else int(ai))
        self.md = float(_env("DSTPU_ADMISSION_MD", "0.7")) \
            if md is None else float(md)
        if not 0.0 < self.md < 1.0:
            raise ValueError(
                f"admission md must be in (0, 1), got {self.md}")
        self.hysteresis_s = float(
            _env("DSTPU_ADMISSION_HYSTERESIS_S", "2.0")) \
            if hysteresis_s is None else float(hysteresis_s)
        self.retry_cap_s = float(
            _env("DSTPU_ADMISSION_RETRY_CAP_S", "5.0")) \
            if retry_cap_s is None else float(retry_cap_s)
        #: stderr trace of every control tick (evidence, window,
        #: level) — the first thing to turn on when a controller
        #: misbehaves in a drill or in production
        self._debug = _env("DSTPU_ADMISSION_DEBUG", "0").lower() \
            not in ("0", "false", "off", "")
        #: slot capacity = the fleet's max_seqs sum — the window's
        #: ceiling and the AIMD recovery target
        self.cap = max(self.min_live, sum(
            eng.config.max_seqs for _, eng, _ in self._engines()) or 1)
        self.window = self.cap
        self.level = 0
        self.transitions = 0
        self.rejected = 0
        self.last_ratio = 0.0
        self.last_qw_p99: Optional[float] = None
        #: driver-side decode-burst ceiling (L3); harmlessly huge at L0
        self.decode_burst_cap = 1 << 30
        self._last_tick = 0.0
        self._last_bad = 0.0
        # -inf: the FIRST bad evidence window always cuts, regardless
        # of where the caller's clock starts
        self._last_cut = float("-inf")
        self._last_exit = 0.0
        self._wq: Dict[str, _WindowQuantile] = {}
        #: per-engine actuation baselines, captured lazily BEFORE the
        #: first brownout write so exits restore the exact prior state
        self._base: Dict[int, Dict[str, Any]] = {}
        if registry is not None:
            self.registry = registry
        else:
            regs = [eng.metrics for _, eng, _ in self._engines()
                    if eng.metrics is not None]
            self.registry = regs[0] if regs \
                else new_registry("admission")
        r = self.registry
        self.g_window = r.gauge("admission_window")
        self.g_level = r.gauge("admission_level")
        self.c_rejected = r.counter("admission_rejected")
        self.h_retry = r.histogram("admission_retry_after_s")
        self._c_trans = {d: r.counter("brownout_transitions",
                                      direction=d)
                         for d in ("enter", "exit")}
        # pool-level door rejections never reach an engine observer, so
        # the controller owns their outcome counter; engine-level ones
        # ride engine._reject -> ServeObserver.on_reject as usual
        self._count_rejects = self._is_pool
        self.g_window.set(self.window)
        self.g_level.set(0)

    # ------------------------------------------------------------------ #
    # evidence plumbing
    # ------------------------------------------------------------------ #

    def _engines(self) -> List[Tuple[str, Any, Any]]:
        """Live (id, engine, replica-or-None) actuation targets —
        re-enumerated per use so joiners/drains are picked up."""
        if self._is_pool:
            return [(rep.replica_id, rep.engine, rep)
                    for rep in self.target.replicas()
                    if rep.state != "dead"]
        return [("engine", self.target, None)]

    def _flight(self):
        fl = getattr(self.target, "flight", None)
        return fl

    # ------------------------------------------------------------------ #
    # the control loop
    # ------------------------------------------------------------------ #

    def poll(self, now: Optional[float] = None) -> None:
        """Run one control tick iff ``tick_s`` elapsed — the driver
        calls this from every admission poll. A hot path:
        one time read and a compare in the common case."""
        now = time.monotonic() if now is None else now
        if now - self._last_tick >= self.tick_s:
            self.tick(now)

    def tick(self, now: Optional[float] = None) -> None:
        """One control-law step: gather windowed evidence, move the
        AIMD window, move the brownout ladder (≤ one rung), actuate.
        Pure host arithmetic over registry state — tests drive it with
        an explicit ``now`` against synthetic series."""
        now = time.monotonic() if now is None else now
        self._last_tick = now
        worst: Optional[float] = None
        for rid, eng, rep in self._engines():
            m = eng.metrics
            if m is None or not m.enabled:
                continue
            # keep the sampled series fresh even when the engine is too
            # stalled to reach its own commit-boundary sampling — the
            # overloaded case is exactly when evidence matters most
            m.maybe_sample()
            wq = self._wq.get(rid)
            if wq is None:
                wq = self._wq[rid] = _WindowQuantile(self.window_s)
            p99 = wq.observe(m.histogram("serve_queue_wait_s"), 0.99,
                             now)
            if p99 is not None and (worst is None or p99 > worst):
                worst = p99
            if rep is not None:
                rep.admission_headroom = None if p99 is None else \
                    max(-1.0, 1.0 - p99 / self.qw_slo_s)
        self.last_qw_p99 = worst
        ratio = 0.0 if worst is None else worst / self.qw_slo_s
        self.last_ratio = ratio
        # one multiplicative cut per EVIDENCE window, not per tick: the
        # windowed p99 only refreshes when its snapshot rotates (every
        # window_s), so cutting every tick would punish a single bad
        # burst window_s/tick_s times over (TCP cuts once per RTT for
        # the same reason)
        fresh_bad = ratio > 1.0 and now - self._last_cut >= self.window_s
        if ratio > 1.0:
            self._last_bad = now
            if fresh_bad:
                # overloaded: multiplicative decrease; recovery then
                # needs hysteresis_s of CONTINUOUS health
                self._last_cut = now
                self.window = max(self.min_live,
                                  int(self.window * self.md))
        elif self.window < self.cap \
                and now - self._last_bad >= self.hysteresis_s:
            self.window = min(self.cap, self.window + self.ai)
        # ladder: warranted level from the overload ratio; rise one
        # rung per evidence window, fall one rung per hysteresis window
        # of health (its OWN dwell clock, so rung exits do not stall
        # the window's additive recovery)
        want = 0
        for lvl in range(len(BROWNOUT_LEVELS) - 1, 0, -1):
            if ratio > _LEVEL_RATIOS[lvl]:
                want = lvl
                break
        new = self.level
        if want > self.level and fresh_bad:
            new = self.level + 1
        elif want < self.level \
                and now - self._last_bad >= self.hysteresis_s \
                and now - self._last_exit >= self.hysteresis_s:
            new = self.level - 1
            self._last_exit = now
        if new != self.level:
            self._transition(self.level, new, ratio)
        self._apply(new)
        self.level = new
        self.g_window.set(self.window)
        self.g_level.set(self.level)
        if self._debug:
            import sys
            p = "-" if worst is None else f"{worst * 1e3:.1f}ms"
            print(f"[admission] t={now:.3f} qw_p99={p} "
                  f"ratio={ratio:.2f} window={self.window} "
                  f"level={BROWNOUT_LEVELS[self.level]}",
                  file=sys.stderr)

    def prime(self, now: Optional[float] = None) -> None:
        """Rotate the windowed-evidence snapshots past ALL prior
        registry history and reset the control state. The histograms
        are cumulative, so a controller attached to an engine that has
        already served traffic would spend its first window steering on
        stale evidence — the overload drill calls this between its
        controller-off and controller-on passes."""
        now = time.monotonic() if now is None else now
        for rid, eng, _rep in self._engines():
            m = eng.metrics
            if m is None or not m.enabled:
                continue
            wq = self._wq.get(rid)
            if wq is None:
                wq = self._wq[rid] = _WindowQuantile(self.window_s)
            src = m.histogram("serve_queue_wait_s")
            buckets = getattr(src, "buckets", None)
            if buckets is not None:
                wq._t_snap = now
                wq._buckets = dict(buckets)
                wq._zero = src.zero
                wq._count = src.count
                wq._sum = src.sum
        if self.level:
            self._apply(0)
        self.level = 0
        self.window = self.cap
        self.transitions = 0
        self.last_ratio = 0.0
        self.last_qw_p99 = None
        self._last_bad = 0.0
        self._last_cut = float("-inf")
        self._last_exit = 0.0
        self._last_tick = 0.0
        self.g_window.set(self.window)
        self.g_level.set(0)

    def apply_level(self, level: int) -> None:
        """Force the ladder actuation for ``level`` without waiting for
        evidence (idempotent; baselines are captured on first use, so a
        later ``apply_level(0)`` restores the exact prior config).

        Intended for PRE-WARMING: the degraded modes change program
        shapes (spec decode off, prefill chunk halved), so the first
        real brownout would otherwise pay a fresh XLA compile on the
        step path — at the exact moment the engine is overloaded, and
        the resulting stall feeds back into the controller's own
        queue-wait evidence. Deploy-time warmup runs a few requests at
        the deepest compiled level and restores normal before serving.
        """
        self._apply(int(level))
        self.level = int(level)
        self.g_level.set(self.level)

    def _transition(self, old: int, new: int, ratio: float) -> None:
        """Record one ladder move: catalogued counter + flight event
        (the ``dstpu_top`` / postmortem evidence of WHY)."""
        self.transitions += 1
        direction = "enter" if new > old else "exit"
        self._c_trans[direction].inc()
        fl = self._flight()
        if fl is not None:
            fl.event("admission_level", level=new,
                     level_name=BROWNOUT_LEVELS[new],
                     prev=BROWNOUT_LEVELS[old],
                     ratio=round(ratio, 3), window=self.window)

    def _apply(self, level: int) -> None:
        """Actuate the ladder idempotently: every knob is derived from
        its lazily-captured baseline, so repeated application is a
        no-op and exit restores the exact prior state. All writes are
        host attributes the engines re-read per plan/decode call —
        SHRINK-only where compiled shapes are concerned (the scheduler
        already emits every chunk length the shrunken cap produces), so
        no brownout level can trigger a fresh compile.

        Phase-specialist fleets (docs/serving.md "Disaggregated
        serving") actuate per ROLE: decode-side knobs (L2 spec
        brownout, the L3 decode-burst cap) are meaningless on a replica
        that never decodes, and the L3 prefill-chunk halving is
        meaningless on one that never prefills — skipping them keeps a
        specialist's baseline config untouched (and its compiled shapes
        warm) while the knobs that DO apply still bite. ``mixed``
        replicas (the default, and every replica under
        ``DSTPU_DISAGG=0``) actuate everything, exactly as before."""
        for _, eng, rep in self._engines():
            role = getattr(rep, "role", "mixed") if rep is not None \
                else "mixed"
            base = self._base.get(id(eng))
            if base is None:
                base = self._base[id(eng)] = {
                    "promote_defer_ticks": getattr(
                        eng.state, "promote_defer_ticks", 1),
                    "spec_mode": eng.spec_mode,
                    "spec_k": eng.spec_k,
                    "prefill_chunk_cap": eng.config.prefill_chunk_cap,
                }
            # L1: stretch the hierarchical-KV promote-ahead head start —
            # promotions yield more scheduler ticks to decode chunks
            # (token-stream-invariant: only WHEN a prefill chunk runs)
            eng.state.promote_defer_ticks = 4 if level >= 1 \
                else base["promote_defer_ticks"]
            # L2: bypass speculation (spec is token-identical to greedy,
            # so parity holds) and shrink the draft depth for when it
            # comes back partway through recovery. Prefill specialists
            # never run verify rounds — leave their spec config alone
            if level >= 2 and role != "prefill":
                eng.spec_mode = "off"
                eng.spec_k = max(1, min(base["spec_k"], 2))
            else:
                eng.spec_mode = base["spec_mode"]
                eng.spec_k = base["spec_k"]
            # L3: halve the prefill chunk depth (decode latency wins
            # over prefill throughput under pressure); shrink-only.
            # Decode specialists run no prefill chunks — and on a
            # PREFILL specialist there is no colocated decode to
            # protect, so halving would only cut its throughput
            if level >= 3 and role == "mixed":
                cs = eng.config.chunk_size
                cap = base["prefill_chunk_cap"] or cs
                eng.config.prefill_chunk_cap = max(1, min(cap, cs) // 2)
            else:
                eng.config.prefill_chunk_cap = base["prefill_chunk_cap"]
            if rep is not None:
                # browned-out replicas advertise reduced slots: the
                # router's queue_frac denominator shrinks, so its
                # full-replica gate trips earlier fleet-wide
                rep.slot_frac = max(0.25, self.window / self.cap) \
                    if level >= 1 else 1.0
        self.decode_burst_cap = 2 if level >= 3 else (1 << 30)

    # ------------------------------------------------------------------ #
    # the door (driver-facing, hot path)
    # ------------------------------------------------------------------ #

    def door(self, live: int, klass: int = 0) -> bool:
        """Admit or refuse one offer given ``live`` in-flight requests:
        True = admit. A hot path — two compares."""
        if self.level >= 4 and klass > 0:
            return False
        return live < self.window

    def retry_after_s(self) -> float:
        """The retry hint a door rejection carries: backs off with the
        ladder level and the measured overload ratio, capped. At level
        0 a rejection only means the window was momentarily full, so
        the hint stays one tick — burning a large slice of a tight
        deadline on the first backoff wastes goodput the engine could
        have delivered."""
        return min(self.retry_cap_s,
                   self.tick_s * (2.0 ** self.level)
                   * max(1.0, self.last_ratio))

    def reject(self, uid: int, klass: int = 0) -> Dict[str, Any]:
        """Record one typed door rejection on the target (the same
        ``rejections`` record shape every other refusal uses, so
        report breakdowns unify) and return the record. A
        hot path — dict stores and pre-bound counter adds."""
        hint = self.retry_after_s()
        self.rejected += 1
        self.c_rejected.inc()
        self.h_retry.observe(hint)
        if self._count_rejects:
            # pool-level records bypass every engine observer; the
            # controller owns their outcome counter (single engines
            # count through engine._reject -> on_reject as usual)
            self.registry.counter(
                "serve_requests_rejected_admission").inc()
        self.target._reject(uid, "admission_overload",
                            retry_after_s=round(hint, 4),
                            level=self.level, window=self.window,
                            klass=klass)
        return self.target.rejections[uid]

    # ------------------------------------------------------------------ #

    def state(self) -> Dict[str, Any]:
        """Structured controller state for reports and drills."""
        return {
            "window": self.window,
            "cap": self.cap,
            "level": self.level,
            "level_name": BROWNOUT_LEVELS[self.level],
            "transitions": self.transitions,
            "rejected": self.rejected,
            "last_overload_ratio": round(self.last_ratio, 4),
            "last_qw_p99_s": round(self.last_qw_p99, 6)
            if self.last_qw_p99 is not None else None,
            "qw_slo_s": self.qw_slo_s,
            "knobs": {
                "window_s": self.window_s, "tick_s": self.tick_s,
                "min_live": self.min_live, "ai": self.ai,
                "md": self.md, "hysteresis_s": self.hysteresis_s,
                "retry_cap_s": self.retry_cap_s,
            },
        }
