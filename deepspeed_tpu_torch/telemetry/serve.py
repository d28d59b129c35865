"""Serve-side telemetry observer — per-request SLO instrumentation.

Port of ``deepspeed_tpu/telemetry/serve.py``, host code that the port keeps its
own copy of (it imports nothing of the JAX package).

One object the v2 ragged engine owns (``engine._obs``; None when
``DSTPU_TELEMETRY=0`` so every call site is a single ``is not None``
guard): it binds the hot metric handles once at engine build and turns
the engine's EXISTING host-side boundaries into SLO numbers —

  * admission (``put``)          -> ``serve_requests_admitted`` +
    ``seq.admitted_at`` stamp;
  * first schedule (plan)        -> ``serve_queue_wait_s``;
  * token commit (commit/fused)  -> ``serve_ttft_s`` on the first
    committed token, ``serve_tpot_s`` on every later one,
    ``serve_tokens_committed``;
  * rejection / abort / flush    -> the outcome counters goodput is
    computed from;
  * plan/dispatch/commit phases  -> flight-recorder spans (the same
    phase names the watchdog brackets carry).

Everything is pure host work (floats, dict lookups on pre-bound
handles) on paths that already run at those boundaries — no device
access; the engine's launches are the same with telemetry on or off.
The ``device_execute`` component is the wait at the engine's blocking
readback (``InferenceEngineV2._readback``): where the card's work shows
up as exposed host time. While a ``torch.profiler`` runs, each flight
phase is also a named profiler range (:meth:`ServeObserver.phase`), so a
Chrome trace shows every kernel launch under the phase that enqueued
it. The
per-request timestamps additionally live on the SequenceDescriptor
(``admitted_at``/``first_sched_at``/``first_token_at``/
``last_token_at``), so TTFT >= queue-wait is checkable per request, not
just in aggregate.

Export: every ``DSTPU_TELEMETRY_EXPORT_EVERY`` committed steps the
registry snapshot is atomically published to ``DSTPU_TELEMETRY_EXPORT``
(the file ``bin/dstpu_top`` renders) and attached monitor bridges tick.
"""

from __future__ import annotations

import os
import time
import weakref
from typing import Any, Dict, Optional

import torch

from .flight_recorder import FlightRecorder, auto_dump, register_recorder
from .registry import MetricsRegistry, new_registry, telemetry_enabled

#: True while a torch profiler records (the phases then open ranges)
_profiling = torch.autograd._profiler_enabled

#: rejection reason (engine._reject) -> outcome counter name
_REJECT_COUNTERS = {
    "kv_pool_exhausted": "serve_requests_shed",
    "deadline_exceeded": "serve_requests_deadline_expired",
    "draining": "serve_requests_rejected_draining",
    "admission_overload": "serve_requests_rejected_admission",
}


def serve_observer(engine) -> Optional["ServeObserver"]:
    """The engine's telemetry attach point: a ServeObserver, or None
    when DSTPU_TELEMETRY=0 (the zero-overhead path — the engine then
    never calls into this module again)."""
    if not telemetry_enabled():
        return None
    return ServeObserver(engine)


class ServeObserver:
    def __init__(self, engine):
        # weak: the engine owns its observer, and a cycle would keep the
        # engine's device memory alive until a garbage collection
        self._engine = weakref.ref(engine)
        self.registry: MetricsRegistry = new_registry("serve")
        self.flight = FlightRecorder()
        register_recorder(self.flight)
        # env knobs read with LITERAL names
        self.export_path = os.environ.get("DSTPU_TELEMETRY_EXPORT") or None
        self.export_every = int(
            os.environ.get("DSTPU_TELEMETRY_EXPORT_EVERY", "50") or "50")
        # request-scoped flight spans: uid-tagged admit/queue/prefill/
        # first-token/decode/finish marks so ONE request's life is
        # reconstructable from a single Chrome-trace dump (each request
        # renders as its own track). A handful of ring entries per
        # request; DSTPU_FLIGHT_REQUESTS=0 keeps the ring phases-only.
        self.req_spans = os.environ.get("DSTPU_FLIGHT_REQUESTS", "1") \
            not in ("0", "false", "off")
        # step-time attribution (telemetry/attribution.py,
        # docs/observability.md "Step-time attribution"): when armed, the
        # observer closes the books on every committed step — wall clock
        # since the previous commit boundary, minus the bracketed
        # plan/dispatch/readback/apply components, is the HOST GAP. All
        # pure perf_counter arithmetic at the same host-side boundaries
        # the SLO metrics already own; DSTPU_ATTRIB=0 restores the exact
        # pre-attribution record path (the bench's parity control).
        self.attrib = os.environ.get("DSTPU_ATTRIB", "1") \
            not in ("0", "false", "off")
        self._in_loop = False
        self._anchor = 0.0
        self._acc = 0.0
        self._attrib_prev: Dict[str, float] = {}
        self._last_export_step = 0
        self._prefix_prev: Dict[str, float] = {}
        self._flight_dropped_prev = 0
        #: the open profiler range of the current phase (profiling only)
        self._range = None
        r = self.registry
        # hot handles bound once — the record paths below are pre-bound
        # attribute ops, no registry lookups per token
        self.c_admitted = r.counter("serve_requests_admitted")
        self.c_completed = r.counter("serve_requests_completed")
        self.c_aborted = r.counter("serve_requests_aborted")
        self.c_drained = r.counter("serve_requests_drained")
        self.c_tokens = r.counter("serve_tokens_committed")
        self.c_steps = r.counter("serve_steps")
        self.c_fed = r.counter("serve_steps_device_fed")
        self.c_retries = r.counter("serve_step_retries")
        self.c_spec_proposed = r.counter("spec_proposed")
        self.c_spec_accepted = r.counter("spec_accepted")
        self.c_spec_rounds = r.counter("spec_rounds")
        self.h_ttft = r.histogram("serve_ttft_s")
        self.h_tpot = r.histogram("serve_tpot_s")
        self.h_queue = r.histogram("serve_queue_wait_s")
        self.h_plan = r.histogram("serve_plan_s")
        self.h_dispatch = r.histogram("serve_dispatch_s")
        self.h_commit = r.histogram("serve_commit_block_s")
        self.h_apply = r.histogram("serve_commit_apply_s")
        self.h_gap = r.histogram("serve_host_gap_s")
        self.h_wall = r.histogram("serve_step_wall_s")
        self.h_promote = r.histogram("prefix_promote_wait_s")
        self.c_promoted = r.counter("prefix_promoted_blocks")
        self.c_flight_dropped = r.counter("flight_spans_dropped")
        # disaggregated serving (docs/serving.md "Disaggregated
        # serving"): handoff volume counted at the source replica,
        # adoption + exposed transfer wall at the destination
        self.c_handoff_seqs = r.counter("serve_handoff_seqs")
        self.c_handoff_blocks = r.counter("serve_handoff_blocks")
        self.c_handoff_bytes = r.counter("serve_handoff_bytes")
        self.c_handoff_in = r.counter("serve_handoff_seqs_in")
        self.c_handoff_replays = r.counter("serve_handoff_fallback_replays")
        self.h_handoff_exposed = r.histogram("serve_handoff_exposed_s")
        self._reject_counters = {
            reason: r.counter(name)
            for reason, name in _REJECT_COUNTERS.items()}

    def _req_span(self, name, t0_m, t1_m, uid, trace=None, **args):
        """Record a request-lifecycle span from MONOTONIC endpoints
        (the per-seq SLO stamps) onto the flight ring's perf_counter
        axis — the clock offset is measured at record time, so the span
        lands exactly where it happened. ``trace`` is the fleet-wide
        trace context (minted at ReplicaPool.put, carried on the
        sequence descriptor) — merged multi-replica dumps key one
        request's track on it. A hot path: two clock
        reads + a ring append."""
        off = time.perf_counter() - time.monotonic()
        if trace is not None:
            args["trace"] = trace
        self.flight.record(name, t0_m + off, t1_m + off,
                           args={"uid": uid, **args})

    def _req_event(self, name, uid, trace, **args):
        """Instant request-lifecycle mark, trace-tagged when the request
        carries a fleet trace context. A hot path — one
        ring append."""
        if trace is not None:
            args["trace"] = trace
        self.flight.event(name, uid=uid, **args)

    # ------------------- request lifecycle (hot) ---------------------- #
    # Hot paths: these run inside the pipeline's
    # plan-ahead/commit window — pure host arithmetic only.

    def on_admit(self, seq, now):
        """``now`` is the request's admission stamp — the open-loop
        loadgen passes the request's scheduled ARRIVAL time here (via
        ``put(..., arrivals=...)``), so queue-wait/TTFT include any time
        the request waited outside the engine; the default is the
        put() call time."""
        seq.admitted_at = now
        self.c_admitted.inc()
        if self.req_spans:
            # anchored at the (possibly past) admission stamp so the
            # uid track reads admit -> queue -> ttft in order even when
            # admission lagged the arrival (the loadgen's regime)
            self._req_span("req_admit", now, now, seq.uid,
                           trace=seq.trace_id)

    def on_sched(self, sched, now):
        """First-schedule stamps for this plan's sequences -> queue
        wait. Continuations keep their original stamp (queue wait is an
        admission-time property)."""
        req = self.req_spans
        for item in sched:
            seq = item.seq
            if seq.first_sched_at is None:
                seq.first_sched_at = now
                if seq.admitted_at is not None:
                    self.h_queue.observe(now - seq.admitted_at)
                    if req:
                        self._req_span("req_queue_wait",
                                       seq.admitted_at, now, seq.uid,
                                       trace=seq.trace_id)
            if req and len(item.tokens) > 1:
                self._req_event("req_prefill_chunk", seq.uid,
                                seq.trace_id, ntok=len(item.tokens))

    def on_token_commit(self, seq, now, n=1):
        """``n`` output tokens of ``seq`` became host-visible at ``now``
        (one per pipelined commit; ``n`` per fused decode_batch chunk).
        First commit -> TTFT; later commits -> per-token TPOT. A fused
        chunk's follow-on tokens share one wall interval, so TPOT is the
        interval split evenly (weight n) — the same quantity the bench's
        per-chunk arithmetic reported."""
        self.c_tokens.inc(n)
        if seq.first_token_at is None:
            seq.first_token_at = now
            if seq.admitted_at is not None:
                self.h_ttft.observe(now - seq.admitted_at)
                if self.req_spans:
                    self._req_span("req_ttft", seq.admitted_at, now,
                                   seq.uid, trace=seq.trace_id)
        else:
            last = seq.last_token_at
            if last is not None and now > last:
                self.h_tpot.observe((now - last) / n, n=n)
        seq.last_token_at = now

    def on_plan(self, dt):
        self.h_plan.observe(dt)
        self._acc += dt

    def on_dispatch(self, dt, fed):
        self.c_steps.inc()
        if fed:
            self.c_fed.inc()
        self.h_dispatch.observe(dt)
        self._acc += dt

    def on_fused_dispatch(self, dt):
        """One fused decode_batch / speculative-verify enqueue (n steps
        in one dispatch): same dispatch histogram, no per-step counter
        (``serve_steps`` counts pipelined dispatches; fused rounds are
        already visible as spec_rounds / token commits). A
        hot path — one observe + one add."""
        self.h_dispatch.observe(dt)
        self._acc += dt

    def on_commit_block(self, dt):
        self.h_commit.observe(dt)
        self._acc += dt

    def on_commit_apply(self, dt):
        """Host-side commit application — token bookkeeping, journal
        appends, rollbacks and deferred flushes between the blocking
        readback and the commit boundary. A hot path."""
        self.h_apply.observe(dt)
        self._acc += dt

    # ---------------- step-time attribution boundaries ----------------- #

    def on_loop_enter(self):
        """Serve-loop entry (the pipeline ring driver, the fused decode
        loop, a speculative round loop): anchor the attribution clock.
        Loops never genuinely nest (decode_spec exits its window BEFORE
        falling back into the pipelined impl), so entry always
        RE-ANCHORS unconditionally — a loop that unwound on an
        exception without reaching its exit therefore cannot poison
        later windows with a stale anchor (self-healing beats a leaked
        flag). A hot path — attribute stores only."""
        self._in_loop = True
        if self.attrib:
            self._anchor = time.perf_counter()
            self._acc = 0.0

    def on_loop_exit(self):
        """Serve-loop exit: close the residual tail since the last
        commit boundary (loop-condition checks, ring teardown) so a
        window's component sum equals its wall clock. A hot path."""
        self._in_loop = False
        if self.attrib:
            self._close_step(time.perf_counter())

    def _close_step(self, now):
        """The ONE copy of the attribution closure arithmetic (both the
        per-commit boundary and the loop-exit tail call it): wall since
        the anchor, the unbracketed residual into host_gap, re-anchor.
        A hot path — pure host arithmetic."""
        wall = now - self._anchor
        if wall > 0.0:
            gap = wall - self._acc
            self.h_wall.observe(wall)
            self.h_gap.observe(gap if gap > 0.0 else 0.0)
        self._anchor = now
        self._acc = 0.0

    def on_retry(self):
        self.c_retries.inc()

    def on_spec(self, proposed, accepted):
        """One speculative verify round committed: ``proposed`` draft
        tokens offered across the round's slots, ``accepted`` of them
        survived greedy verification (the committed corrections/bonus
        tokens ride serve_tokens_committed). A hot path —
        three pre-bound counter adds."""
        self.c_spec_rounds.inc()
        if proposed:
            self.c_spec_proposed.inc(proposed)
        if accepted:
            self.c_spec_accepted.inc(accepted)

    def on_spec_commit(self, seq, accepted, drafted):
        """One TRACED request's share of a speculative verify round —
        the spec-round mark on its fleet trace track (untraced requests
        skip the ring append entirely; the aggregate counters above
        cover them). A hot path."""
        if self.req_spans and seq.trace_id is not None:
            self._req_event("req_spec_round", seq.uid, seq.trace_id,
                            accepted=accepted, drafted=drafted)

    def on_promote(self, blocks, wait_s):
        """One request's hierarchical-KV promotion dispatched:
        ``blocks`` host-tier blocks scattered back on device, paying
        ``wait_s`` of host-side dispatch time on the plan path (the
        transfers themselves overlap under subsequent compute — this
        histogram IS the exposed cost the serve_hier bench gates on).
        A hot path: a counter add + one observe."""
        self.c_promoted.inc(blocks)
        self.h_promote.observe(wait_s)

    def on_handoff_out(self, seqs, blocks, nbytes):
        """This replica handed ``seqs`` freshly prefilled sequences to a
        decode specialist (``blocks`` KV blocks, ``nbytes`` payload —
        int8 rows + scale planes for quantized pools). Counted at the
        SOURCE so per-role registries attribute handoff traffic to the
        prefill side. A hot path — three counter adds."""
        self.c_handoff_seqs.inc(seqs)
        self.c_handoff_blocks.inc(blocks)
        self.c_handoff_bytes.inc(nbytes)

    def on_handoff_in(self, seqs, blocks, exposed_s):
        """This replica adopted ``seqs`` migrated sequences
        (``blocks`` KV blocks scattered in). ``exposed_s`` is the
        caller-measured NON-overlapped transfer wall — the part of the
        gather→materialize→scatter chain that did not hide under
        neighboring compute; the serve_disagg bench gates on its share
        of prefill time. A hot path."""
        self.c_handoff_in.inc(seqs)
        self.h_handoff_exposed.observe(exposed_s)
        del blocks  # volume counted once, at the source

    def on_handoff_replay(self, seqs):
        """Handoffs that fell back to manifest replay (destination
        could not adopt, or the transfer died mid-flight): the request
        re-prefills its chain token-identically instead. A
        hot path — one counter add."""
        self.c_handoff_replays.inc(seqs)

    def on_reject(self, reason, uid=None, trace=None):
        c = self._reject_counters.get(reason)
        if c is not None:
            c.inc()
        if self.req_spans and uid is not None:
            self._req_event("req_reject", uid, trace, reason=reason)

    def on_abort(self, rejected):
        """engine.abort() on a live uid; shed/deadline aborts arrive
        with their rejection already counted."""
        if not rejected:
            self.c_aborted.inc()

    def on_flush(self, seq, rejected, draining):
        """Outcome classification at the one release path: drained
        sequences ride the manifest (neither good nor bad), rejected/
        aborted ones were counted at their failure site, everything
        else completed cleanly — the goodput numerator."""
        if seq is None:
            return
        if draining:
            self.c_drained.inc()
            outcome = "drained"
        elif rejected or seq.status.value == "finished":
            # FINISHED is only ever set by abort() — counted there (the
            # value comparison avoids importing the enum: telemetry must
            # stay import-cycle-free below the engine)
            outcome = "rejected" if rejected else "aborted"
        else:
            self.c_completed.inc()
            outcome = "completed"
        if self.req_spans:
            ft, lt = seq.first_token_at, seq.last_token_at
            if ft is not None and lt is not None and lt > ft:
                self._req_span("req_decode", ft, lt, seq.uid,
                               trace=seq.trace_id)
            self._req_event("req_finish", seq.uid, seq.trace_id,
                            outcome=outcome)

    def phase(self, name, step=None):
        """Enter flight phase ``name`` (``idle`` closes the open one).
        While a profiler records, the phase is also a
        ``record_function`` range of the same name."""
        self.flight.phase(name, step)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if name != "idle" and _profiling():
            self._range = torch.profiler.record_function(name)
            self._range.__enter__()

    @property
    def engine(self):
        return self._engine()

    # --------------------- boundaries / exports ----------------------- #

    def after_commit(self, step: int) -> None:
        """Periodic work at the commit boundary: close the attribution
        step (wall since the previous boundary; the unbracketed residual
        is the HOST GAP), then time-series sampling (throttled to
        DSTPU_SERIES_EVERY_S), then gauge refresh, export publish,
        monitor-bridge tick — every ``export_every`` steps."""
        if self.attrib and self._in_loop:
            self._close_step(time.perf_counter())
        self.registry.maybe_sample()
        if step - self._last_export_step < self.export_every:
            return
        self._last_export_step = step
        self.sync_gauges()
        if self.export_path:
            self.registry.export(self.export_path,
                                 extra={"engine": "serve"})
        self.registry.tick(step)

    def sync_gauges(self) -> None:
        """Refresh pool/prefix gauges and mirror the host-side prefix
        dict counters into registry counters (delta-sync keeps them
        monotone). Cheap host metadata reads only."""
        eng = self.engine
        r = self.registry
        r.gauge("kv_pool_blocks_total").set(eng.config.num_blocks)
        r.gauge("kv_pool_blocks_free").set(eng.kv_cache.free_blocks)
        rep = eng.state.kv_memory_report()
        r.gauge("kv_pool_bytes_total").set(rep["kv_pool_bytes_total"])
        r.gauge("kv_pool_bytes_per_chip").set(
            rep["kv_pool_bytes_per_chip"])
        st = eng.prefix_stats if eng._prefix is not None \
            else dict(eng.state.prefix_stats)
        # delta-synced host-dict counters (monotone); prefix_promoted_
        # blocks is NOT here — on_promote counts it live so the
        # promote-wait histogram and the counter move together
        for key, metric in (("matched_tokens", "prefix_matched_tokens"),
                            ("prefill_tokens", "prefix_prefill_tokens"),
                            ("cow_copies", "prefix_cow_copies"),
                            ("hit_blocks", "prefix_hit_blocks"),
                            ("evicted", "prefix_evicted_blocks"),
                            ("evicted_cap", "prefix_evicted_cap"),
                            ("evicted_pressure", "prefix_evicted_pressure"),
                            ("demoted", "prefix_demoted_blocks"),
                            ("host_hit_blocks", "prefix_host_hit_blocks"),
                            ("host_evicted",
                             "prefix_host_evicted_blocks")):
            cur = st.get(key, 0)
            prev = self._prefix_prev.get(key, 0)
            if cur > prev:
                r.counter(metric).inc(cur - prev)
                self._prefix_prev[key] = cur
        if eng._prefix is not None:
            r.gauge("prefix_cached_blocks").set(st["cached_blocks"])
            r.gauge("prefix_evictable_blocks").set(st["evictable_blocks"])
            r.gauge("prefix_host_blocks").set(st["host_cached_blocks"])
        # step-time attribution: mirror the component histograms' running
        # SUMS into one labelled counter (delta-sync keeps it monotone) —
        # the sampled counter series then yields per-window component
        # deltas, which is what dstpu_top's "dominant component" line and
        # the regression sentinel's phase rows read. Off the hot path by
        # construction (export boundaries only).
        for comp, hist in (("plan", self.h_plan),
                           ("dispatch", self.h_dispatch),
                           ("device_execute", self.h_commit),
                           ("commit_apply", self.h_apply),
                           ("host_gap", self.h_gap),
                           ("promote_wait", self.h_promote)):
            cur = hist.sum
            prev = self._attrib_prev.get(comp, 0.0)
            if cur > prev:
                r.counter("serve_attrib_seconds_total",
                          component=comp).inc(cur - prev)
                self._attrib_prev[comp] = cur
        dropped = self.flight.dropped
        if dropped > self._flight_dropped_prev:
            self.c_flight_dropped.inc(dropped - self._flight_dropped_prev)
            self._flight_dropped_prev = dropped

    def on_drain(self, manifest: Dict[str, Any]) -> None:
        """Drain published: attach the SLO report to the manifest (the
        registry-fed consumer) and auto-dump the flight ring next to the
        replay state."""
        manifest["telemetry"] = self.slo_report()
        auto_dump("drain")

    # ---------------------------- reports ----------------------------- #

    def slo_report(self) -> Dict[str, Any]:
        """The serving-layer summary: TTFT/TPOT/queue-wait percentiles,
        outcome counts and the goodput fraction (completed / terminal
        outcomes; drained requests are in flight to a survivor, not an
        outcome)."""
        self.sync_gauges()
        return slo_report_from_registry(self.registry)


def slo_report_from_registry(registry) -> Dict[str, Any]:
    """The one copy of the SLO-report arithmetic, over any registry
    holding the serve_* metrics: a live engine's own registry
    (:meth:`ServeObserver.slo_report`) or a merged fleet rollup
    (`serving.ReplicaPool.slo_report`) — per-engine and fleet goodput
    can never disagree on the formula."""
    r = registry

    def c(name: str) -> float:
        return r.counter(name).value

    bad = (c("serve_requests_shed")
           + c("serve_requests_deadline_expired")
           + c("serve_requests_rejected_draining")
           + c("serve_requests_rejected_admission")
           + c("serve_requests_aborted"))
    good = c("serve_requests_completed")
    done = good + bad
    spec_prop = c("spec_proposed")
    spec_acc = c("spec_accepted")
    return {
        "spec": {
            "proposed": spec_prop,
            "accepted": spec_acc,
            "rounds": c("spec_rounds"),
        },
        "spec_accept_rate": spec_acc / spec_prop if spec_prop else None,
        "ttft_s": r.histogram("serve_ttft_s").summary(),
        "tpot_s": r.histogram("serve_tpot_s").summary(),
        "queue_wait_s": r.histogram("serve_queue_wait_s").summary(),
        "tokens_committed": c("serve_tokens_committed"),
        "requests": {
            "admitted": c("serve_requests_admitted"),
            "completed": good,
            "shed": c("serve_requests_shed"),
            "deadline_expired": c("serve_requests_deadline_expired"),
            "rejected_draining": c("serve_requests_rejected_draining"),
            "rejected_admission": c("serve_requests_rejected_admission"),
            "aborted": c("serve_requests_aborted"),
            "drained": c("serve_requests_drained"),
        },
        "goodput_frac": good / done if done else None,
    }
