"""InferenceEngineV2 — continuous-batching ragged engine (port of
``deepspeed_tpu/inference/v2/engine_v2.py``).

``put(batch_uids, batch_tokens)`` feeds tokens for any mix of new prompts
and decode continuations, runs steps over whatever the SplitFuse scheduler
picked, and returns last-token results for every sequence that finished
its pending work. ``decode_batch`` runs ``n`` decode steps through the
runner's decode loop with one host sync; ``decode_pipelined`` runs them
through the overlapped pipeline; ``generate`` drives them for a batch of
prompts.

Each step splits into plan (host: scheduler and staged arrays), dispatch
(the runner's step, enqueued on the current CUDA stream without waiting)
and commit (the readback and bookkeeping). ``serve_pipeline_depth`` steps
are planned and dispatched ahead of the oldest step's commit, so the host
plans step k+1 while the card runs step k; the device orders in-flight
steps by stream order (each step's KV appends come before the next
step's reads). A decode step's input tokens come from the previous
step's on-device token output (``step_greedy_fb`` / ``step_sample_fb``),
so the steady decode state needs no host round trip a token. An EOS is
seen on the delayed readback; the steps already dispatched past it are
killed, and their positions and KV blocks are rolled back once the last
of them has run. Depth 0 plans, dispatches and commits each step in
turn: the parity oracle.

Token selection is on the device: greedy, or per-request sampling
(``put(..., sampling=...)``, ``sampling.py``) with ``(seed, position)``
threefry keys.

The KV block lifecycle: with ``prefix_cache`` a fresh prompt's longest
cached block chain is shared (``prefix_cache.py``), a partial tail is
copied, and a chain demoted to the host tier is promoted back; when the
scheduler starves the engine pauses (host-offloads) the least recently
scheduled block holder and resumes it as room appears, and sheds a
request with a structured rejection (``rejections``) when nothing else
helps. ``abort`` cancels a request at any time, ``request_deadline_s``
aborts late ones, ``request_drain`` / ``drain`` / ``replay`` carry live
requests across a restart (``drain.py``), and a dispatch that raises an
I/O-class error is retried. Every release of a block waits for the
commit of the last in-flight step that writes it.

Speculative decoding (``spec_decode``, ``speculative.py``): with "ngram"
or "draft" (a small model paired by ``attach_draft``), ``decode_pipelined``
sends an all-greedy batch through ``decode_spec``: a proposer drafts
``spec_k`` tokens a sequence, one verify pass of the decode loop scores
the K+1 positions, the longest agreeing prefix plus the model's own next
token is committed, and the rest is rolled back by ``trim_blocks``. The
streams are those of non-speculative greedy decode.

The runner comes from the model config (``_runner_for``): the Llama,
GPT-2, OPT, BLOOM, GPT-NeoX, GPT-J, Falcon and Phi runners.

Telemetry (``telemetry/serve.py``; off with ``DSTPU_TELEMETRY=0``): the
observer ``_obs`` turns the plan / dispatch / commit boundaries into
the registry (:attr:`metrics`: TTFT, TPOT, queue wait, outcome counters,
step-time attribution) and the flight ring (:attr:`flight`), and
:meth:`slo_report` summarises them. The watchdog (``attach_watchdog``,
or ``DSTPU_SERVE_WATCHDOG=1``) names the phase a stalled step hung in;
the fault sites ``pre_dispatch``, ``mid_commit``,
``during_prefill_chunk``, ``during_cow_copy`` and
``during_handoff_gather`` fire through ``resilience.fault_injection``.
``handoff_out`` / ``handoff_in`` move a prefilled sequence's KV block
chain and identity to another engine (``serving/pool.py``'s
prefill -> decode handoff).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...resilience.fault_injection import get_fault_injector
from ...telemetry.serve import serve_observer
from ...utils.device import resolve_device
from ...utils.dtypes import resolve_dtype
from .blocked_allocator import OutOfBlocksError
from .config import RaggedInferenceConfig
from .drain import (EngineDrainingError, ReplayJournal, ServeDrainError,
                    ServeStepError, build_manifest, write_manifest)
from .kv_cache import BlockedKVCache
from .llama_runner import LlamaRaggedRunner
from .model_runner import GPT2RaggedRunner, RaggedBatch
from .prefix_cache import PrefixCache
from .sampling import (SAMPLE_CANDIDATES, SamplingParams, derive_seed,
                       host_token, seed_of, stage_slot)
from .scheduler import SplitFuseScheduler
from .sequence import SequenceStatus
from .state_manager import StateManager

logger = logging.getLogger(__name__)

#: the value a speculatively scheduled decode token carries in
#: ``pending_tokens`` while its real value is still an in-flight device
#: output (the step substitutes the device value; the commit of the step
#: that produced it patches the host value in if it is still queued)
_SPEC_TOKEN = -1


class _PlannedStep:
    """Host half of one step: the schedule and its staged host tensors
    (pinned on a card). ``fed`` says whether a slot takes its token from
    the device (``feed_mask`` / ``feed_idx``); ``sample`` is the (seeds,
    spos, temps, topks, topps) quintet when a scheduled sequence samples
    (None: the greedy step)."""

    __slots__ = ("sched", "tokens", "start", "ntok", "tables",
                 "feed_mask", "feed_idx", "fed", "use_greedy", "sample")

    def __init__(self, sched, tokens, start, ntok, tables, feed_mask,
                 feed_idx, fed, use_greedy, sample=None):
        self.sched = sched
        self.tokens = tokens
        self.start = start
        self.ntok = ntok
        self.tables = tables
        self.feed_mask = feed_mask
        self.feed_idx = feed_idx
        self.fed = fed
        self.use_greedy = use_greedy
        self.sample = sample


class _InFlightStep:
    """A dispatched, uncommitted step: its device result and what its
    commit needs. ``dead`` slots were killed by a later-seen EOS or an
    abort (their readback is discarded); ``rollbacks`` are (seq,
    n_tokens) retractions and ``aborts`` are sequences whose flush waits
    for THIS step to have run, since its KV appends still target the
    blocks they free."""

    __slots__ = ("sched", "result", "use_greedy", "dead", "rollbacks",
                 "aborts", "logprobs")

    def __init__(self, sched, result, use_greedy, logprobs=None):
        self.sched = sched
        self.result = result
        self.use_greedy = use_greedy
        self.dead: set = set()
        self.rollbacks: List[Tuple[Any, int]] = []
        self.aborts: List[Any] = []
        #: the sampled step's [S] chosen-token logprobs (None if greedy)
        self.logprobs = logprobs


def _move_tree(tree, device):
    """The parameter tree on ``device``; a packed WOQ leaf (a NamedTuple
    of tensors and metadata) moves field by field."""
    if isinstance(tree, dict):
        return {k: _move_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(v.to(device) if isinstance(v, torch.Tensor)
                            else v for v in tree))
    return tree.to(device)


def _runner_for(model_cfg: Any, cfg: RaggedInferenceConfig):
    """The ragged runner of the model's family (the JAX engine's
    ``_runner_for``, branch by branch): dense Llama, OPT, Falcon, Phi,
    BLOOM, GPT-NeoX, GPT-J, else GPT-2 (``config.validate`` has refused
    the families without a ported runner)."""
    from ...models.llama import LlamaConfig
    from ...models.opt import OPTConfig
    if isinstance(model_cfg, LlamaConfig):
        return LlamaRaggedRunner(model_cfg, cfg)
    if isinstance(model_cfg, OPTConfig):
        from .opt_runner import OPTRaggedRunner
        return OPTRaggedRunner(model_cfg, cfg)
    from ...models.falcon import FalconConfig
    from ...models.phi import PhiConfig
    if isinstance(model_cfg, FalconConfig):
        from .falcon_phi_runner import FalconRaggedRunner
        return FalconRaggedRunner(model_cfg, cfg)
    if isinstance(model_cfg, PhiConfig):
        from .falcon_phi_runner import PhiRaggedRunner
        return PhiRaggedRunner(model_cfg, cfg)
    from ...models.bloom import BloomConfig
    from ...models.gpt_neox import GPTJConfig, GPTNeoXConfig
    if isinstance(model_cfg, BloomConfig):
        from .bloom_gptj_neox_runner import BloomRaggedRunner
        return BloomRaggedRunner(model_cfg, cfg)
    if isinstance(model_cfg, GPTNeoXConfig):
        from .bloom_gptj_neox_runner import GPTNeoXRaggedRunner
        return GPTNeoXRaggedRunner(model_cfg, cfg)
    if isinstance(model_cfg, GPTJConfig):
        from .bloom_gptj_neox_runner import GPTJRaggedRunner
        return GPTJRaggedRunner(model_cfg, cfg)
    return GPT2RaggedRunner(model_cfg, cfg)


class InferenceEngineV2:
    def __init__(self, model_cfg: Any, params: Any,
                 config: Optional[RaggedInferenceConfig] = None,
                 device: Any = None):
        """``model_cfg``: a :class:`~...models.llama.LlamaConfig`,
        :class:`~...models.gpt2.GPT2Config`, or the config of OPT, BLOOM,
        GPT-NeoX, GPT-J, Falcon or Phi (``models/``).
        ``params``: its parameter tree (``checkpoint/jax_params.py``),
        dense or weight-only-quantized (``inference/quantization.py``),
        moved to ``device`` if it lives elsewhere. ``device`` defaults to
        ``cuda`` and raises without a card; pass ``"cpu"`` for the plain
        path."""
        self.device = resolve_device(device)
        self.config = config or RaggedInferenceConfig()
        self.config.validate(model_cfg)
        self.model_cfg = model_cfg
        self.runner = _runner_for(model_cfg, self.config)
        self.params = _move_tree(params, self.device)
        self.kv_cache = BlockedKVCache(
            self.config, self.runner.num_layers, self.runner.kv_heads,
            self.runner.head_dim, dtype=resolve_dtype(self.config.dtype),
            device=self.device)
        self.state = StateManager(self.config, self.kv_cache)
        cfg = self.config
        self._prefix: Optional[PrefixCache] = None
        if cfg.prefix_cache:
            self._prefix = PrefixCache(
                cfg.block_size, max_blocks=cfg.prefix_cache_max_blocks,
                policy=cfg.prefix_cache_policy,
                host_blocks=cfg.prefix_cache_host_blocks)
            self.kv_cache.attach_prefix_cache(self._prefix)
            self.state.prefix = self._prefix
        self.scheduler = SplitFuseScheduler(self.config, self.state)
        self._step_counter = 0
        #: steps planned and dispatched ahead of the oldest commit
        self.pipeline_depth = self.config.serve_pipeline_depth
        # reused per-(S, C) staging sets (see _staging_bufs)
        self._staging: Dict[Tuple[int, int], Dict[str, Any]] = {}
        # device feedback source: the latest dispatched greedy step's [S]
        # token output, and each uid's slot in it
        self._feed_src: Optional[torch.Tensor] = None
        self._feed_slot: Dict[int, int] = {}
        self._no_feed = torch.zeros((1,), dtype=torch.int32,
                                    device=self.device)
        #: steps dispatched, steps with device-fed slots, host seconds in
        #: plan / dispatch / the commit's blocking readback, and the
        #: device-to-host readbacks made
        #: device-to-host readbacks made, dispatches retried, and host
        #: seconds enqueuing host-tier promotions
        self.pipeline_stats = {"steps": 0, "fed_steps": 0, "plan_s": 0.0,
                               "dispatch_s": 0.0, "commit_block_s": 0.0,
                               "readbacks": 0, "retries": 0,
                               "promote_wait_s": 0.0}
        #: host wall time of generate's phases: the prompt put() (prefill,
        #: ends in the readback of its last step) and everything after
        #: (decode), with the tokens each produced
        self.timing = {"prefill_s": 0.0, "decode_s": 0.0,
                       "prefill_tokens": 0, "decode_tokens": 0}
        # ---- serve-side resilience (drain.py) ----
        self.request_deadline_s = float(cfg.request_deadline_s)
        #: True once any sequence carries a deadline: the deadline sweep
        #: is then armed
        self._has_deadlines = self.request_deadline_s > 0
        self.serve_step_retries = int(cfg.serve_step_retries)
        self.serve_retry_backoff_s = float(cfg.serve_retry_backoff_s)
        self.serve_shed = bool(cfg.serve_shed)
        self.journal = ReplayJournal(cfg.serve_journal) \
            if cfg.serve_journal else None
        #: any object with a boolean ``preempted`` (attach_preemption)
        self.preemption = None
        self._drain_requested = False
        self._live_ring: Optional[deque] = None
        #: structured rejections (load shedding, deadlines, drain-time
        #: admission refusals): uid -> record
        self.rejections: Dict[int, Dict[str, Any]] = {}
        # ---- speculative decoding (speculative.py) ----
        self.spec_mode = cfg.spec_decode
        self.spec_k = int(cfg.spec_k)
        self.spec_ngram = int(cfg.spec_ngram)
        #: the paired draft engine (attach_draft) for spec_mode "draft"
        self._draft_engine: Optional["InferenceEngineV2"] = None
        #: the proposer, built at the first speculative round
        self._proposer = None
        #: verify rounds, drafts proposed and accepted (the committable
        #: window, as each sequence's spec_proposed / spec_accepted), and
        #: host seconds proposing, in the verify (dispatch and readback)
        #: and in the round's commit
        self.spec_stats = {"rounds": 0, "proposed": 0, "accepted": 0,
                           "propose_s": 0.0, "verify_s": 0.0,
                           "commit_s": 0.0}
        #: the serve loop's StepWatchdog (attach_watchdog)
        self._watchdog = None
        if os.environ.get("DSTPU_SERVE_WATCHDOG") == "1":
            from ...resilience.watchdog import StepWatchdog
            self._watchdog = StepWatchdog(action="log")
        #: the telemetry observer (telemetry/serve.py; None with
        #: DSTPU_TELEMETRY=0): per-request SLO metrics, step-time
        #: attribution and the phase flight recorder, recorded at the
        #: host-side boundaries this loop already owns
        self._obs = serve_observer(self)

    # ------------------------------------------------------------------ #
    # reference-parity surface
    # ------------------------------------------------------------------ #

    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[Sequence[int]],
            _greedy: bool = False,
            arrivals: Optional[Dict[int, float]] = None,
            deadlines: Optional[Dict[int, float]] = None,
            sampling: Optional[Dict[int, SamplingParams]] = None,
            traces: Optional[Dict[int, str]] = None
            ) -> Dict[int, Any]:
        """Feed tokens, run scheduled steps until all fed work is consumed,
        and return {uid: last-token logits (numpy [V] fp32)} for sequences
        with no pending work, or {uid: token id} on the ``_greedy`` path
        that :meth:`generate` uses (selected on the device). ``sampling``
        maps uid -> :class:`SamplingParams`, attached to a fresh sequence
        for its life: on the ``_greedy`` path its tokens are sampled on
        the device (temperature 0 is the greedy token). Steps run through
        the pipeline (``serve_pipeline_depth``); the pool may be
        oversubscribed (idle sequences are paused to host memory and
        resumed as room appears).

        Admission: while the engine is draining, a fresh request is
        refused with a record in :attr:`rejections` (a continuation of a
        live one is not fed: it rides the drain manifest); so is a fresh
        prompt that could never fit the pool (``kv_pool_exhausted``,
        unless ``serve_shed`` is off). A refused uid is absent from the
        returned dict. ``arrivals`` maps uid -> its ``time.monotonic()``
        arrival, the anchor of its deadline; ``deadlines`` maps uid -> a
        deadline in seconds (overriding ``request_deadline_s``). Both
        apply to fresh sequences (``arrivals`` is also the telemetry
        admission stamp). ``traces`` maps uid -> a fleet-wide trace id
        (``ReplicaPool.put`` mints them), attached at admission, tagged
        onto the request's flight spans and carried by the drain
        manifest. With ``prefix_cache`` a fresh prompt first takes its
        longest cached chain."""
        admitted: List[int] = []
        bs = self.config.block_size
        for uid, toks in zip(batch_uids, batch_tokens):
            seq0 = self.state.get(uid)
            fresh = seq0 is None or (seq0.seen_tokens == 0
                                     and not seq0.kv_blocks)
            if self._draining():
                if fresh:
                    self._reject(uid, "draining",
                                 detail="engine is draining for preemption")
                continue
            if fresh and self.serve_shed:
                # a prompt whose KV (plus one generated token) exceeds the
                # whole pool can never be served: shed it at the door
                need = -(-(len(toks) + 1) // bs)
                if need > self.config.num_blocks:
                    self._reject(
                        uid, "kv_pool_exhausted", needed_blocks=need,
                        num_blocks=self.config.num_blocks,
                        detail="prompt exceeds the whole KV pool")
                    continue
            seq = self.state.put_tokens(uid, toks)
            admitted.append(uid)
            # a reused uid sheds its stale rejection record
            self.rejections.pop(uid, None)
            if fresh:
                sp = sampling.get(uid) if sampling else None
                if sp is not None:
                    seq.sampling = sp
                tid = traces.get(uid) if traces else None
                if tid is not None:
                    # before on_admit: the admit span carries the trace
                    seq.trace_id = tid
                arrived = arrivals.get(uid) if arrivals else None
                if self._obs is not None:
                    self._obs.on_admit(
                        seq, arrived if arrived is not None
                        else time.monotonic())
                dl = deadlines.get(uid) if deadlines else None
                if dl is None and self.request_deadline_s > 0:
                    dl = self.request_deadline_s
                if dl is not None and dl > 0 and seq.deadline_at is None:
                    seq.deadline_at = dl + (
                        arrived if arrived is not None
                        else time.monotonic())
                    seq.deadline_s = dl
                    self._has_deadlines = True
                if self.journal is not None \
                        and seq.seen_tokens == 0 and not seq.kv_blocks:
                    # prompt still building: (re-)journal the full chain
                    # with its sampling identity
                    self.journal.admit(uid, seq.prompt_log,
                                       sampling=seq.sampling.to_dict()
                                       if seq.sampling is not None
                                       else None,
                                       trace=seq.trace_id)
            if self._prefix is not None:
                self._match_prefix(seq)
        done: Dict[int, Any] = {}

        def work_left():
            return any(s.in_flight for s in self.state.sequences.values())

        def commit_one(ring):
            _, step_done = self._commit_step(ring.popleft())
            done.update(step_done)

        self._drive_pipeline(
            work_left, lambda: self._plan_step(greedy=_greedy), commit_one)
        if self._prefix is not None:
            self._register_prefix(admitted)
        return done

    def _match_prefix(self, seq) -> None:
        """The prefix-cache hit path: point a fresh prompt's table at the
        longest cached chain and enqueue the device copies the match asks
        for (CoW block copies, then one batched host-to-device promotion
        scatter), on the stream ahead of any step that reads them.
        ``pipeline_stats["promote_wait_s"]`` is the host time enqueuing
        the promotion takes."""
        plan = self.state.match_prefix(seq)
        if plan:
            # fault site: a replica dying between the match (the table
            # already points at shared blocks) and the CoW copies
            get_fault_injector().maybe_fire("during_cow_copy")
        for src, dst in plan.copies:
            self.kv_cache.copy_block(src, dst)
        if plan.promotes:
            t0 = time.perf_counter()
            self.kv_cache.promote_blocks(plan.promotes)
            dt = time.perf_counter() - t0
            self.pipeline_stats["promote_wait_s"] += dt
            if self._obs is not None:
                # promoted_blocks, not len(promotes): a host-tier CoW
                # tail is copied without flipping its source entry
                self._obs.on_promote(plan.promoted_blocks, dt)

    def _register_prefix(self, batch_uids) -> None:
        """Insert this put() call's prefilled prompt blocks into the cache
        (their KV writes are enqueued; stream order makes them safe to
        share)."""
        for uid in batch_uids:
            seq = self.state.get(uid)
            if seq is not None:
                self.state.register_prefix(seq)

    @property
    def prefix_stats(self) -> Dict[str, Any]:
        """The host-side prefix-cache counters merged with the cache's,
        and the skipped-chunk fraction: matched / (matched + prefilled
        prompt tokens), and the share of matched tokens the host tier
        served."""
        st = dict(self.state.prefix_stats)
        if self._prefix is not None:
            st.update(self._prefix.stats)
            st["cached_blocks"] = self._prefix.cached_blocks
            st["evictable_blocks"] = self._prefix.evictable_blocks
            st["host_cached_blocks"] = self._prefix.host_cached_blocks
            st["host_tier_blocks"] = self._prefix.host_blocks
        ran = st["prefill_tokens"]
        hit = st["matched_tokens"]
        st["prefill_chunks_skipped_frac"] = (
            hit / (hit + ran) if hit + ran else 0.0)
        st["host_hit_frac"] = (
            st["host_matched_tokens"] / hit if hit else 0.0)
        return st

    def query(self, uid: int) -> Tuple[int, int]:
        """(tokens seen, max additional tokens before block exhaustion).
        A paused sequence reports 0 headroom: resume() it first."""
        seq = self.state.get_or_create(uid)
        if seq.status is SequenceStatus.PAUSED:
            return seq.seen_tokens, 0
        free_local = self.config.max_blocks_per_seq - len(seq.kv_blocks)
        free = min(free_local, self.kv_cache.free_blocks)
        slack = len(seq.kv_blocks) * self.config.block_size - seq.seen_tokens
        return seq.seen_tokens, slack + free * self.config.block_size

    def flush(self, uid: int) -> None:
        """Release a sequence and its KV blocks."""
        self._flush_uid(uid)

    @property
    def free_blocks(self) -> int:
        return self.kv_cache.free_blocks

    def logprobs_of(self, uid: int) -> List[float]:
        """Chosen-token log-probabilities recorded so far for ``uid``
        (empty unless its SamplingParams set ``logprobs=True``)."""
        seq = self.state.get(uid)
        return list(seq.logprob_log) if seq is not None else []

    # ------------------------------------------------------------------ #
    # the serving path: plan -> dispatch -> commit
    # ------------------------------------------------------------------ #

    def _drive_pipeline(self, work_left, make_plan, commit_one,
                        on_dispatch=None) -> None:
        """The ring-drive loop behind put() and decode_pipelined: fill
        the in-flight ring up to ``pipeline_depth`` steps (plan and
        dispatch; expired deadlines are aborted and paused sequences
        resumed first), then commit the oldest. Nothing schedulable with
        nothing in flight: pause a block holder, else shed a request,
        else raise (``serve_shed`` off). ``commit_one(ring)`` pops and
        applies the oldest step; ``on_dispatch(plan, fl)`` runs after each
        dispatch. Once draining (``request_drain`` or an attached
        preemption flag), no step is planned, every dispatched step is
        committed, and the loop returns. The watchdog brackets each
        iteration and names its phases; the telemetry observer's
        attribution window is the whole loop."""
        depth = max(1, self.pipeline_depth)
        ring: deque = deque()
        wd = self._watchdog
        obs = self._obs
        self._live_ring = ring
        if obs is not None:
            # step-time attribution window: everything until the loop
            # exit is accounted, the unbracketed residual as host gap
            obs.on_loop_enter()
        try:
            while ring or (work_left() and not self._draining()):
                if wd is not None:
                    wd.step_start(self._step_counter)
                try:
                    while len(ring) < depth and not self._draining() \
                            and work_left():
                        self._expire_deadlines()
                        self._try_resume()
                        if wd is not None:
                            wd.phase("plan")
                        if obs is not None:
                            obs.phase("plan", self._step_counter)
                        plan = make_plan()
                        if plan is None:
                            break
                        if wd is not None:
                            wd.phase("dispatch")
                        if obs is not None:
                            obs.phase("dispatch", self._step_counter)
                        fl = self._dispatch_with_retry(plan)
                        ring.append(fl)
                        if on_dispatch is not None:
                            on_dispatch(plan, fl)
                    if ring:
                        commit_one(ring)
                        continue
                    if self._draining():
                        break
                    if not work_left():
                        # an expiry or abort cleared the last pending work
                        continue
                    if not self._relieve_kv_pressure() \
                            and not self._shed_starved():
                        raise RuntimeError(
                            "scheduler starved: KV pool too small even "
                            "after pausing all idle sequences "
                            f"(free blocks={self.kv_cache.free_blocks})")
                except BaseException:
                    if wd is not None:
                        wd.step_abort()
                    raise
                finally:
                    if wd is not None:
                        wd.step_end(self._step_counter)
                    if obs is not None:
                        # close the open flight span at the boundary
                        obs.phase("idle")
        finally:
            self._live_ring = None
            if obs is not None:
                obs.on_loop_exit()

    # ------------------------------------------------------------------ #
    # serve-side resilience: drain / replay / abort / shed / deadlines
    # ------------------------------------------------------------------ #

    def attach_preemption(self, handler) -> None:
        """Poll ``handler.preempted`` inside the serve loop (a
        :class:`~...resilience.preemption.PreemptionHandler`, or any
        object with a boolean ``preempted``): once it is true the
        pipeline stops planning, commits everything in flight and
        returns; the caller then runs :meth:`drain`."""
        self.preemption = handler

    def attach_watchdog(self, wd) -> None:
        """Cover the serve loop with a
        :class:`~...resilience.watchdog.StepWatchdog`: each pipeline
        iteration is bracketed and its plan / dispatch / commit phases
        named, so a stalled step's diagnosis says where it hung."""
        self._watchdog = wd

    def request_drain(self) -> None:
        """Put the engine into draining mode (idempotent): no new
        admissions, no new planned steps; in-flight steps still commit."""
        self._drain_requested = True

    @property
    def draining(self) -> bool:
        return self._draining()

    def _draining(self) -> bool:
        return self._drain_requested or (
            self.preemption is not None and self.preemption.preempted)

    def _reject(self, uid: int, reason: str, **fields) -> None:
        """Record a structured rejection (load shed / deadline / drain
        refusal / admission door): the crash-free failure path a serving
        layer turns into a retriable response."""
        # retry_after_s is first-class in the record (None unless the
        # admission controller's door rejection sets it)
        rec = {"uid": uid, "reason": reason, "time": time.time(),
               "retry_after_s": fields.pop("retry_after_s", None),
               **fields}
        self.rejections[uid] = rec
        if self._obs is not None:
            seq = self.state.get(uid)
            self._obs.on_reject(reason, uid,
                                seq.trace_id if seq is not None else None)
        logger.warning(f"serve rejection uid={uid}: {reason} "
                       + (str(fields) if fields else ""))

    def _expire_deadlines(self) -> None:
        """Abort requests with pending work whose deadline has passed (a
        request that owes nothing right now is left alone)."""
        if not self._has_deadlines:
            return
        now = time.monotonic()
        for seq in list(self.state.sequences.values()):
            if not seq.in_flight:
                continue
            if seq.deadline_at is not None and now > seq.deadline_at \
                    and seq.status is not SequenceStatus.FINISHED:
                self._reject(seq.uid, "deadline_exceeded",
                             deadline_s=seq.deadline_s
                             if seq.deadline_s is not None
                             else self.request_deadline_s,
                             deadline_at=seq.deadline_at,
                             seen_tokens=seq.seen_tokens,
                             generated=len(seq.gen_log))
                self.abort(seq.uid)

    def _shed_starved(self) -> bool:
        """Load shedding: the scheduler starved with the pool exhausted
        even after eviction and pausing. Abort the cheapest victim to
        redo (not yet started first, then the largest demand) with a
        rejection record."""
        if not self.serve_shed:
            return False
        cands = [s for s in self.state.sequences.values()
                 if s.in_flight and s.status is not SequenceStatus.FINISHED]
        if not cands:
            return False
        victim = min(cands, key=lambda s: (s.seen_tokens != 0,
                                           -(s.seen_tokens + s.in_flight)))
        self._reject(
            victim.uid, "kv_pool_exhausted",
            needed_blocks=victim.blocks_needed(victim.in_flight,
                                               self.config.block_size),
            free_blocks=self.kv_cache.free_blocks,
            seen_tokens=victim.seen_tokens)
        self.abort(victim.uid)
        return True

    def abort(self, uid: int) -> bool:
        """Cancel a sequence at any time, releasing its state exactly:
        pending work is dropped, its slots in every in-flight step are
        killed, and its flush (blocks to the allocator, prefix refcounts
        decref'd) waits for the commit of the last in-flight step that
        still writes its blocks. Returns False for an unknown uid."""
        seq = self.state.get(uid)
        if seq is None:
            return False
        if seq.status is SequenceStatus.FINISHED:
            return True                    # already cancelled
        if self._obs is not None:
            self._obs.on_abort(uid in self.rejections)
        seq.pending_tokens.clear()
        seq.spec_pending = 0
        seq.status = SequenceStatus.FINISHED   # the scheduler skips it
        last_fl = None
        if self._live_ring:
            for fl in self._live_ring:
                touched = False
                for j, item in enumerate(fl.sched):
                    if item.seq.uid == uid:
                        # already-dead slots count too: their KV writes
                        # (and any rollback) still reference the blocks
                        fl.dead.add(j)
                        touched = True
                if touched or any(s is seq for s, _ in fl.rollbacks):
                    last_fl = fl
        if last_fl is not None:
            last_fl.aborts.append(seq)
        else:
            self._flush_uid(uid)
        return True

    def _flush_uid(self, uid: int) -> None:
        """The one engine-level release path (flush, deferred abort,
        drain): count the outcome, journal the finish, then free through
        the state manager (shared blocks decref'd, private blocks to the
        allocator)."""
        if self._obs is not None:
            self._obs.on_flush(self.state.get(uid),
                               uid in self.rejections, self._draining())
        if self.journal is not None and self.state.get(uid) is not None:
            self.journal.finish(uid)
        if self._proposer is not None:
            # a draft-model proposer mirrors live sequences on its own
            # engine: release its copy with ours
            self._proposer.drop(uid)
        self.state.flush(uid)

    def drain(self, path: Optional[str] = None,
              ledger: Any = None) -> Dict[str, Any]:
        """Cooperative drain: stop admitting, snapshot every live
        sequence into a replay manifest (uid, prompt, tokens generated so
        far, scheduler state), release all engine state, and publish the
        manifest atomically at ``path`` if given. Appends a
        ``serve_drain`` record to ``ledger`` (a
        :class:`~...resilience.ledger.RestartLedger`, or one at
        ``DSTPU_RESTART_LEDGER``). With telemetry on, the manifest
        carries the SLO report (``telemetry``) and the flight ring
        records the drain span (and is dumped under
        ``DSTPU_FLIGHT_DIR``). Call with no steps in flight (after the
        interrupted engine call returned). Returns the manifest;
        ``pool`` says whether every block came back."""
        if self._live_ring is not None:
            raise ServeDrainError(
                "drain() called with steps in flight — request_drain() "
                "and let the interrupted engine call return first")
        self.request_drain()
        t_drain0 = time.perf_counter()
        # land pending demotion copies: the host tier survives the drain
        self.kv_cache.finalize_demotions()
        manifest = build_manifest(self)
        if self.journal is not None:
            # retire the journal before flushing: the flushes must not
            # journal finishes for sequences the manifest still owes
            self.journal.close()
            self.journal = None
        for uid in list(self.state.sequences):
            self._flush_uid(uid)
        free = self.kv_cache.free_blocks
        manifest["pool"] = {
            "num_blocks": self.config.num_blocks,
            "free_blocks_after_drain": free,
            "fully_recovered": free == self.config.num_blocks,
        }
        manifest["rejections"] = list(self.rejections.values())
        if self._obs is not None:
            # the drain span and the SLO report, attached before the
            # publish so the file carries it too
            self._obs.flight.record("drain", t_drain0,
                                    time.perf_counter(),
                                    step=self._step_counter)
            self._obs.on_drain(manifest)
        if path:
            write_manifest(manifest, path)
            manifest["path"] = path
        if ledger is None and os.environ.get("DSTPU_RESTART_LEDGER"):
            from ...resilience.ledger import RestartLedger
            ledger = RestartLedger(os.environ["DSTPU_RESTART_LEDGER"])
        if ledger is not None:
            ledger.record("serve_drain",
                          sequences=len(manifest["sequences"]),
                          manifest=path,
                          fully_recovered=manifest["pool"]["fully_recovered"])
        return manifest

    def replay(self, manifest: Dict[str, Any]) -> Dict[int, Any]:
        """Re-admit a drained replica's sequences here: each re-enters as
        ``prompt + generated`` and is prefilled (with the prefix cache,
        mostly as hits), and the returned ``{uid: next token}`` is the one
        the uninterrupted run would have emitted next. Sampled sequences
        keep their SamplingParams, traced ones their trace id. The
        sequences stay live, with their prompt/generated split
        restored."""
        if self._draining():
            raise EngineDrainingError(
                "replay() on a draining engine — replay belongs on the "
                "restarted or survivor replica")
        recs = manifest.get("sequences", [])
        uids = [int(r["uid"]) for r in recs]
        chains = [list(r["prompt"]) + list(r["generated"]) for r in recs]
        sp_map = {int(r["uid"]): SamplingParams.from_dict(r["sampling"])
                  for r in recs if r.get("sampling")}
        # the trace context survives the membership change: the replayed
        # request's spans join the track its first replica started
        tr_map = {int(r["uid"]): r["trace"]
                  for r in recs if r.get("trace")}
        if self._obs is not None:
            with self._obs.flight.span("replay", step=self._step_counter,
                                       sequences=len(recs)):
                out = self.put(uids, chains, _greedy=True,
                               sampling=sp_map or None,
                               traces=tr_map or None)
        else:
            out = self.put(uids, chains, _greedy=True,
                           sampling=sp_map or None, traces=tr_map or None)
        for r in recs:
            seq = self.state.get(int(r["uid"]))
            if seq is not None:
                seq.prompt_log = list(r["prompt"])
                seq.gen_log = list(r["generated"]) + seq.gen_log
        return out

    def _dispatch_with_retry(self, plan: _PlannedStep) -> _InFlightStep:
        """Dispatch with bounded retry: an I/O-class failure redispatches
        the same planned step (a failed dispatch changed no host state)
        after an exponential backoff; past ``serve_step_retries`` it
        raises ServeStepError."""
        delay = self.serve_retry_backoff_s
        attempt = 0
        while True:
            try:
                return self._dispatch_step(plan)
            except (OSError, ConnectionError) as e:
                attempt += 1
                self.pipeline_stats["retries"] += 1
                if self._obs is not None:
                    self._obs.on_retry()
                if attempt > self.serve_step_retries:
                    raise ServeStepError(
                        f"serve step dispatch failed {attempt} times; "
                        f"last error: {e}") from e
                logger.warning(
                    f"serve step dispatch transient failure ({e}); "
                    f"retry {attempt}/{self.serve_step_retries} in "
                    f"{delay:.3f}s")
                if delay > 0:
                    time.sleep(delay)
                delay *= 2

    # ------------------------------------------------------------------ #
    # pause / resume: oversubscribing the pool through host memory
    # ------------------------------------------------------------------ #

    def _resume_headroom(self, seq) -> int:
        """Blocks needed to restore ``seq`` and schedule its next chunk
        (resuming with less would thrash)."""
        bs = self.config.block_size
        n = min(seq.in_flight, self.config.effective_chunk)
        total = -(-(seq.seen_tokens + n) // bs)
        return max(total, seq.paused_blocks)

    def _try_resume(self) -> None:
        """Restore paused sequences with pending work, oldest first, while
        free blocks cover their saved KV and their next chunk."""
        paused = sorted(
            (s for s in self.state.sequences.values()
             if s.status is SequenceStatus.PAUSED and s.in_flight > 0),
            key=lambda s: s.last_step)
        for seq in paused:
            if self._resume_headroom(seq) > self.kv_cache.free_blocks:
                break
            self.resume(seq.uid)

    def _relieve_kv_pressure(self) -> bool:
        """Pause the least recently scheduled block holder: idle ones
        first, then one with pending work (its KV is complete up to
        ``seen_tokens``). False when no sequence holds a block."""
        holders = [s for s in self.state.sequences.values()
                   if s.status is not SequenceStatus.PAUSED and s.kv_blocks]
        idle = sorted((s for s in holders if not s.in_flight),
                      key=lambda s: s.last_step)
        if idle:
            self.pause(idle[0].uid)
            return True
        pending = sorted((s for s in holders if s.in_flight),
                         key=lambda s: s.last_step)
        if pending:
            self.pause(pending[0].uid)
            return True
        return False

    def pause(self, uid: int) -> None:
        """Offload a sequence's KV blocks to host memory and release them,
        so other sequences can use the pool. Pending tokens may wait: KV
        is complete up to ``seen_tokens``. Shared blocks are decref'd;
        resume() restores the copy into private blocks."""
        seq = self.state.get(uid)
        if seq is None:
            raise KeyError(f"unknown sequence {uid}")
        if seq.status is SequenceStatus.PAUSED:
            return
        seq.host_kv = self.kv_cache.offload(seq.kv_blocks)
        seq.paused_blocks = len(seq.kv_blocks)
        self.state.release_blocks(seq, seq.kv_blocks)
        seq.kv_blocks = []
        seq.status = SequenceStatus.PAUSED

    def resume(self, uid: int) -> None:
        """Reserve blocks for a paused sequence and restore its KV from
        host memory as it was (block ids may differ)."""
        seq = self.state.get(uid)
        if seq is None:
            raise KeyError(f"unknown sequence {uid}")
        if seq.status is not SequenceStatus.PAUSED:
            return
        blocks = self.kv_cache.reserve(seq.paused_blocks)
        self.kv_cache.restore(seq.host_kv, blocks)
        seq.kv_blocks = list(blocks)
        seq.host_kv = None
        seq.paused_blocks = 0
        seq.status = SequenceStatus.WAITING

    # ------------------------------------------------------------------ #
    # the disaggregated-serving handoff (serving/pool.py): a prefill
    # replica hands a freshly prefilled sequence, its KV block chain and
    # its replay identity, to a decode replica. The records are a
    # superset of the drain manifest's, so a failed handoff falls back to
    # replay from the same records.
    # ------------------------------------------------------------------ #

    def handoff_out(self, batch_uids: Sequence[int]) -> Dict[str, Any]:
        """Snapshot and release sequences for migration to another
        engine. For each uid with no pending work, gather its exact KV
        block chain (``kv_cache.gather_blocks``: one indexing copy on the
        stream, rows block-major, an int8 pool's scales with them) and
        build a record with its full replay identity: prompt / generated
        split, sampling, trace context, logprobs, deadline and telemetry
        stamps. Only once every record is built are the sources released
        (journal finish, proposer drop, ``state.flush``), without counting
        an outcome: the request goes on at the destination. A fault in
        the gather loop (the ``during_handoff_gather`` site) therefore
        leaves every sequence live here. The records' ``kv`` is the
        device copy (rows, or (rows, scales) for an int8 pool); the
        caller moves it."""
        recs: List[Dict[str, Any]] = []
        blocks_moved = 0
        bytes_moved = 0
        for uid in batch_uids:
            seq = self.state.get(uid)
            if seq is None or not seq.kv_blocks or seq.in_flight \
                    or seq.status in (SequenceStatus.PAUSED,
                                      SequenceStatus.FINISHED):
                continue
            get_fault_injector().maybe_fire("during_handoff_gather")
            rows, scales = self.kv_cache.gather_blocks(seq.kv_blocks)
            recs.append({
                "uid": seq.uid,
                "prompt": list(seq.prompt_log),
                "generated": list(seq.gen_log),
                "sampling": seq.sampling.to_dict()
                if seq.sampling is not None else None,
                "trace": seq.trace_id,
                "seen_tokens": seq.seen_tokens,
                "blocks": len(seq.kv_blocks),
                "kv": rows if scales is None else (rows, scales),
                "logprobs": list(seq.logprob_log),
                "deadline_at": seq.deadline_at,
                "deadline_s": seq.deadline_s,
                "stamps": (seq.admitted_at, seq.first_sched_at,
                           seq.first_token_at, seq.last_token_at),
            })
            blocks_moved += len(seq.kv_blocks)
            bytes_moved += rows.numel() * rows.element_size()
            if scales is not None:
                bytes_moved += scales.numel() * scales.element_size()
        # released after every record is built: the loop above changes
        # no state
        for rec in recs:
            uid = rec["uid"]
            if self.journal is not None:
                self.journal.finish(uid)
            if self._proposer is not None:
                self._proposer.drop(uid)
            self.state.flush(uid)
        if recs and self._obs is not None:
            self._obs.on_handoff_out(len(recs), blocks_moved, bytes_moved)
        return {"version": 1, "source": "handoff", "time": time.time(),
                "seq_size": max(1, int(self.config.seq_size)),
                "sequences": recs}

    def handoff_in(self, manifest: Dict[str, Any],
                   exposed_s: float = 0.0) -> Dict[str, List[int]]:
        """Adopt migrated sequences from :meth:`handoff_out`'s manifest:
        reserve each record's block count, scatter its KV (host or
        device, scales with the rows) with one ``restore`` a sequence,
        and rebuild the descriptor so the next decode step continues the
        stream with no re-prefill. Blocks arrive private (never shared
        with the prefix cache). Records the pool cannot cover are
        returned in ``spilled`` for the caller to replay from their
        chains. ``exposed_s`` (the caller's measured, non-overlapped
        transfer time) is observed into ``serve_handoff_exposed_s``."""
        if self._draining():
            raise EngineDrainingError(
                "handoff_in() on a draining engine — migrate to a "
                "serving replica")
        accepted: List[int] = []
        spilled: List[int] = []
        blocks_in = 0
        for rec in manifest.get("sequences", []):
            uid = int(rec["uid"])
            if self.state.get(uid) is not None:
                raise ValueError(
                    f"handoff_in: sequence {uid} already live on this "
                    f"engine")
            nblocks = int(rec["blocks"])
            try:
                blocks = self.kv_cache.reserve(nblocks)
            except OutOfBlocksError:
                spilled.append(uid)
                continue
            kv = rec["kv"]
            self.kv_cache.restore(kv if isinstance(kv, tuple)
                                  else (kv, None), blocks)
            seq = self.state.get_or_create(uid)
            seq.kv_blocks = list(blocks)
            seq.prompt_log = list(rec["prompt"])
            seq.gen_log = list(rec["generated"])
            seq.prompt_len = len(seq.prompt_log)
            seq.seen_tokens = int(rec["seen_tokens"])
            seq.prefix_tokens = None     # never registered here: private
            seq.status = SequenceStatus.WAITING
            if rec.get("sampling"):
                seq.sampling = SamplingParams.from_dict(rec["sampling"])
            seq.trace_id = rec.get("trace")
            seq.logprob_log = list(rec.get("logprobs") or [])
            (seq.admitted_at, seq.first_sched_at, seq.first_token_at,
             seq.last_token_at) = rec.get("stamps") or (None,) * 4
            if rec.get("deadline_at") is not None:
                seq.deadline_at = rec["deadline_at"]
                seq.deadline_s = rec.get("deadline_s")
                self._has_deadlines = True
            if self.journal is not None:
                # the full chain as the admitted prompt, as a replay
                # admission would journal it
                self.journal.admit(
                    uid, seq.prompt_log + seq.gen_log,
                    sampling=rec.get("sampling"), trace=seq.trace_id)
            accepted.append(uid)
            blocks_in += nblocks
        if accepted and self._obs is not None:
            self._obs.on_handoff_in(len(accepted), blocks_in, exposed_s)
        return {"accepted": accepted, "spilled": spilled}

    def _staging_bufs(self, S: int, C: int) -> Tuple[torch.Tensor, ...]:
        """The next of ``pipeline_depth + 1`` reused staging sets for an
        [S, C] step, zeroed (top_p ones): tokens, start, ntok, tables,
        feed_mask, feed_idx, then seeds, spos, temps, topks, topps. On a
        card they are pinned, so the dispatch's copies run without the
        host waiting; the rotation keeps a set from being rewritten while
        a step that reads it may still be in flight (a set comes back
        only after its step was committed)."""
        pool = self._staging.get((S, C))
        if pool is None:
            MAXB = self.config.max_blocks_per_seq
            pin = self.device.type == "cuda"

            def buf(shape, dt):
                t = torch.zeros(shape, dtype=dt)
                return t.pin_memory() if pin else t

            i32, f32 = torch.int32, torch.float32
            pool = {"sets": [
                (buf((S, C), i32), buf((S,), i32), buf((S,), i32),
                 buf((S, MAXB), i32), buf((S,), i32), buf((S,), i32),
                 buf((S,), i32), buf((S,), i32), buf((S,), f32),
                 buf((S,), i32), buf((S,), f32))
                for _ in range(max(1, self.pipeline_depth) + 1)],
                "next": 0}
            self._staging[(S, C)] = pool
        bufs = pool["sets"][pool["next"]]
        pool["next"] = (pool["next"] + 1) % len(pool["sets"])
        for b in bufs[:-1]:
            b.zero_()
        bufs[-1].fill_(1.0)
        return bufs

    def _plan_step(self, greedy: bool = False,
                   eligible=None) -> Optional[_PlannedStep]:
        """PLAN: run the scheduler and stage the step's host arrays. Host
        work only: no device call, no readback."""
        t0 = time.perf_counter()
        sched = self.scheduler.schedule(eligible)
        if not sched:
            return None
        self._step_counter += 1
        self.state.step += 1
        for item in sched:
            item.seq.last_step = self._step_counter
            item.seq.last_sched = self.state.step
        if self._obs is not None:
            # first-schedule stamps -> the queue-wait histogram
            self._obs.on_sched(sched, time.monotonic())
        cfg = self.config
        # shape buckets: a pure-decode step (one token per slot) runs
        # [S, 1] instead of padding every slot to the prefill chunk; the
        # slot dim rounds up to a power of two (16 .. 512) within max_seqs
        C = 1 if all(len(item.tokens) == 1 for item in sched) \
            else cfg.effective_chunk
        S = cfg.max_seqs
        for b in (16, 32, 64, 128, 256, 512):
            if len(sched) <= b <= cfg.max_seqs:
                S = b
                break
        bufs = self._staging_bufs(S, C)
        (tokens, start, ntok, tables, feed_mask, feed_idx, seeds, spos,
         temps, topks, topps) = (b.numpy() for b in bufs)
        # a sampled sequence in the step: the sampler selects every slot's
        # token (greedy slots at temperature 0, the argmax); so does a
        # logprobs request, whose output must not depend on its batch
        use_sample = greedy and any(
            item.seq.sampling is not None
            and (not item.seq.sampling.greedy or item.seq.sampling.logprobs)
            for item in sched)
        has_feed = False
        for i, item in enumerate(sched):
            seq = item.seq
            if seq.spec_pending and item.tokens == [_SPEC_TOKEN]:
                # the placeholder's value is the latest dispatched step's
                # device output for this sequence: the step takes it there
                seq.spec_pending -= 1
                feed_mask[i] = 1
                feed_idx[i] = self._feed_slot[seq.uid]
                has_feed = True
            else:
                tokens[i, :len(item.tokens)] = item.tokens
            start[i] = item.start_pos
            ntok[i] = len(item.tokens)
            tables[i, :len(seq.kv_blocks)] = seq.kv_blocks
            if use_sample:
                # the fold_in operand: the position the selected token
                # will occupy, whatever the chunking or the depth
                stage_slot((seeds, spos, temps, topks, topps), i, seq,
                           item.start_pos + len(item.tokens))
        if any(len(item.tokens) > 1 for item in sched):
            # fault site: a replica dying with a freshly planned
            # multi-token prefill chunk (tokens consumed on the host, the
            # step never dispatched)
            get_fault_injector().maybe_fire("during_prefill_chunk")
        dt = time.perf_counter() - t0
        self.pipeline_stats["plan_s"] += dt
        if self._obs is not None:
            self._obs.on_plan(dt)
        return _PlannedStep(sched, *bufs[:6], has_feed, greedy,
                            sample=bufs[6:] if use_sample else None)

    def _to_device(self, t: Any) -> torch.Tensor:
        """A host array or tensor on the engine's device: a pinned tensor
        copies without the host waiting; on the CPU, a copy (the staging
        sets are reused)."""
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        if self.device.type == "cpu":
            return t.clone()
        return t.to(self.device, non_blocking=True)

    def _dispatch_step(self, plan: _PlannedStep) -> _InFlightStep:
        """DISPATCH: enqueue the step on the device and return without
        waiting for it. A greedy or sampled step's [S] token output
        becomes the feedback source of the next plan's placeholders."""
        # fault site: planned but not yet enqueued ("ioerror" is the
        # transient _dispatch_with_retry absorbs)
        get_fault_injector().maybe_fire("pre_dispatch")
        t0 = time.perf_counter()
        dev = self._to_device
        batch = RaggedBatch(tokens=dev(plan.tokens),
                            start_pos=dev(plan.start),
                            n_tokens=dev(plan.ntok),
                            block_tables=dev(plan.tables))
        pool = self.kv_cache.pool
        logprobs = None
        if plan.sample is not None:
            # one sampler step serves fed and unfed steps: an unfed step
            # passes its all-zero mask and a [1] dummy source
            prev = self._feed_src if plan.fed else self._no_feed
            result, logprobs = self.runner.step_sample_fb(
                self.params, pool, batch, prev, dev(plan.feed_mask),
                dev(plan.feed_idx), *(dev(t) for t in plan.sample))
            self.pipeline_stats["fed_steps"] += int(plan.fed)
        elif plan.fed:
            result = self.runner.step_greedy_fb(
                self.params, pool, batch, self._feed_src,
                dev(plan.feed_mask), dev(plan.feed_idx))
            self.pipeline_stats["fed_steps"] += 1
        elif plan.use_greedy:
            result = self.runner.step_greedy(self.params, pool, batch)
        else:
            result = self.runner.step(self.params, pool, batch)
        if plan.use_greedy:
            self._feed_src = result
            self._feed_slot = {item.seq.uid: i
                               for i, item in enumerate(plan.sched)}
        self.pipeline_stats["steps"] += 1
        dt = time.perf_counter() - t0
        self.pipeline_stats["dispatch_s"] += dt
        if self._obs is not None:
            self._obs.on_dispatch(dt, plan.fed)
        return _InFlightStep(plan.sched, result, plan.use_greedy,
                             logprobs=logprobs)

    def _readback(self, t: torch.Tensor) -> np.ndarray:
        """The one blocking device-to-host copy of a result: where the
        card's work shows up as host time (telemetry's
        ``device_execute``)."""
        self.pipeline_stats["readbacks"] += 1
        return t.cpu().numpy()

    def _pre_commit(self, fl: _InFlightStep):
        """Shared entry of both commit paths: the watchdog's and the
        flight ring's commit phase, the ``mid_commit`` fault site, then
        the step's blocking readback (its tokens or logits, and its
        logprobs only when a sequence of the step asked for them).
        Returns (result, logprobs or None)."""
        if self._watchdog is not None:
            self._watchdog.phase("commit")
        if self._obs is not None:
            self._obs.phase("commit", self._step_counter)
        get_fault_injector().maybe_fire("mid_commit")
        t0 = time.perf_counter()
        result = self._readback(fl.result)
        lps = None
        if fl.logprobs is not None and any(
                item.seq.sampling is not None and item.seq.sampling.logprobs
                for item in fl.sched):
            lps = self._readback(fl.logprobs)
        dt = time.perf_counter() - t0
        self.pipeline_stats["commit_block_s"] += dt
        if self._obs is not None:
            self._obs.on_commit_block(dt)
        return result, lps

    def _finish_commit(self, fl: _InFlightStep) -> None:
        """Shared exit of both commit paths: the EOS rollbacks, then the
        deferred abort flushes, that had to wait for this step to run. A
        rollback whose sequence was flushed meanwhile is a no-op (its
        blocks went back with the flush). Pending demotion copies are
        complete here (the readback synchronized the stream): they are
        materialized."""
        for seq, retract in fl.rollbacks:
            if self.state.get(seq.uid) is not seq:
                continue
            seq.seen_tokens -= retract
            self.state.trim_blocks(seq)
        for seq in fl.aborts:
            self._flush_uid(seq.uid)
        self.kv_cache.finalize_demotions()

    @staticmethod
    def _log_token(seq, i: int, lps) -> None:
        if lps is not None and seq.sampling is not None \
                and seq.sampling.logprobs:
            seq.logprob_log.append(float(lps[i]))

    def _commit_step(self, fl: _InFlightStep) -> Tuple[int, Dict[int, Any]]:
        """COMMIT (the put() path): read the step back and apply it to host
        state. Greedy or sampled last-chunk tokens extend each sequence's
        ``gen_log`` and the journal."""
        result, lps = self._pre_commit(fl)
        obs = self._obs
        now = time.monotonic() if obs is not None else 0.0
        t_apply = time.perf_counter() if obs is not None else 0.0
        out: Dict[int, Any] = {}
        journal_toks: Dict[int, List[int]] = {}
        for i, item in enumerate(fl.sched):
            if i in fl.dead or not item.is_last_chunk:
                continue
            if fl.use_greedy:
                tok = int(result[i])
                out[item.seq.uid] = tok
                item.seq.gen_log.append(tok)
                self._log_token(item.seq, i, lps)
                if self.journal is not None:
                    journal_toks[item.seq.uid] = [tok]
            else:
                out[item.seq.uid] = result[i]
            if obs is not None:
                # the last chunk's output is the request's first
                # host-visible result: TTFT / TPOT
                obs.on_token_commit(item.seq, now)
            item.seq.status = SequenceStatus.WAITING
        if self.journal is not None:
            self.journal.tokens(journal_toks)
        self._finish_commit(fl)
        if obs is not None:
            obs.on_commit_apply(time.perf_counter() - t_apply)
            obs.after_commit(self._step_counter)
        return len(fl.sched), out

    # ------------------------------------------------------------------ #
    # the pipelined decode
    # ------------------------------------------------------------------ #

    def decode_pipelined(self, batch_uids: Sequence[int],
                         first_tokens: Sequence[int], n,
                         eos_token_id: Optional[int] = None
                         ) -> Dict[int, List[int]]:
        """Decode up to ``n`` tokens per uid (an int, or a budget per uid)
        through the overlapped pipeline: planning and bookkeeping run
        ``pipeline_depth`` steps ahead of the delayed commit, and each
        step's input tokens come from the previous step's on-device token
        output. Sequences with SamplingParams are sampled on the device in
        the same pipeline. With ``spec_decode`` armed, a batch whose every
        sequence is greedy (no sampling, no logprobs) and has no pending
        tokens goes through :meth:`decode_spec` instead, with the same
        tokens.

        Scheduling past the newest committed token is speculative: when
        the delayed readback shows a sequence emitted ``eos_token_id`` (or
        reached its budget) at step k, its steps k+1.. already dispatched
        are killed (no token of theirs is emitted), and its positions and
        over-allocated KV blocks are rolled back once the last dead step
        has run (``StateManager.trim_blocks``).

        Sequences must have no pending tokens (drain with put() first);
        returns {uid: emitted tokens}, ending with eos when it fired. The
        stream is the synchronous path's."""
        if self.spec_mode != "off" and batch_uids and all(
                (s := self.state.get(u)) is not None
                and (s.sampling is None
                     or (s.sampling.greedy and not s.sampling.logprobs))
                and not s.in_flight for u in batch_uids):
            # sampled sequences would need rejection sampling, and a
            # logprobs request the sampler's per-token output, which the
            # verify pass does not produce
            return self.decode_spec(batch_uids, first_tokens, n,
                                    eos_token_id=eos_token_id)
        return self._decode_pipelined_impl(batch_uids, first_tokens, n,
                                           eos_token_id=eos_token_id)

    def _decode_pipelined_impl(self, batch_uids: Sequence[int],
                               first_tokens: Sequence[int], n,
                               eos_token_id: Optional[int] = None
                               ) -> Dict[int, List[int]]:
        cfg = self.config
        if len(batch_uids) != len(first_tokens):
            raise ValueError(
                f"{len(batch_uids)} uids but {len(first_tokens)} "
                f"first_tokens")
        if isinstance(n, (list, tuple)):
            budgets = {u: int(b) for u, b in zip(batch_uids, n)}
        else:
            budgets = {u: int(n) for u in batch_uids}
        seqs: Dict[int, Any] = {}
        for uid in batch_uids:
            seq = self.state.get(uid)
            if seq is None:
                raise ValueError(f"unknown sequence {uid}")
            if seq.in_flight:
                raise ValueError(f"sequence {uid} has pending tokens; "
                                 f"drain with put() first")
            seqs[uid] = seq
        for uid, seq in self.state.sequences.items():
            if uid not in budgets and seq.in_flight:
                raise ValueError(
                    f"sequence {uid} has pending tokens but is not in "
                    f"this decode batch")
        out: Dict[int, List[int]] = {u: [] for u in batch_uids}
        finished = {u for u in batch_uids if budgets[u] <= 0}
        inflight_n = {u: 0 for u in batch_uids}
        spec_src: Dict[int, _InFlightStep] = {}   # uid -> producer step
        for uid, t in zip(batch_uids, first_tokens):
            if uid not in finished:
                self.state.put_tokens(uid, [int(t)])
        self._feed_src, self._feed_slot = None, {}

        def eligible(seq):
            # a placeholder may be scheduled only while its producing step
            # is the latest dispatched (whose output is the feed source);
            # otherwise it waits for the producer's commit to patch it
            if seq.spec_pending and seq.pending_tokens \
                    and seq.pending_tokens[0] == _SPEC_TOKEN:
                return seq.uid in self._feed_slot
            return True

        def work_left():
            return any(seqs[u].in_flight for u in budgets
                       if u not in finished)

        def commit_one(ring):
            fl = ring.popleft()
            toks, lps = self._pre_commit(fl)
            obs = self._obs
            now = time.monotonic() if obs is not None else 0.0
            t_apply = time.perf_counter() if obs is not None else 0.0
            journal_toks: Dict[int, List[int]] = {}
            for i, item in enumerate(fl.sched):
                seq = item.seq
                u = seq.uid
                inflight_n[u] -= 1
                patch = spec_src.get(u) is fl
                if patch:
                    del spec_src[u]
                if i in fl.dead:
                    continue
                tok = int(toks[i])
                seq.status = SequenceStatus.WAITING
                out[u].append(tok)
                seq.gen_log.append(tok)
                self._log_token(seq, i, lps)
                if obs is not None:
                    obs.on_token_commit(seq, now)
                if self.journal is not None:
                    journal_toks.setdefault(u, []).append(tok)
                if patch and seq.spec_pending and seq.pending_tokens \
                        and seq.pending_tokens[0] == _SPEC_TOKEN:
                    # this step produced the queued placeholder, and its
                    # value is now known: feed it by value instead
                    seq.pending_tokens[0] = tok
                    seq.spec_pending -= 1
                if len(out[u]) < budgets[u] and \
                        (eos_token_id is None or tok != eos_token_id):
                    continue
                # the stop, seen on the delayed readback: kill everything
                # dispatched (or queued) past it. The queued next input,
                # placeholder or patched, exists only because of the
                # speculation: drop it
                finished.add(u)
                if seq.pending_tokens:
                    seq.pending_tokens.pop()
                    if seq.spec_pending:
                        seq.spec_pending -= 1
                    spec_src.pop(u, None)
                retract, last_fl = 0, None
                for fl2 in ring:
                    for j, item2 in enumerate(fl2.sched):
                        if item2.seq.uid == u and j not in fl2.dead:
                            fl2.dead.add(j)
                            retract += 1
                            last_fl = fl2
                if retract:
                    # the dead steps' KV appends still target the blocks
                    # being retracted: free them once the last has run
                    last_fl.rollbacks.append((seq, retract))
            if self.journal is not None:
                self.journal.tokens(journal_toks)
            self._finish_commit(fl)
            if obs is not None:
                obs.on_commit_apply(time.perf_counter() - t_apply)
                obs.after_commit(self._step_counter)

        def speculate(plan, fl):
            # every live sequence of this step gets a placeholder whose
            # value is this step's in-flight output; never past its
            # budget or its block capacity
            for item in plan.sched:
                seq = item.seq
                u = seq.uid
                if u not in budgets or u in finished:
                    continue
                inflight_n[u] += 1
                if len(out[u]) + inflight_n[u] < budgets[u] and \
                        seq.seen_tokens + seq.in_flight < cfg.max_context:
                    seq.pending_tokens.append(_SPEC_TOKEN)
                    seq.spec_pending += 1
                    spec_src[u] = fl

        self._drive_pipeline(
            work_left, lambda: self._plan_step(greedy=True,
                                               eligible=eligible),
            commit_one, on_dispatch=speculate)
        self._feed_src, self._feed_slot = None, {}
        return out

    # ------------------------------------------------------------------ #
    # speculative decoding (speculative.py)
    # ------------------------------------------------------------------ #

    def attach_draft(self, draft_model_cfg: Any, draft_params: Any,
                     draft_config: Optional[RaggedInferenceConfig] = None
                     ) -> "InferenceEngineV2":
        """Pair a small draft model with this engine for
        ``spec_decode="draft"``. The draft runs as its own engine on this
        engine's device, over the same slot and block geometry with its
        own KV pool, and must share the target's vocabulary. Its journal
        and telemetry are off and it never speculates itself: draft
        tokens are proposals, never served output. Returns the draft
        engine."""
        tv = getattr(self.runner.model_cfg, "vocab_size", None)
        dv = getattr(draft_model_cfg, "vocab_size", None)
        if tv != dv:
            raise ValueError(
                f"draft model vocab_size {dv} != target {tv}: a drafting "
                f"pair must share the tokenizer")
        if draft_config is None:
            draft_config = dataclasses.replace(
                self.config, prefix_cache=False, serve_pipeline_depth=0,
                spec_decode="off", serve_journal="",
                request_deadline_s=0.0, ep_size=1)
        draft = InferenceEngineV2(draft_model_cfg, draft_params,
                                  draft_config, device=self.device)
        draft.journal = None
        draft._obs = None
        draft.spec_mode = "off"
        self._draft_engine = draft
        self._proposer = None
        return draft

    def _spec_proposer(self):
        if self._proposer is None:
            from .speculative import build_proposer
            self._proposer = build_proposer(self)
        return self._proposer

    @property
    def spec_enabled(self) -> bool:
        """True when greedy decode routes through speculative decoding."""
        return self.spec_mode != "off"

    # ------------------------------------------------------------------ #
    # telemetry accessors (telemetry/serve.py; None or {} with
    # DSTPU_TELEMETRY=0)
    # ------------------------------------------------------------------ #

    @property
    def metrics(self):
        """This engine's MetricsRegistry (per engine, so a dead replica's
        and a survivor's stats never mix), or None."""
        return self._obs.registry if self._obs is not None else None

    @property
    def flight(self):
        """This engine's phase FlightRecorder, or None."""
        return self._obs.flight if self._obs is not None else None

    def slo_report(self) -> Dict[str, Any]:
        """TTFT / TPOT / queue-wait percentiles, outcome counts, goodput
        and speculation's acceptance for everything this engine served
        ({} with telemetry off). The step-time attribution is
        ``telemetry.attribution_report(eng.metrics.snapshot())``."""
        return self._obs.slo_report() if self._obs is not None else {}

    def decode_spec(self, batch_uids: Sequence[int],
                    first_tokens: Sequence[int], n,
                    eos_token_id: Optional[int] = None
                    ) -> Dict[int, List[int]]:
        """Speculative greedy decode. Each round a proposer drafts
        ``spec_k`` tokens a sequence, one verify pass of the decode loop
        (``draft_toks``) scores all K+1 positions, and the host commits
        the longest agreeing prefix plus the model's own token at the
        first disagreement (or the bonus token after a full acceptance):
        each round advances a sequence by 1 .. K+1 tokens.

        Rollback: the verify appended KV for all K+1 positions; the host
        retracts ``seen_tokens`` to the accepted length and frees the
        blocks past it by ``trim_blocks`` (cache-shared blocks are
        decref'd, never freed). Rows past the accepted length in a kept
        block are overwritten by the next round before anything reads
        them, and decode positions never lie in shared prefix blocks.

        Returns {uid: emitted tokens} as :meth:`decode_pipelined` does
        (budgets, eos truncation); sequences must have no pending tokens.
        Under KV pressure it pauses block holders and retries; sequences
        it cannot serve (pressure, or a context too near its cap for K+1
        more positions) finish on the pipelined path, which can shed."""
        from .speculative import accept_length
        cfg = self.config
        if len(batch_uids) != len(first_tokens):
            raise ValueError(
                f"{len(batch_uids)} uids but {len(first_tokens)} "
                f"first_tokens")
        if isinstance(n, (list, tuple)):
            budgets = {u: int(b) for u, b in zip(batch_uids, n)}
        else:
            budgets = {u: int(n) for u in batch_uids}
        seqs: Dict[int, Any] = {}
        for uid in batch_uids:
            seq = self.state.get(uid)
            if seq is None:
                raise ValueError(f"unknown sequence {uid}")
            if seq.in_flight:
                raise ValueError(f"sequence {uid} has pending tokens; "
                                 f"drain with put() first")
            seqs[uid] = seq
        out: Dict[int, List[int]] = {u: [] for u in batch_uids}
        last = {u: int(t) for u, t in zip(batch_uids, first_tokens)}
        live = {u for u in batch_uids if budgets[u] > 0}
        proposer = self._spec_proposer()
        K = self.spec_k
        # one verify length for every round: a budget's tail verifies a
        # few positions past it and the commit truncates
        L = K + 1
        S, MAXB = cfg.max_seqs, cfg.max_blocks_per_seq
        bs = cfg.block_size
        st = self.spec_stats
        # per-call staging: each round reads its verify back before the
        # next round rewrites these
        tok0 = np.zeros((S,), np.int32)
        start = np.zeros((S,), np.int32)
        active = np.zeros((S,), np.int32)
        tables = np.zeros((S, MAXB), np.int32)
        draft_arr = np.zeros((S, L), np.int32)
        obs = self._obs
        if obs is not None:
            # attribution window: each round is one verify dispatch and
            # one readback; accept / rollback bookkeeping is the apply
            obs.on_loop_enter()
        while live:
            if self._draining():
                # stop proposing: the outstanding budgets ride the drain
                break
            self._try_resume()
            for u in list(live):
                # shed or aborted out of band
                if seqs[u].status is SequenceStatus.FINISHED \
                        or u in self.rejections:
                    live.discard(u)
            ready = sorted(
                (u for u in live
                 if seqs[u].status is not SequenceStatus.PAUSED
                 # never verify past a sequence's context capacity: a
                 # straggler near its cap takes the pipelined path below
                 and seqs[u].seen_tokens + L <= cfg.max_context),
                key=lambda u: len(out[u]))[:S]
            if not ready:
                if live and self._relieve_kv_pressure():
                    continue
                break
            rem = {u: budgets[u] - len(out[u]) for u in ready}
            need = sum(seqs[u].blocks_needed(L, bs) for u in ready)
            if need > self.kv_cache.free_blocks or any(
                    len(seqs[u].kv_blocks)
                    + seqs[u].blocks_needed(L, bs) > MAXB
                    for u in ready):
                if self._relieve_kv_pressure():
                    continue
                break                       # irreducible pressure
            t0 = time.perf_counter()
            histories = [seqs[u].prompt_log + seqs[u].gen_log
                         for u in ready]
            drafts_list = proposer.propose_batch(
                [seqs[u] for u in ready], histories, K)
            t1 = time.perf_counter()
            for u in ready:
                self.state.ensure_blocks(seqs[u], L)
            for b in (tok0, start, active, tables, draft_arr):
                b.fill(0)
            for i, u in enumerate(ready):
                seq = seqs[u]
                tok0[i] = last[u]
                start[i] = seq.seen_tokens
                active[i] = 1
                tables[i, :len(seq.kv_blocks)] = seq.kv_blocks
                row = list(drafts_list[i])[:K]
                while len(row) < K:
                    # a short or absent proposal pads by repeating: a pad
                    # is a draft the verify may still accept
                    row.append(row[-1] if row else last[u])
                draft_arr[i, 0] = last[u]
                draft_arr[i, 1:] = row
            dev = self._to_device
            t_d = time.perf_counter()
            toks, _, _ = self.runner.decode_loop(
                self.params, self.kv_cache.pool, dev(tok0), dev(start),
                dev(active), dev(tables), L, draft_toks=dev(draft_arr))
            t_r = time.perf_counter()
            if obs is not None:
                obs.on_fused_dispatch(t_r - t_d)
            toks = self._readback(toks)
            t2 = time.perf_counter()
            if obs is not None:
                obs.on_commit_block(t2 - t_r)
            self.kv_cache.finalize_demotions()   # the readback synchronized
            self._step_counter += L
            now = time.monotonic() if obs is not None else 0.0
            round_prop = round_acc = 0
            journal_toks: Dict[int, List[int]] = {}
            for i, u in enumerate(ready):
                seq = seqs[u]
                emitted = [int(t) for t in toks[i]]
                d_row = [int(t) for t in draft_arr[i, 1:]]
                j = accept_length(d_row, emitted)
                acc = emitted[:j + 1]
                if len(acc) > rem[u]:
                    acc = acc[:rem[u]]
                if eos_token_id is not None and eos_token_id in acc:
                    acc = acc[:acc.index(eos_token_id) + 1]
                a = len(acc)
                seen0 = seq.seen_tokens
                # consumed inputs = committed tokens = a; the other L - a
                # appended positions are retracted (nothing is in flight:
                # the readback is done)
                seq.seen_tokens = seen0 + a
                self.state.trim_blocks(seq)
                seq.last_step = self._step_counter
                seq.status = SequenceStatus.WAITING
                # the replay chain: the fed first token joins gen_log
                # unless it is one of our own committed outputs
                hist = []
                if len(seq.prompt_log) + len(seq.gen_log) <= seen0:
                    hist.append(int(draft_arr[i, 0]))
                hist.extend(acc)
                seq.gen_log.extend(hist)
                out[u].extend(acc)
                last[u] = acc[-1]
                # acceptance over the committable window: drafts kept
                # (a - 1 of the consumed inputs) over the drafts that
                # could commit this round (rem - 1 at a budget's tail)
                prop_eff = min(K, rem[u] - 1)
                acc_drafts = min(j, a - 1)
                seq.spec_proposed += prop_eff
                seq.spec_accepted += acc_drafts
                st["proposed"] += prop_eff
                st["accepted"] += acc_drafts
                round_prop += prop_eff
                round_acc += acc_drafts
                proposer.observe_commit(seq, seen0, acc, d_row)
                if self.journal is not None:
                    journal_toks[u] = hist
                if obs is not None and a:
                    obs.on_token_commit(seq, now, n=a)
                    # a traced request's spec-round mark on its track
                    obs.on_spec_commit(seq, acc_drafts, prop_eff)
                if len(out[u]) >= budgets[u] or (
                        eos_token_id is not None
                        and acc[-1] == eos_token_id):
                    live.discard(u)
            if self.journal is not None:
                self.journal.tokens(journal_toks)
            st["rounds"] += 1
            st["propose_s"] += t1 - t0
            st["verify_s"] += t2 - t1
            dt = time.perf_counter() - t2
            st["commit_s"] += dt
            if obs is not None:
                obs.on_commit_apply(dt)
                obs.on_spec(round_prop, round_acc)
                obs.after_commit(self._step_counter)
        if obs is not None:
            obs.on_loop_exit()
        if live:
            # pressure or the context cap: the stragglers finish on the
            # pipelined path (which can shed)
            lu = sorted(live)
            res = self._decode_pipelined_impl(
                lu, [last[u] for u in lu],
                [budgets[u] - len(out[u]) for u in lu],
                eos_token_id=eos_token_id)
            for u in lu:
                out[u].extend(res.get(u) or [])
        return out

    # ------------------------------------------------------------------ #
    # the fused decode loop
    # ------------------------------------------------------------------ #

    def decode_greedy(self, batch_uids: Sequence[int],
                      first_tokens: Sequence[int],
                      n: int) -> Dict[int, List[int]]:
        """Back-compat wrapper: :meth:`decode_batch`."""
        return self.decode_batch(batch_uids, first_tokens, n)

    def _stage_loop_sampling(self, seqs, S: int, fallback=None
                             ) -> Dict[str, torch.Tensor]:
        """Per-slot sampling arrays for the decode loop: {} when every
        slot is greedy (the loop's greedy program), else seeds / temps /
        top_ks / top_ps on the device, greedy slots at temperature 0.
        ``fallback`` (any object with ``greedy``, ``temperature``,
        ``top_k``, ``top_p`` and ``seed``) applies to sequences without
        their own params, with per-uid seeds derived from its seed."""
        fb = fallback if fallback is not None and not fallback.greedy \
            else None
        if fb is None and not any(
                s.sampling is not None
                and (not s.sampling.greedy or s.sampling.logprobs)
                for s in seqs):
            return {}
        seeds = np.zeros((S,), np.int32)
        temps = np.zeros((S,), np.float32)
        topks = np.zeros((S,), np.int32)
        topps = np.ones((S,), np.float32)
        for i, seq in enumerate(seqs):
            p = seq.sampling
            if p is None and fb is not None:
                p = SamplingParams(
                    temperature=fb.temperature, top_k=fb.top_k,
                    top_p=fb.top_p,
                    seed=derive_seed(getattr(fb, "seed", None) or 0,
                                     seq.uid))
            if p is None or p.greedy:
                continue
            seeds[i] = seed_of(p, seq.uid)
            temps[i] = p.temperature
            topks[i] = min(p.top_k, SAMPLE_CANDIDATES)
            topps[i] = p.top_p
        return {"seeds": self._to_device(seeds),
                "temps": self._to_device(temps),
                "top_ks": self._to_device(topks),
                "top_ps": self._to_device(topps)}

    def decode_batch(self, batch_uids: Sequence[int],
                     first_tokens: Sequence[int], n: int,
                     sampling: Any = None,
                     eos_token_id: Optional[int] = None
                     ) -> Dict[int, List[int]]:
        """Decode ``n`` tokens for each uid through the runner's decode
        loop: one host sync per ``n`` tokens. Selection is greedy for
        sequences without sampling params, else the per-slot sampler with
        ``(seed, position)`` keys: one loop serves a mixed batch, and
        temperature 0 reproduces greedy. ``sampling`` is a per-call
        fallback for sequences without their own params. KV blocks for
        all n positions are reserved up front; raises OutOfBlocksError
        when the pool cannot cover them. ``first_tokens``: each sequence's
        next INPUT token (its KV is appended at position seen_tokens).
        With ``eos_token_id`` a slot freezes once it emits eos."""
        cfg = self.config
        if len(batch_uids) > cfg.max_seqs:
            raise ValueError(f"{len(batch_uids)} uids > max_seqs "
                             f"{cfg.max_seqs}")
        if len(batch_uids) != len(first_tokens):
            raise ValueError(
                f"{len(batch_uids)} uids but {len(first_tokens)} "
                f"first_tokens")
        seqs = []
        for uid in batch_uids:
            seq = self.state.get(uid)
            if seq is None or seq.status is SequenceStatus.PAUSED:
                raise ValueError(f"sequence {uid} missing or paused")
            if seq.in_flight:
                raise ValueError(f"sequence {uid} has pending tokens; "
                                 f"drain with put() first")
            seqs.append(seq)
        # reserve atomically: check the whole batch's demand first
        bsz = cfg.block_size
        need = 0
        for s_ in seqs:
            nb = s_.blocks_needed(n, bsz)
            if len(s_.kv_blocks) + nb > cfg.max_blocks_per_seq:
                raise OutOfBlocksError(
                    f"sequence {s_.uid} would exceed max_blocks_per_seq")
            need += nb
        if need > self.kv_cache.free_blocks:
            raise OutOfBlocksError(
                f"decode_batch needs {need} blocks, "
                f"{self.kv_cache.free_blocks} free")
        for seq in seqs:
            self.state.ensure_blocks(seq, n)

        S, MAXB = cfg.max_seqs, cfg.max_blocks_per_seq
        tok0 = np.zeros((S,), np.int32)
        start = np.zeros((S,), np.int32)
        active = np.zeros((S,), np.int32)
        tables = np.zeros((S, MAXB), np.int32)
        for i, (seq, t0) in enumerate(zip(seqs, first_tokens)):
            tok0[i] = t0
            start[i] = seq.seen_tokens
            active[i] = 1
            tables[i, :len(seq.kv_blocks)] = seq.kv_blocks
        samp = self._stage_loop_sampling(seqs, S, sampling)
        obs = self._obs
        if obs is not None:
            # attribution window of the fused path: one dispatch and one
            # blocking readback cover n steps; the bookkeeping after is
            # the commit apply
            obs.on_loop_enter()
        t_d = time.perf_counter()
        toks, lps, consumed = self.runner.decode_loop(
            self.params, self.kv_cache.pool, self._to_device(tok0),
            self._to_device(start), self._to_device(active),
            self._to_device(tables), n,
            eos_id=-1 if eos_token_id is None else int(eos_token_id),
            **samp)
        t_r = time.perf_counter()
        if obs is not None:
            obs.on_fused_dispatch(t_r - t_d)
        toks = self._readback(toks)
        lps = self._readback(lps) if lps is not None and any(
            s.sampling is not None and s.sampling.logprobs
            for s in seqs) else None
        consumed = self._readback(consumed) if consumed is not None \
            else None
        if obs is not None:
            obs.on_commit_block(time.perf_counter() - t_r)
        t_apply = time.perf_counter() if obs is not None else 0.0
        self.kv_cache.finalize_demotions()   # the readback synchronized
        self._step_counter += n
        now = time.monotonic() if obs is not None else 0.0
        out: Dict[int, List[int]] = {}
        journal_toks: Dict[int, List[int]] = {}
        for i, (uid, seq) in enumerate(zip(batch_uids, seqs)):
            used = int(consumed[i]) if consumed is not None else n
            hist = []
            if len(seq.prompt_log) + len(seq.gen_log) <= seq.seen_tokens:
                hist.append(int(first_tokens[i]))
            hist.extend(int(t) for t in toks[i][:used])
            seq.gen_log.extend(hist)
            if lps is not None and seq.sampling is not None \
                    and seq.sampling.logprobs:
                seq.logprob_log.extend(float(v) for v in lps[i][:used])
            if self.journal is not None:
                journal_toks[uid] = hist
            seq.seen_tokens += used
            seq.last_step = self._step_counter
            seq.status = SequenceStatus.WAITING
            out[uid] = toks[i].tolist()
            if obs is not None and used > 0:
                # one fused chunk commits `used` tokens at one stamp:
                # TPOT is the interval split evenly
                obs.on_token_commit(seq, now, n=used)
        if self.journal is not None:
            self.journal.tokens(journal_toks)
        if obs is not None:
            obs.on_commit_apply(time.perf_counter() - t_apply)
            obs.after_commit(self._step_counter)
            obs.on_loop_exit()
        return out

    # ------------------------------------------------------------------ #

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None,
                 seed: int = 0) -> List[List[int]]:
        """Continuous-batching generation: prompts enter the scheduler
        together; then ``decode_loop_steps`` tokens per device call
        through the decode loop while the pool covers them, and the
        pipelined decode (``serve_pipeline_depth`` > 0) or token-at-a-time
        put() steps for the tail. ``sampling`` (temperature, top_k,
        top_p) applies to every prompt, sampled on the device with
        per-uid seeds ``derive_seed(seed, uid)``; None or temperature 0 is
        greedy."""
        greedy = sampling is None or sampling.greedy
        uids = list(range(len(prompts)))
        if max_new_tokens <= 0:
            return [[] for _ in uids]
        sp_map = None
        if not greedy:
            sp_map = {u: SamplingParams(
                temperature=sampling.temperature, top_k=sampling.top_k,
                top_p=sampling.top_p, seed=derive_seed(seed, u))
                for u in uids}
        live = set(uids)
        outputs: Dict[int, List[int]] = {u: [] for u in uids}
        last_tok: Dict[int, int] = {}

        def drop_rejected():
            # shed or deadline-aborted requests leave with what they got;
            # their records stay in self.rejections
            for u in list(live):
                if u in self.rejections:
                    live.discard(u)

        t0 = time.perf_counter()
        results = self.put(uids, [list(p) for p in prompts], _greedy=True,
                           sampling=sp_map)
        t1 = time.perf_counter()
        self.timing["prefill_s"] += t1 - t0
        self.timing["prefill_tokens"] += sum(len(p) for p in prompts)
        drop_rejected()
        for u in uids:
            if u not in results:
                live.discard(u)
                continue
            nxt = host_token(results[u])
            outputs[u].append(nxt)
            if (eos_token_id is not None and nxt == eos_token_id) or \
                    max_new_tokens <= 1:
                live.discard(u)
                self.flush(u)
            else:
                last_tok[u] = nxt
        N = self.config.decode_loop_steps

        def finish_chunk(u, toks):
            toks = toks[:max_new_tokens - len(outputs[u])]
            if not toks:
                return
            if eos_token_id is not None and eos_token_id in toks:
                cut = toks.index(eos_token_id)
                outputs[u].extend(toks[:cut + 1])
                live.discard(u)
                self.flush(u)
            else:
                outputs[u].extend(toks)
                last_tok[u] = toks[-1]
                if len(outputs[u]) >= max_new_tokens:
                    live.discard(u)
                    self.flush(u)

        while live:
            self._try_resume()
            lu = sorted(live)
            # pause/resume lets sequences progress unevenly: loop by the
            # least remaining budget; shorter tails take the per-step paths
            need = min(max_new_tokens - len(outputs[u]) for u in lu)
            if N > 1 and need >= N and len(lu) <= self.config.max_seqs:
                # under KV pressure, pause the least recently scheduled
                # holders and keep the loop running on the rest; paused
                # sequences resume on later rounds
                outs = None
                ready = [u for u in lu if self.state.sequences[u].status
                         is not SequenceStatus.PAUSED]
                while ready:
                    try:
                        outs = self.decode_batch(
                            ready, [last_tok[u] for u in ready], N,
                            sampling=sampling, eos_token_id=eos_token_id)
                        break
                    except OutOfBlocksError:
                        if not self._relieve_kv_pressure():
                            break
                        ready = [u for u in ready
                                 if self.state.sequences[u].status
                                 is not SequenceStatus.PAUSED]
                if outs:
                    for u in list(outs):
                        finish_chunk(u, outs[u])
                    continue
            if self.pipeline_depth > 0:
                # the pipelined tail: per-step decode with device token
                # feedback, commits (and EOS) lagging pipeline_depth steps
                outs = self.decode_pipelined(
                    lu, [last_tok[u] for u in lu],
                    [max_new_tokens - len(outputs[u]) for u in lu],
                    eos_token_id=eos_token_id)
                for u in lu:
                    finish_chunk(u, outs[u])
                drop_rejected()
                continue
            # depth 0: token-at-a-time
            results = self.put(lu, [[last_tok[u]] for u in lu], _greedy=True)
            drop_rejected()
            for u in lu:
                if u not in results:
                    live.discard(u)
                    continue
                nxt = host_token(results[u])
                outputs[u].append(nxt)
                if (eos_token_id is not None and nxt == eos_token_id) or \
                        len(outputs[u]) >= max_new_tokens:
                    live.discard(u)
                    self.flush(u)
                else:
                    last_tok[u] = nxt
        self.timing["decode_s"] += time.perf_counter() - t1
        self.timing["decode_tokens"] += sum(len(o) for o in outputs.values()) \
            - len([u for u in uids if outputs[u]])
        return [outputs[u] for u in uids]
