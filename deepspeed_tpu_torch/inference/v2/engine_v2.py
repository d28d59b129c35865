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
threefry keys. Prefix caching, pause/offload, drain/replay, speculative
decoding and telemetry are not ported yet (``config.py`` refuses their
knobs); a pool too small for the pending work raises.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils.device import resolve_device
from ...utils.dtypes import resolve_dtype
from .blocked_allocator import OutOfBlocksError
from .config import RaggedInferenceConfig
from .kv_cache import BlockedKVCache
from .llama_runner import LlamaRaggedRunner
from .model_runner import RaggedBatch
from .sampling import (SAMPLE_CANDIDATES, SamplingParams, derive_seed,
                       host_token, seed_of, stage_slot)
from .scheduler import SplitFuseScheduler
from .sequence import SequenceStatus
from .state_manager import StateManager

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
    commit needs. ``dead`` slots were killed by a later-seen EOS (their
    readback is discarded); ``rollbacks`` are (seq, n_tokens) retractions
    that wait for THIS step to have run, since its KV appends still
    target the blocks they free."""

    __slots__ = ("sched", "result", "use_greedy", "dead", "rollbacks",
                 "logprobs")

    def __init__(self, sched, result, use_greedy, logprobs=None):
        self.sched = sched
        self.result = result
        self.use_greedy = use_greedy
        self.dead: set = set()
        self.rollbacks: List[Tuple[Any, int]] = []
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


class InferenceEngineV2:
    def __init__(self, model_cfg: Any, params: Any,
                 config: Optional[RaggedInferenceConfig] = None,
                 device: Any = None):
        """``model_cfg``: a :class:`~...models.llama.LlamaConfig`.
        ``params``: its parameter tree (``checkpoint/jax_params.py``),
        dense or weight-only-quantized (``inference/quantization.py``),
        moved to ``device`` if it lives elsewhere. ``device`` defaults to
        ``cuda`` and raises without a card; pass ``"cpu"`` for the plain
        path."""
        self.device = resolve_device(device)
        self.config = config or RaggedInferenceConfig()
        self.config.validate(model_cfg)
        self.model_cfg = model_cfg
        self.runner = LlamaRaggedRunner(model_cfg, self.config)
        self.params = _move_tree(params, self.device)
        self.kv_cache = BlockedKVCache(
            self.config, self.runner.num_layers, self.runner.kv_heads,
            self.runner.head_dim, dtype=resolve_dtype(self.config.dtype),
            device=self.device)
        self.state = StateManager(self.config, self.kv_cache)
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
        self.pipeline_stats = {"steps": 0, "fed_steps": 0, "plan_s": 0.0,
                               "dispatch_s": 0.0, "commit_block_s": 0.0,
                               "readbacks": 0}
        #: host wall time of generate's phases: the prompt put() (prefill,
        #: ends in the readback of its last step) and everything after
        #: (decode), with the tokens each produced
        self.timing = {"prefill_s": 0.0, "decode_s": 0.0,
                       "prefill_tokens": 0, "decode_tokens": 0}

    # ------------------------------------------------------------------ #
    # reference-parity surface
    # ------------------------------------------------------------------ #

    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[Sequence[int]],
            _greedy: bool = False,
            sampling: Optional[Dict[int, SamplingParams]] = None
            ) -> Dict[int, Any]:
        """Feed tokens, run scheduled steps until all fed work is consumed,
        and return {uid: last-token logits (numpy [V] fp32)} for sequences
        with no pending work, or {uid: token id} on the ``_greedy`` path
        that :meth:`generate` uses (selected on the device). ``sampling``
        maps uid -> :class:`SamplingParams`, attached to a fresh sequence
        for its life: on the ``_greedy`` path its tokens are sampled on
        the device (temperature 0 is the greedy token). Steps run through
        the pipeline (``serve_pipeline_depth``). A fresh prompt that
        could never fit the KV pool raises OutOfBlocksError."""
        bs = self.config.block_size
        for uid, toks in zip(batch_uids, batch_tokens):
            seq0 = self.state.get(uid)
            fresh = seq0 is None or (seq0.seen_tokens == 0
                                     and not seq0.kv_blocks)
            need = -(-(len(toks) + 1) // bs)
            if fresh and need > self.config.num_blocks:
                raise OutOfBlocksError(
                    f"sequence {uid}: prompt needs {need} blocks, the pool "
                    f"has {self.config.num_blocks}")
            seq = self.state.put_tokens(uid, toks)
            if fresh and sampling and sampling.get(uid) is not None:
                seq.sampling = sampling[uid]
        done: Dict[int, Any] = {}

        def work_left():
            return any(s.in_flight for s in self.state.sequences.values())

        def commit_one(ring):
            _, step_done = self._commit_step(ring.popleft())
            done.update(step_done)

        self._drive_pipeline(
            work_left, lambda: self._plan_step(greedy=_greedy), commit_one)
        return done

    def query(self, uid: int) -> Tuple[int, int]:
        """(tokens seen, max additional tokens before block exhaustion)."""
        seq = self.state.get_or_create(uid)
        free_local = self.config.max_blocks_per_seq - len(seq.kv_blocks)
        free = min(free_local, self.kv_cache.free_blocks)
        slack = len(seq.kv_blocks) * self.config.block_size - seq.seen_tokens
        return seq.seen_tokens, slack + free * self.config.block_size

    def flush(self, uid: int) -> None:
        """Release a sequence and its KV blocks."""
        self.state.flush(uid)

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
        dispatch), then commit the oldest. ``commit_one(ring)`` pops and
        applies the oldest step; ``on_dispatch(plan, fl)`` runs after each
        dispatch. Nothing schedulable with nothing in flight is a pool too
        small for the pending work: pause/offload of idle sequences is
        not ported, so that raises."""
        depth = max(1, self.pipeline_depth)
        ring: deque = deque()
        while ring or work_left():
            while len(ring) < depth and work_left():
                plan = make_plan()
                if plan is None:
                    break
                fl = self._dispatch_step(plan)
                ring.append(fl)
                if on_dispatch is not None:
                    on_dispatch(plan, fl)
            if ring:
                commit_one(ring)
                continue
            if work_left():
                raise RuntimeError(
                    "scheduler starved: KV pool too small for the pending "
                    f"work (free blocks={self.kv_cache.free_blocks})")

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
        cfg = self.config
        # shape buckets: a pure-decode step (one token per slot) runs
        # [S, 1] instead of padding every slot to the chunk; the slot dim
        # rounds up to a power of two (16 .. 512) within max_seqs
        C = 1 if all(len(item.tokens) == 1 for item in sched) \
            else cfg.chunk_size
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
        self.pipeline_stats["plan_s"] += time.perf_counter() - t0
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
            self.pipeline_stats["fed_steps"] += int(plan.fed)
            result, logprobs = self.runner.step_sample_fb(
                self.params, pool, batch, prev, dev(plan.feed_mask),
                dev(plan.feed_idx), *(dev(t) for t in plan.sample))
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
        self.pipeline_stats["dispatch_s"] += time.perf_counter() - t0
        return _InFlightStep(plan.sched, result, plan.use_greedy,
                             logprobs=logprobs)

    def _readback(self, t: torch.Tensor) -> np.ndarray:
        """The one blocking device-to-host copy of a result."""
        self.pipeline_stats["readbacks"] += 1
        return t.cpu().numpy()

    def _pre_commit(self, fl: _InFlightStep):
        """Shared entry of both commit paths: the step's blocking readback
        (its tokens or logits, and its logprobs only when a sequence of
        the step asked for them). Returns (result, logprobs or None)."""
        t0 = time.perf_counter()
        result = self._readback(fl.result)
        lps = None
        if fl.logprobs is not None and any(
                item.seq.sampling is not None and item.seq.sampling.logprobs
                for item in fl.sched):
            lps = self._readback(fl.logprobs)
        self.pipeline_stats["commit_block_s"] += time.perf_counter() - t0
        return result, lps

    def _finish_commit(self, fl: _InFlightStep) -> None:
        """Shared exit of both commit paths: the EOS rollbacks that had to
        wait for this step to run. A rollback whose sequence was flushed
        meanwhile is a no-op (its blocks went back with the flush)."""
        for seq, retract in fl.rollbacks:
            if self.state.get(seq.uid) is not seq:
                continue
            seq.seen_tokens -= retract
            self.state.trim_blocks(seq)

    @staticmethod
    def _log_token(seq, i: int, lps) -> None:
        if lps is not None and seq.sampling is not None \
                and seq.sampling.logprobs:
            seq.logprob_log.append(float(lps[i]))

    def _commit_step(self, fl: _InFlightStep) -> Tuple[int, Dict[int, Any]]:
        """COMMIT (the put() path): read the step back and apply it to host
        state. Greedy or sampled last-chunk tokens extend each sequence's
        ``gen_log``."""
        result, lps = self._pre_commit(fl)
        out: Dict[int, Any] = {}
        for i, item in enumerate(fl.sched):
            if i in fl.dead or not item.is_last_chunk:
                continue
            if fl.use_greedy:
                tok = int(result[i])
                out[item.seq.uid] = tok
                item.seq.gen_log.append(tok)
                self._log_token(item.seq, i, lps)
            else:
                out[item.seq.uid] = result[i]
            item.seq.status = SequenceStatus.WAITING
        self._finish_commit(fl)
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
        the same pipeline. Speculative decoding (``decode_spec``) is not
        ported yet (queue item A5.2).

        Scheduling past the newest committed token is speculative: when
        the delayed readback shows a sequence emitted ``eos_token_id`` (or
        reached its budget) at step k, its steps k+1.. already dispatched
        are killed (no token of theirs is emitted), and its positions and
        over-allocated KV blocks are rolled back once the last dead step
        has run (``StateManager.trim_blocks``).

        Sequences must have no pending tokens (drain with put() first);
        returns {uid: emitted tokens}, ending with eos when it fired. The
        stream is the synchronous path's."""
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
            self._finish_commit(fl)

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
            if seq is None:
                raise ValueError(f"sequence {uid} missing")
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
        toks, lps, consumed = self.runner.decode_loop(
            self.params, self.kv_cache.pool, self._to_device(tok0),
            self._to_device(start), self._to_device(active),
            self._to_device(tables), n,
            eos_id=-1 if eos_token_id is None else int(eos_token_id),
            **samp)
        toks = self._readback(toks)
        lps = self._readback(lps) if lps is not None and any(
            s.sampling is not None and s.sampling.logprobs
            for s in seqs) else None
        consumed = self._readback(consumed) if consumed is not None \
            else None
        self._step_counter += n
        out: Dict[int, List[int]] = {}
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
            seq.seen_tokens += used
            seq.last_step = self._step_counter
            seq.status = SequenceStatus.WAITING
            out[uid] = toks[i].tolist()
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

        t0 = time.perf_counter()
        results = self.put(uids, [list(p) for p in prompts], _greedy=True,
                           sampling=sp_map)
        t1 = time.perf_counter()
        self.timing["prefill_s"] += t1 - t0
        self.timing["prefill_tokens"] += sum(len(p) for p in prompts)
        for u in uids:
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
            lu = sorted(live)
            need = min(max_new_tokens - len(outputs[u]) for u in lu)
            if N > 1 and need >= N and len(lu) <= self.config.max_seqs:
                try:
                    outs = self.decode_batch(
                        lu, [last_tok[u] for u in lu], N,
                        sampling=sampling, eos_token_id=eos_token_id)
                except OutOfBlocksError:
                    outs = None        # pool too tight: the per-step paths
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
                continue
            # depth 0: token-at-a-time
            results = self.put(lu, [[last_tok[u]] for u in lu], _greedy=True)
            for u in lu:
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
