"""InferenceEngineV2 — continuous-batching ragged engine (port of
``deepspeed_tpu/inference/v2/engine_v2.py``).

``put(batch_uids, batch_tokens)`` feeds tokens for any mix of new prompts
and decode continuations, runs steps over whatever the SplitFuse scheduler
picked, and returns last-token results for every sequence that finished
its pending work. ``decode_batch`` runs ``n`` greedy decode steps with one
host sync; ``generate`` drives both for a batch of prompts.

Each step splits into plan (host: scheduler + staged arrays), dispatch
(the runner's step on the device) and commit (readback and bookkeeping),
run synchronously: this is the JAX package's pipeline at depth 0, its
parity oracle. Greedy selection only; sampled decoding, the pipelined
loop, prefix caching, pause/offload, drain/replay and telemetry are not
ported yet (``config.py`` refuses their knobs).
"""

from __future__ import annotations

import time
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
from .sampling import SamplingParams, host_token
from .scheduler import SplitFuseScheduler
from .sequence import SequenceStatus
from .state_manager import StateManager


class _PlannedStep:
    """Host half of one step: the schedule plus its staged numpy arrays."""

    __slots__ = ("sched", "tokens", "start", "ntok", "tables", "use_greedy")

    def __init__(self, sched, tokens, start, ntok, tables, use_greedy):
        self.sched = sched
        self.tokens = tokens
        self.start = start
        self.ntok = ntok
        self.tables = tables
        self.use_greedy = use_greedy


class _InFlightStep:
    """A dispatched, uncommitted step: its device result."""

    __slots__ = ("sched", "result", "use_greedy")

    def __init__(self, sched, result, use_greedy):
        self.sched = sched
        self.result = result
        self.use_greedy = use_greedy


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
            _greedy: bool = False) -> Dict[int, Any]:
        """Feed tokens, run scheduled steps until all fed work is consumed,
        and return {uid: last-token logits (numpy [V] fp32)} for sequences
        with no pending work, or {uid: argmax token id} on the ``_greedy``
        path that :meth:`generate` uses. A fresh prompt that could never
        fit the KV pool raises OutOfBlocksError."""
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
            self.state.put_tokens(uid, toks)
        done: Dict[int, Any] = {}
        while any(s.in_flight for s in self.state.sequences.values()):
            plan = self._plan_step(greedy=_greedy)
            if plan is None:
                # nothing schedulable: pause/offload of idle holders is
                # not ported, so a pool this small is a hard error
                raise RuntimeError(
                    "scheduler starved: KV pool too small for the pending "
                    f"work (free blocks={self.kv_cache.free_blocks})")
            _, step_done = self._commit_step(self._dispatch_step(plan))
            done.update(step_done)
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

    # ------------------------------------------------------------------ #
    # the serving path: plan -> dispatch -> commit
    # ------------------------------------------------------------------ #

    def _plan_step(self, greedy: bool = False) -> Optional[_PlannedStep]:
        """PLAN: run the scheduler and stage the step's host arrays."""
        sched = self.scheduler.schedule()
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
        tokens = np.zeros((S, C), np.int32)
        start = np.zeros((S,), np.int32)
        ntok = np.zeros((S,), np.int32)
        tables = np.zeros((S, cfg.max_blocks_per_seq), np.int32)
        for i, item in enumerate(sched):
            seq = item.seq
            tokens[i, :len(item.tokens)] = item.tokens
            start[i] = item.start_pos
            ntok[i] = len(item.tokens)
            tables[i, :len(seq.kv_blocks)] = seq.kv_blocks
        return _PlannedStep(sched, tokens, start, ntok, tables, greedy)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device, non_blocking=True)

    def _dispatch_step(self, plan: _PlannedStep) -> _InFlightStep:
        """DISPATCH: run the step on the device (CUDA launches return
        before the device finishes; commit's readback waits)."""
        batch = RaggedBatch(tokens=self._to_device(plan.tokens),
                            start_pos=self._to_device(plan.start),
                            n_tokens=self._to_device(plan.ntok),
                            block_tables=self._to_device(plan.tables))
        pool = self.kv_cache.pool
        if plan.use_greedy:
            result = self.runner.step_greedy(self.params, pool, batch)
        else:
            result = self.runner.step(self.params, pool, batch)
        return _InFlightStep(plan.sched, result, plan.use_greedy)

    def _commit_step(self, fl: _InFlightStep) -> Tuple[int, Dict[int, Any]]:
        """COMMIT: read the step back and apply it to host state. Greedy
        last-chunk tokens extend each sequence's ``gen_log``."""
        result = fl.result.cpu().numpy()
        out: Dict[int, Any] = {}
        for i, item in enumerate(fl.sched):
            if not item.is_last_chunk:
                continue
            if fl.use_greedy:
                tok = int(result[i])
                out[item.seq.uid] = tok
                item.seq.gen_log.append(tok)
            else:
                out[item.seq.uid] = result[i]
            item.seq.status = SequenceStatus.WAITING
        return len(fl.sched), out

    # ------------------------------------------------------------------ #
    # fused greedy decode
    # ------------------------------------------------------------------ #

    def decode_greedy(self, batch_uids: Sequence[int],
                      first_tokens: Sequence[int],
                      n: int) -> Dict[int, List[int]]:
        """Back-compat wrapper: :meth:`decode_batch`."""
        return self.decode_batch(batch_uids, first_tokens, n)

    def decode_batch(self, batch_uids: Sequence[int],
                     first_tokens: Sequence[int], n: int,
                     eos_token_id: Optional[int] = None
                     ) -> Dict[int, List[int]]:
        """Greedy-decode ``n`` tokens for each uid through the runner's
        decode loop: one host sync per ``n`` tokens. KV blocks for all n
        positions are reserved up front; raises OutOfBlocksError when the
        pool cannot cover them. ``first_tokens``: each sequence's next
        INPUT token (its KV is appended at position seen_tokens). With
        ``eos_token_id`` a slot freezes once it emits eos."""
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
        toks, consumed = self.runner.decode_loop(
            self.params, self.kv_cache.pool, self._to_device(tok0),
            self._to_device(start), self._to_device(active),
            self._to_device(tables), n,
            eos_id=-1 if eos_token_id is None else int(eos_token_id))
        toks = toks.cpu().numpy()
        consumed = consumed.cpu().numpy() if consumed is not None else None
        self._step_counter += n
        out: Dict[int, List[int]] = {}
        for i, (uid, seq) in enumerate(zip(batch_uids, seqs)):
            used = int(consumed[i]) if consumed is not None else n
            hist = []
            if len(seq.prompt_log) + len(seq.gen_log) <= seq.seen_tokens:
                hist.append(int(first_tokens[i]))
            hist.extend(int(t) for t in toks[i][:used])
            seq.gen_log.extend(hist)
            seq.seen_tokens += used
            seq.last_step = self._step_counter
            seq.status = SequenceStatus.WAITING
            out[uid] = toks[i].tolist()
        return out

    # ------------------------------------------------------------------ #

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None
                 ) -> List[List[int]]:
        """Greedy continuous-batching generation: prompts enter the
        scheduler together; then ``decode_loop_steps`` tokens per device
        call through the decode loop while the pool covers them, and
        token-at-a-time put() steps for the tail."""
        if sampling is not None and not sampling.greedy:
            raise NotImplementedError(
                "sampled decoding is not ported yet (greedy only)")
        uids = list(range(len(prompts)))
        if max_new_tokens <= 0:
            return [[] for _ in uids]
        live = set(uids)
        outputs: Dict[int, List[int]] = {u: [] for u in uids}
        last_tok: Dict[int, int] = {}

        t0 = time.perf_counter()
        results = self.put(uids, [list(p) for p in prompts], _greedy=True)
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
                        eos_token_id=eos_token_id)
                except OutOfBlocksError:
                    outs = None        # pool too tight: the put() path
                if outs:
                    for u in list(outs):
                        finish_chunk(u, outs[u])
                    continue
            # tails / tiny budgets: token-at-a-time
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
