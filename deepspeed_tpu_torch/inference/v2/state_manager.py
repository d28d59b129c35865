"""Sequence state manager (port of
``deepspeed_tpu/inference/v2/state_manager.py``).

Tracks live sequences, grows their KV block allocations as tokens arrive,
and frees state on flush. The prefix-cache and host-offload tiers of the
JAX manager are not ported yet: every block here is private to one
sequence and goes straight back to the allocator.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from .blocked_allocator import OutOfBlocksError
from .config import RaggedInferenceConfig
from .kv_cache import BlockedKVCache
from .sequence import SequenceDescriptor, SequenceStatus


class StateManager:
    def __init__(self, cfg: RaggedInferenceConfig, kv_cache: BlockedKVCache):
        self.cfg = cfg
        self.kv_cache = kv_cache
        self._seqs: Dict[int, SequenceDescriptor] = {}
        # scheduler clock: one tick per scheduler invocation (bumped by the
        # engine's plan phase); new sequences stamp their arrival here
        self.step: int = 0

    def get_or_create(self, uid: int) -> SequenceDescriptor:
        if uid not in self._seqs:
            self._seqs[uid] = SequenceDescriptor(uid=uid,
                                                 last_sched=self.step)
        return self._seqs[uid]

    def get(self, uid: int) -> Optional[SequenceDescriptor]:
        return self._seqs.get(uid)

    @property
    def sequences(self) -> Dict[int, SequenceDescriptor]:
        return self._seqs

    def put_tokens(self, uid: int, tokens: Iterable[int]) -> SequenceDescriptor:
        seq = self.get_or_create(uid)
        toks = [int(t) for t in tokens]
        fresh = seq.seen_tokens == 0 and not seq.kv_blocks
        if fresh:
            # still a fresh prompt: the fed tokens are prompt
            seq.prompt_log.extend(toks)
        else:
            # continuation feed: a token is new history unless it is one
            # of our own committed outputs being fed back
            unfed = len(seq.prompt_log) + len(seq.gen_log) \
                - seq.seen_tokens - len(seq.pending_tokens)
            seq.gen_log.extend(toks[max(0, unfed):])
        seq.pending_tokens.extend(toks)
        if fresh:
            seq.prompt_len = seq.in_flight
        if seq.status is not SequenceStatus.RUNNING:
            seq.status = SequenceStatus.WAITING
        total = seq.seen_tokens + seq.in_flight
        if total > self.cfg.max_context:
            raise ValueError(
                f"sequence {uid}: {total} tokens exceeds max_context "
                f"{self.cfg.max_context} (raise max_blocks_per_seq)")
        return seq

    def can_schedule(self, uid: int, n_tokens: int) -> bool:
        """Would `n_tokens` more tokens fit in blocks we can still
        allocate?"""
        seq = self.get_or_create(uid)
        need = seq.blocks_needed(n_tokens, self.cfg.block_size)
        return (need <= self.kv_cache.free_blocks
                and len(seq.kv_blocks) + need <= self.cfg.max_blocks_per_seq)

    def ensure_blocks(self, seq: SequenceDescriptor, n_tokens: int) -> None:
        need = seq.blocks_needed(n_tokens, self.cfg.block_size)
        if need:
            if len(seq.kv_blocks) + need > self.cfg.max_blocks_per_seq:
                raise OutOfBlocksError(
                    f"sequence {seq.uid} exceeds max_blocks_per_seq "
                    f"({self.cfg.max_blocks_per_seq})")
            seq.kv_blocks.extend(self.kv_cache.reserve(need))

    def trim_blocks(self, seq: SequenceDescriptor) -> int:
        """Free the KV blocks beyond what ``seq.seen_tokens`` needs: the
        rollback of the pipeline's EOS retraction (the caller has already
        retracted ``seen_tokens``). Stale KV inside the kept tail block is
        harmless: appends are addressed by position, so the next tokens
        overwrite it. Returns the number of blocks freed."""
        needed = -(-seq.seen_tokens // self.cfg.block_size)
        extra = seq.kv_blocks[needed:]
        if extra:
            del seq.kv_blocks[needed:]
            self.kv_cache.free(extra)
        return len(extra)

    def flush(self, uid: int) -> None:
        """Release a sequence and its KV blocks."""
        seq = self._seqs.pop(uid, None)
        if seq is not None and seq.kv_blocks:
            self.kv_cache.free(seq.kv_blocks)
