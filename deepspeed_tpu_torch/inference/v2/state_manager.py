"""Sequence state manager (port of
``deepspeed_tpu/inference/v2/state_manager.py``).

Tracks live sequences, grows their KV block allocations as tokens arrive,
and frees state on flush. With prefix caching on (``prefix_cache.py``)
the manager is also the refcount boundary: a sequence's leading blocks
may be cache-shared (``seq.shared``), and every release path — flush, the
pipelined EOS rollback's ``trim_blocks``, the engine's pause — decrefs
shared blocks through the cache instead of freeing them. ``match_prefix``
and ``register_prefix`` are the two host-side halves of prefix reuse; the
engine enqueues the device copies a match asks for.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .blocked_allocator import OutOfBlocksError
from .config import RaggedInferenceConfig
from .kv_cache import BlockedKVCache
from .prefix_cache import PrefixCache
from .sequence import SequenceDescriptor, SequenceStatus


@dataclass
class MatchPlan:
    """Device work one prefix match asks of the engine: ``copies`` are
    device-to-device CoW block copies (src_block, dst_block) behind a
    device-tier partial-tail hit; ``promotes`` are host-to-device
    scatters ((rows, scales), dst_block) behind host-tier hits, full
    blocks and host-tier CoW tails. The host bookkeeping (refcounts, tier
    flips, block tables) is already done; the engine enqueues the copies
    before any step that reads the blocks."""

    copies: List[Tuple[int, int]] = field(default_factory=list)
    promotes: List[Tuple[Any, int]] = field(default_factory=list)
    #: promotes entries that moved a host entry to the device tier (a
    #: host-tier CoW tail scatters without moving its source)
    promoted_blocks: int = 0

    def __bool__(self) -> bool:
        return bool(self.copies or self.promotes)


class StateManager:
    def __init__(self, cfg: RaggedInferenceConfig, kv_cache: BlockedKVCache):
        self.cfg = cfg
        self.kv_cache = kv_cache
        self._seqs: Dict[int, SequenceDescriptor] = {}
        # scheduler clock: one tick per scheduler invocation (bumped by the
        # engine's plan phase); new sequences stamp their arrival here
        self.step: int = 0
        #: the content-addressed block index (None = prefix caching off);
        #: set by the engine, which also attaches it to the kv cache
        self.prefix: Optional[PrefixCache] = None
        #: scheduler ticks of head start a host-tier promotion gets before
        #: its sequence's next prefill chunk
        self.promote_defer_ticks: int = 1
        #: matched tokens never ran a prefill chunk, prefill_tokens did
        #: (scheduler-counted, prompt positions only); trims are the
        #: multi-token rollbacks; host_matched_tokens were matched out of
        #: the host tier
        self.prefix_stats = {"matched_tokens": 0, "matched_blocks": 0,
                             "cow_tokens": 0, "cow_copies": 0,
                             "prefill_tokens": 0, "match_queries": 0,
                             "trims": 0, "trimmed_blocks": 0,
                             "host_matched_tokens": 0}

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
        # a paused sequence stays paused: the engine resumes it when
        # blocks free up (engine_v2._try_resume)
        if seq.status not in (SequenceStatus.RUNNING, SequenceStatus.PAUSED):
            seq.status = SequenceStatus.WAITING
        total = seq.seen_tokens + seq.in_flight
        if total > self.cfg.max_context:
            raise ValueError(
                f"sequence {uid}: {total} tokens exceeds max_context "
                f"{self.cfg.max_context} (raise max_blocks_per_seq)")
        return seq

    # ------------------------------------------------------------------ #
    # prefix caching: match (longest cached prefix) + register
    # ------------------------------------------------------------------ #

    def match_prefix(self, seq: SequenceDescriptor) -> MatchPlan:
        """Point a fresh sequence's block table at the longest cached
        chain of its prompt and skip those tokens' prefill (pending ->
        seen with no chunk scheduled). Returns the :class:`MatchPlan` of
        device copies the engine must enqueue. At least one token is
        always left to prefill, so the last chunk still gives logits."""
        plan = MatchPlan()
        pc = self.prefix
        if pc is None or seq.seen_tokens or seq.kv_blocks \
                or seq.in_flight < 2:
            return plan
        toks = seq.pending_tokens
        seq.prefix_tokens = list(toks)
        self.prefix_stats["match_queries"] += 1
        entries, cow, cow_len = pc.match(toks)
        bs = self.cfg.block_size
        maxb = self.cfg.max_blocks_per_seq
        matched = 0
        hit_blocks = 0
        # demotion is leaf-first, so the matched chain is a device prefix
        # followed by a host suffix. Acquire the device prefix first: it
        # is then pinned before a promotion's reserve goes looking for
        # demotion victims
        n_dev = 0
        for e in entries:
            if e.tier != "device":
                break
            n_dev += 1
            pc.acquire(e)
            seq.kv_blocks.append(e.block)
            seq.shared.add(e.block)
            matched += bs
            hit_blocks += 1
        for e in entries[n_dev:]:
            # a host-tier link comes back through a fresh device block.
            # The reserve may demote other cold chains and overflow the
            # host tier's cap: re-check the entry survived. Stop at the
            # first link the pool cannot cover
            try:
                dst = self.kv_cache.reserve(1)[0]
            except OutOfBlocksError:
                break
            if e.host_ref is None or e.tier != "host":
                self.kv_cache.free([dst])
                break
            buf = self.kv_cache.buffer_of(e)
            pc.promote(e, dst)
            pc.acquire(e)
            plan.promotes.append((buf, dst))
            plan.promoted_blocks += 1
            seq.kv_blocks.append(dst)
            seq.shared.add(dst)
            matched += bs
            hit_blocks += 1
            self.prefix_stats["host_matched_tokens"] += bs
        pc.stats["hit_blocks"] += hit_blocks
        self.prefix_stats["matched_blocks"] += hit_blocks
        if cow is not None and hit_blocks == len(entries) \
                and len(seq.kv_blocks) < maxb and cow.tier != "dead":
            # partial-tail hit. The tier is re-read: the promotions'
            # reserves may have demoted a device cow or destroyed a host
            # one. A device source is pinned across the reserve (at
            # refcount 0 it would be a reclaim candidate for the very
            # block being allocated); a host source is re-checked after
            host_cow = cow.tier == "host"
            if not host_cow:
                pc.acquire(cow)
            try:
                dst = self.kv_cache.reserve(1)[0]
            except OutOfBlocksError:
                dst = None
            finally:
                if not host_cow:
                    pc.release_block(cow.block)
            if dst is not None and host_cow \
                    and (cow.host_ref is None or cow.tier != "host"):
                self.kv_cache.free([dst])
                dst = None
            if dst is not None:
                if host_cow:
                    # the agreeing span scatters host -> device into the
                    # private copy; the source entry stays demoted
                    plan.promotes.append((self.kv_cache.buffer_of(cow),
                                          dst))
                    pc.stats["host_hit_blocks"] += 1
                    self.prefix_stats["host_matched_tokens"] += cow_len
                else:
                    plan.copies.append((cow.block, dst))
                seq.kv_blocks.append(dst)        # private: CoW, not shared
                matched += cow_len
                pc.stats["cow_hits"] += 1
                self.prefix_stats["cow_copies"] += 1
                self.prefix_stats["cow_tokens"] += cow_len
        if matched:
            seq.seen_tokens += matched
            del seq.pending_tokens[:matched]
            self.prefix_stats["matched_tokens"] += matched
        if plan.promotes:
            seq.promote_defer = self.promote_defer_ticks
        return plan

    def register_prefix(self, seq: SequenceDescriptor) -> None:
        """Insert this sequence's prefilled full prompt blocks into the
        cache (first writer wins; duplicates stay private). The engine
        calls it once a put() call has drained: every registered block's
        KV writes are enqueued, and a later matcher's steps run after
        them on the stream."""
        pc = self.prefix
        toks = seq.prefix_tokens
        if pc is None or toks is None:
            return
        if seq.status is SequenceStatus.PAUSED or not seq.kv_blocks:
            return
        bs = self.cfg.block_size
        usable = min(seq.seen_tokens, len(toks), len(seq.kv_blocks) * bs)
        node = None
        for i in range(usable // bs):
            grp = tuple(toks[i * bs:(i + 1) * bs])
            child = pc.lookup_child(node, grp)
            if child is not None:
                if child.block != seq.kv_blocks[i]:
                    # another sequence registered this group with another
                    # block: ours stays private, and grafting our next
                    # blocks under its chain would break refs(parent) >=
                    # refs(child)
                    break
                node = child
                continue
            entry = pc.insert(node, grp, seq.kv_blocks[i])
            if entry is None:
                break              # cap reached and nothing evictable
            seq.shared.add(seq.kv_blocks[i])
            node = entry
        if seq.seen_tokens >= len(toks):
            seq.prefix_tokens = None        # prompt fully processed
        self.kv_cache.collect_prefix_evictions()

    def release_blocks(self, seq: SequenceDescriptor, blocks) -> None:
        """The one release path: cache-shared blocks are decref'd (they
        stay cached, reclaimable once cold), private blocks go back to
        the allocator."""
        private: List[int] = []
        for b in blocks:
            if b in seq.shared:
                seq.shared.discard(b)
                self.prefix.release_block(b)
            else:
                private.append(b)
        if private:
            self.kv_cache.free(private)

    # ------------------------------------------------------------------ #

    def can_schedule(self, uid: int, n_tokens: int) -> bool:
        """Would `n_tokens` more tokens fit in blocks we can still
        allocate (free or reclaimable)? Paused sequences never fit."""
        seq = self.get_or_create(uid)
        if seq.status is SequenceStatus.PAUSED:
            return False
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
        """Release the KV blocks beyond what ``seq.seen_tokens`` needs:
        the rollback of the pipeline's EOS retraction (the caller has
        already retracted ``seen_tokens``). Shared blocks are decref'd
        exactly once, never freed. Stale KV inside the kept tail block is
        harmless: appends are addressed by position, so the next tokens
        overwrite it. Returns the number of blocks released."""
        needed = -(-seq.seen_tokens // self.cfg.block_size)
        extra = seq.kv_blocks[needed:]
        if extra:
            del seq.kv_blocks[needed:]
            self.release_blocks(seq, extra)
            self.prefix_stats["trims"] += 1
            self.prefix_stats["trimmed_blocks"] += len(extra)
        return len(extra)

    def kv_memory_report(self) -> Dict[str, int]:
        """KV-pool bytes: total, on one card (the same: one card), and
        the parallel degrees (1 until A8)."""
        n = self.kv_cache.memory_bytes()
        return {"kv_pool_bytes_total": n, "kv_pool_bytes_per_chip": n,
                "tp_size": max(1, int(self.cfg.tp_size)),
                "seq_size": max(1, int(self.cfg.seq_size))}

    def flush(self, uid: int) -> None:
        """Release a sequence and its KV blocks."""
        seq = self._seqs.pop(uid, None)
        if seq is not None and seq.kv_blocks:
            self.release_blocks(seq, seq.kv_blocks)

    def flush_all(self) -> None:
        for uid in list(self._seqs):
            self.flush(uid)
