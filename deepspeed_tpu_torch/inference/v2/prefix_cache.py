"""Content-addressed prefix cache over the paged KV pool — two tiers (port
of ``deepspeed_tpu/inference/v2/prefix_cache.py``, the same host logic).

Automatic prefix caching for the v2 ragged engine (the optimization the
reference's blocked KV layout exists to enable — fixed blocks are what
make KV state shareable and remappable): fleets of requests that share a
system prompt / few-shot preamble re-prefill identical tokens from
position 0, so both the prefill FLOPs and the KV HBM writes for those
tokens are redundant. This module indexes FULL KV blocks by the token
chain that produced them so a later sequence can point its block table at
the already-written device blocks and skip those prefill chunks entirely.

Design:

  * **Block identity is the whole prefix**, not the block's own tokens:
    entries are parent-linked (a trie over ``block_size``-token groups),
    so two blocks holding the same 64 tokens at different positions — or
    after different histories — never alias. KV content is a
    deterministic function of (params, config, token chain, absolute
    positions), and a chain always starts at position 0, which is what
    makes reuse exact: the cached rows are bit-identical to what a fresh
    prefill would write (including int8 ``kv_quant`` payloads + scales
    and WOQ-weight-produced values — determinism covers the quantized
    content too).
  * **Refcounts, never frees**: a cached block is co-owned by the cache
    and every live sequence whose table references it. Release paths
    (flush, EOS rollback ``trim_blocks``, pause) *decref*; the block only
    returns to the allocator when the cache itself evicts it.
  * **Refcount-0 blocks stay cached** (that is the whole point) and are
    reclaimed ONLY under allocator pressure: ``BlockedKVCache.reserve``
    asks the cache to free just enough refcount-0 blocks, leaf-first in
    LRU (or FIFO) order. A parent is never reclaimed before its cached
    device children — an orphaned child could no longer be reached by a
    match walk and would leak its block until drain.
  * **Hierarchical KV (``host_blocks`` > 0)**: instead of *destroying* a
    refcount-0 block under reserve pressure, the kv cache *demotes* it —
    one batched, non-blocking device→host gather per reserve call — and
    the entry stays in the trie tagged ``tier="host"``. A later match on
    a chain with demoted links *promotes* them back through fresh device
    blocks (the restore scatter path), so a demoted hit is still a hit,
    just a slower one. The host tier has its own capacity cap and LRU:
    only past ``host_blocks`` is cached content actually destroyed.
    Because demotion (like eviction) is leaf-first, a host entry's
    children are always host — every chain is a device prefix followed
    by a host suffix, which is what lets promotion walk top-down.
  * **Copy-on-write tail**: when a match ends mid-block (the shared
    preamble is rarely block-aligned) the cached child block whose tokens
    extend the match is COPIED into a freshly allocated private block
    (one on-device row copy for a device-tier source, one host→device
    restore scatter for a host-tier one — zero collectives either way)
    and the sequence skips the agreeing token span; its own continuation
    then writes into the private copy — never into the shared block.

Everything here is host-side metadata (dicts over ints); the device
interactions — the CoW row copy, the demotion gather and the promotion
scatter — are enqueued by the kv-cache layer on the engine's stream
without blocking. ``match``/``insert``/``evict`` and the demote/promote
halves run inside the serve loop's plan-ahead window and never read the
device.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Tuple

TokenKey = Tuple[int, ...]


class _Entry:
    """One cached full block: ``tokens`` (its block_size-token group),
    its parent link (identity = the whole chain), the device block id it
    owns (``tier="device"``; -1 once demoted), the live-sequence
    refcount, and — on the host tier — an opaque ``host_ref`` the kv
    cache resolves to the demoted KV rows. ``dev_kids`` counts
    device-tier children: reclamation (demote OR evict) is legal exactly
    when it is 0, so a device prefix never leaves before its device
    descendants while host descendants (already off-device) never block
    it."""

    __slots__ = ("tokens", "block", "parent", "children", "refs", "stamp",
                 "born", "tier", "host_ref", "dev_kids")

    def __init__(self, tokens: TokenKey, block: int,
                 parent: Optional["_Entry"], stamp: int):
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children: Dict[TokenKey, _Entry] = {}
        self.refs = 0            # live sequences referencing this block
        self.stamp = stamp       # LRU clock: last time refs dropped to 0
        self.born = stamp        # FIFO clock: insertion order
        self.tier = "device"     # "device" | "host" (hierarchical KV)
        self.host_ref: Any = None    # kv-cache handle to the demoted rows
        self.dev_kids = 0        # device-tier children count


class PrefixCache:
    """Host-side index of cached KV blocks, layered on the allocator:
    device-tier blocks it holds are *allocated* as far as
    ``BlockedAllocator`` is concerned and are returned via :meth:`evict`
    (or recycled through :meth:`demote`) only; host-tier entries own no
    device block at all."""

    def __init__(self, block_size: int, max_blocks: int = 0,
                 policy: str = "lru", host_blocks: int = 0):
        if policy not in ("lru", "fifo"):
            raise ValueError(
                f"prefix_cache_policy must be 'lru' or 'fifo', got "
                f"{policy!r}")
        if host_blocks < 0:
            raise ValueError(
                f"prefix_cache_host_blocks must be >= 0 (0 = tier off), "
                f"got {host_blocks}")
        self.block_size = block_size
        self.max_blocks = max_blocks          # 0 = bounded by the pool only
        self.policy = policy
        self.host_blocks = host_blocks        # 0 = host tier off
        self._roots: Dict[TokenKey, _Entry] = {}
        self._by_block: Dict[int, _Entry] = {}
        # blocks evicted as a side effect of a capped insert, awaiting
        # collection by BlockedKVCache (the allocator's owner is the only
        # place that frees)
        self._pending_free: List[int] = []
        self._evictable = 0      # running count of refs==0 DEVICE entries
        self._host_count = 0     # entries currently on the host tier
        # lazy-deletion min-heap of (rank, block) reclaim candidates:
        # device entries are pushed when their refcount drops to 0 (and
        # parents when their last device child leaves), stale tuples are
        # skipped at pop time by re-validating against the live entry —
        # so evict()/pop_demotable() under steady pool pressure never
        # rescan the whole index
        self._heap: List[Tuple[int, int]] = []
        # host-tier LRU: (rank, born, entry) — born is a unique
        # tiebreaker so heapq never compares entries; stale tuples are
        # rank/tier-checked at pop time exactly like the device heap
        self._host_heap: List[Tuple[int, int, _Entry]] = []
        self._clock = 0
        self.stats = {"hit_blocks": 0, "cow_hits": 0, "inserted": 0,
                      # destroys, split by cause (the churn-attribution
                      # fix): cap-pressure inserts vs reserve-pressure
                      # reclamation; "evicted" stays their sum for the
                      # established consumers
                      "evicted": 0, "evicted_cap": 0, "evicted_pressure": 0,
                      # hierarchical KV: blocks moved device->host under
                      # pressure, host->device on a match, matched while
                      # (or from) host-resident, and destroyed at the
                      # host tier's own cap
                      "demoted": 0, "promoted": 0, "host_hit_blocks": 0,
                      "host_evicted": 0}

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #

    @property
    def host_tier(self) -> bool:
        return self.host_blocks > 0

    @property
    def cached_blocks(self) -> int:
        """Device-tier cached blocks (entries holding a pool block)."""
        return len(self._by_block)

    @property
    def host_cached_blocks(self) -> int:
        """Entries currently resident on the host-RAM tier."""
        return self._host_count

    @property
    def evictable_blocks(self) -> int:
        """Device blocks reclaimable under pressure. refs(parent) >=
        refs(child) (a matching sequence acquires every entry on its
        path), so a refcount-0 entry's whole subtree is refcount-0 and
        the count of refs==0 device entries IS the reclaimable total
        (host descendants hold no pool block and never gate a parent).
        Maintained as a running counter — this is read via
        ``BlockedKVCache.free_blocks`` on every ``can_schedule`` call, a
        scan here would scale with cache size."""
        return self._evictable

    def entry_of(self, block: int) -> Optional[_Entry]:
        return self._by_block.get(block)

    # ------------------------------------------------------------------ #
    # match / acquire / release — the serve-loop hot path
    # ------------------------------------------------------------------ #

    def match(self, tokens) -> Tuple[List[_Entry], Optional[_Entry], int]:
        """Longest cached prefix of ``tokens``, across BOTH tiers.

        Returns ``(entries, cow, cow_len)``: ``entries`` are the matched
        full-block chain (NOT yet acquired — the caller increfs via
        :meth:`acquire` once it commits to using them; host-tier links
        must be promoted first, see ``StateManager.match_prefix``);
        ``cow`` is the child entry whose block agrees with the next
        ``cow_len`` tokens after the full-block match (copy-on-write
        candidate, either tier), or None. At least ONE trailing token is
        always left unmatched so the engine still runs a final chunk and
        returns last-token logits."""
        bs = self.block_size
        n = len(tokens)
        out: List[_Entry] = []
        node: Optional[_Entry] = None
        pos = 0
        while pos + bs <= n - 1:
            key = tuple(tokens[pos:pos + bs])
            child = (self._roots if node is None else node.children).get(key)
            if child is None:
                break
            out.append(child)
            node = child
            pos += bs
        # copy-on-write tail: the longest agreeing span of any cached
        # child of the matched node (capped one short of the remainder)
        cow, cow_len = None, 0
        cap = n - pos - 1
        if cap > 0:
            children = self._roots if node is None else node.children
            limit = min(cap, bs)
            first = tokens[pos]
            for child in children.values():
                ctoks = child.tokens
                if ctoks[0] != first:
                    continue   # span would be 0 — a node with many
                    #            children (one per unique tail) reduces
                    #            to one int compare per sibling
                span = 1
                while span < limit and ctoks[span] == tokens[pos + span]:
                    span += 1
                if span > cow_len:
                    cow, cow_len = child, span
        if cow_len == 0:
            cow = None
        return out, cow, cow_len

    def acquire(self, entry: _Entry) -> None:
        if entry.tier != "device":
            raise RuntimeError(
                "acquire on a host-tier entry — promote it first "
                "(StateManager.match_prefix owns that ordering)")
        if entry.refs == 0:
            self._evictable -= 1
        entry.refs += 1

    def release_block(self, block: int) -> bool:
        """Decref the entry owning ``block``; True when it was cached
        (False = not a cache block, the caller frees it normally)."""
        entry = self._by_block.get(block)
        if entry is None:
            return False
        if entry.refs <= 0:
            raise RuntimeError(
                f"prefix-cache refcount underflow on block {block}")
        entry.refs -= 1
        if entry.refs == 0:
            self._evictable += 1
            self._clock += 1
            entry.stamp = self._clock
            if not entry.dev_kids:
                self._push_candidate(entry)
        return True

    def _rank(self, entry: _Entry) -> int:
        return entry.stamp if self.policy == "lru" else entry.born

    def _push_candidate(self, entry: _Entry) -> None:
        # stale tuples (re-acquired entries, evicted-and-reused block
        # ids, demoted entries) are skipped at pop time by a rank/tier
        # mismatch: stamps are unique per release and born per insert,
        # so a matching rank identifies the same incarnation in the same
        # state. Compact when stale tuples dominate, keeping the heap
        # O(cached).
        heapq.heappush(self._heap, (self._rank(entry), entry.block))
        if len(self._heap) > 2 * len(self._by_block) + 64:
            self._heap = [(self._rank(e), e.block)
                          for e in self._by_block.values()
                          if not e.refs and not e.dev_kids]
            heapq.heapify(self._heap)

    def _push_host_candidate(self, entry: _Entry) -> None:
        heapq.heappush(self._host_heap,
                       (self._rank(entry), entry.born, entry))
        if len(self._host_heap) > 2 * self._host_count + 64:
            self._host_heap = [(self._rank(e), e.born, e)
                               for _, _, e in self._host_heap
                               if e.tier == "host" and not e.children]
            heapq.heapify(self._host_heap)

    # ------------------------------------------------------------------ #
    # insert / evict
    # ------------------------------------------------------------------ #

    def lookup_child(self, parent: Optional[_Entry],
                     tokens: TokenKey) -> Optional[_Entry]:
        return (self._roots if parent is None else parent.children) \
            .get(tokens)

    def insert(self, parent: Optional[_Entry], tokens: TokenKey,
               block: int) -> Optional[_Entry]:
        """Adopt ``block`` (already written with ``tokens``' KV under
        ``parent``'s chain) into the index with refs=1 held by the
        registering sequence. Returns None — and adopts nothing — when
        the key already exists (the first writer won; the caller's block
        stays private), when ``parent`` is host-resident (a device child
        under a host parent would break the tier ordering promotion
        depends on — the registrant's copy simply stays private), or
        when the ``max_blocks`` cap is reached and nothing is
        reclaimable."""
        if len(tokens) != self.block_size:
            raise ValueError(
                f"only full {self.block_size}-token blocks are cacheable, "
                f"got {len(tokens)}")
        if parent is not None and parent.tier != "device":
            return None
        siblings = self._roots if parent is None else parent.children
        if tokens in siblings:
            return None
        if self.max_blocks and len(self._by_block) >= self.max_blocks:
            # stay under the cap by evicting one cold block; if nothing
            # is evictable the insert is skipped (block stays private).
            # Cap pressure always DESTROYS (evicted_cap) — demotion is
            # reserved for pool pressure, where the content is about to
            # be re-requested; an index kept at a deliberate cap should
            # not leak onto the host tier
            victims = self.evict(1, reason="cap")
            if not victims:
                return None
            # the victim's block goes back to the ALLOCATOR through the
            # caller-visible path: stash it for collection
            self._pending_free.extend(victims)
        self._clock += 1
        entry = _Entry(tokens, block, parent, self._clock)
        entry.refs = 1
        siblings[tokens] = entry
        self._by_block[block] = entry
        if parent is not None:
            parent.dev_kids += 1
        self.stats["inserted"] += 1
        return entry

    def collect_pending_free(self) -> List[int]:
        out = self._pending_free
        self._pending_free = []
        return out

    def _pop_reclaimable(self, n: int) -> List[_Entry]:
        """Pop up to ``n`` valid reclaim candidates off the device heap:
        refcount-0 device entries with no device children, policy order.
        Shared by :meth:`evict` (destroy) and :meth:`pop_demotable`
        (move to the host tier)."""
        out: List[_Entry] = []
        picked = set()
        while self._heap and len(out) < n:
            rank, blk = heapq.heappop(self._heap)
            e = self._by_block.get(blk)
            if e is None or e.refs or e.dev_kids or e.tier != "device" \
                    or self._rank(e) != rank or id(e) in picked:
                # stale: superseded, reused id, or a duplicate push at
                # an unchanged rank (released to 0, then gained and
                # lost a child — both pushes carry the same stamp, and
                # within one batch the first pick has not yet
                # invalidated the entry)
                continue
            picked.add(id(e))
            out.append(e)
        return out

    def _reclaimed(self, e: _Entry) -> None:
        """Shared device-side bookkeeping when ``e`` leaves the device
        tier (evicted or demoted): drop the block mapping and cascade
        candidacy to a parent this departure just unblocked."""
        del self._by_block[e.block]
        self._evictable -= 1
        p = e.parent
        if p is not None:
            p.dev_kids -= 1
            if p.tier == "device" and not p.refs and not p.dev_kids:
                self._push_candidate(p)

    def _unlink(self, e: _Entry) -> None:
        siblings = self._roots if e.parent is None else e.parent.children
        del siblings[e.tokens]

    def _destroy_host_subtree(self, e: _Entry) -> None:
        """Destroy every (host-tier) descendant of ``e`` — used when a
        device entry with host children is destroy-evicted: the host
        subtree would be unreachable by any match walk. All descendants
        of a reclaim candidate are refcount-0 host entries by the tier
        and refcount invariants."""
        stack = list(e.children.values())
        e.children.clear()
        while stack:
            c = stack.pop()
            self._drop_host_ref(c)
            c.tier = "dead"
            self._host_count -= 1
            self.stats["host_evicted"] += 1
            stack.extend(c.children.values())
            c.children.clear()

    @staticmethod
    def _drop_host_ref(e: _Entry) -> None:
        """Detach an entry from the host tier's storage, releasing its
        block's bytes back (the kv cache's batch accounting — host RAM
        must track the resident count, not historical batch sizes)."""
        ref = e.host_ref
        e.host_ref = None
        if ref is not None and hasattr(ref, "release"):
            ref.release()

    def evict(self, n: int, reason: str = "pressure") -> List[int]:
        """DESTROY up to ``n`` refcount-0 device blocks, leaf-first in
        policy order (lru: least-recently-released; fifo: oldest
        insertion). Returns the freed device block ids (the caller hands
        them back to the allocator); any host-tier descendants of a
        victim are destroyed with it. ``reason`` attributes the churn:
        "pressure" (reserve demand) or "cap" (index-cap insert). With
        the host tier armed, reserve pressure goes through
        :meth:`pop_demotable`/:meth:`demote` instead and this path only
        runs for cap inserts, explicit drains and tier-off engines.
        O(log cached) per victim off the persistent candidate heap —
        this runs inside ``reserve`` on the scheduling hot path."""
        freed: List[int] = []
        while len(freed) < n:
            # pop-and-destroy in rounds: destroying a leaf pushes its
            # newly childless parent, which the next round picks up —
            # the leaf-first cascade that drains a whole cold chain in
            # one call
            batch = self._pop_reclaimable(n - len(freed))
            if not batch:
                break
            for e in batch:
                if e.children:
                    self._destroy_host_subtree(e)
                self._unlink(e)
                self._reclaimed(e)
                e.tier = "dead"
                freed.append(e.block)
                self.stats["evicted"] += 1
                self.stats["evicted_cap" if reason == "cap"
                           else "evicted_pressure"] += 1
        return freed

    # ------------------------------------------------------------------ #
    # hierarchical KV: demote / promote / host-tier eviction
    # ------------------------------------------------------------------ #

    def pop_demotable(self, n: int) -> List[_Entry]:
        """Select up to ``n`` reclaim victims for DEMOTION (device →
        host) and remove them from the candidate heap. The caller
        (``BlockedKVCache``) must gather their rows and complete the
        move with :meth:`demote` — the entries stay device-tier and
        block-mapped until then so the gather can still address them.
        Pure heap pops and dict reads."""
        if not self.host_tier:
            return []
        return self._pop_reclaimable(n)

    def demote(self, entries: List[_Entry], refs: List[Any]) -> None:
        """Complete a demotion: the victims' rows were gathered (one
        batched non-blocking dispatch) and ``refs[i]`` is the kv-cache
        handle resolving to entry ``i``'s rows. Each entry keeps its
        place in the trie, tagged ``tier="host"``; its device block id
        is dropped (the caller returns the blocks to the allocator) and
        it joins the host-tier LRU. Past ``host_blocks`` the coldest
        host-resident chains are destroyed for real. Host dict/heap
        bookkeeping only."""
        for e, ref in zip(entries, refs):
            self._reclaimed(e)
            e.tier = "host"
            e.host_ref = ref
            e.block = -1
            self._clock += 1
            e.stamp = self._clock
            self._host_count += 1
            self.stats["demoted"] += 1
            if not e.children:
                self._push_host_candidate(e)
        over = self._host_count - self.host_blocks
        if over > 0:
            self.evict_host(over)

    def evict_host(self, n: int) -> int:
        """Destroy up to ``n`` host-tier entries, leaf-first in policy
        order — the ONLY place hierarchical-KV content is actually lost.
        Returns the number destroyed (runs inside demote, inside
        reserve)."""
        destroyed = 0
        while self._host_heap and destroyed < n:
            rank, _, e = heapq.heappop(self._host_heap)
            if e.tier != "host" or e.children or self._rank(e) != rank:
                continue               # stale: promoted, evicted, re-ranked
            self._unlink(e)
            e.tier = "dead"
            self._drop_host_ref(e)
            self._host_count -= 1
            self.stats["host_evicted"] += 1
            destroyed += 1
            p = e.parent
            if p is not None and not p.children:
                if p.tier == "host":
                    self._push_host_candidate(p)
                elif not p.refs and not p.dev_kids:
                    # a device parent whose last (host) child left was
                    # already demotable; candidacy is unchanged — no push
                    # needed (dev_kids never counted host children)
                    pass
        return destroyed

    def promote(self, entry: _Entry, block: int) -> Any:
        """Move a host-tier entry back onto the device: it now owns
        ``block`` (freshly reserved by the caller, who resolves the
        entry's rows BEFORE this call and dispatches the host→device
        restore scatter after). Returns the released host handle; the
        tier's storage for this block is dropped here — the caller's
        already-resolved buffer keeps the bytes alive through the
        scatter. The entry re-enters the device tier with refs=0 — the
        matching sequence acquires it immediately after (same call, no
        reclaim window in between). Pure dict/counter bookkeeping."""
        if entry.tier != "host":
            raise RuntimeError("promote on a non-host entry")
        ref = entry.host_ref
        self._drop_host_ref(entry)
        entry.tier = "device"
        entry.block = block
        self._by_block[block] = entry
        self._host_count -= 1
        self._evictable += 1       # refs==0 device entry (caller acquires)
        p = entry.parent
        if p is not None:
            p.dev_kids += 1
        self.stats["promoted"] += 1
        self.stats["host_hit_blocks"] += 1
        return ref

    # ------------------------------------------------------------------ #
    # invariants (tests / drills)
    # ------------------------------------------------------------------ #

    def check_invariants(self) -> None:
        """Model-checker hook (tests): structural consistency of the
        index — every entry reachable from a root, block map exact,
        refs(parent) >= refs(child), tier ordering (a host entry's
        children are host), dev_kids exact, host count exact and within
        its cap."""
        seen = {}
        hosts = 0
        stack = [(None, e) for e in self._roots.values()]
        while stack:
            parent, e = stack.pop()
            assert e.parent is parent, "parent link broken"
            assert e.tier in ("device", "host"), f"dead entry {e.tokens} " \
                "still linked"
            if parent is not None:
                assert parent.refs >= e.refs, \
                    "child outlives parent refcount"
                if parent.tier == "host":
                    assert e.tier == "host", \
                        "device entry under a host parent"
            assert e.dev_kids == sum(
                1 for c in e.children.values() if c.tier == "device"), \
                "dev_kids out of sync with children tiers"
            if e.tier == "device":
                assert e.block not in seen, "block owned by two entries"
                seen[e.block] = e
            else:
                hosts += 1
                assert e.refs == 0, "host-tier entry holds references"
                assert e.block == -1, "host-tier entry still block-mapped"
            stack.extend((e, c) for c in e.children.values())
        assert seen.keys() == self._by_block.keys(), \
            "block index out of sync with the trie"
        assert hosts == self._host_count, "host-tier count out of sync"
        if self.host_tier:
            assert hosts <= self.host_blocks, "host tier over its cap"
        assert self._evictable == sum(
            1 for e in self._by_block.values() if e.refs == 0), \
            "evictable counter out of sync with refcounts"
        live = {(self._rank(e), e.block) for e in self._by_block.values()
                if not e.refs and not e.dev_kids}
        assert live <= set(self._heap), \
            "reclaimable device leaf missing from the candidate heap"
        host_live = {(self._rank(e), e.born)
                     for _, _, e in self._host_heap
                     if e.tier == "host" and not e.children}

        def walk_hosts():
            stack = list(self._roots.values())
            while stack:
                e = stack.pop()
                if e.tier == "host" and not e.children:
                    yield (self._rank(e), e.born)
                stack.extend(e.children.values())

        assert set(walk_hosts()) <= host_live, \
            "host-tier leaf missing from the host candidate heap"

    def assert_exact_refs(self, sequences) -> None:
        """Refcount-EXACTNESS oracle (tests + drills), across BOTH
        tiers: every device-cached block's refcount must equal the
        number of live sequences whose ``shared`` set holds it — the
        invariant a multi-token trim (speculative rollback, EOS
        retraction) must preserve by decrefing each released shared
        block exactly once — and every host-tier entry must hold ZERO
        references (a sequence can only reference device blocks; the
        demote/promote ops must never strand a count on the host
        tier)."""
        want: Dict[int, int] = {}
        for seq in sequences:
            for b in seq.kv_blocks:
                if b in seq.shared:
                    want[b] = want.get(b, 0) + 1
        for b, e in self._by_block.items():
            got = want.get(b, 0)
            assert e.refs == got, (
                f"refcount drift on block {b}: cache says {e.refs}, "
                f"{got} live sequences share it")
        stack = list(self._roots.values())
        while stack:
            e = stack.pop()
            if e.tier == "host":
                assert e.refs == 0, (
                    f"host-tier entry {e.tokens[:4]}... carries "
                    f"{e.refs} refs — demote/promote leaked a count")
            stack.extend(e.children.values())
