"""Blocked (paged) KV cache (port of ``deepspeed_tpu/inference/v2/kv_cache.py``).

A fixed device-resident pool addressed through per-sequence block tables,
stored flat as one tensor ``data`` [layers, 2 (k/v), (num_blocks + 1) *
block_size, kv_heads * head_dim]. The final block is the trash block:
padded query positions write into its last row, so they never touch a
live sequence's KV. ``data[layer, 0]`` / ``data[layer, 1]`` are contiguous
``[slots, KV*D]`` views — what the paged kernels read — and cost no copy.
Unlike the JAX package the pool is updated in place (``index_copy_``): one
pool is resident, with no functional rethreading.

The pool holds bf16, fp16 or fp32 rows, or, with
``kv_cache_dtype="int8"``, int8 rows and per-(token, KV head) f32
``scales`` [layers, 2, kv_heads, slots] (``kv_quant.py``).

Blocks move in and out of the pool for the prefix cache and for pause:
the copy-on-write row copy (``copy_block``), the demotion gather to the
host tier (``_demote``), the promotion scatter back (``promote_blocks``),
and a paused sequence's ``offload`` / ``restore``. Every one moves the
int8 pool's scales with its rows, and every one is enqueued on the
current CUDA stream, the stream the engine's steps run on, so stream
order puts each after the steps that wrote its rows and before the steps
that read them: the host never waits. A host copy is a pinned buffer
filled by a non-blocking device-to-host copy; only a host read of it
(``_HostBatch.materialize``) waits, on an event recorded after the copy.
Host buffers hold whole blocks, block-major: rows [n, layers, 2,
block_size, KV*D], scales [n, layers, 2, KV, block_size].
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from .blocked_allocator import BlockedAllocator
from .config import RaggedInferenceConfig
from .kv_quant import KVPool
from .prefix_cache import PrefixCache

#: (rows, scales or None) of whole blocks, block-major (module docstring)
HostKV = Tuple[torch.Tensor, Optional[torch.Tensor]]


class _HostBatch:
    """One demotion batch: the rows (and int8 scales) of every block one
    ``reserve`` call demoted, gathered by one indexing op and copied to
    one pinned host buffer by one non-blocking copy. Until
    :meth:`materialize` (at a commit boundary) a promotion reads the
    device gather directly; after it, the host buffer, whose blocks are
    views ``parts[i]``. :meth:`drop` releases a block that left the host
    tier; the buffer goes when its last block does."""

    __slots__ = ("rows", "scales", "host", "event", "count", "parts",
                 "dead")

    def __init__(self, rows: torch.Tensor, scales: Optional[torch.Tensor],
                 host: HostKV, event: Any):
        self.rows = rows
        self.scales = scales
        self.host = host
        self.event = event
        self.count = rows.shape[0]
        #: index -> (rows, scales) host views, once materialized
        self.parts = None
        self.dead: set = set()

    def drop(self, index: int) -> None:
        self.dead.add(index)
        if self.parts is not None:
            self.parts.pop(index, None)
            if not self.parts:
                self.host = None

    def slice(self, index: int) -> HostKV:
        if self.parts is not None:
            return self.parts[index]
        return (self.rows[index],
                None if self.scales is None else self.scales[index])

    def materialize(self) -> None:
        """Switch promotions to the host copy and let the device gather
        go: waits for the copy's event (already passed at a commit
        boundary, whose readback synchronized the stream)."""
        if self.parts is not None:
            return
        if self.event is not None:
            self.event.synchronize()
        rows, scales = self.host
        self.parts = {i: (rows[i], None if scales is None else scales[i])
                      for i in range(self.count) if i not in self.dead}
        self.rows = self.scales = None
        if not self.parts:
            self.host = None


class _HostRef:
    """A prefix-cache entry's handle onto its block of a demotion batch
    (``prefix_cache._Entry.host_ref``)."""

    __slots__ = ("batch", "index")

    def __init__(self, batch: _HostBatch, index: int):
        self.batch = batch
        self.index = index

    def get(self) -> HostKV:
        """(rows, scales-or-None) of this block."""
        return self.batch.slice(self.index)

    def release(self) -> None:
        self.batch.drop(self.index)


class BlockedKVCache:
    def __init__(self, cfg: RaggedInferenceConfig, num_layers: int,
                 kv_heads: int, head_dim: int, dtype: Any = torch.bfloat16,
                 device: Any = "cuda"):
        if dtype not in (torch.bfloat16, torch.float16, torch.float32):
            raise ValueError(f"KV pool dtype {dtype}: the pool holds bf16, "
                             f"fp16 or fp32 rows (or int8 by kv_cache_dtype)")
        self.cfg = cfg
        self.num_layers = num_layers
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.allocator = BlockedAllocator(cfg.num_blocks)
        self.prefix: Optional[PrefixCache] = None   # attach_prefix_cache
        slots = (cfg.num_blocks + 1) * cfg.block_size
        self.quantized = cfg.kv_cache_dtype == "int8"
        self.dtype = torch.int8 if self.quantized else dtype
        self.data = torch.zeros((num_layers, 2, slots, kv_heads * head_dim),
                                dtype=self.dtype, device=device)
        self.scales = torch.zeros((num_layers, 2, kv_heads, slots),
                                  dtype=torch.float32, device=device) \
            if self.quantized else None
        #: demotion batches not yet materialized (finalize_demotions)
        self._pending_host: List[_HostBatch] = []

    @property
    def pool(self):
        """What the runner's step takes: a KVPool (data and scales travel
        together) when quantized, else the data tensor itself."""
        return KVPool(self.data, self.scales) if self.quantized \
            else self.data

    @property
    def device(self) -> torch.device:
        return self.data.device

    def memory_bytes(self) -> int:
        n = self.data.numel() * self.data.element_size()
        if self.scales is not None:
            n += self.scales.numel() * self.scales.element_size()
        return n

    def attach_prefix_cache(self, prefix: PrefixCache) -> None:
        """Layer the content-addressed block index over the allocator:
        refcount-0 cached blocks count as reclaimable capacity and are
        demoted or evicted by :meth:`reserve` only under pressure."""
        self.prefix = prefix

    @property
    def free_blocks(self) -> int:
        """Blocks a caller can still reserve: the allocator's free list
        plus refcount-0 prefix-cached blocks (reclaimable on demand)."""
        n = self.allocator.free_blocks
        if self.prefix is not None:
            n += self.prefix.evictable_blocks
        return n

    def collect_prefix_evictions(self) -> None:
        if self.prefix is not None:
            freed = self.prefix.collect_pending_free()
            if freed:
                self.allocator.free(freed)

    def reserve(self, n: int) -> List[int]:
        """Allocate ``n`` blocks, reclaiming refcount-0 prefix-cached
        blocks on demand: with the host tier on they are demoted (one
        gather and one non-blocking copy to host per round), otherwise
        destroyed."""
        self.collect_prefix_evictions()
        short = n - self.allocator.free_blocks
        if short > 0 and self.prefix is not None:
            if self.prefix.host_tier:
                short -= self._demote(short)
            if short > 0:
                self.allocator.free(self.prefix.evict(short))
        return self.allocator.allocate(n)

    def free(self, blocks) -> None:
        self.allocator.free(blocks)

    # ------------------------- block movement ------------------------- #

    def _block_ids(self, blocks: Sequence[int]) -> torch.Tensor:
        """Block ids as a long tensor on the pool's device, through a
        pinned buffer on a card so the copy does not wait."""
        t = torch.tensor(list(blocks), dtype=torch.long)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _blocked(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """A view of a pool tensor with its slots axis split into
        (blocks, block_size)."""
        bs = self.cfg.block_size
        shape = t.shape[:axis] + (t.shape[axis] // bs, bs) \
            + t.shape[axis + 1:]
        return t.view(shape)

    def gather_blocks(self, blocks: Sequence[int]) -> HostKV:
        """Device copy of ``blocks``' rows and scales, block-major:
        rows [n, L, 2, bs, KV*D], scales [n, L, 2, KV, bs]."""
        ids = self._block_ids(blocks)
        rows = self._blocked(self.data, 2).index_select(2, ids) \
            .permute(2, 0, 1, 3, 4).contiguous()
        scales = None
        if self.scales is not None:
            scales = self._blocked(self.scales, 3).index_select(3, ids) \
                .permute(3, 0, 1, 2, 4).contiguous()
        return rows, scales

    def _to_host(self, rows: torch.Tensor, scales: Optional[torch.Tensor]
                 ) -> Tuple[HostKV, Any]:
        """Host copies of device tensors: pinned buffers filled by
        non-blocking copies, and an event recorded after them (None on
        the CPU, where the gathered tensors already are host memory)."""
        if rows.device.type == "cpu":
            return (rows, scales), None

        def host(t):
            if t is None:
                return None
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            return h
        out = (host(rows), host(scales))
        event = torch.cuda.Event()
        event.record()
        return out, event

    def offload(self, blocks: Sequence[int]) -> HostKV:
        """Host copy of ``blocks`` for a paused sequence: (rows, scales
        or None), block-major. Non-blocking on a card; a later
        :meth:`restore` on the same stream reads it after the copy."""
        host, _ = self._to_host(*self.gather_blocks(blocks))
        return host

    def restore(self, host_buf: HostKV, blocks: Sequence[int]) -> None:
        """Scatter whole blocks (host or device, block-major) into
        ``blocks`` of the pool, in place, scales with the rows."""
        rows, scales = host_buf
        if rows.shape[0] != len(blocks):
            raise ValueError(f"restore: buffer holds {rows.shape[0]} "
                             f"blocks, {len(blocks)} requested")
        ids = self._block_ids(blocks)
        dev = self.device
        self._blocked(self.data, 2).index_copy_(
            2, ids, rows.to(dev, non_blocking=True).permute(1, 2, 0, 3, 4))
        if self.scales is not None:
            self._blocked(self.scales, 3).index_copy_(
                3, ids, scales.to(dev, non_blocking=True)
                .permute(1, 2, 3, 0, 4))

    def copy_block(self, src: int, dst: int) -> None:
        """Copy one block's rows and scales ``src`` -> ``dst`` in place:
        the copy-on-write step behind a partial-tail prefix match."""
        bs = self.cfg.block_size
        s, d = slice(src * bs, (src + 1) * bs), slice(dst * bs,
                                                      (dst + 1) * bs)
        self.data[:, :, d].copy_(self.data[:, :, s])
        if self.scales is not None:
            self.scales[..., d].copy_(self.scales[..., s])

    # ------------------- host tier: demote / promote ------------------ #

    def _demote(self, short: int) -> int:
        """Demote up to ``short`` refcount-0 cached blocks to the host
        tier: each round one gather of the victims' rows and one
        non-blocking copy to a pinned buffer; the entries re-tagged
        ``tier="host"``, their device blocks back to the allocator (the
        steps that reuse them run after the gather on the stream).
        Returns the number of blocks recovered."""
        recovered = 0
        while recovered < short:
            # rounds: demoting a leaf makes its parent demotable
            victims = self.prefix.pop_demotable(short - recovered)
            if not victims:
                break
            blocks = [e.block for e in victims]
            rows, scales = self.gather_blocks(blocks)
            host, event = self._to_host(rows, scales)
            batch = _HostBatch(rows, scales, host, event)
            self._pending_host.append(batch)
            self.prefix.demote(
                victims, [_HostRef(batch, i) for i in range(len(victims))])
            self.allocator.free(blocks)
            recovered += len(blocks)
        return recovered

    def finalize_demotions(self) -> None:
        """Materialize pending demotion batches (at commit boundaries,
        where the readback has synchronized the stream, and at drain)."""
        for batch in self._pending_host:
            batch.materialize()
        self._pending_host = []

    def buffer_of(self, entry) -> HostKV:
        """A host-tier entry's rows for promotion or a CoW tail: the
        device gather before materialize, the pinned host copy after."""
        return entry.host_ref.get()

    def promote_block(self, buf: HostKV, dst: int) -> None:
        """Scatter one demoted block's rows into device block ``dst``."""
        self.promote_blocks([(buf, dst)])

    def promote_blocks(self, promotes) -> None:
        """Batched promotion: one scatter for a matched chain's
        ((rows, scales), dst) pairs. Each part goes to the device by its
        own non-blocking copy (from pinned memory, or already there for a
        batch not yet materialized) and the parts are stacked there: the
        host copies nothing."""
        bufs = [b for b, _ in promotes]
        blocks = [d for _, d in promotes]

        def stack(parts):
            if parts[0] is None:
                return None
            return torch.stack([p.to(self.device, non_blocking=True)
                                for p in parts])
        self.restore((stack([b[0] for b in bufs]),
                      stack([b[1] for b in bufs])), blocks)
