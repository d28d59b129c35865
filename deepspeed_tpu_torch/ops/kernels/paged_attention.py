"""Paged-KV flash attention (port of ``deepspeed_tpu/ops/kernels/paged_attention.py``).

Flash attention that reads K/V straight through per-sequence block tables,
so a step touches only the blocks a sequence occupies. Two hand-written
CUDA kernels (``csrc/paged_attention.cu``) replace the two Pallas kernels:

- ``paged_prefill`` (K1) for C > 1 queries per slot — replaces
  ``_paged_kernel``. In bf16 at head dims 64 and 128 with C >= 64 it is a
  persistent wgmma kernel: work items (slot, query head, 128 queries),
  a head's query tiles side by side, dealt by :func:`prefill_plan` from
  the shapes alone, K/V through the block table by TMA (block sizes that
  are multiples of 64) or a cp.async gather, both products on wgmma, one
  block an item (the same bits from call to call). Other head dims and smaller chunks take
  an mma.sync kernel (:func:`prefill_route`);
- ``paged_decode`` (K2) for C == 1 — replaces ``_decode_grouped_kernel``.
  In bf16 it is split-context flash-decoding: one block per (sequence, KV
  head, chunk of <= 16 query heads, split of the context), K/V streamed
  as bf16 by 16-byte ``cp.async``, both products on ``mma.sync``; the last
  split of each group to finish merges the splits' fp32 partials in split
  order.
  :func:`decode_plan` picks the splits from the shapes alone, so a decode
  step reads nothing back from the card. fp32 runs a CUDA-core kernel,
  the parity oracle.

Layout contract (as in the JAX package and ``kv_cache.py``): the pool is
``[slots, KV*D]`` flat token rows with ``slots = (num_blocks + 1) *
block_size`` (a trailing trash block); a ``[slots, KV, D]`` pool is viewed
flat. Block tables are padded with 0 past each sequence's live blocks;
nothing reads through a padded entry.

Each wrapper runs its kernel for CUDA tensors (or raises) and the plain
PyTorch version, :func:`paged_attention_plain`, for CPU tensors. Only a
launch counts in :data:`LAUNCHES`.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ...utils.device import scratch, sm_count

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"paged_prefill": 0, "paged_decode": 0}

#: head dims both kernels are instantiated for (any GQA group: K2 splits a
#: group wider than its 16-row block across blocks)
KERNEL_HEAD_DIMS = (16, 32, 64, 80, 96, 128)

#: K2 (bf16): query heads of a block, keys of a staged tile, the fewest
#: keys worth a split of their own, the blocks the plan aims for in SMs (a
#: few waves), and the most splits (the merge keeps a weight a split and
#: query head in the block's shared memory)
DEC_HEADS, DEC_TILE, DEC_MIN_SPLIT_KEYS, DEC_WAVES = 16, 64, 128, 4
DEC_MAX_SPLITS = 256
#: CUDA's grid limits on the y and z axes (K2: KV heads x head chunks,
#: sequences)
GRID_YZ_MAX = 65535


@functools.lru_cache(maxsize=256)
def decode_plan(S: int, KV: int, g: int, cap: int, sms: int):
    """K2's launch plan from shapes alone (no read of ``seq_lens``, so no
    device sync): ``(head_chunks, splits, keys_per_split)`` for ``S``
    sequences of ``KV`` KV heads with ``g`` query heads each, over a block
    table of ``cap = maxb * block_size`` keys, on a card of ``sms`` SMs.

    A block serves up to 16 query heads of one KV head (``head_chunks``
    per KV head). The context splits into ``splits`` ranges of
    ``keys_per_split`` keys (a multiple of the 64-key tile; together they
    cover ``cap``) until S x KV x head_chunks x splits reaches
    ``DEC_WAVES`` blocks an SM, each split keeping at least
    ``DEC_MIN_SPLIT_KEYS`` keys, and at most ``DEC_MAX_SPLITS`` splits. A
    split past a sequence's live range skips the key loop."""
    if min(S, KV, g, cap, sms) < 1:
        raise ValueError(f"decode_plan({S}, {KV}, {g}, {cap}, {sms})")
    head_chunks = -(-g // DEC_HEADS)
    pairs = S * KV * head_chunks
    tiles = -(-cap // DEC_TILE)
    most = max(1, min(DEC_MAX_SPLITS,
                      tiles // (DEC_MIN_SPLIT_KEYS // DEC_TILE)))
    splits = max(1, min(-(-DEC_WAVES * sms // pairs), most))
    per = -(-tiles // splits)
    return head_chunks, -(-tiles // per), per * DEC_TILE


#: K1 (bf16) on wgmma: queries of a work item (two consumer warpgroups of
#: 64), keys of a K/V tile, the head dims it is built for and the fewest
#: queries a slot it takes (a chunk of fewer runs the mma.sync kernel)
PREFILL_ROWS, PREFILL_KEYS = 128, 128
WGMMA_PREFILL_HEAD_DIMS = (64, 128)
WGMMA_PREFILL_MIN_C = 64
#: rows of a TMA box of the pool: a block size that is a multiple of it
#: loads K/V by TMA, any other by the cp.async gather
PREFILL_BOX = 64
#: K1's routes, numbered as ``csrc/paged_attention.cu``'s PrefillRoute
PREFILL_ROUTES = ("f32", "mma", "wgmma_tma", "wgmma_gather")


def prefill_route(C: int, D: int, dtype: torch.dtype,
                  block_size: int) -> str:
    """K1's kernel for a chunk of ``C`` queries a slot at head dim ``D``:
    a pure function of the shapes (never chosen on failure). fp32 runs the
    CUDA-core kernel (the parity oracle); bf16 runs the wgmma kernel at
    head dims 64 and 128 when C >= 64 -- its K/V by TMA when the block
    size is a multiple of the 64-row box, else by the cp.async gather --
    and the mma.sync kernel otherwise (head dims 16, 32, 80 and 96, and
    small SplitFuse chunks)."""
    if dtype == torch.float32:
        return "f32"
    if D in WGMMA_PREFILL_HEAD_DIMS and C >= WGMMA_PREFILL_MIN_C:
        return "wgmma_tma" if block_size % PREFILL_BOX == 0 \
            else "wgmma_gather"
    return "mma"


class PrefillPlan(NamedTuple):
    """The wgmma K1's deal: ``items`` work items (slot, query head,
    128-query tile) over ``grid`` persistent blocks; ``blocks[b]`` lists
    block b's items in order as ``(slot, head, query tile, key tiles)``,
    the key tiles counted for the worst case (every slot full)."""
    items: int
    grid: int
    blocks: Tuple[Tuple[Tuple[int, int, int, int], ...], ...]


def prefill_item(item: int, S: int, C: int, H: int) -> Tuple[int, int, int]:
    """(slot, head, query tile) of work item ``item``, as the kernel's
    ``PwItem`` reads it: a (slot, head)'s query tiles side by side, last
    first, then the next head of the slot, so that the blocks at work at
    one time read the same K/V (one head's tiles, then the query heads of
    one KV head) and find it in L2."""
    nqt = -(-C // PREFILL_ROWS)
    s, h = divmod(item // nqt, H)
    return s, h, nqt - 1 - item % nqt


def prefill_worst_tiles(qt: int, C: int, cap: int) -> int:
    """Key tiles of query tile ``qt`` when its slot is full: the chunk's
    queries at the table's last C positions, no window."""
    start = max(0, cap - C)
    hi = min(cap, start + min(C, (qt + 1) * PREFILL_ROWS))
    return -(-hi // PREFILL_KEYS)


@functools.lru_cache(maxsize=256)
def prefill_plan(S: int, C: int, H: int, cap: int, sms: int) -> PrefillPlan:
    """The wgmma K1's launch plan from shapes alone (no read of
    ``start_pos`` or ``seq_lens``, so no device sync): ``S`` slots of ``C``
    queries and ``H`` query heads over a block table of ``cap = maxb *
    block_size`` keys, on a card of ``sms`` SMs (one block an SM).

    Items run a (slot, head)'s query tiles side by side
    (:func:`prefill_item`) and are dealt in rounds of one item a block,
    forward in even rounds and backward in odd ones, so that under the
    causal diagonal each block's long and short items pair up (the
    kernel's ``pw_item``). Each item finds its live key range
    on the device; one with none skips its key loop."""
    if min(S, C, H, cap, sms) < 1:
        raise ValueError(f"prefill_plan({S}, {C}, {H}, {cap}, {sms})")
    nqt = -(-C // PREFILL_ROWS)
    items = nqt * S * H
    grid = min(items, sms)
    blocks = [[] for _ in range(grid)]
    for r in range(-(-items // grid)):
        for blk in range(grid):
            item = r * grid + (grid - 1 - blk if r % 2 else blk)
            if item >= items:
                continue
            s, h, qt = prefill_item(item, S, C, H)
            blocks[blk].append((s, h, qt, prefill_worst_tiles(qt, C, cap)))
    return PrefillPlan(items, grid, tuple(tuple(b) for b in blocks))


_LIB = None                        # the loaded kernel library


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          start_pos: torch.Tensor, seq_lens: torch.Tensor, *,
                          block_size: int, sm_scale: float,
                          sliding_window: Optional[int],
                          num_kv_heads: int) -> torch.Tensor:
    """The kernels' function in plain PyTorch: gather each sequence's
    context through its block table, mask, softmax in fp32.

    Query ``c`` of slot ``s`` (position ``start_pos[s] + c``) attends key
    ``j`` when ``j <= pos``, ``j < seq_lens[s]`` and, with a window,
    ``j > pos - window``. A row with no such key (an idle slot,
    ``seq_lens == 0``) is zeros. Products accumulate in fp32; as in the
    Pallas kernels, the probabilities are cast to the pool dtype before
    they multiply V, and the row sums are taken before that cast."""
    S, C, H, D = q.shape
    KV = num_kv_heads
    g = H // KV
    bs = block_size
    maxb = block_tables.shape[1]
    T = maxb * bs
    dev = q.device
    j = torch.arange(T, device=dev)
    tables = block_tables.long()
    rows = tables[:, j // bs] * bs + j % bs                     # [S, T]
    k = k_pool[rows].reshape(S, T, KV, D).float()
    v = v_pool[rows].reshape(S, T, KV, D).float()
    pos = start_pos.long()[:, None] + torch.arange(C, device=dev)[None, :]
    lens = seq_lens.long().clamp(max=T)
    mask = (j[None, None, :] <= pos[:, :, None]) \
        & (j[None, None, :] < lens[:, None, None])              # [S, C, T]
    if sliding_window is not None:
        mask = mask & (j[None, None, :] > pos[:, :, None] - sliding_window)
    qg = q.float().reshape(S, C, KV, g, D)
    s = torch.einsum("sckgd,stkd->skgct", qg, k) * sm_scale
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p.to(v_pool.dtype).float()
    o = torch.einsum("skgct,stkd->sckgd", p, v) \
        / torch.where(l == 0, torch.ones_like(l), l).permute(0, 3, 1, 2, 4)
    return o.reshape(S, C, H, D).to(q.dtype)


def check_kernel_shape(num_heads: int, num_kv_heads: int, head_dim: int,
                       dtype: torch.dtype) -> None:
    """Raise unless both kernels take these heads and dtype (the wrappers'
    check for CUDA tensors; the CPU tests call it on the configs the port
    serves): ValueError for malformed heads or a dtype the kernels do not
    take, NotImplementedError for a head dim that is not ported."""
    if num_heads % num_kv_heads:
        raise ValueError(f"GQA requires H % KV == 0 ({num_heads}/"
                         f"{num_kv_heads})")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q dtype {dtype}: the kernels take bf16 or fp32")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"head_dim {head_dim}: the paged-attention kernels for head "
            f"dims other than {KERNEL_HEAD_DIMS} are not ported")


def _flat_pool(pool: torch.Tensor, num_kv_heads: Optional[int]):
    if pool.dim() == 3:
        return pool.reshape(pool.shape[0], -1), pool.shape[1]
    if num_kv_heads is None:
        raise ValueError("num_kv_heads required with a flat 2-D pool")
    return pool, num_kv_heads


def _check(q, k_pool, v_pool, block_tables, start_pos, seq_lens, *,
           block_size, KV, decode):
    if q.dim() != 4:
        raise ValueError(f"q must be [S, C, H, D], got {tuple(q.shape)}")
    S, C, H, D = q.shape
    if decode and C != 1:
        raise ValueError(f"paged_decode takes C == 1, got C = {C}")
    if H % KV:
        raise ValueError(f"GQA requires H % KV == 0 ({H}/{KV})")
    if k_pool.dim() != 2 or k_pool.shape != v_pool.shape:
        raise ValueError("k_pool/v_pool must both be [slots, KV*D]")
    slots, KVD = k_pool.shape
    if KVD != KV * D:
        raise ValueError(f"pool rows {KVD} != KV*D = {KV * D}")
    if slots % block_size:
        raise ValueError(
            f"pool slots ({slots}) must be a multiple of block_size "
            f"({block_size}); allocate (num_blocks+1)*block_size")
    if block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError(f"block_tables must be [S={S}, MAXB]")
    if start_pos.shape != (S,) or seq_lens.shape != (S,):
        raise ValueError(f"start_pos and seq_lens must be [S={S}]")
    if not q.is_cuda:
        return
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("start_pos", start_pos),
                    ("seq_lens", seq_lens)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("start_pos", start_pos),
                    ("seq_lens", seq_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_kernel_shape(H, KV, D, q.dtype)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(
            f"pool dtype {k_pool.dtype}/{v_pool.dtype} != q dtype {q.dtype} "
            f"(cast q to the pool dtype)")
    for name, t in (("block_tables", block_tables), ("start_pos", start_pos),
                    ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")


def _run(name, q, k_pool, v_pool, block_tables, start_pos, seq_lens, *,
         block_size, sm_scale, sliding_window, num_kv_heads):
    """Both wrappers: check the arguments, then the plain version for CPU
    tensors, or launch kernel ``name`` and count the launch."""
    decode = name == "paged_decode"
    k_pool, KV = _flat_pool(k_pool, num_kv_heads)
    v_pool, _ = _flat_pool(v_pool, KV)
    _check(q, k_pool, v_pool, block_tables, start_pos, seq_lens,
           block_size=block_size, KV=KV, decode=decode)
    if not q.is_cuda:
        return paged_attention_plain(
            q, k_pool, v_pool, block_tables, start_pos, seq_lens,
            block_size=block_size, sm_scale=sm_scale,
            sliding_window=sliding_window, num_kv_heads=KV)
    global _LIB
    if _LIB is None:
        from . import _build
        _LIB = _build.load("paged_attention")
    lib = _LIB
    S, C, H, D = q.shape
    maxb = block_tables.shape[1]
    out = torch.empty_like(q)
    window = int(sliding_window) if sliding_window is not None else 0
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
              block_tables.data_ptr(), start_pos.data_ptr(),
              seq_lens.data_ptr(), out.data_ptr())
    if decode:
        hc, splits, kps = decode_plan(S, KV, H // KV, maxb * block_size,
                                      sm_count(q.device))
        part = cnt = 0
        if splits > 1 and q.dtype == torch.bfloat16:
            part, cnt = scratch(q.device, stream, S * H * splits * (D + 2),
                                S * KV * hc)
        err = lib.paged_decode_launch(
            *common, part, cnt, S, H, KV, D, maxb, block_size,
            float(sm_scale), window, int(q.dtype == torch.bfloat16), splits,
            kps, stream)
    else:
        route = prefill_route(C, D, q.dtype, block_size)
        grid = 0
        if route.startswith("wgmma"):
            grid = prefill_plan(S, C, H, maxb * block_size,
                                sm_count(q.device)).grid
        err = lib.paged_prefill_launch(
            *common, S, C, H, KV, D, maxb, block_size, float(sm_scale),
            window, k_pool.shape[0], PREFILL_ROUTES.index(route), grid,
            stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def paged_prefill(q, k_pool, v_pool, block_tables, start_pos, seq_lens, *,
                  block_size: int, sm_scale: float,
                  sliding_window: Optional[int] = None,
                  num_kv_heads: Optional[int] = None) -> torch.Tensor:
    """K1: attention for q ``[S, C, H, D]``, any C >= 1 (CUDA kernel on a
    card, by :func:`prefill_route`; the plain version on the CPU)."""
    return _run("paged_prefill", q, k_pool, v_pool, block_tables, start_pos,
                seq_lens, block_size=block_size, sm_scale=sm_scale,
                sliding_window=sliding_window, num_kv_heads=num_kv_heads)


def paged_decode(q, k_pool, v_pool, block_tables, start_pos, seq_lens, *,
                 block_size: int, sm_scale: float,
                 sliding_window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None) -> torch.Tensor:
    """K2: decode attention for q ``[S, 1, H, D]`` over any number of
    blocks per sequence (the linear layout is MAXB = 1)."""
    return _run("paged_decode", q, k_pool, v_pool, block_tables, start_pos,
                seq_lens, block_size=block_size, sm_scale=sm_scale,
                sliding_window=sliding_window, num_kv_heads=num_kv_heads)


def flash_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          start_pos: torch.Tensor, seq_lens: torch.Tensor, *,
                          block_size: int, sm_scale: Optional[float] = None,
                          sliding_window: Optional[int] = None,
                          num_kv_heads: Optional[int] = None,
                          alibi_slopes: Optional[torch.Tensor] = None,
                          k_scales: Optional[torch.Tensor] = None,
                          v_scales: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Flash attention over paged KV; K1 for C > 1, K2 for C == 1.

    q ``[S, C, H, D]`` (the step's K/V already appended to the pool);
    k_pool/v_pool ``[slots, KV*D]`` (or ``[slots, KV, D]``);
    block_tables ``[S, MAXB]`` int32; start_pos ``[S]`` int32 — position
    of ``q[s, 0]``; seq_lens ``[S]`` int32 — live context length (0 marks
    an idle slot, which emits zeros). Returns ``[S, C, H, D]`` in q.dtype.
    ALiBi and int8-pool scales are not ported yet."""
    if alibi_slopes is not None:
        raise NotImplementedError("ALiBi in the paged kernels is not ported")
    if k_scales is not None or v_scales is not None \
            or k_pool.dtype == torch.int8:
        raise NotImplementedError("the int8 KV pool is not ported")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    fn = paged_decode if q.shape[1] == 1 else paged_prefill
    return fn(q, k_pool, v_pool, block_tables, start_pos, seq_lens,
              block_size=block_size, sm_scale=sm_scale,
              sliding_window=sliding_window, num_kv_heads=num_kv_heads)
