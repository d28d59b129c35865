"""Paged-KV flash attention (port of ``deepspeed_tpu/ops/kernels/paged_attention.py``).

Flash attention that reads K/V straight through per-sequence block tables,
so a step touches only the blocks a sequence occupies. Two hand-written
CUDA kernels (``csrc/paged_attention.cu``) replace the two Pallas kernels:

- ``paged_prefill`` (K1) for C > 1 queries per slot — replaces
  ``_paged_kernel``. In bf16 or fp16 at head dims 64 and 128 with C >= 64
  it is a persistent wgmma kernel: work items (slot, query head, 128
  queries), a head's query tiles side by side, dealt by
  :func:`prefill_plan` from the shapes alone, K/V through the block table
  by TMA (block sizes that are multiples of 64) or a cp.async gather,
  both products on wgmma, one block an item (the same bits from call to
  call). Other head dims, smaller chunks and an int8 pool take an
  mma.sync kernel (:func:`prefill_route`);
- ``paged_decode`` (K2) for C == 1 — replaces ``_decode_grouped_kernel``.
  In bf16 or fp16 it is split-context flash-decoding: one block per
  (sequence, KV head, chunk of <= 16 query heads, split of the context),
  K/V streamed by 16-byte ``cp.async``, both products on ``mma.sync``;
  the last split of each group to finish merges the splits' fp32
  partials in split order. A decode-loop ring (below) is one more split.
  :func:`decode_plan` picks the splits from the shapes alone, so a decode
  step reads nothing back from the card. fp32 runs a CUDA-core kernel,
  the parity oracle.

What the Pallas kernels compute, all of it: an int8 pool with per-(token,
KV head) f32 scales (``inference/v2/kv_quant.py``: the K scale multiplies
score column j after Q.K^T, the V scale probability column j after the
row sum and before P's cast to the compute dtype), ALiBi (``score -=
slope[h] * (pos - j)`` before the mask), and the decode loop's ring: the
loop's own K/V, unquantized in the compute dtype, attended after the
settled pool (row r sits ``ring_count - 1 - r`` behind the query).

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
#: the same launches by route (K1: :data:`PREFILL_ROUTES`; K2: ``split``
#: or ``f32``) and by what they took: an int8 pool, ALiBi slopes, a
#: decode-loop ring, fp16
ROUTE_LAUNCHES: Dict[str, int] = {
    k: 0 for k in ("prefill_f32", "prefill_mma", "prefill_wgmma_tma",
                   "prefill_wgmma_gather", "decode_f32", "decode_split",
                   "int8", "alibi", "ring", "fp16")}

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


def prefill_route(C: int, D: int, dtype: torch.dtype, block_size: int,
                  quant: bool = False) -> str:
    """K1's kernel for a chunk of ``C`` queries a slot at head dim ``D``
    in compute dtype ``dtype``, over an int8 pool when ``quant``: a pure
    function of the shapes (never chosen on failure). fp32 runs the
    CUDA-core kernel (the parity oracle). An int8 pool in bf16 or fp16
    runs the mma.sync kernel, which widens the int8 rows to the compute
    dtype in registers as it stages them (TMA copies bytes and cannot
    widen). Otherwise bf16 and fp16 run the wgmma kernel at head dims 64
    and 128 when C >= 64 -- its K/V by TMA when the block size is a
    multiple of the 64-row box, else by the cp.async gather -- and the
    mma.sync kernel elsewhere (head dims 16, 32, 80 and 96, and small
    SplitFuse chunks)."""
    if dtype == torch.float32:
        return "f32"
    if not quant and D in WGMMA_PREFILL_HEAD_DIMS \
            and C >= WGMMA_PREFILL_MIN_C:
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

#: q dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          start_pos: torch.Tensor, seq_lens: torch.Tensor, *,
                          block_size: int, sm_scale: float,
                          sliding_window: Optional[int],
                          num_kv_heads: int,
                          k_scales: Optional[torch.Tensor] = None,
                          v_scales: Optional[torch.Tensor] = None,
                          alibi_slopes: Optional[torch.Tensor] = None,
                          ring_k: Optional[torch.Tensor] = None,
                          ring_v: Optional[torch.Tensor] = None,
                          ring_count: int = 0) -> torch.Tensor:
    """The kernels' function in plain PyTorch: gather each sequence's
    context through its block table, mask, softmax in fp32.

    Query ``c`` of slot ``s`` (position ``start_pos[s] + c``) attends key
    ``j`` when ``j <= pos``, ``j < seq_lens[s]`` and, with a window,
    ``pos - j < window``. A row with no such key (an idle slot,
    ``seq_lens == 0``) is zeros. The compute dtype is q's over an int8
    pool and the pool's otherwise (q is cast to it, as the Pallas kernels
    do). Score ``(q . k_j) * sm_scale``, times ``k_scales[kv, j]`` over an
    int8 pool (whose codes widen exactly), less ``slope[h] * (pos - j)``
    with ALiBi, then the mask. Products accumulate in fp32; the row sums
    are taken, then probability column j is multiplied by ``v_scales[kv,
    j]``, then the probabilities are cast to the compute dtype before
    they multiply V.

    A ring (``ring_k``/``ring_v`` [R, S, KV*D] in the compute dtype, the
    decode loop's own K/V, C == 1): rows ``r < ring_count`` of a slot with
    ``seq_lens > 0`` are keys at distance ``ring_count - 1 - r`` behind
    the query, never scaled, attended after the pool's columns."""
    S, C, H, D = q.shape
    KV = num_kv_heads
    g = H // KV
    bs = block_size
    maxb = block_tables.shape[1]
    T = maxb * bs
    dev = q.device
    quant = k_pool.dtype == torch.int8
    cdt = q.dtype if quant else v_pool.dtype
    j = torch.arange(T, device=dev)
    tables = block_tables.long()
    rows = tables[:, j // bs] * bs + j % bs                     # [S, T]
    k = k_pool[rows].reshape(S, T, KV, D).float()
    v = v_pool[rows].reshape(S, T, KV, D).float()
    pos = start_pos.long()[:, None] + torch.arange(C, device=dev)[None, :]
    lens = seq_lens.long().clamp(max=T)
    dist = (pos[:, :, None] - j[None, None, :]).float()        # [S, C, T]
    mask = (dist >= 0) & (j[None, None, :] < lens[:, None, None])
    if sliding_window is not None:
        mask = mask & (dist < sliding_window)
    qg = q.to(cdt).float().reshape(S, C, KV, g, D)
    s = torch.einsum("sckgd,stkd->skgct", qg, k) * sm_scale
    if k_scales is not None:
        s = s * k_scales.float()[:, rows].permute(1, 0, 2)[:, :, None, None]
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().reshape(1, KV, g, 1, 1)
        s = s - slopes * dist[:, None, None]
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    if ring_k is not None:
        R = ring_k.shape[0]
        rk = ring_k.to(cdt).float().permute(1, 0, 2).reshape(S, R, KV, D)
        rv = ring_v.to(cdt).float().permute(1, 0, 2).reshape(S, R, KV, D)
        r = torch.arange(R, device=dev)
        rdist = (ring_count - 1 - r).float()                    # [R]
        rmask = (r[None, :] < ring_count) & (seq_lens[:, None] > 0)
        if sliding_window is not None:
            rmask = rmask & (rdist < sliding_window)[None, :]
        rs = torch.einsum("sckgd,srkd->skgcr", qg, rk) * sm_scale
        if slopes is not None:
            rs = rs - slopes * rdist
        rs = rs.masked_fill(~rmask[:, None, None, None, :], float("-inf"))
        s = torch.cat([s, rs], dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pp = p[..., :T]
    if v_scales is not None:
        pp = pp * v_scales.float()[:, rows].permute(1, 0, 2)[:, :, None, None]
    o = torch.einsum("skgct,stkd->sckgd", pp.to(cdt).float(), v)
    if ring_k is not None:
        o = o + torch.einsum("skgcr,srkd->sckgd",
                             p[..., T:].to(cdt).float(), rv)
    o = o / torch.where(l == 0, torch.ones_like(l), l).permute(0, 3, 1, 2, 4)
    return o.reshape(S, C, H, D).to(q.dtype)


def check_kernel_shape(num_heads: int, num_kv_heads: int, head_dim: int,
                       dtype: torch.dtype) -> None:
    """Raise unless both kernels take these heads and compute dtype (the
    wrappers' check for CUDA tensors; the CPU tests call it on the
    configs the port serves): ValueError for malformed heads or a dtype
    the kernels do not take, NotImplementedError for a head dim that is
    not ported."""
    if num_heads % num_kv_heads:
        raise ValueError(f"GQA requires H % KV == 0 ({num_heads}/"
                         f"{num_kv_heads})")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"q dtype {dtype}: the kernels take bf16, fp16 or "
                         f"fp32")
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


class _Extras(NamedTuple):
    """What a call adds to the plain pool: int8 scales [KV, slots], ALiBi
    slopes [H], the ring [R, S, KV*D] and its count."""
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None
    alibi_slopes: Optional[torch.Tensor] = None
    ring_k: Optional[torch.Tensor] = None
    ring_v: Optional[torch.Tensor] = None
    ring_count: int = 0


def _check(q, k_pool, v_pool, block_tables, start_pos, seq_lens, ex, *,
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
    quant = k_pool.dtype == torch.int8
    if (k_pool.dtype == torch.int8) != (v_pool.dtype == torch.int8):
        raise ValueError("k_pool and v_pool must both be int8 or neither")
    if quant:
        # (the JAX package's errors, flash_paged_attention:727-739)
        if ex.k_scales is None or ex.v_scales is None:
            raise ValueError("an int8 k_pool needs scales (scales_full or "
                             "k_scales+v_scales, see kv_quant.py)")
        for name, t in (("k_scales", ex.k_scales), ("v_scales", ex.v_scales)):
            if t.shape != (KV, slots):
                raise ValueError(f"{name} must be [{KV}, {slots}], got "
                                 f"{tuple(t.shape)}")
    elif ex.k_scales is not None or ex.v_scales is not None:
        raise ValueError("KV scales passed but the pool is not int8")
    if ex.alibi_slopes is not None and ex.alibi_slopes.shape != (H,):
        raise ValueError(f"alibi_slopes must be [H={H}], got "
                         f"{tuple(ex.alibi_slopes.shape)}")
    if (ex.ring_k is None) != (ex.ring_v is None):
        raise ValueError("ring_k and ring_v go together")
    if ex.ring_k is not None:
        if C != 1:
            raise ValueError("ring decode requires C == 1 (pure decode "
                             "steps)")
        R = ex.ring_k.shape[0]
        for name, t in (("ring_k", ex.ring_k), ("ring_v", ex.ring_v)):
            if t.shape != (R, S, KVD):
                raise ValueError(f"{name} must be [R, S={S}, {KVD}], got "
                                 f"{tuple(t.shape)}")
        if not 0 <= ex.ring_count <= R:
            raise ValueError(f"ring_count {ex.ring_count} outside "
                             f"[0, R={R}]")
    if not q.is_cuda:
        return
    check_kernel_shape(H, KV, D, q.dtype)
    if not quant and (k_pool.dtype != q.dtype or v_pool.dtype != q.dtype):
        raise ValueError(
            f"pool dtype {k_pool.dtype}/{v_pool.dtype} != q dtype {q.dtype} "
            f"(cast q to the pool dtype)")
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("start_pos", start_pos),
                    ("seq_lens", seq_lens), ("k_scales", ex.k_scales),
                    ("v_scales", ex.v_scales),
                    ("alibi_slopes", ex.alibi_slopes)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_scales", ex.k_scales), ("v_scales", ex.v_scales),
                    ("alibi_slopes", ex.alibi_slopes)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("ring_k", ex.ring_k), ("ring_v", ex.ring_v)):
        if t is None:
            continue
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {dev} (the "
                             f"compute dtype), got {t.dtype} on {t.device}")
        if t.stride(2) != 1 or t.stride(1) != KVD:
            raise ValueError(f"{name}'s rows [S, KV*D] must be dense")
    if ex.ring_k is not None and ex.ring_k.stride() != ex.ring_v.stride():
        raise ValueError("ring_k and ring_v must share their strides")
    for name, t in (("block_tables", block_tables), ("start_pos", start_pos),
                    ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _run(name, q, k_pool, v_pool, block_tables, start_pos, seq_lens, ex, *,
         block_size, sm_scale, sliding_window, num_kv_heads):
    """Both wrappers: check the arguments, then the plain version for CPU
    tensors, or launch kernel ``name`` and count the launch."""
    decode = name == "paged_decode"
    k_pool, KV = _flat_pool(k_pool, num_kv_heads)
    v_pool, _ = _flat_pool(v_pool, KV)
    _check(q, k_pool, v_pool, block_tables, start_pos, seq_lens, ex,
           block_size=block_size, KV=KV, decode=decode)
    if not q.is_cuda:
        return paged_attention_plain(
            q, k_pool, v_pool, block_tables, start_pos, seq_lens,
            block_size=block_size, sm_scale=sm_scale,
            sliding_window=sliding_window, num_kv_heads=KV, **ex._asdict())
    global _LIB
    if _LIB is None:
        from . import _build
        _LIB = _build.load("paged_attention")
    lib = _LIB
    S, C, H, D = q.shape
    maxb = block_tables.shape[1]
    slots = k_pool.shape[0]
    quant = k_pool.dtype == torch.int8
    out = torch.empty_like(q)
    window = int(sliding_window) if sliding_window is not None else 0
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
              block_tables.data_ptr(), start_pos.data_ptr(),
              seq_lens.data_ptr(), out.data_ptr(), _ptr(ex.k_scales),
              _ptr(ex.v_scales), _ptr(ex.alibi_slopes))
    code = DTYPE_CODES[q.dtype]
    if decode:
        hc, splits, kps = decode_plan(S, KV, H // KV, maxb * block_size,
                                      sm_count(q.device))
        ring = ex.ring_k is not None
        # the ring is one more split, merged after the pool's in order
        total = splits + int(ring)
        part = cnt = 0
        if total > 1 and q.dtype != torch.float32:
            part, cnt = scratch(q.device, stream, S * H * total * (D + 2),
                                S * KV * hc)
        err = lib.paged_decode_launch(
            *common, part, cnt, _ptr(ex.ring_k), _ptr(ex.ring_v), S, H, KV,
            D, maxb, block_size, float(sm_scale), window, slots, code,
            int(quant), splits, kps,
            ex.ring_k.stride(0) if ring else 0,
            int(ex.ring_count) if ring else 0, stream)
        route = "decode_f32" if q.dtype == torch.float32 else "decode_split"
    else:
        route = prefill_route(C, D, q.dtype, block_size, quant)
        grid = 0
        if route.startswith("wgmma"):
            grid = prefill_plan(S, C, H, maxb * block_size,
                                sm_count(q.device)).grid
        err = lib.paged_prefill_launch(
            *common, S, C, H, KV, D, maxb, block_size, float(sm_scale),
            window, slots, PREFILL_ROUTES.index(route), grid, code,
            int(quant), stream)
        route = "prefill_" + route
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[route] += 1
    for key, on in (("int8", quant), ("alibi", ex.alibi_slopes is not None),
                    ("ring", ex.ring_k is not None),
                    ("fp16", q.dtype == torch.float16)):
        ROUTE_LAUNCHES[key] += int(on)
    return out


def paged_prefill(q, k_pool, v_pool, block_tables, start_pos, seq_lens, *,
                  block_size: int, sm_scale: float,
                  sliding_window: Optional[int] = None,
                  num_kv_heads: Optional[int] = None,
                  k_scales: Optional[torch.Tensor] = None,
                  v_scales: Optional[torch.Tensor] = None,
                  alibi_slopes: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """K1: attention for q ``[S, C, H, D]``, any C >= 1 (CUDA kernel on a
    card, by :func:`prefill_route`; the plain version on the CPU)."""
    return _run("paged_prefill", q, k_pool, v_pool, block_tables, start_pos,
                seq_lens, _Extras(k_scales, v_scales, alibi_slopes),
                block_size=block_size, sm_scale=sm_scale,
                sliding_window=sliding_window, num_kv_heads=num_kv_heads)


def paged_decode(q, k_pool, v_pool, block_tables, start_pos, seq_lens, *,
                 block_size: int, sm_scale: float,
                 sliding_window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None,
                 k_scales: Optional[torch.Tensor] = None,
                 v_scales: Optional[torch.Tensor] = None,
                 alibi_slopes: Optional[torch.Tensor] = None,
                 ring_k: Optional[torch.Tensor] = None,
                 ring_v: Optional[torch.Tensor] = None,
                 ring_count: int = 0) -> torch.Tensor:
    """K2: decode attention for q ``[S, 1, H, D]`` over any number of
    blocks per sequence (the linear layout is MAXB = 1), and the ring."""
    return _run("paged_decode", q, k_pool, v_pool, block_tables, start_pos,
                seq_lens, _Extras(k_scales, v_scales, alibi_slopes, ring_k,
                                  ring_v, int(ring_count)),
                block_size=block_size, sm_scale=sm_scale,
                sliding_window=sliding_window, num_kv_heads=num_kv_heads)


def flash_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          start_pos: torch.Tensor, seq_lens: torch.Tensor, *,
                          block_size: int, sm_scale: Optional[float] = None,
                          sliding_window: Optional[int] = None,
                          num_kv_heads: Optional[int] = None,
                          alibi_slopes: Optional[torch.Tensor] = None,
                          k_scales: Optional[torch.Tensor] = None,
                          v_scales: Optional[torch.Tensor] = None,
                          scales_full: Optional[torch.Tensor] = None,
                          pool_layer: Optional[int] = None,
                          ring_k: Optional[torch.Tensor] = None,
                          ring_v: Optional[torch.Tensor] = None,
                          ring_count: int = 0) -> torch.Tensor:
    """Flash attention over paged KV; K1 for C > 1, K2 for C == 1.

    q ``[S, C, H, D]`` (the step's K/V already in the pool, or in the
    ring); k_pool/v_pool ``[slots, KV*D]`` (or ``[slots, KV, D]``) in q's
    dtype, or int8 with scales; block_tables ``[S, MAXB]`` int32;
    start_pos ``[S]`` int32 — position of ``q[s, 0]``; seq_lens ``[S]``
    int32 — live context length in the pool (0 marks an idle slot, which
    emits zeros; with a ring, the settled length, ring tokens excluded).
    ``alibi_slopes`` ``[H]`` f32: ALiBi. An int8 pool takes its f32
    scales as ``k_scales``/``v_scales`` ``[KV, slots]``, or as
    ``scales_full`` ``[L, 2, KV, slots]`` with ``pool_layer`` (as the JAX
    package does); q then stays in the compute dtype. ``ring_k``/
    ``ring_v`` ``[R, S, KV*D]`` in q's dtype (views of the decode loop's
    ``[R, L, 2, S, KV*D]`` carry at one layer; rows dense) with
    ``ring_count`` valid rows: decode only. Returns ``[S, C, H, D]`` in
    q.dtype. See :func:`paged_attention_plain` for the function."""
    if scales_full is not None:
        li = int(pool_layer) if pool_layer is not None else 0
        if k_scales is None:
            k_scales, v_scales = scales_full[li, 0], scales_full[li, 1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(block_size=block_size, sm_scale=sm_scale,
              sliding_window=sliding_window, num_kv_heads=num_kv_heads,
              k_scales=k_scales, v_scales=v_scales, alibi_slopes=alibi_slopes)
    if q.shape[1] == 1:
        return paged_decode(q, k_pool, v_pool, block_tables, start_pos,
                            seq_lens, ring_k=ring_k, ring_v=ring_v,
                            ring_count=ring_count, **kw)
    if ring_k is not None:
        raise ValueError("ring decode requires C == 1 (pure decode steps)")
    return paged_prefill(q, k_pool, v_pool, block_tables, start_pos,
                         seq_lens, **kw)
