"""Flash attention, forward and backward (port of
``deepspeed_tpu/ops/kernels/flash_attention.py``).

Hand-written CUDA kernels (``csrc/flash_attention.cu``) replace the three
Pallas kernels of the training path:

- ``flash_fwd`` — replaces ``_fwd_kernel``: O and the row logsumexp; at
  head dims 64 and 128 in bf16/fp16 a wgmma + TMA kernel (a persistent
  block an SM, work items of 192 or 128 query rows against 128-key K/V
  tiles, heaviest first: :func:`fwd_schedule`), at 16 and 32 an mma.sync
  one;
- ``flash_bwd`` — replaces ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
  together at head dims 64 and 128 in bf16/fp16: one wgmma + TMA kernel
  (``flash_bwd_wgmma_kernel``: work items of (batch, KV head, 128-key
  tile), dK/dV in registers over every query tile of the GQA group, dQ
  added into an fp32 workspace by bulk reduce-add; :func:`bwd_schedule`)
  between a prep pass (delta = rowsum(dO * O) - dlse, the workspace
  zeroed) and a cast pass (the workspace to dQ), three launches of one
  call;
- ``flash_bwd_dq`` / ``flash_bwd_dkv`` — the mma.sync pair at head dims 16
  and 32, and the CUDA-core pair in fp32, from a delta computed in
  PyTorch (as the JAX package computes it in XLA).

Tensors are ``[B, H, T, D]`` views of any strides with a unit head_dim
stride, so BTHD activations pass as transposed views without a copy; the
kernels mask the ragged sequence edges themselves instead of padding to
the tile. The causal diagonal is bottom-right aligned (query ``i`` sees key
``j`` iff ``j <= i + Tk - Tq``).

Each wrapper launches its kernels for CUDA tensors (or raises) and runs its
plain PyTorch version (``flash_fwd_plain``, ``flash_bwd_plain``,
``flash_bwd_dq_plain``, ``flash_bwd_dkv_plain``) for CPU tensors. The plain
versions make the same casts as the Pallas kernels: P to V's dtype before
P.V, ds to K's (dQ) or Q's (dK) dtype, P to dO's dtype for dV. Only a
launch counts in :data:`LAUNCHES`, each kernel under its own name.

A fourth kernel, ``flash_sparse_fwd`` (``csrc/sparse_attention.cu``),
replaces ``_fwd_sparse_kernel``: block-sparse attention forward over a
static ``(H, nq, nk)`` block mask, behind :func:`flash_attention_sparse`
(plain version :func:`flash_attention_sparse_plain`). :func:`sparse_route`
picks its kernel from the shapes: in bf16/fp16 at head dims 64 and 128 a
persistent wgmma + TMA kernel over the live 128-key tiles of each query
block, its items dealt by :func:`sparse_plan`; at the other head dims
(16, 32, 80, 96, others up to 128 zero-padded) an mma.sync one; in fp32 a
CUDA-core one. It counts in :data:`SPARSE_LAUNCHES` and, by route, in
:data:`SPARSE_ROUTES`.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_prep": 0,
                            "flash_bwd": 0, "flash_bwd_cast": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
#: head dims whose bf16/fp16 forward runs the wgmma + TMA kernel (the
#: training paths'); 16 and 32 (GPT2Config.tiny, untimed) run mma.sync
WGMMA_FWD_HEAD_DIMS = (64, 128)
#: query rows of a wgmma forward work item by head dim (64 for each
#: consumer warpgroup), keys of one of its K/V tiles
FWD_ROWS = {64: 192, 128: 128}
FWD_KEYS = 128
#: head dims whose bf16/fp16 backward runs the wgmma + TMA kernel; 16 and
#: 32, and fp32 at every head dim, run the dq / dkv pair
WGMMA_BWD_HEAD_DIMS = (64, 128)
#: query rows of a tile of the wgmma backward by head dim, keys of its
#: work item (64 for each consumer warpgroup)
BWD_ROWS = {64: 128, 128: 64}
BWD_KEYS = 128
#: the kernels' element types, by the code their C entry points take
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: block-sparse forward launches (a dict of its own: the training phases
#: hold every entry of :data:`LAUNCHES` to layers x steps)
SPARSE_LAUNCHES: Dict[str, int] = {"flash_sparse_fwd": 0}
#: the same launches by the kernel that ran (:func:`sparse_route`)
SPARSE_ROUTES: Dict[str, int] = {"f32": 0, "mma": 0, "wgmma": 0}
SPARSE_ROUTE_CODES = {"f32": 0, "mma": 1, "wgmma": 2}
#: head dims the block-sparse kernels are instantiated for (others up to
#: the last zero-padded to the next: :func:`sparse_head_dim`), and those
#: of the wgmma kernel
SPARSE_HEAD_DIMS = (16, 32, 64, 80, 96, 128)
SPARSE_WGMMA_HEAD_DIMS = (64, 128)
#: the wgmma route's query rows an item and keys a K/V tile, and an item's
#: cost in the plan beyond its tiles (its start and its stores), in tiles
SPARSE_ROWS = 128
SPARSE_KEYS = 128
SPARSE_ITEM_COST = 1
_TILE = 64                       # key rows of a tile of the mma / f32 route


def reset_launch_counts() -> None:
    for d in (LAUNCHES, SPARSE_LAUNCHES, SPARSE_ROUTES):
        for k in d:
            d[k] = 0


# ------------------------------------------------------------ plain versions


def _scores(q, k, *, causal, sm_scale):
    """fp32 scores ``[B, Hk, g, Tq, Tk]`` (GQA by a grouped view, never a
    repeat) and the live mask (None when nothing is masked)."""
    B, H, Tq, D = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hk, H // Hk, Tq, D)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * sm_scale
    mask = None
    if causal:
        i = torch.arange(Tq, device=q.device)[:, None]
        j = torch.arange(Tk, device=q.device)[None, :]
        mask = j <= i + (Tk - Tq)
    return s, mask


def _probs(q, k, lse, *, causal, sm_scale):
    """Backward probabilities exp(s - lse), zero where masked and where
    lse is not finite (a row with no live key)."""
    B, H, Tq, _ = q.shape
    Hk = k.shape[1]
    s, mask = _scores(q, k, causal=causal, sm_scale=sm_scale)
    lse_g = lse.float().reshape(B, Hk, H // Hk, Tq, 1)
    live = torch.isfinite(lse_g)
    if mask is not None:
        live = live & mask
    p = torch.exp(s - torch.where(torch.isfinite(lse_g), lse_g,
                                  torch.zeros_like(lse_g)))
    return p.masked_fill(~live, 0.0)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_fwd``'s function in plain PyTorch: ``(o, lse)`` with o
    ``[B, H, Tq, D]`` in q's dtype and lse ``[B, H, Tq]`` fp32. A row with
    no live key gives o = 0 and lse = -inf."""
    B, H, Tq, D = q.shape
    s, mask = _scores(q, k, causal=causal, sm_scale=sm_scale)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    # the probabilities in V's dtype before P.V, the sums taken before
    pv = torch.einsum("bkgqt,bktd->bkgqd", p.to(v.dtype).float(), v.float())
    o = pv / torch.where(l == 0, torch.ones_like(l), l)
    lse = m + torch.log(l)                                   # -inf where l == 0
    return (o.reshape(B, H, Tq, D).to(q.dtype),
            lse.reshape(B, H, Tq).contiguous())


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool,
                       sm_scale: float) -> torch.Tensor:
    """``flash_bwd_dq``'s function: dQ from lse and delta (both fp32
    ``[B, H, Tq]``), in q's dtype."""
    B, H, Tq, D = q.shape
    Hk = k.shape[1]
    p = _probs(q, k, lse, causal=causal, sm_scale=sm_scale)
    dog = do.float().reshape(B, Hk, H // Hk, Tq, D)
    dp = torch.einsum("bkgqd,bktd->bkgqt", dog, v.float())
    dl = delta.float().reshape(B, Hk, H // Hk, Tq, 1)
    ds = (p * (dp - dl) * sm_scale).to(k.dtype).float()
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, k.float())
    return dq.reshape(B, H, Tq, D).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool,
                        sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_bwd_dkv``'s function: dK and dV ``[B, Hk, Tk, D]`` summed
    over each KV head's query-head group, in k's and v's dtypes."""
    B, H, Tq, D = q.shape
    Hk = k.shape[1]
    p = _probs(q, k, lse, causal=causal, sm_scale=sm_scale)
    dog = do.float().reshape(B, Hk, H // Hk, Tq, D)
    qg = q.float().reshape(B, Hk, H // Hk, Tq, D)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p.to(do.dtype).float(), dog)
    dp = torch.einsum("bkgqd,bktd->bkgqt", dog, v.float())
    dl = delta.float().reshape(B, Hk, H // Hk, Tq, 1)
    ds = (p * (dp - dl) * sm_scale).to(q.dtype).float()
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_delta_plain(o, do, dlse=None) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32, minus the lse cotangent when lse
    is an output (the JAX package's ``_bwd``), contiguous ``[B, H, Tq]``:
    the function of the backward's prep pass."""
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def flash_bwd_plain(q, k, v, do, o, lse, dlse=None, *, causal: bool,
                    sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_bwd``'s function: ``(dq, dk, dv)`` from the forward's o and
    lse, and the cotangents dO and (when lse is an output) dlse."""
    delta = flash_bwd_delta_plain(o, do, dlse)
    kw = dict(causal=causal, sm_scale=sm_scale)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


# ------------------------------------------------------------ the kernels


def _empty_like_order(x: torch.Tensor,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A dense buffer of x's shape whose leading dims are laid out in the
    order of x's strides, head_dim last: a transposed BTHD view gets a
    BTHD buffer, so the caller's reshape back to [B, T, C] is a view."""
    order = sorted(range(3), key=lambda d: (-x.stride(d), d)) + [3]
    buf = torch.empty([x.shape[d] for d in order], dtype=dtype or x.dtype,
                      device=x.device)
    return buf.permute([order.index(d) for d in range(4)])


def check_kernel_shape(head_dim: int, dtype: torch.dtype) -> None:
    """Raise unless the flash kernels take this head dim and dtype (the
    wrappers' check for CUDA tensors; the CPU tests call it on the configs
    the port trains): ValueError for a dtype the kernels do not take,
    NotImplementedError for a head dim that is not ported."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"q dtype {dtype}: the kernels take bf16, fp16 or "
                         f"fp32")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"head_dim {head_dim}: the flash kernels for head dims other "
            f"than {KERNEL_HEAD_DIMS} are not ported")


def _check(q, k, v, *rest):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, T, D]")
    B, H, Tq, D = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % Hk:
        raise ValueError(f"GQA requires q_heads % kv_heads == 0 ({H}/{Hk})")
    if not q.is_cuda:
        return
    for t in (k, v) + rest:
        if t.device != q.device:
            raise ValueError(f"a tensor on {t.device}, q on {q.device}")
    check_kernel_shape(D, q.dtype)
    for t in (k, v):
        if t.dtype != q.dtype:
            raise ValueError(f"k/v dtype {t.dtype} != q dtype {q.dtype}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("the kernels need a unit head_dim stride")


def _check_tma(q, k, v, do=None, what: str = "forward") -> None:
    """The wgmma kernels read q, k, v (and the backward dO; 2-byte
    elements) through TMA maps: each base address and each stride of a
    (batch, head, time) dim longer than 1 must be a 16-byte multiple.
    Raise, naming the first that is not."""
    named = (("q", q), ("k", k), ("v", v)) + ((("dO", do),)
                                              if do is not None else ())
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} starts at an address that is not a "
                             f"16-byte multiple: the flash {what}'s TMA "
                             f"maps need one")
        for label, n, st in zip(("batch", "head", "time"), t.shape,
                                t.stride()):
            if n > 1 and st % 8:
                raise ValueError(
                    f"{name}'s {label} stride is {st} elements ({2 * st} "
                    f"bytes): the flash {what}'s TMA maps need 16-byte "
                    f"multiples")


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """t itself when TMA can read it (see :func:`_check_tma`; a broadcast
    dim, stride 0, counts as unreadable), else a dense copy: autograd hands
    the backward dO in whatever layout the graph produced (an expanded
    zero, a sliced view)."""
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        n == 1 or (st and st % 8 == 0)
        for n, st in zip(t.shape[:3], t.stride()[:3]))
    return t if ok else t.contiguous()


def _key_limit(i: int, Tq: int, Tk: int, causal: bool) -> int:
    """Keys [0, limit) that query row ``i`` sees (none past Tq)."""
    if i >= Tq:
        return 0
    return min(Tk, max(0, i + Tk - Tq + 1)) if causal else Tk


def fwd_key_tiles(qt: int, rows: int, Tq: int, Tk: int,
                  causal: bool) -> int:
    """The K/V tiles the wgmma forward loads for query tile ``qt`` of
    ``rows`` rows: those holding a key that its last live row sees; the
    tiles past them are above the causal diagonal for every row."""
    kend = _key_limit(min((qt + 1) * rows, Tq) - 1, Tq, Tk, causal)
    return -(-kend // FWD_KEYS)


def fwd_schedule(B: int, H: int, Tq: int, Tk: int, causal: bool, D: int,
                 sms: int) -> List[List[Tuple[int, int, int, int]]]:
    """The wgmma forward's work, as its kernel deals it: for each of its
    ``min(items, sms)`` persistent blocks, the ``(b, h, query tile, K/V
    tiles)`` items it walks, in order. The items run heaviest first
    (every (batch, head)'s last query tile, then the tiles before it, the
    heads of a GQA group side by side) and are dealt in rounds of one item
    a block, forward in even rounds and backward in odd ones, so that
    under the causal diagonal each block's long and short items even
    out."""
    rows = FWD_ROWS[D]
    nqt = -(-Tq // rows)
    items = nqt * B * H
    grid = min(items, sms)
    out: List[List[Tuple[int, int, int, int]]] = [[] for _ in range(grid)]
    for r in range(-(-items // grid)):
        for blk in range(grid):
            item = r * grid + (grid - 1 - blk if r % 2 else blk)
            if item >= items:
                continue
            qt = nqt - 1 - item // (B * H)
            bh = item % (B * H)
            out[blk].append((bh // H, bh % H, qt,
                             fwd_key_tiles(qt, rows, Tq, Tk, causal)))
    return out


def bwd_query_tiles(kt: int, Tq: int, Tk: int, causal: bool,
                    D: int) -> range:
    """The query tiles (of ``BWD_ROWS[D]`` rows) that see key tile ``kt``
    (of ``BWD_KEYS`` keys) in the wgmma backward: under the bottom-right
    causal diagonal those from the first holding a row ``i`` with
    ``i + Tk - Tq >= kt * BWD_KEYS``; empty when no row sees the tile."""
    rows = BWD_ROWS[D]
    nqt = -(-Tq // rows)
    first = max(0, kt * BWD_KEYS - (Tk - Tq)) // rows if causal else 0
    return range(min(first, nqt), nqt)


def bwd_schedule(B: int, H: int, Hk: int, Tq: int, Tk: int, causal: bool,
                 D: int, sms: int) -> List[List[Tuple[int, int, int, int]]]:
    """The wgmma backward's work, as its kernel deals it: for each of its
    ``min(items, sms)`` persistent blocks, the ``(b, hk, key tile,
    query tiles)`` items it walks, in order (query tiles counted over the
    GQA group's ``H // Hk`` heads: the block walks each head's
    :func:`bwd_query_tiles`, head by head). The items run (batch, KV
    head) by (batch, KV head), its key tiles in order, and are dealt in
    rounds of one item a block, forward in even rounds and backward in odd
    ones: the blocks at work at one time share a few heads (whose Q, dO
    and dQ workspace then stay in L2), and each block's key tile changes
    from round to round, so that its long and short items even out under
    the causal diagonal."""
    nkt = -(-Tk // BWD_KEYS)
    items = nkt * B * Hk
    grid = min(items, sms)
    out: List[List[Tuple[int, int, int, int]]] = [[] for _ in range(grid)]
    for r in range(-(-items // grid)):
        for blk in range(grid):
            item = r * grid + (grid - 1 - blk if r % 2 else blk)
            if item >= items:
                continue
            bh, kt = divmod(item, nkt)
            n = (H // Hk) * len(bwd_query_tiles(kt, Tq, Tk, causal, D))
            out[blk].append((bh // Hk, bh % Hk, kt, n))
    return out


def bwd_workspace_floats(B: int, H: int, Tq: int, D: int) -> Tuple[int, int]:
    """fp32 elements of the wgmma backward's two workspaces: the dQ
    accumulator (every query tile of every (batch, head), padded to whole
    tiles) and the prep pass's rows (lse in base 2 and delta, per tile)."""
    rows = BWD_ROWS[D]
    tiles = B * H * -(-Tq // rows)
    return tiles * rows * D, tiles * 2 * rows


def bwd_launch_names(head_dim: int, dtype: torch.dtype) -> Tuple[str, ...]:
    """The :data:`LAUNCHES` entries one backward on the card adds one to:
    the wgmma kernel and its two passes, or the dq / dkv pair."""
    if dtype != torch.float32 and head_dim in WGMMA_BWD_HEAD_DIMS:
        return ("flash_bwd_prep", "flash_bwd", "flash_bwd_cast")
    return ("flash_bwd_dq", "flash_bwd_dkv")


def _check_rows(q, do, lse, delta):
    """The backward's extra inputs: dO like q, lse/delta contiguous fp32."""
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} != q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3]:
            raise ValueError(f"{name} must be [B, H, Tq]")
    if not q.is_cuda:
        return
    if do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError("dO must have q's dtype and a unit head_dim stride")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32")


def _launch(name: str, ptrs, strided, q, k, *, causal, sm_scale) -> None:
    from . import _build
    lib = _build.load("flash_attention")
    B, H, Tq, D = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    flat = [s for t in strided for s in t.stride()[:3]]
    strides = (ctypes.c_longlong * len(flat))(*flat)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, f"{name}_launch")(
        *[t.data_ptr() for t in ptrs], ctypes.addressof(strides), B, H, Hk,
        Tq, Tk, D, float(sm_scale), int(bool(causal)),
        KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    LAUNCHES[name] += 1


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, sm_scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: ``(o, lse)`` for q ``[B, H, Tq, D]``, k/v ``[B, Hk, Tk, D]``
    (CUDA kernel on a card, the plain version on the CPU)."""
    _check(q, k, v)
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.dtype != torch.float32 and q.shape[-1] in WGMMA_FWD_HEAD_DIMS:
        _check_tma(q, k, v)
    o = _empty_like_order(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v, o, lse), (q, k, v, o), q, k,
            causal=causal, sm_scale=sm_scale)
    return o, lse


def _check_pair_route(q) -> None:
    if bwd_launch_names(q.shape[-1], q.dtype)[0] != "flash_bwd_dq":
        raise ValueError(
            f"head_dim {q.shape[-1]} in {q.dtype}: the backward runs "
            f"flash_bwd's wgmma kernel (the dq / dkv pair takes head dims "
            f"16 and 32, and fp32)")


def flash_bwd(q, k, v, do, o, lse, dlse=None, *, causal: bool,
              sm_scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward: ``(dq, dk, dv)`` from the forward's o and lse and the
    cotangents dO and (when lse is an output) dlse. On a card at head dims
    64 and 128 in bf16/fp16 the wgmma kernel with its prep and cast
    passes; otherwise delta in PyTorch and the dq / dkv pair; on the CPU
    :func:`flash_bwd_plain`."""
    _check(q, k, v, do, o, lse)
    if o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} != q {tuple(q.shape)}")
    if dlse is not None and dlse.shape != q.shape[:3]:
        raise ValueError("dlse must be [B, H, Tq]")
    kw = dict(causal=causal, sm_scale=sm_scale)
    if not q.is_cuda:
        _check_rows(q, do, lse, lse)
        return flash_bwd_plain(q, k, v, do, o, lse, dlse, **kw)
    if bwd_launch_names(q.shape[-1], q.dtype)[0] == "flash_bwd_dq":
        delta = flash_bwd_delta_plain(o, do, dlse)
        return (flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    if dlse is not None:
        dlse = dlse.float().contiguous()
    _check_rows(q, do, lse, lse if dlse is None else dlse)
    if o.dtype != q.dtype or o.stride(-1) != 1:
        raise ValueError("o must have q's dtype and a unit head_dim stride")
    _check_tma(q, k, v, do, what="backward")
    B, H, Tq, D = q.shape
    dq, dk, dv = _empty_like_order(q), _empty_like_order(k), \
        _empty_like_order(v)
    from ...utils.device import scratch
    n_dq, n_rows = bwd_workspace_floats(B, H, Tq, D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, _ = scratch(q.device, stream, n_dq + n_rows, 0)
    from . import _build
    lib = _build.load("flash_attention")
    flat = [s for t in (q, k, v, do, o, dq, dk, dv) for s in t.stride()[:3]]
    strides = (ctypes.c_longlong * len(flat))(*flat)
    err = lib.flash_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        o.data_ptr(), lse.data_ptr(),
        None if dlse is None else dlse.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), ws, ws + 4 * n_dq,
        ctypes.addressof(strides), B, H, k.shape[1], Tq, k.shape[2], D,
        float(sm_scale), int(bool(causal)), KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd failed: cudaError {err}")
    for name in bwd_launch_names(D, q.dtype):
        LAUNCHES[name] += 1
    return dq, dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
                 sm_scale: float) -> torch.Tensor:
    """dQ from lse and delta (CUDA kernel on a card, plain on the CPU)."""
    _check(q, k, v, do, lse, delta)
    _check_rows(q, do, lse, delta)
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                                  sm_scale=sm_scale)
    _check_pair_route(q)
    dq = _empty_like_order(q)
    _launch("flash_bwd_dq", (q, k, v, do, lse, delta, dq), (q, k, v, do, dq),
            q, k, causal=causal, sm_scale=sm_scale)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
                  sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV (CUDA kernel on a card, plain on the CPU)."""
    _check(q, k, v, do, lse, delta)
    _check_rows(q, do, lse, delta)
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                                   sm_scale=sm_scale)
    _check_pair_route(q)
    dk = _empty_like_order(k)
    dv = _empty_like_order(v)
    _launch("flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
            (q, k, v, do, dk, dv), q, k, causal=causal, sm_scale=sm_scale)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with both differentiable; the lse cotangent folds into the
    backward as ``delta - dlse`` (the JAX package's ``_flash_lse``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if q.is_cuda and q.dtype != torch.float32 and \
                q.shape[-1] in WGMMA_FWD_HEAD_DIMS:
            # the wgmma kernels read q/k/v by TMA: a view whose base or
            # strides TMA cannot take goes as a dense copy, which the
            # backward then reads too
            q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
        o, lse = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        elif q.is_cuda:
            do = _tma_ready(do)
        dq, dk, dv = flash_bwd(q, k, v, do, o, lse, dlse, causal=ctx.causal,
                               sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512,
                    layout: str = "BTHD", return_lse: bool = False):
    """Tiled online-softmax attention, differentiable.

    q ``[B, T, H, D]`` (``layout="BTHD"``, flax's order) or ``[B, H, T, D]``
    (``"BHTD"``); k/v in the same layout with a KV head count dividing H
    (GQA: query head ``h`` reads KV head ``h // (H // Hk)``, never a
    repeated copy). ``sm_scale`` defaults to 1/sqrt(D). ``block_q`` /
    ``block_k`` are accepted as tile hints; the kernels' tiles are fixed
    (the forward's 192 or 128 rows at head dims 64 and 128, else 64). ``return_lse`` also returns the row logsumexp ``[B, H, Tq]``
    fp32, itself differentiable (ring attention combines partials by it).
    """
    if layout == "BTHD":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    elif layout != "BHTD":
        raise ValueError(f"unknown layout {layout!r}")
    if block_q <= 0 or block_k <= 0:
        raise ValueError("block_q and block_k must be positive")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))
    if layout == "BTHD":
        o = o.transpose(1, 2)
    return (o, lse) if return_lse else o


# ------------------------------------------------------------ block-sparse


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _token_mask(block_mask: np.ndarray, block_q: int, block_k: int, tq: int,
                tk: int, device) -> torch.Tensor:
    """The block mask at token level: ``[H, Tq, Tk]`` bool, expanded on
    ``device``."""
    bm = torch.from_numpy(np.asarray(block_mask) > 0).to(device)
    return bm.repeat_interleave(block_q, dim=1).repeat_interleave(
        block_k, dim=2)[:, :tq, :tk]


def flash_attention_sparse_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, block_mask, *,
                                 sm_scale: float, block_q: int = 128,
                                 block_k: int = 128) -> torch.Tensor:
    """``flash_sparse_fwd``'s function in plain PyTorch, ``[B, H, T, D]``:
    softmax over the keys of the allowed ``block_q x block_k`` blocks
    (keys past Tk never count), P cast to V's dtype before P.V with the
    sums taken before; a row with no allowed key gives zeros."""
    B, H, Tq, D = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    live = _token_mask(block_mask, block_q, block_k, Tq, Tk, q.device)
    s, _ = _scores(q, k, causal=False, sm_scale=sm_scale)
    s = s.masked_fill(~live.reshape(Hk, H // Hk, Tq, Tk), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgqt,bktd->bkgqd", p.to(v.dtype).float(), v.float())
    o = pv / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, H, Tq, D).to(q.dtype)


def sparse_head_dim(head_dim: int) -> int:
    """The head dim the block-sparse kernels run ``head_dim`` at: itself
    when instantiated (:data:`SPARSE_HEAD_DIMS`), else the next one up
    (the wrapper zero-pads q, k and v to it: zero columns add nothing to
    Q K^T, and the extra output columns are sliced away).
    NotImplementedError past the largest."""
    for d in SPARSE_HEAD_DIMS:
        if head_dim <= d:
            return d
    raise NotImplementedError(
        f"head_dim {head_dim}: the block-sparse kernels for head dims above "
        f"{SPARSE_HEAD_DIMS[-1]} are not ported")


def sparse_route(dtype: torch.dtype, head_dim: int, block_q: int,
                 block_k: int) -> str:
    """The block-sparse kernel a card runs, from the shapes alone (never
    chosen on failure; a view a route cannot read goes to it as a dense
    copy): ``"f32"`` (the CUDA-core kernel) for fp32; ``"wgmma"`` for
    bf16 / fp16 at kernel head dims 64 and 128 (:func:`sparse_head_dim`)
    with ``block_q`` and ``block_k`` multiples of 128; ``"mma"`` (mma.sync)
    for the other head dims and for blocks of 64 (mod 128). Blocks that
    are no multiple of 64 raise NotImplementedError (the public entry
    clamps them to multiples of 128, so no JAX caller reaches this)."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"q dtype {dtype}: the block-sparse kernels take "
                         f"fp32, bf16 or fp16")
    dk = sparse_head_dim(head_dim)
    if block_q % _TILE or block_k % _TILE:
        raise NotImplementedError(
            f"block_q {block_q} / block_k {block_k}: the block-sparse "
            f"kernels for blocks that are no multiple of {_TILE} are not "
            f"ported")
    if dtype == torch.float32:
        return "f32"
    if dk in SPARSE_WGMMA_HEAD_DIMS and block_q % SPARSE_ROWS == 0 \
            and block_k % SPARSE_KEYS == 0:
        return "wgmma"
    return "mma"


def sparse_tile_csr(block_mask: np.ndarray, block_k: int, tk: int,
                    device, tile: int = _TILE
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(row_ptr, tiles)``: for each (head, query block), in order, the
    ``tile``-key tiles (64, or :data:`SPARSE_KEYS` on the wgmma route) of
    its allowed key blocks that start below ``tk`` (ascending), as int32
    CSR on ``device``; built on the host once per mask and kept on the
    device (the kernel only reads them)."""
    bm = np.asarray(block_mask) > 0
    return _tile_csr(bm.tobytes(), bm.shape, block_k, tk, str(device), tile)


def _live_tiles(bm: np.ndarray, block_k: int, tk: int,
                tile: int) -> np.ndarray:
    """``[h, nq, nk * block_k / tile]`` bool: the live key tiles."""
    nk = bm.shape[2]
    per = block_k // tile
    live = np.repeat(bm, per, axis=2)
    live &= (np.arange(nk * per) * tile < tk)[None, None, :]
    return live


@functools.lru_cache(maxsize=64)
def _tile_csr(mask_bytes: bytes, shape: Tuple[int, int, int], block_k: int,
              tk: int, device: str, tile: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    bm = np.frombuffer(mask_bytes, dtype=bool).reshape(shape)
    h, nq, _ = shape
    live = _live_tiles(bm, block_k, tk, tile).reshape(h * nq, -1)
    row_ptr = np.concatenate([[0], np.cumsum(live.sum(axis=1))]).astype(
        np.int32)
    tiles = np.nonzero(live)[1].astype(np.int32)
    return (torch.from_numpy(row_ptr).to(device),
            torch.from_numpy(np.concatenate([tiles, [0]]).astype(np.int32)
                             ).to(device))


class SparsePlan(NamedTuple):
    """The wgmma block-sparse forward's deal: ``items`` work items (batch,
    head, :data:`SPARSE_ROWS`-row query tile) over ``grid`` persistent
    blocks; ``blocks[i]`` lists block i's items in the order it walks them,
    as ``(b, h, query tile, live key tiles)``."""
    items: int
    grid: int
    blocks: Tuple[Tuple[Tuple[int, int, int, int], ...], ...]


def sparse_item_tiles(block_mask, block_q: int, block_k: int, Tq: int,
                      Tk: int) -> np.ndarray:
    """``[H, ceil(Tq / SPARSE_ROWS)]`` int: the live
    :data:`SPARSE_KEYS`-key tiles each (head, query tile) of the wgmma
    route walks (its query block's CSR row)."""
    bm = np.asarray(block_mask) > 0
    counts = _live_tiles(bm, block_k, Tk, SPARSE_KEYS).sum(axis=2)
    qb = np.arange(-(-Tq // SPARSE_ROWS)) * SPARSE_ROWS // block_q
    return counts[:, qb]


def sparse_plan(block_mask, block_q: int, block_k: int, Tq: int, Tk: int,
                B: int, sms: int) -> SparsePlan:
    """The wgmma route's launch plan from the mask and the shapes (nothing
    on the device): the (batch, head, query tile) items, heaviest first
    (most live key tiles; BSLongformer's global rows carry every tile),
    a (batch, head)'s items side by side within equal weights so that the
    blocks at work at one time read the same K/V from L2; each item goes
    to the least loaded of ``min(items, sms)`` persistent blocks (ties to
    the lowest index), counting an item as its tiles plus
    :data:`SPARSE_ITEM_COST` for its start and its stores. Each block then
    walks its items heaviest first, and no atomics decide who computes
    what, so the output is the same from call to call."""
    bm = np.asarray(block_mask) > 0
    if min(B, Tq, Tk, sms) < 1 or block_q % SPARSE_ROWS or \
            block_k % SPARSE_KEYS:
        raise ValueError(f"sparse_plan: block_q {block_q}, block_k "
                         f"{block_k}, Tq {Tq}, Tk {Tk}, B {B}, sms {sms}")
    H = bm.shape[0]
    if bm.shape != (H, -(-Tq // block_q), -(-Tk // block_k)):
        raise ValueError(f"sparse_plan: block_mask shape {bm.shape} for Tq "
                         f"{Tq}, Tk {Tk}, blocks {block_q} x {block_k}")
    per = sparse_item_tiles(bm, block_q, block_k, Tq, Tk)   # [H, nqt]
    nqt = per.shape[1]
    n = B * H * nqt
    weight = np.tile(per.reshape(-1), B)            # by code (b, h, qt)
    order = np.lexsort((np.arange(n), -weight))
    grid = min(n, sms)
    blocks: List[List[Tuple[int, int, int, int]]] = [[] for _ in
                                                      range(grid)]
    heap = [(0, blk) for blk in range(grid)]
    for code in order.tolist():
        load, blk = heapq.heappop(heap)
        t = int(weight[code])
        bh, qt = divmod(code, nqt)
        blocks[blk].append((bh // H, bh % H, qt, t))
        heapq.heappush(heap, (load + t + SPARSE_ITEM_COST, blk))
    return SparsePlan(n, grid, tuple(tuple(b) for b in blocks))


@functools.lru_cache(maxsize=64)
def _plan_tensors(mask_bytes: bytes, shape: Tuple[int, int, int],
                  block_q: int, block_k: int, tq: int, tk: int, B: int,
                  sms: int, device: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`sparse_plan` as the kernel reads it: ``block_ptr`` int32
    ``[grid + 1]`` and ``items`` int32 (each ``(b * H + h) * nqt + qt``)
    on ``device``, and the grid; cached beside the CSR."""
    bm = np.frombuffer(mask_bytes, dtype=bool).reshape(shape)
    plan = sparse_plan(bm, block_q, block_k, tq, tk, B, sms)
    H, nqt = shape[0], -(-tq // SPARSE_ROWS)
    sizes = [len(b) for b in plan.blocks]
    block_ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    items = np.array([(b * H + h) * nqt + qt for blk in plan.blocks
                      for b, h, qt, _ in blk], np.int32)
    return (torch.from_numpy(block_ptr).to(device),
            torch.from_numpy(items).to(device), plan.grid)


def _rows_ready(t: torch.Tensor) -> torch.Tensor:
    """t itself when the mma.sync kernel can read it (16-byte rows: the
    base and every (batch, head, time) stride 16-byte multiples), else a
    dense copy."""
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st in t.stride()[:3])
    return t if ok else t.contiguous()


def _unit_ready(t: torch.Tensor) -> torch.Tensor:
    """t itself when its head_dim stride is 1 (the fp32 kernel's one
    need), else a dense copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_sparse_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block_mask: np.ndarray, *, sm_scale: float,
                     block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """The block-sparse forward on ``[B, H, T, D]`` (a CUDA kernel on a
    card, by :func:`sparse_route`; the plain version on the CPU);
    ``block_mask`` a host array of shape ``(H, ceil(Tq / block_q),
    ceil(Tk / block_k))``. A head dim without an instance is zero-padded
    to :func:`sparse_head_dim`, ``sm_scale`` staying the caller's."""
    _check_sparse(q, k, v)
    if not q.is_cuda:
        return flash_attention_sparse_plain(q, k, v, block_mask,
                                            sm_scale=sm_scale,
                                            block_q=block_q, block_k=block_k)
    B, H, Tq, D = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    route = sparse_route(q.dtype, D, block_q, block_k)
    dk = sparse_head_dim(D)
    if dk != D:
        q, k, v = (torch.nn.functional.pad(t, (0, dk - D))
                   for t in (q, k, v))
    else:
        ready = {"wgmma": _tma_ready, "mma": _rows_ready,
                 "f32": _unit_ready}[route]
        q, k, v = (ready(t) for t in (q, k, v))
    bm = np.asarray(block_mask) > 0
    row_ptr, tiles = sparse_tile_csr(
        bm, block_k, Tk, q.device, SPARSE_KEYS if route == "wgmma" else _TILE)
    block_ptr = items = None
    grid = 0
    if route == "wgmma":
        from ...utils.device import sm_count
        block_ptr, items, grid = _plan_tensors(
            bm.tobytes(), bm.shape, block_q, block_k, Tq, Tk, B,
            sm_count(q.device), str(q.device))
    o = _empty_like_order(q)
    from . import _build
    lib = _build.load("sparse_attention")
    flat = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    strides = (ctypes.c_longlong * len(flat))(*flat)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sparse_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        row_ptr.data_ptr(), tiles.data_ptr(),
        None if block_ptr is None else block_ptr.data_ptr(),
        None if items is None else items.data_ptr(),
        ctypes.addressof(strides), B, H, Hk, Tq, Tk, dk, bm.shape[1],
        block_q, float(sm_scale), KERNEL_DTYPES[q.dtype],
        SPARSE_ROUTE_CODES[route], grid, stream)
    if err != 0:
        raise RuntimeError(f"flash_sparse_fwd ({route}) failed: cudaError "
                           f"{err}")
    SPARSE_LAUNCHES["flash_sparse_fwd"] += 1
    SPARSE_ROUTES[route] += 1
    return o if dk == D else o[..., :D]


def _check_sparse(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, T, D]")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"GQA requires q_heads % kv_heads == 0 "
                         f"({H}/{k.shape[1]})")
    if not q.is_cuda:
        return
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"a tensor on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"k/v dtype {t.dtype} != q dtype {q.dtype}")


class _SparseFlash(torch.autograd.Function):
    """Forward only, as the Pallas kernel (no VJP): a backward raises."""

    @staticmethod
    def forward(ctx, q, k, v, block_mask, sm_scale, block_q, block_k):
        return flash_sparse_fwd(q, k, v, block_mask, sm_scale=sm_scale,
                                block_q=block_q, block_k=block_k)

    @staticmethod
    def backward(ctx, do):
        raise RuntimeError(
            "flash_attention_sparse is forward-only (no backward, as the "
            "JAX package's kernel); train through sparse_attention's "
            "masked path (impl='xla')")


def flash_attention_sparse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block_mask, *, sm_scale: Optional[float] = None,
                           block_q: int = 128, block_k: int = 128,
                           layout: str = "BTHD") -> torch.Tensor:
    """Block-sparse flash attention (forward): ``block_mask`` is a static
    host ``(heads, ceil(T / block_q), ceil(T / block_k))`` bool/int layout
    (numpy or a CPU tensor); masked blocks are never read. q in
    ``layout`` (BTHD or BHTD); k/v with a KV head count dividing H (GQA
    reads the group's KV head, no repeat). Inference-oriented: a backward
    through it raises; training paths use the masked attention of
    ``ops.sparse_attention``."""
    if layout == "BTHD":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    elif layout != "BHTD":
        raise ValueError(f"unknown layout {layout!r}")
    b, h, tq, d = q.shape
    hk = k.shape[1]
    if hk != h and h % hk:
        raise ValueError(f"GQA requires q_heads % kv_heads == 0 ({h}/{hk})")
    tk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    block_q = min(block_q, _round_up(tq, 128))
    block_k = min(block_k, _round_up(tk, 128))
    nq, nk = -(-tq // block_q), -(-tk // block_k)
    if isinstance(block_mask, torch.Tensor):
        if block_mask.is_cuda:
            raise ValueError(
                "flash_attention_sparse needs a static host block_mask "
                "(numpy or a CPU tensor); it determines the kernel's tile "
                "lists, built on the host")
        block_mask = block_mask.numpy()
    bm = np.asarray(block_mask)
    if bm.shape != (h, nq, nk):
        raise ValueError(
            f"block_mask shape {bm.shape} != (heads={h}, nq={nq}, nk={nk}) "
            f"for block_q={block_q}, block_k={block_k}")
    o = _SparseFlash.apply(q, k, v, bm, float(sm_scale), block_q, block_k)
    if layout == "BTHD":
        o = o.transpose(1, 2)
    return o
