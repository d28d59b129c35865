"""Flash attention, forward and backward (port of
``deepspeed_tpu/ops/kernels/flash_attention.py``).

Three hand-written CUDA kernels (``csrc/flash_attention.cu``) replace the
three Pallas kernels of the training path:

- ``flash_fwd`` — replaces ``_fwd_kernel``: O and the row logsumexp;
- ``flash_bwd_dq`` — replaces ``_bwd_dq_kernel``: dQ over the key tiles;
- ``flash_bwd_dkv`` — replaces ``_bwd_dkv_kernel``: dK/dV of each KV head
  over every query head of its GQA group and every query tile.

``delta = rowsum(dO * O)`` (minus the lse cotangent when lse is an output)
is computed in PyTorch between them, as the JAX package computes it in
XLA. Tensors are ``[B, H, T, D]`` views of any strides with a unit head_dim
stride, so BTHD activations pass as transposed views without a copy; the
kernels mask the ragged sequence edges themselves instead of padding to
the tile. The causal diagonal is bottom-right aligned (query ``i`` sees key
``j`` iff ``j <= i + Tk - Tq``).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version (``flash_fwd_plain``, ``flash_bwd_dq_plain``,
``flash_bwd_dkv_plain``) for CPU tensors. The plain versions make the same
casts as the Pallas kernels: P to V's dtype before P.V, ds to K's (dQ) or
Q's (dK) dtype, P to dO's dtype for dV. Only a launch counts in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}
KERNEL_HEAD_DIMS = (64, 128)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q dtype {q.dtype}: the kernels take bf16 or fp32")
    for t in (k, v):
        if t.dtype != q.dtype:
            raise ValueError(f"k/v dtype {t.dtype} != q dtype {q.dtype}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("the kernels need a unit head_dim stride")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernels take {KERNEL_HEAD_DIMS}")


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
        int(q.dtype == torch.bfloat16), stream)
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
    o = _empty_like_order(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v, o, lse), (q, k, v, o), q, k,
            causal=causal, sm_scale=sm_scale)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
                 sm_scale: float) -> torch.Tensor:
    """dQ from lse and delta (CUDA kernel on a card, plain on the CPU)."""
    _check(q, k, v, do, lse, delta)
    _check_rows(q, do, lse, delta)
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                                  sm_scale=sm_scale)
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
        elif do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
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
    (64 rows). ``return_lse`` also returns the row logsumexp ``[B, H, Tq]``
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
