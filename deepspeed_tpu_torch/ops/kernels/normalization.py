"""Fused RMSNorm / LayerNorm (port of
``deepspeed_tpu/ops/kernels/normalization.py``).

Two hand-written CUDA kernels (``csrc/normalization.cu``) replace the two
Pallas kernels:

- ``rms_norm`` — replaces ``_rms_kernel``: ``x * rsqrt(mean(x^2) + eps) *
  w``;
- ``layer_norm`` — replaces ``_ln_kernel``: ``(x - mean) * rsqrt(var +
  eps) * w + b``, the variance of the centred row.

Both take x in f32 whatever its dtype and cast the output back to it; the
weight and bias are read as f32. :func:`norm_plan` picks the kernel's
route and launch from the shapes alone: rows held in registers by teams
of warps (``"rows"``, every hidden size of 16-byte rows whose weights fit
in shared memory) or a block a row (``"scalar"``). Each norm is one
``torch.autograd.Function`` on both devices: the forward launches the
kernel for a CUDA tensor (or raises) and runs the plain version
(:func:`rms_norm_plain`, :func:`layer_norm_plain`) for a CPU tensor; the
backward is the JAX package's hand-written VJP (``_rms_bwd``,
``_ln_bwd``) in plain PyTorch on either device. Only a launch counts in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import torch

from ...utils.device import sm_count

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"rms_norm": 0, "layer_norm": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the rows route: 16-byte vectors a lane it is instantiated for, the
#: count a lane takes wherever a row needs that many (the fastest in
#: ``chip_smoke.py --norm-sweep`` at every shape it times: more registers
#: a thread spill at 16), warps of a row's team at most, warps of a block,
#: and the shared memory its staged f32 weights may take
NORM_VPLS = (1, 2, 4, 8, 16)
NORM_LANE_VECTORS = 4
NORM_MAX_TEAM_WARPS = 16
NORM_BLOCK_WARPS = 16
NORM_SMEM_LIMIT = 160 * 1024
_ROUTES = {"rows": 0, "scalar": 1}


class NormPlan(NamedTuple):
    """The norm kernel's launch: ``route`` "rows" (a team of ``wpr`` warps
    holds a row in registers, ``vpl`` 16-byte vectors a lane, ``teams``
    rows in flight a block of ``threads``, the weights staged in
    ``smem_bytes`` of shared memory; blocks persistent, teams walking the
    rows by grid stride) or "scalar" (a block a row; the other fields 0)."""
    route: str
    wpr: int
    vpl: int
    teams: int
    threads: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def norm_plan(rows: int, hidden: int, dtype: torch.dtype,
              layer_norm: bool) -> NormPlan:
    """The launch for ``rows`` rows of ``hidden`` elements of ``dtype``,
    from the shapes alone: the rows route where a row is whole 16-byte
    vectors and its f32 weights (w, and b for LayerNorm) fit in
    :data:`NORM_SMEM_LIMIT` -- a warp a row with the fewest vectors a lane
    while :data:`NORM_LANE_VECTORS` cover it, else that many vectors a
    lane (8 or 16 where a team would need more than 16 warps) and the
    fewest warps a row, :data:`NORM_BLOCK_WARPS` warps a block; otherwise
    the scalar route."""
    if rows <= 0 or hidden <= 0:
        raise ValueError(f"norm_plan({rows}, {hidden}): positive sizes")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {dtype}: the kernels take fp32, bf16 or "
                         f"fp16")
    n = 16 // dtype.itemsize
    smem = hidden * 4 * (2 if layer_norm else 1)
    nv = hidden // n
    if hidden % n or smem > NORM_SMEM_LIMIT:
        return NormPlan("scalar", 0, 0, 0, 0, 0)
    for vpl in NORM_VPLS:
        if vpl <= NORM_LANE_VECTORS and 32 * vpl >= nv:
            return NormPlan("rows", 1, vpl, NORM_BLOCK_WARPS,
                            32 * NORM_BLOCK_WARPS, smem)
    for vpl in NORM_VPLS:
        wpr = -(-nv // (32 * vpl))
        if vpl >= NORM_LANE_VECTORS and wpr <= NORM_MAX_TEAM_WARPS:
            teams = NORM_BLOCK_WARPS // wpr
            return NormPlan("rows", wpr, vpl, teams, 32 * wpr * teams, smem)
    return NormPlan("scalar", 0, 0, 0, 0, 0)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it when its data does not start on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions


def rms_norm_plain(x2d: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """``rms_norm``'s function in plain PyTorch (the Pallas arithmetic)."""
    x = x2d.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * w.float()).to(x2d.dtype)


def layer_norm_plain(x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """``layer_norm``'s function in plain PyTorch (the Pallas arithmetic)."""
    x = x2d.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x2d.dtype)


# ------------------------------------------------------------ the kernels


def _launch(name: str, x2d, w, b, eps) -> torch.Tensor:
    if x2d.dtype not in _DTYPE_CODES:
        raise ValueError(f"x dtype {x2d.dtype}: the kernels take fp32, "
                         "bf16 or fp16")
    for t in (w,) if b is None else (w, b):
        if t.device != x2d.device:
            raise ValueError(f"a parameter on {t.device}, x on {x2d.device}")
    rows, hidden = x2d.shape
    if rows == 0:
        return torch.empty_like(x2d)
    from . import _build
    lib = _build.load("normalization")
    plan = norm_plan(rows, hidden, x2d.dtype, b is not None)
    x2d = x2d.contiguous()
    wf = w.float().contiguous()
    bf = None if b is None else b.float().contiguous()
    if plan.route == "rows":          # 16-byte vectors of x, w and b
        x2d, wf = _aligned(x2d), _aligned(wf)
        bf = None if bf is None else _aligned(bf)
    out = torch.empty_like(x2d)
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    err = lib.norm_fwd_launch(
        x2d.data_ptr(), wf.data_ptr(), 0 if bf is None else bf.data_ptr(),
        out.data_ptr(), rows, hidden, float(eps), int(b is not None),
        _DTYPE_CODES[x2d.dtype], _ROUTES[plan.route], plan.wpr, plan.vpl,
        plan.teams, sm_count(x2d.device), stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def rms_norm_fwd(x2d: torch.Tensor, w: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """RMSNorm forward of ``[rows, hidden]`` (CUDA kernel on a card, the
    plain version on the CPU)."""
    if not x2d.is_cuda:
        return rms_norm_plain(x2d, w, eps)
    return _launch("rms_norm", x2d, w, None, eps)


def layer_norm_fwd(x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LayerNorm forward of ``[rows, hidden]`` (CUDA kernel on a card, the
    plain version on the CPU)."""
    if not x2d.is_cuda:
        return layer_norm_plain(x2d, w, b, eps)
    return _launch("layer_norm", x2d, w, b, eps)


# ------------------------------------------------------------ autograd


def _stats(x, eps, centre):
    xf = x.float()
    xc = xf - torch.mean(xf, dim=-1, keepdim=True) if centre else xf
    rstd = torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + eps)
    return xc * rstd, rstd


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, eps):
        ctx.save_for_backward(x2d, w)
        ctx.eps = eps
        return rms_norm_fwd(x2d, w, eps)

    @staticmethod
    def backward(ctx, g):
        """``_rms_bwd`` (``normalization.py:64-74``)."""
        x, w = ctx.saved_tensors
        xhat, rstd = _stats(x, ctx.eps, centre=False)
        gf = g.float()
        dw = torch.sum(gf * xhat, dim=0).to(w.dtype)
        gw = gf * w.float()
        dx = rstd * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
        return dx.to(x.dtype), dw, None


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, b, eps):
        ctx.save_for_backward(x2d, w)
        ctx.eps = eps
        ctx.b_dtype = b.dtype
        return layer_norm_fwd(x2d, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        """``_ln_bwd`` (``normalization.py:130-143``); db takes w's dtype,
        as there."""
        x, w = ctx.saved_tensors
        xhat, rstd = _stats(x, ctx.eps, centre=True)
        gf = g.float()
        dw = torch.sum(gf * xhat, dim=0).to(w.dtype)
        db = torch.sum(gf, dim=0).to(w.dtype)
        gw = gf * w.float()
        dx = rstd * (gw - torch.mean(gw, dim=-1, keepdim=True)
                     - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
        return dx.to(x.dtype), dw, db.to(ctx.b_dtype), None


def _check(x, weight, *rest):
    hidden = x.shape[-1] if x.dim() else 0
    for name, t in zip(("weight", "bias"), (weight,) + rest):
        if t.shape != (hidden,):
            raise ValueError(f"{name} {tuple(t.shape)} must be [{hidden}] "
                             f"for x {tuple(x.shape)}")


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; f32 statistics regardless of input
    dtype; differentiable in x and weight."""
    _check(x, weight)
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    return _RMSNorm.apply(x2d, weight, float(eps)).reshape(shape)


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, *, eps: float = 1e-5
                     ) -> torch.Tensor:
    """LayerNorm over the last axis; f32 statistics regardless of input
    dtype; differentiable in x, weight and bias."""
    _check(x, weight, bias)
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    return _LayerNorm.apply(x2d, weight, bias, float(eps)).reshape(shape)
