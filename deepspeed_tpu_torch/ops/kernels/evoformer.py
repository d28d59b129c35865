"""Evoformer (triangle) attention forward kernel (port of
``deepspeed_tpu/ops/kernels/evoformer.py``).

One hand-written CUDA kernel (``csrc/evoformer.cu``), ``evoformer_fwd``,
replaces the Pallas kernel ``_fwd_kernel``: flash attention over
``[B, N, S, H, D]`` MSA / triangle tensors with the two canonical additive
biases added in the score tile, so the ``[B, N, H, Sq, Sk]`` score tensor
never exists in device memory:

- mask bias ``[B, N, Sk]`` (the reference's ``[B, N, 1, 1, Sk]``),
  broadcast over heads and queries;
- pair bias ``[B, H, Sq, Sk]`` (the reference's ``[B, 1, H, Sq, Sk]``),
  broadcast over the N rows.

:func:`evoformer_flash` is differentiable through a
``torch.autograd.Function`` whose backward recomputes through the plain
chunked path (``ops.evoformer_attn.DS4Sci_EvoformerAttention`` with
``use_kernel=False``), as the JAX package's ``_evo_bwd_rule`` does: one
extra forward's work, no backward kernel. Its forward launches the kernel
for CUDA tensors (or raises) and runs :func:`evoformer_flash_plain` for CPU
tensors. Only a launch counts in :data:`LAUNCHES`.

The kernel takes fp32, bf16 and fp16 (:data:`KERNEL_DTYPES`). In bf16 and
fp16 a block owns 64 query rows of one (b, h) and :data:`EVO_ROWS` MSA
rows, and stages each 64-key pair-bias tile once for them beside their
K/V tiles (:func:`evo_plan`); the biases stay f32 in every dtype.

The kernel runs head dims 16, 32 and 64 natively. For any other D up to
64 the wrapper zero-pads q, k and v along D to the next of these (the
scores and so the softmax are unchanged; the output is sliced back) and
keeps the scale of the true D; a D above 64 raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"evoformer_fwd": 0}
#: head dims the kernel is instantiated for; others up to the last are
#: zero-padded to the next one (:func:`kernel_head_dim`)
KERNEL_HEAD_DIMS = (16, 32, 64)
#: the kernel's dtype codes (fp32 the CUDA-core kernel, bf16 and fp16 the
#: tensor-core one)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_M_FLOOR = -1e30
#: the 16-bit kernel: MSA rows a block (a warp set of 4 warps each, every set
#: on the block's 64 query rows), query / key tile rows, and the shared
#: memory a block may take on an H100
EVO_ROWS = 2
EVO_TILE = 64
SMEM_LIMIT = 232448


class EvoPlan(NamedTuple):
    """The 16-bit kernel's launch for kernel head dim ``D`` over ``N`` MSA
    rows: a block owns ``rows`` MSA rows of one (b, h, 64-query tile),
    ``grid`` is (query tiles, H, B x row groups), the last group ragged when
    ``rows`` does not divide N; ``smem_bytes`` of dynamic shared memory
    (two cp.async stages, each the sets' K/V tiles and mask-bias rows and
    one 64 x 64 f32 pair-bias tile); ``pair_bias_bytes`` the pair bias the
    blocks read through L2, once per row group."""
    rows: int
    groups: int
    grid: tuple
    smem_bytes: int
    pair_bias_bytes: int


def evo_plan(D: int, B: int, N: int, H: int, Sq: int, Sk: int) -> EvoPlan:
    """The 16-bit kernel's plan, as ``csrc/evoformer.cu`` launches it
    (``EVO_SETS``, ``evo_stage_bytes``); the wrapper passes ``rows`` and the
    launch refuses any other. Shared memory does not grow with Sk: the key
    loop streams 64-key tiles."""
    if D not in KERNEL_HEAD_DIMS or min(B, N, H, Sq, Sk) < 1:
        raise ValueError(f"evo_plan({D}, {B}, {N}, {H}, {Sq}, {Sk})")
    R, T = EVO_ROWS, EVO_TILE
    groups = -(-N // R)
    stage = R * (2 * T * (D + 8) * 2 + T * 4) + T * T * 4
    return EvoPlan(R, groups, (-(-Sq // T), H, B * groups), 2 * stage,
                   B * H * Sq * Sk * 4 * groups)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def evoformer_flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask_bias: Optional[torch.Tensor] = None,
                          pair_bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``evoformer_fwd``'s function in plain PyTorch: f32 scores times the
    scale, + mask bias, + pair bias (as f32), keys past Sk excluded, the
    row max clamped at -1e30 (a row whose every key is -inf gives zeros),
    P cast to V's dtype before P.V with the sums taken before."""
    D = q.shape[-1]
    scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bnqhd,bnkhd->bnhqk", q.float(), k.float()) * scale
    if mask_bias is not None:
        s = s + mask_bias.float()[:, :, None, None, :]
    if pair_bias is not None:
        s = s + pair_bias.float()[:, None]
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_M_FLOOR)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bnhqk,bnkhd->bnhqd", p.to(v.dtype).float(), v.float())
    o = pv / torch.where(l == 0, torch.ones_like(l), l)
    return o.permute(0, 1, 3, 2, 4).to(q.dtype)


def kernel_head_dim(D: int) -> int:
    """The kernel instance that serves head dim ``D``: the least of
    :data:`KERNEL_HEAD_DIMS` at or above it."""
    for d in KERNEL_HEAD_DIMS:
        if D <= d:
            return d
    raise NotImplementedError(
        f"head_dim {D}: the Evoformer kernel for head dims over "
        f"{KERNEL_HEAD_DIMS[-1]} is not ported")


def _check(q, k, v, mask_bias, pair_bias):
    if q.dim() != 5 or k.shape != v.shape or k.dim() != 5:
        raise ValueError(f"expected [B, N, S, H, D] q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, N, Sq, H, D = q.shape
    Sk = k.shape[2]
    if k.shape[:2] != (B, N) or k.shape[3:] != (H, D):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if mask_bias is not None and mask_bias.shape != (B, N, Sk):
        raise ValueError(f"mask_bias {tuple(mask_bias.shape)} must be "
                         f"[B, N, Sk] = {(B, N, Sk)}")
    if pair_bias is not None and pair_bias.shape != (B, H, Sq, Sk):
        raise ValueError(f"pair_bias {tuple(pair_bias.shape)} must be "
                         f"[B, H, Sq, Sk] = {(B, H, Sq, Sk)}")


def evoformer_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask_bias: Optional[torch.Tensor] = None,
                  pair_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward (CUDA kernel on a card, the plain version on the CPU)."""
    _check(q, k, v, mask_bias, pair_bias)
    if not q.is_cuda:
        return evoformer_flash_plain(q, k, v, mask_bias, pair_bias)
    B, N, Sq, H, D = q.shape
    Sk = k.shape[2]
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"q dtype {q.dtype}: the kernel takes fp32, bf16 "
                         f"or fp16")
    for t in (k, v, mask_bias, pair_bias):
        if t is not None and t.device != q.device:
            raise ValueError(f"a tensor on {t.device}, q on {q.device}")
    for t in (k, v):
        if t.dtype != q.dtype:
            raise ValueError(f"k/v dtype {t.dtype} != q dtype {q.dtype}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("the kernel needs a unit head_dim stride")
    Dk = kernel_head_dim(D)
    if Dk != D:
        q, k, v = (torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v))
    # the biases as f32, contiguous (no copy when they already are)
    mb = None if mask_bias is None else \
        mask_bias.to(torch.float32).contiguous()
    pb = None if pair_bias is None else \
        pair_bias.to(torch.float32).contiguous()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    from . import _build
    lib = _build.load("evoformer")
    flat = [s for t in (q, k, v, o) for s in
            (t.stride(0), t.stride(1), t.stride(2), t.stride(3))]
    strides = (ctypes.c_longlong * len(flat))(*flat)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.evoformer_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if mb is None else mb.data_ptr(), 0 if pb is None else pb.data_ptr(),
        ctypes.addressof(strides), B, N, H, Sq, Sk, Dk, float(D ** -0.5),
        KERNEL_DTYPES[q.dtype], evo_plan(Dk, B, N, H, Sq, Sk).rows,
        stream)
    if err != 0:
        raise RuntimeError(f"evoformer_fwd failed: cudaError {err}")
    LAUNCHES["evoformer_fwd"] += 1
    return o if Dk == D else o[..., :D]


def _evo_ref(q, k, v, mask_bias, pair_bias):
    """The chunked plain path (identical math) that the backward replays."""
    from ..evoformer_attn import DS4Sci_EvoformerAttention
    biases = []
    if mask_bias is not None:
        biases.append(mask_bias[:, :, None, None, :])
    if pair_bias is not None:
        biases.append(pair_bias[:, None])
    return DS4Sci_EvoformerAttention(q, k, v, biases, use_kernel=False)


class _Evoformer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask_bias, pair_bias):
        ctx.save_for_backward(q, k, v, mask_bias, pair_bias)
        return evoformer_fwd(q, k, v, mask_bias, pair_bias)

    @staticmethod
    def backward(ctx, g):
        """``_evo_bwd_rule`` (``evoformer.py:187-210``): the VJP of the
        chunked plain path; bias gradients only for the biases given."""
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(True)
                      for t in saved]
            out = _evo_ref(*inputs)
            live = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad(out, live, g))
        return tuple(None if t is None else next(grads) for t in inputs)


def evoformer_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_bias: Optional[torch.Tensor] = None,
                    pair_bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Fused evoformer attention: q/k/v ``[B, N, S, H, D]``; ``mask_bias``
    ``[B, N, Sk]`` (additive, the reference's ``[B, N, 1, 1, Sk]``
    squeezed) and ``pair_bias`` ``[B, H, Sq, Sk]`` (the ``[B, 1, H, Sq,
    Sk]`` squeezed). Differentiable; the backward recomputes through the
    chunked plain path."""
    return _Evoformer.apply(q, k, v, mask_bias, pair_bias)
