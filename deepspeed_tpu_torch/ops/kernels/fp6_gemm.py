"""Fused FP6 (e3m2) weight-only GEMM (port of
``deepspeed_tpu/ops/kernels/fp6_gemm.py``).

Weights cross device memory at 6 bits a value and are decoded to the
compute dtype tile by tile inside the GEMM. One hand-written CUDA kernel
(``csrc/fp6_gemm.cu``), ``fp6_matmul``, replaces the Pallas kernel
``_fp6_kernel``.

Storage layout (:func:`fp6_gemm_pack`): a [K, N] weight (N % 4 == 0)
becomes

- ``bytes3`` [3, K, N/4] uint8 — the byte planes of the 24-bit word packing
  the 4 codes of columns (j, j + N/4, j + N/2, j + 3N/4);
- ``scale`` [4, N/4] f32 — per-column scales, plane-major;

so output column ``p * N/4 + j`` comes from plane ``p`` of packed column
``j`` and the kernel writes row-major [M, N] directly.

:func:`fp6_matmul` launches the kernel for a CUDA tensor (bf16 on the
tensor cores, fp32 on a CUDA-core parity kernel; another dtype raises) and
runs :func:`fp6_matmul_plain` for a CPU tensor. Both decode each weight,
scale it in f32 and cast it to x's dtype before the product (f32 sums).
Only a launch counts in :data:`LAUNCHES`. Packing and unpacking are plain
PyTorch, as they are jnp in the JAX package.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..fp_quantizer import _minifloat_decode, _minifloat_encode

_E, _M = 3, 2                      # e3m2
_BIAS = 2 ** (_E - 1) - 1          # 3
_MAX = 2.0 ** _BIAS * (2.0 - 2.0 ** (-_M))      # 14.0

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"fp6_matmul": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Fp6GemmWeight(NamedTuple):
    bytes3: torch.Tensor           # [3, K, N/4] uint8
    scale: torch.Tensor            # [4, N/4] f32
    shape: Tuple[int, int]         # (K, N)


def fp6_gemm_pack(w: torch.Tensor) -> Fp6GemmWeight:
    """Quantize a [K, N] weight (N % 4 == 0) to the GEMM layout with
    per-column scales (a true division by 14, as the JAX package)."""
    K, N = w.shape
    if N % 4:
        raise ValueError(f"N ({N}) must be divisible by 4")
    J = N // 4
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=0), min=1e-12) / _MAX      # [N]
    codes = _minifloat_encode(wf / scale[None, :], _E, _M).to(torch.int32)
    word = (codes[:, :J] | (codes[:, J:2 * J] << 6)
            | (codes[:, 2 * J:3 * J] << 12) | (codes[:, 3 * J:] << 18))
    bytes3 = torch.stack([word & 0xFF, (word >> 8) & 0xFF,
                          (word >> 16) & 0xFF]).to(torch.uint8)
    return Fp6GemmWeight(bytes3=bytes3, scale=scale.reshape(4, J),
                         shape=(K, N))


def _words(fw: Fp6GemmWeight) -> torch.Tensor:
    b = fw.bytes3.to(torch.int32)
    return b[0] | (b[1] << 8) | (b[2] << 16)                         # [K, J]


def fp6_gemm_unpack(fw: Fp6GemmWeight) -> torch.Tensor:
    """Full f32 decode of the GEMM layout: [K, N]."""
    word = _words(fw)
    return torch.cat([_minifloat_decode((word >> (6 * p)) & 0x3F, _E, _M)
                      * fw.scale[p][None, :] for p in range(4)], dim=1)


def fp6_matmul_plain(x: torch.Tensor, fw: Fp6GemmWeight) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the weight decoded, scaled
    in f32 and cast to x's dtype, the product summed in f32, the result
    in x's dtype."""
    K, N = fw.shape
    w = fp6_gemm_unpack(fw).to(x.dtype).to(torch.float32)
    return (x.reshape(-1, K).to(torch.float32) @ w).to(x.dtype).reshape(
        *x.shape[:-1], N)


def _check(x: torch.Tensor, fw: Fp6GemmWeight) -> None:
    K, N = fw.shape
    J = N // 4
    if N % 4 or fw.bytes3.shape != (3, K, J) or fw.scale.shape != (4, J):
        raise ValueError(f"malformed Fp6GemmWeight: shape {fw.shape}, "
                         f"bytes3 {tuple(fw.bytes3.shape)}, scale "
                         f"{tuple(fw.scale.shape)}")
    if x.shape[-1] != K:
        raise ValueError(f"x [..., {x.shape[-1]}] @ fp6 weight {fw.shape}")
    if not x.is_cuda:
        return
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x dtype {x.dtype}: the kernel takes bf16 or fp32")
    for name, t, dt in (("bytes3", fw.bytes3, torch.uint8),
                        ("scale", fw.scale, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fp6_matmul(x: torch.Tensor, fw: Fp6GemmWeight) -> torch.Tensor:
    """``x @ W`` with W stored fp6-packed. x: [..., K] bf16/fp32; returns
    [..., N] in x's dtype (the CUDA kernel on a card, the plain version on
    the CPU). Every K and N % 4 == 0 runs the kernel: there is no
    unpacked fallback."""
    _check(x, fw)
    if not x.is_cuda:
        return fp6_matmul_plain(x, fw)
    K, N = fw.shape
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*x.shape[:-1], N)
    from . import _build
    lib = _build.load("fp6_gemm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fp6_matmul_launch(
        x2.data_ptr(), fw.bytes3.data_ptr(), fw.scale.data_ptr(),
        out.data_ptr(), M, K, N // 4, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fp6_matmul failed: cudaError {err}")
    LAUNCHES["fp6_matmul"] += 1
    return out.reshape(*x.shape[:-1], N)
