"""Group quantization — int8 / int4, symmetric / asymmetric (port of
``deepspeed_tpu/ops/kernels/quantization.py``).

The flattened input is cut into groups of ``group_size`` (the last one
zero-padded); each group gets f32 statistics and int8 codes. Two
hand-written CUDA kernels (``csrc/quantization.cu``) replace the two
Pallas kernels behind :func:`quantize_blockwise`:

- ``quantize_sym`` — replaces ``_quant_kernel``: scale = absmax / qmax,
  codes = clip(rint(x / scale), -qmax, qmax);
- ``quantize_asym`` — replaces ``_quant_asym_kernel``: zero = min, scale =
  (max - min) / (2 qmax), codes = clip(rint((x - min) / scale) - qmax).

For ``bits=4`` the kernels also pack two codes per byte (low nibble the
even index). The arithmetic is the JAX package's to the bit: f32
statistics; the division by the constant ``qmax`` (or ``2 qmax``) is a
multiply by its f32 reciprocal, as XLA compiles it; ``x / scale`` is a
true IEEE division; rounding is half to even. The padded tail of the last
group counts in its statistics (so an asymmetric group's min or max may be
0) and its codes are stored, as the JAX wrapper's zero padding does.

:func:`quantize_blockwise` launches a kernel for a CUDA tensor of fp32,
bf16 or fp16 (or raises) and runs :func:`quantize_blockwise_plain` for a
CPU tensor. :func:`quant_plan` picks the kernel's route from the shapes
alone: groups held in registers by segments of lanes (``"vector"``, where
a group is a power-of-two count of 16-byte vectors) or a warp a group
(``"scalar"``). Only a launch counts in :data:`LAUNCHES`.
:func:`dequantize_blockwise`, :func:`pack_int4`, :func:`unpack_int4` and
:func:`quant_dequant` are plain PyTorch, as they are jnp in the JAX
package.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...utils.device import sm_count

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"quantize_sym": 0, "quantize_asym": 0}
#: the kernels' dtype codes
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the vector route: 16-byte vectors a lane it is instantiated for, and
#: the vectors a lane keeps in flight a step (``IN_FLIGHT`` in the source)
QUANT_VPLS = (1, 2, 4, 8)
QUANT_IN_FLIGHT = 4
_ROUTES = {"vector": 0, "scalar": 1}


class QuantPlan(NamedTuple):
    """The quantizer's launch: ``route`` "vector" (a segment of ``lanes``
    lanes holds a group in registers, ``vpl`` 16-byte vectors a lane;
    ``groups_per_tile`` groups a warp tile, ``tiles_in_flight`` tiles a
    warp loads before reducing any; warps take tiles by grid stride) or
    "scalar" (a warp a group; the other fields 0)."""
    route: str
    lanes: int
    vpl: int
    groups_per_tile: int
    tiles_in_flight: int


@functools.lru_cache(maxsize=64)
def quant_plan(group_size: int, dtype: torch.dtype) -> QuantPlan:
    """The launch for groups of ``group_size`` elements of ``dtype``,
    from the shapes alone: the vector route where a group is G = 2^k
    16-byte vectors (G <= 32 x 8), min(G, 32) lanes a group; otherwise the
    scalar route."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"dtype {dtype}: the kernels take fp32, bf16 or "
                         f"fp16")
    n = 16 // dtype.itemsize
    g = group_size // n
    if group_size <= 0 or group_size % n or g & (g - 1) or \
            g > 32 * QUANT_VPLS[-1]:
        return QuantPlan("scalar", 0, 0, 0, 0)
    lanes = min(g, 32)
    vpl = g // lanes
    return QuantPlan("vector", lanes, vpl, 32 // lanes,
                     max(1, QUANT_IN_FLIGHT // vpl))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class QuantizedTensor(NamedTuple):
    """Packed group-quantized tensor. ``values`` is int8 ``[groups,
    group_size]`` (``group_size / 2`` packed bytes for 4-bit),
    ``scale``/``zero`` are ``[groups, 1]`` f32 (``zero`` None when
    symmetric); ``shape``/``bits``/``group_size`` undo the packing."""
    values: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor]
    shape: Tuple[int, ...]
    bits: int
    group_size: int


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (in int8 storage) two per byte, low nibble first."""
    lo = q[..., 0::2] & 0x0F
    hi = (q[..., 1::2] & 0x0F) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    lo = (p << 4) >> 4                       # arithmetic shift sign-extends
    hi = p >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], -1)


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _recip(d: float) -> float:
    """The f32 reciprocal XLA multiplies by for ``/ d``."""
    return float(np.float32(1.0) / np.float32(d))


def quantize_blockwise_plain(x: torch.Tensor, *, bits: int, group_size: int,
                             symmetric: bool = True) -> QuantizedTensor:
    """The kernels' function in plain PyTorch (zero-padded group copy)."""
    flat = x.reshape(-1).to(torch.float32)
    groups = torch.nn.functional.pad(
        flat, (0, (-flat.shape[0]) % group_size)).reshape(-1, group_size)
    qmax = _qmax(bits)
    if symmetric:
        absmax = groups.abs().amax(dim=1, keepdim=True)
        scale = torch.clamp(absmax, min=1e-12) * _recip(qmax)
        zero = None
        q = torch.round(groups / scale)
    else:
        zero = groups.amin(dim=1, keepdim=True)
        hi = groups.amax(dim=1, keepdim=True)
        scale = torch.clamp(hi - zero, min=1e-12) * _recip(2 * qmax)
        q = torch.round((groups - zero) / scale) - qmax
    v = torch.clamp(q, -qmax, qmax).to(torch.int8)
    if bits == 4:
        v = pack_int4(v)
    return QuantizedTensor(v, scale, zero, tuple(x.shape), bits, group_size)


def _check(x: torch.Tensor, bits: int, group_size: int) -> None:
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if group_size <= 0:
        raise ValueError(f"group_size must be positive, got {group_size}")
    if bits == 4 and group_size % 2:
        raise ValueError(f"4-bit packing requires even group_size, "
                         f"got {group_size}")
    if x.numel() == 0:
        raise ValueError("quantize_blockwise of an empty tensor")


def quantize_blockwise(x: torch.Tensor, *, bits: int = 8,
                       group_size: int = 256,
                       symmetric: bool = True) -> QuantizedTensor:
    """Group-quantize ``x`` to int8/int4 with per-group f32 scales: the
    CUDA kernel for a CUDA tensor (fp32, bf16 or fp16, else it raises),
    the plain version for a CPU tensor."""
    _check(x, bits, group_size)
    if not x.is_cuda:
        return quantize_blockwise_plain(x, bits=bits, group_size=group_size,
                                        symmetric=symmetric)
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"x dtype {x.dtype}: the kernels take fp32, bf16 "
                         f"or fp16")
    n = x.numel()
    from . import _build
    lib = _build.load("quantization")
    ng = -(-n // group_size)
    plan = quant_plan(group_size, x.dtype)
    flat = x.contiguous()
    if plan.route == "vector" and flat.data_ptr() % 16:
        flat = flat.clone()           # the vector route's 16-byte loads
    dev = x.device
    width = group_size // 2 if bits == 4 else group_size
    values = torch.empty((ng, width), dtype=torch.int8, device=dev)
    scale = torch.empty((ng, 1), dtype=torch.float32, device=dev)
    zero = None if symmetric else torch.empty((ng, 1), dtype=torch.float32,
                                              device=dev)
    qmax = _qmax(bits)
    name = "quantize_sym" if symmetric else "quantize_asym"
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.quantize_launch(
        flat.data_ptr(), values.data_ptr(), scale.data_ptr(),
        0 if zero is None else zero.data_ptr(), n, group_size, bits,
        int(symmetric), _recip(qmax if symmetric else 2 * qmax),
        KERNEL_DTYPES[x.dtype], _ROUTES[plan.route], plan.lanes, plan.vpl,
        sm_count(dev), stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    LAUNCHES[name] += 1
    return QuantizedTensor(values, scale, zero, tuple(x.shape), bits,
                           group_size)


def dequantize_blockwise(qt: QuantizedTensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (plain PyTorch)."""
    v = qt.values
    if qt.bits == 4:
        v = unpack_int4(v)
    x = v.to(torch.float32) * qt.scale
    if qt.zero is not None:
        x = x + qt.zero + _qmax(qt.bits) * qt.scale
    n = math.prod(qt.shape)
    return x.reshape(-1)[:n].reshape(qt.shape).to(dtype)


def quant_dequant(x: torch.Tensor, *, bits: int = 8, group_size: int = 256,
                  symmetric: bool = True) -> torch.Tensor:
    """Fake-quant round trip."""
    qt = quantize_blockwise(x, bits=bits, group_size=group_size,
                            symmetric=symmetric)
    return dequantize_blockwise(qt, dtype=x.dtype)
