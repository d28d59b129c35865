"""Floating-point (minifloat) quantization — FP6 / FP8 / FP12 (port of
``deepspeed_tpu/ops/fp_quantizer.py``; plain PyTorch, the JAX module has
no Pallas kernel).

Values are scaled per group so that the group's largest magnitude hits
the format's largest representable value, then rounded to the nearest
representable minifloat. Storage is real ``q_bits`` per value: fp8 is one
byte per code, fp6 packs 4 codes into 3 bytes, fp12 packs 2 into 3.

Formats: fp6 = e3m2, fp8 = e4m3, fp12 = e4m7. The arithmetic follows the
JAX module step for step (fp32, round half to even), so the codes and
scales are the same bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

#: q_bits -> (exp_bits, man_bits)
FORMATS = {6: (3, 2), 8: (4, 3), 12: (4, 7)}


class FPQuantizedTensor(NamedTuple):
    """Minifloat-quantized tensor: bit-packed uint8 codes + f32 scales."""
    codes: torch.Tensor           # uint8, bit-packed
    scale: torch.Tensor           # (groups, 1) f32
    shape: Tuple[int, ...]
    q_bits: int
    group_size: int
    packed: bool


def _minifloat_encode(x: torch.Tensor, exp_bits: int,
                      man_bits: int) -> torch.Tensor:
    """Round |x| <= max representable to the nearest minifloat; int16
    codes ``sign << (exp_bits + man_bits) | exp << man_bits | mantissa``.
    Denormals (exp field 0) are ``mantissa * 2^(1 - bias) / 2^man_bits``."""
    bias = 2 ** (exp_bits - 1) - 1
    sign = (x < 0).to(torch.int32)
    ax = x.to(torch.float32).abs()
    e = torch.floor(torch.log2(torch.clamp(ax, min=1e-38))).to(torch.int32)
    e = torch.clamp(e, 1 - bias, bias)
    frac = ax / torch.exp2(e.to(torch.float32))
    m = torch.round((frac - 1.0) * (1 << man_bits)).to(torch.int32)
    # rounding can overflow the mantissa: bump the exponent
    bump = m >= (1 << man_bits)
    e = torch.where(bump & (e < bias), e + 1, e)
    m = torch.where(bump, torch.zeros_like(m), m)
    m = torch.clamp(m, 0, (1 << man_bits) - 1)
    min_normal = 2.0 ** (1 - bias)
    sub = ax < min_normal
    m_sub = torch.round(ax / min_normal * (1 << man_bits)).to(torch.int32)
    m_sub = torch.clamp(m_sub, 0, (1 << man_bits) - 1)
    efield = torch.where(sub, torch.zeros_like(e), e + bias)
    m = torch.where(sub, m_sub, m)
    code = (sign << (exp_bits + man_bits)) | (efield << man_bits) | m
    return code.to(torch.int16)


def _minifloat_decode(code: torch.Tensor, exp_bits: int,
                      man_bits: int) -> torch.Tensor:
    """fp32 values of int codes (inverse of :func:`_minifloat_encode`)."""
    bias = 2 ** (exp_bits - 1) - 1
    code = code.to(torch.int32)
    m = (code & ((1 << man_bits) - 1)).to(torch.float32)
    efield = (code >> man_bits) & ((1 << exp_bits) - 1)
    sign = (code >> (exp_bits + man_bits)) & 1
    min_normal = 2.0 ** (1 - bias)
    mag = torch.where(
        efield > 0,
        torch.exp2(efield.to(torch.float32) - bias)
        * (1.0 + m / (1 << man_bits)),
        min_normal * m / (1 << man_bits))
    return torch.where(sign == 1, -mag, mag)


def _pack_codes(codes: torch.Tensor, q_bits: int) -> torch.Tensor:
    """Bit-pack a flat int16 code array (values < 2**q_bits) into uint8."""
    c = codes.reshape(-1).to(torch.int64)
    if q_bits == 8:
        return c.to(torch.uint8)
    per = {6: 4, 12: 2}.get(q_bits)
    if per is None:
        raise ValueError(q_bits)
    c = torch.nn.functional.pad(c, (0, (-c.shape[0]) % per)).reshape(-1, per)
    if q_bits == 6:                            # 4 codes -> 3 bytes
        v = c[:, 0] | (c[:, 1] << 6) | (c[:, 2] << 12) | (c[:, 3] << 18)
    else:                                      # 2 codes -> 3 bytes
        v = c[:, 0] | (c[:, 1] << 12)
    return torch.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF],
                       dim=1).reshape(-1).to(torch.uint8)


def _unpack_codes(packed: torch.Tensor, q_bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`_pack_codes`; returns ``n`` int16 codes."""
    if q_bits == 8:
        return packed.to(torch.int16)[:n]
    b = packed.to(torch.int64).reshape(-1, 3)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    if q_bits == 6:
        c = torch.stack([v & 0x3F, (v >> 6) & 0x3F, (v >> 12) & 0x3F,
                         (v >> 18) & 0x3F], dim=1)
    else:                                      # 12
        c = torch.stack([v & 0xFFF, (v >> 12) & 0xFFF], dim=1)
    return c.reshape(-1)[:n].to(torch.int16)


def _max_representable(exp_bits: int, man_bits: int) -> float:
    bias = 2 ** (exp_bits - 1) - 1
    return float(2.0 ** bias * (2.0 - 2.0 ** (-man_bits)))


def fp_quantize(x: torch.Tensor, q_bits: int = 6,
                group_size: int = 128) -> FPQuantizedTensor:
    """Group-scale and minifloat-round ``x`` (any shape)."""
    if q_bits not in FORMATS:
        raise ValueError(f"q_bits must be one of {sorted(FORMATS)}, "
                         f"got {q_bits}")
    exp_bits, man_bits = FORMATS[q_bits]
    shape = tuple(x.shape)
    flat = x.reshape(-1).to(torch.float32)
    gr = torch.nn.functional.pad(
        flat, (0, (-flat.shape[0]) % group_size)).reshape(-1, group_size)
    absmax = gr.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) \
        / _max_representable(exp_bits, man_bits)
    codes = _minifloat_encode(gr / scale, exp_bits, man_bits)
    return FPQuantizedTensor(codes=_pack_codes(codes, q_bits), scale=scale,
                             shape=shape, q_bits=q_bits,
                             group_size=group_size, packed=True)


def fp_dequantize(t: FPQuantizedTensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    exp_bits, man_bits = FORMATS[t.q_bits]
    n = math.prod(t.shape)
    n_codes = -(-n // t.group_size) * t.group_size
    codes = _unpack_codes(t.codes, t.q_bits, n_codes)
    vals = _minifloat_decode(codes.reshape(-1, t.group_size),
                             exp_bits, man_bits) * t.scale
    return vals.reshape(-1)[:n].reshape(t.shape).to(dtype)

