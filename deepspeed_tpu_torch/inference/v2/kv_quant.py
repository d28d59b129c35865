"""The int8 KV pool (port of ``deepspeed_tpu/inference/v2/kv_quant.py``).

The layout is the JAX package's: pool data stays the flat ``[L, 2, slots,
KV*D]`` row layout, in int8; scales are per (token row, KV head), f32,
stored transposed as ``[L, 2, KV, slots]``, so a context window's scales
are ``KV`` contiguous runs (~3% of the int8 row bytes at head dim 128).
The kernels never dequantize a K/V tile: the K scale multiplies score
column j after Q.K^T, the V scale probability column j before P.V (both
exact: a scale is constant along the contracted head dim).

The decode loop's ring stays in the compute dtype: its rows are the
loop's own tokens, quantized once, when the loop flushes them into the
pool (``model_runner.py``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch


class KVPool(NamedTuple):
    """An int8 pool: ``data`` [L, 2, slots, KV*D] int8 and ``scales``
    [L, 2, KV, slots] f32."""
    data: torch.Tensor
    scales: Optional[torch.Tensor] = None


class RingKV(NamedTuple):
    """The decode loop's KV state as a step sees it: the pool is read-only;
    this step's K/V goes into ``ring`` [R, L, 2, S, KV*D] at row ``t``,
    and rows ``0 .. t`` are attended (``rcount = t + 1``)."""
    pool: Any           # KVPool or raw pool tensor
    ring: torch.Tensor
    t: int
    rcount: int


def pool_parts(kv) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(data, scales) of a pool that may be a KVPool or a raw tensor."""
    if isinstance(kv, KVPool):
        return kv.data, kv.scales
    return kv, None


def quantize_rows(rows: torch.Tensor, kv_heads: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(row, KV head) int8 quantization: rows [N, KV*D]
    float -> (codes [N, KV*D] int8, scales [KV, N] f32, transposed as the
    pool keeps them). Codes are ``clip(round(r / s), -127, 127)`` with ``s
    = amax / 127``, rounding half to even and true division, as the JAX
    package's; a zero row gets scale 1 (dequantizes to exact zeros)."""
    n, kvd = rows.shape
    d = kvd // kv_heads
    r = rows.reshape(n, kv_heads, d).float()
    amax = r.abs().amax(dim=2)                                # [N, KV]
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(r / s[:, :, None]), -127, 127)
    return q.to(torch.int8).reshape(n, kvd), s.T


def dequantize_rows(q: torch.Tensor, scales_t: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: q [N, KV*D], scales_t [KV, N] ->
    [N, KV*D] in ``dtype`` (the dense path's dequantize-then-cast)."""
    n, kvd = q.shape
    kv = scales_t.shape[0]
    r = q.reshape(n, kv, kvd // kv).float() * scales_t.T[:, :, None]
    return r.reshape(n, kvd).to(dtype)
