"""Dropout with JAX's mask: one hand-written CUDA kernel
(``csrc/dropout.cu``) for the mask and the scale, fused.

It replaces no Pallas kernel: the JAX package applies flax's
``nn.Dropout`` (``deepspeed_tpu/models/gpt2.py:140-141, 162-163``), which
XLA runs as ``jax.random.bernoulli`` and a select. The function, for ``x``
of dtype T and ``keep_prob = 1 - rate``::

    y = where(uniform(key, x.numel()) < f32(keep_prob),
              T(f32(x) / f32(T(keep_prob))), 0)

with ``uniform`` JAX's threefry floats over the flat row-major index
(``utils/random.py``), so the mask is flax's bit for bit, and the quotient
is the T division flax takes by the weakly typed ``keep_prob``. The
backward is the same function of ``dy`` under the same key (the VJP of
``select(mask, x / kp, 0)``): the mask is never stored.

:func:`dropout` is differentiable (a ``torch.autograd.Function`` whose
forward and backward each launch the kernel once): it launches the kernel
for a CUDA tensor, or raises, and runs :func:`dropout_plain` for a CPU
tensor. :func:`dropout_plain` is the plain version: ``utils.random.
bernoulli`` and ``torch.where`` (differentiable through autograd, to the
same bits as the kernel's backward). The key is an int64 ``[2]`` tensor on
the tensor's device, read by the kernel through a pointer: no site's key
travels to the host. Only a launch counts in :data:`LAUNCHES`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...utils import random as trandom

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"dropout": 0}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def keep_and_divisor(rate: float, dtype: torch.dtype):
    """``(f32(1 - rate), f32(T(1 - rate)))`` as Python floats: the
    compare's fp32 threshold (``jax.random.bernoulli``'s) and the divisor
    flax's ``x / keep_prob`` takes in the input's dtype T."""
    kp = 1.0 - float(rate)
    return (float(np.float32(kp)),
            float(torch.tensor(kp, dtype=torch.float64).to(dtype)))


def _check(x: torch.Tensor, key: torch.Tensor, rate: float) -> None:
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout rate must be in [0, 1], got {rate}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"dropout takes fp32, bf16 or fp16, got {x.dtype}")
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"the key must be an int64 [2] tensor, got "
                         f"{key.dtype} {tuple(key.shape)}")
    if key.device != x.device:
        raise ValueError(f"the key is on {key.device}, x on {x.device}")


def dropout_plain(x: torch.Tensor, key: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (differentiable)."""
    _check(x, key, rate)
    if rate == 1.0:
        return torch.zeros_like(x)
    kp, div = keep_and_divisor(rate, x.dtype)
    keep = trandom.bernoulli(key, kp, x.numel()).view(x.shape)
    # the divisor as a 0-d tensor on x's device: PyTorch's CUDA division
    # by a Python scalar multiplies by its reciprocal, which rounds
    # differently from the quotient flax (and the kernel) take
    d = torch.full((), div, dtype=torch.float32, device=x.device)
    return torch.where(keep, (x.float() / d).to(x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout_fwd(x: torch.Tensor, key: torch.Tensor,
                rate: float) -> torch.Tensor:
    """One launch of the kernel on a CUDA tensor (no autograd): a new
    tensor of ``x``'s shape and dtype."""
    _check(x, key, rate)
    if not x.is_cuda:
        raise ValueError("dropout_fwd launches the CUDA kernel: x must be "
                         "a CUDA tensor (dropout_plain runs on the CPU)")
    x = x.contiguous()
    key = key.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0 or rate == 1.0:
        return y.zero_()
    kp, div = keep_and_divisor(rate, x.dtype)
    from ...utils.device import sm_count
    from . import _build
    lib = _build.load("dropout")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dropout_launch(x.data_ptr(), y.data_ptr(), key.data_ptr(),
                             x.numel(), kp, div, DTYPE_CODES[x.dtype],
                             sm_count(x.device), stream)
    if err != 0:
        raise RuntimeError(f"dropout failed: cudaError {err}")
    LAUNCHES["dropout"] += 1
    return y


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, rate):
        ctx.save_for_backward(key)
        ctx.rate = rate
        return dropout_fwd(x, key, rate)

    @staticmethod
    def backward(ctx, dy):
        (key,) = ctx.saved_tensors
        return dropout_fwd(dy, key, ctx.rate), None, None


def dropout(x: torch.Tensor, key: torch.Tensor, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` applied with ``make_rng``'s ``key``: the
    kernel for a CUDA tensor (forward and backward), the plain version for
    a CPU tensor. A rate of 0 returns ``x`` and a rate of 1 zeros, as
    flax's."""
    if rate == 0.0:
        return x
    if not x.is_cuda:
        return dropout_plain(x, key, rate)
    _check(x, key, rate)
    return _Dropout.apply(x, key, rate)
