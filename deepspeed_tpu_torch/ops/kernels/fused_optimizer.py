"""Fused AdamW update over flat buffers (port of
``deepspeed_tpu/ops/kernels/fused_optimizer.py``).

One hand-written CUDA kernel (``csrc/fused_optimizer.cu``), ``adamw``,
replaces the Pallas kernel ``_adamw_kernel``: one pass updates the f32
parameters ``p`` and moments ``m``, ``v`` in place from a gradient ``g``
(f32 or bf16), with bias correction and decoupled weight decay. In place
is the counterpart of the Pallas call's ``input_output_aliases``: the
returned tensors are the inputs.

The arithmetic is the kernel's, not :func:`adamw_reference`'s::

    m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g g
    p = p - lr ((m c1) / (sqrt(v c2) + eps) + wd p)

with ``c1 = 1 / (1 - b1^t)``, ``c2 = 1 / (1 - b2^t)`` computed once, in
f32, on the buffers' device (``lr`` and ``step`` may be 0-d device tensors:
nothing syncs with the host). :func:`fused_adamw_update` launches the
kernel for CUDA tensors (or raises) and runs :func:`fused_adamw_update_plain`
for CPU tensors; on the card the two give the same bits. Only a launch
counts in :data:`LAUNCHES`. As in the JAX package, the engine's optimizer
dispatch does not use it.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"adamw": 0}

Scalar = Union[float, int, torch.Tensor]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def adamw_hyper(step: Scalar, *, lr: Scalar, b1: float, b2: float,
                eps: float, weight_decay: float,
                device: torch.device) -> torch.Tensor:
    """The kernel's eight f32 hyper-parameters on ``device``: lr, b1, b2,
    eps, wd, c1 = 1/(1 - b1^t), c2 = 1/(1 - b2^t), 0. Host values travel in
    one non-blocking copy; a device ``lr`` or ``step`` is read where it
    lies."""
    host = [float(b1), float(b2), float(eps), float(weight_decay)]
    dev_lr = isinstance(lr, torch.Tensor)
    dev_t = isinstance(step, torch.Tensor)
    if not dev_lr:
        host.append(float(lr))
    if not dev_t:
        host.append(float(step))
    vals = torch.tensor(host, dtype=torch.float32)
    if device.type == "cuda":
        vals = vals.pin_memory().to(device, non_blocking=True)
    b1_t, b2_t, eps_t, wd_t = vals[0], vals[1], vals[2], vals[3]
    at = 4
    if dev_lr:
        lr_t = lr.to(device=device, dtype=torch.float32).reshape(())
    else:
        lr_t, at = vals[at], at + 1
    t = (step.to(device=device, dtype=torch.float32).reshape(()) if dev_t
         else vals[at])
    c1 = 1.0 / (1.0 - b1_t ** t)
    c2 = 1.0 / (1.0 - b2_t ** t)
    return torch.stack([lr_t, b1_t, b2_t, eps_t, wd_t, c1, c2,
                        torch.zeros_like(c1)])


def _adamw_plain(p, g, m, v, hyper) -> None:
    """The kernel's arithmetic, op by op, in place."""
    lr, b1, b2, eps, wd, c1, c2 = (hyper[i] for i in range(7))
    gf = g.float()
    m_new = b1 * m + (1.0 - b1) * gf
    v_new = b2 * v + (1.0 - b2) * gf * gf
    update = (m_new * c1) / (torch.sqrt(v_new * c2) + eps)
    p.copy_(p - lr * (update + wd * p))
    m.copy_(m_new)
    v.copy_(v_new)


def _check(p, g, m, v) -> None:
    for name, t in (("p", p), ("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for t in (g, m, v):
        if t.shape != p.shape:
            raise ValueError(f"shapes differ: p {tuple(p.shape)}, "
                             f"{tuple(t.shape)}")
        if t.device != p.device:
            raise ValueError(f"a buffer on {t.device}, p on {p.device}")
    if not g.is_floating_point():
        raise ValueError(f"g must be a float tensor, got {g.dtype}")


def fused_adamw_update_plain(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    step: Scalar, *, lr: Scalar, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, weight_decay: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``adamw``'s function in plain PyTorch, in place on p, m, v."""
    _check(p, g, m, v)
    hyper = adamw_hyper(step, lr=lr, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay, device=p.device)
    _adamw_plain(p, g, m, v, hyper)
    return p, m, v


def fused_adamw_update(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    step: Scalar, *, lr: Scalar, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, weight_decay: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused AdamW step over contiguous f32 ``p``, ``m``, ``v`` (any
    shape, flat in the JAX package) and ``g`` of the same shape (f32 or
    bf16 on the card, any float on the CPU), updated in place and
    returned. ``step`` is the 1-based step count, ``lr`` a float or a 0-d
    tensor."""
    _check(p, g, m, v)
    if not p.is_cuda:
        return fused_adamw_update_plain(p, g, m, v, step, lr=lr, b1=b1,
                                        b2=b2, eps=eps,
                                        weight_decay=weight_decay)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"g dtype {g.dtype}: the kernel takes fp32 or bf16")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if p.numel() == 0:
        return p, m, v
    hyper = adamw_hyper(step, lr=lr, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay, device=p.device)
    from . import _build
    lib = _build.load("fused_optimizer")
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = lib.adamw_launch(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                           v.data_ptr(), hyper.data_ptr(), p.numel(),
                           int(g.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"adamw failed: cudaError {err}")
    LAUNCHES["adamw"] += 1
    return p, m, v


def adamw_reference(p, g, m, v, step, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay=0.0):
    """The textbook AdamW (``m / (1 - b1^t)``), out of place: the parity
    tests' reference, as in the JAX package."""
    g = g.float()
    t = torch.as_tensor(step, dtype=torch.float32)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    p = p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)
    return p, m, v
