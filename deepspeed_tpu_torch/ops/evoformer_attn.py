"""Evoformer (triangle) attention — DeepSpeed4Science surface (port of
``deepspeed_tpu/ops/evoformer_attn.py``).

Shapes follow the reference API:
    q, k, v : [B, N, S, H, D]   (batch, MSA rows / pair dim, seq, heads, dim)
    biases  : list of broadcastable additive logit biases, typically
              [B, N, 1, 1, S] (per-row mask bias) and
              [B, 1, H, S, S] (pair / triangle bias)

Two paths. With the two canonical bias layouts (or fewer), the fused CUDA
kernel (``ops.kernels.evoformer.evoformer_flash``) keeps the [B, N, H, S,
S] score tensor out of device memory. Otherwise, and on request, plain
PyTorch: one einsum-softmax-einsum chain for small shapes, and for
AlphaFold-scale shapes the query dimension CHUNKED, each chunk under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``), so peak
memory is O(B N H chunk S) and the backward recomputes each chunk's
scores. fp32 softmax regardless of input dtype; rows whose every key is
-inf give zeros. Differentiable end to end.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

#: auto-chunk once the fp32 score tensor would exceed this many bytes
_FUSED_SCORE_BUDGET = 1 << 30


def _attend(q, k, v, biases, scale):
    """[B, N, Cq, H, D] x [B, N, Sk, H, D] -> [B, N, Cq, H, D] in f32;
    biases already sliced to the chunk."""
    logits = torch.einsum("bnqhd,bnkhd->bnhqk", q.float(), k.float()) * scale
    for b in biases:
        logits = logits + b
    # fully masked rows (every key at -inf) would make softmax emit NaN;
    # substitute finite logits for those rows and zero their
    # probabilities (the kernel's 0-output convention, clean gradients)
    row_max = torch.amax(logits, dim=-1, keepdim=True)
    fully_masked = row_max == float("-inf")
    logits = torch.where(fully_masked, torch.zeros_like(logits), logits)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(fully_masked, torch.zeros_like(probs), probs)
    return torch.einsum("bnhqk,bnkhd->bnqhd", probs, v.float())


def DS4Sci_EvoformerAttention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              biases: Optional[Sequence[Optional[
                                  torch.Tensor]]] = None,
                              chunk_size: Optional[int] = None,
                              use_kernel: Optional[bool] = None
                              ) -> torch.Tensor:
    """Fused evoformer attention (reference-API name kept verbatim).

    ``chunk_size``: query-dim tile for the memory-bounded plain path.
    None = auto (fused below ~1 GiB of fp32 scores, 128-wide chunks
    above); pass ``q.shape[2]`` to force fusion.

    ``use_kernel``: route through ``evoformer_flash`` (the CUDA kernel for
    CUDA tensors, its plain version for CPU tensors) when the biases are
    the two canonical reference layouts. None = the kernel for CUDA
    tensors and the plain path for CPU tensors; non-canonical bias layouts
    always take the plain path.
    """
    if q.dim() != 5:
        raise ValueError(f"expected [B, N, S, H, D] tensors, got "
                         f"{tuple(q.shape)}")
    B, N, Sq, H, d = q.shape
    Sk = k.shape[2]
    # the f32 value of 1 / sqrt(d), as the JAX package computes it
    scale = float(1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))
    bs = []
    for bias in biases or ():
        if bias is None:
            continue
        b = bias.float()
        if b.dim() != 5:
            raise ValueError(
                f"bias must be 5-D broadcastable to "
                f"[B, N, H, Sq, Sk], got {tuple(b.shape)}")
        # reference bias layouts are [B, N, 1, 1, Sk] / [B, 1, H, Sq, Sk]:
        # already aligned with [B, N, H, Sq, Sk]
        bs.append(b)

    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        mb = pb = None
        ok = True
        for b in bs:
            if tuple(b.shape[1:4]) == (N, 1, 1) and mb is None:
                mb = b[:, :, 0, 0, :]                  # [B, N, Sk]
            elif b.shape[1] == 1 and tuple(b.shape[2:4]) == (H, Sq) \
                    and pb is None:
                pb = b[:, 0]                           # [B, H, Sq, Sk]
            else:
                ok = False                             # non-canonical layout
        if ok:
            from .kernels.evoformer import evoformer_flash
            return evoformer_flash(q, k, v, mb, pb)

    if chunk_size is None:
        score_bytes = 4 * B * N * H * Sq * Sk
        chunk_size = Sq if score_bytes <= _FUSED_SCORE_BUDGET else 128
    if chunk_size >= Sq:
        return _attend(q, k, v, bs, scale).to(q.dtype)

    nc = -(-Sq // chunk_size)

    def chunk(start, q, k, v, *bs):
        qc = q[:, :, start:start + chunk_size]
        bc = [b if b.shape[3] == 1 else b[:, :, :, start:start + chunk_size]
              for b in bs]
        return _attend(qc, k, v, bc, scale)

    outs = []
    done = 0
    for i in range(nc):
        # the last chunk clamps back instead of padding; its overlap with
        # the previous chunk recomputes identical rows, kept once
        start = min(i * chunk_size, Sq - chunk_size)
        o = checkpoint(chunk, start, q, k, v, *bs, use_reentrant=False)
        outs.append(o[:, :, done - start:])
        done = start + chunk_size
    return torch.cat(outs, dim=2).to(q.dtype)
