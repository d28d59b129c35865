"""Shared causal-LM plumbing (port of ``deepspeed_tpu/models/_lm_utils.py``:
``make_causal_lm``, ``lm_head_xent``, ``chunked_lm_xent`` and
``alibi_slopes``)."""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..utils.tree import flatten, unflatten


def make_causal_lm(model: torch.nn.Module, cfg):
    """``(model, init_fn, loss_fn)`` with the engine's contract
    ``loss_fn(params, batch, generator) -> loss``: batch =
    ``{"tokens": [B, T+1]}``, next-token NLL over full logits. ``model``
    maps tokens to logits; ``loss_fn`` runs it through ``functional_call``
    on the nested param dict, and ``init_fn()`` returns a copy of the
    module's own parameters as that dict."""

    def init_fn():
        return unflatten({n: p.detach().clone()
                          for n, p in model.named_parameters()})

    def loss_fn(params, batch, generator=None):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        logits = functional_call(model, flatten(params), (inputs,)).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None].long())[..., 0]
        return nll.mean()

    return model, init_fn, loss_fn


def lm_head_xent(hidden: torch.Tensor, head: torch.Tensor,
                 targets: torch.Tensor, cfg, *,
                 head_layout: str = "vc") -> torch.Tensor:
    """LM-head loss dispatch for the model zoo: reads the ``xent_*`` knobs
    off ``cfg`` (with the JAX package's defaults). ``head_layout`` is
    "vc" for a [V, C] head (the tied embedding) or "cv" for a [C, V] Dense
    kernel. ``xent_impl="fused"`` runs the streaming kernels
    (``ops/kernels/fused_xent.py``), which want [V, C] rows: "cv" pays one
    transposed copy there, as in the JAX package. The JAX package's
    shard_map branches (a manual seam, several devices) are not ported:
    under a process group of more than one rank the fused path raises
    (ROADMAP A8)."""
    if head_layout not in ("vc", "cv"):
        raise ValueError(f"head_layout must be 'vc' or 'cv', "
                         f"got {head_layout!r}")
    impl = getattr(cfg, "xent_impl", "chunked")
    if impl not in ("chunked", "fused"):
        raise ValueError(
            f"xent_impl must be 'chunked' or 'fused', got {impl!r}")
    ignore = getattr(cfg, "xent_ignore_index", None)
    if impl == "fused":
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized() and \
                torch.distributed.get_world_size() > 1:
            raise NotImplementedError(
                "xent_impl='fused' over several ranks (the JAX package's "
                "shard_map wrapper) is not ported (ROADMAP A8)")
        from ..ops.kernels.fused_xent import fused_lm_xent
        if head_layout == "cv":
            head = head.t().contiguous()
        return fused_lm_xent(hidden, head, targets, ignore_index=ignore)
    return chunked_lm_xent(hidden, head, targets,
                           num_chunks=getattr(cfg, "xent_chunks", 8),
                           remat=getattr(cfg, "xent_remat", True),
                           ignore_index=ignore, head_layout=head_layout)


def _chunk_nll(h: torch.Tensor, emb: torch.Tensor, t: torch.Tensor,
               head_layout: str, V: int,
               ignore_index: Optional[int]) -> torch.Tensor:
    """Summed NLL of one sequence chunk: logits in fp32 from the compute-
    dtype operands (upcast values multiply exactly; fp32 accumulation),
    reduced to logsumexp - target logit and discarded."""
    hf = h.float()
    logits = hf @ (emb.t() if head_layout == "vc" else emb)
    tc = t.long().clamp(0, V - 1)            # ignore ids may be -100
    nll = torch.logsumexp(logits, dim=-1) \
        - logits.gather(-1, tc[..., None])[..., 0]
    # out-of-range ids (t < 0 or t >= V) train against nothing: zeroed
    # here and dropped from the divisor
    valid = (t >= 0) & (t < V)
    if ignore_index is not None:
        valid &= t != ignore_index
    return torch.where(valid, nll, torch.zeros_like(nll)).sum()


def chunked_lm_xent(hidden: torch.Tensor, embedding: torch.Tensor,
                    targets: torch.Tensor, num_chunks: int = 8,
                    remat: bool = True,
                    ignore_index: Optional[int] = None,
                    head_layout: str = "vc") -> torch.Tensor:
    """Mean next-token NLL without materialising the full logits.

    ``hidden`` [B, T, C] in the compute dtype, ``embedding`` [V, C]
    (``head_layout="vc"``, the tied LM head) or [C, V] (``"cv"``),
    ``targets`` [B, T]. The sequence is cut into ``num_chunks`` chunks
    (decremented until it divides T); each chunk's logits are computed with
    fp32 accumulation, reduced, and dropped. With ``remat=True`` each chunk
    runs under ``torch.utils.checkpoint`` and its logits are recomputed in
    the backward pass. ``ignore_index`` and out-of-range ids are dropped
    from the loss and the divisor.

    The compute-dtype operands are upcast to fp32 for the product, which
    is exact for bf16 values; on a card, a TF32 matmul setting keeps that
    forward product exact (bf16 values are TF32 values) and rounds the
    backward's fp32 cotangent to TF32 before its products.
    """
    B, T, C = hidden.shape
    nc = max(1, int(num_chunks))
    while T % nc:
        nc -= 1
    emb = embedding.to(hidden.dtype).float()
    V = emb.shape[0] if head_layout == "vc" else emb.shape[1]
    tc = T // nc
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(nc):
        h = hidden[:, i * tc:(i + 1) * tc]
        t = targets[:, i * tc:(i + 1) * tc]
        if remat:
            total = total + checkpoint(_chunk_nll, h, emb, t, head_layout, V,
                                       ignore_index, use_reentrant=False)
        else:
            total = total + _chunk_nll(h, emb, t, head_layout, V,
                                       ignore_index)
    valid = (targets >= 0) & (targets < V)
    if ignore_index is not None:
        valid &= targets != ignore_index
    return total / valid.sum().clamp_min(1)



def alibi_slopes(num_heads: int) -> torch.Tensor:
    """ALiBi per-head slopes (Press et al.) [H] f32: a geometric schedule
    over the nearest power of two p, with the odd multiples of the 2p
    schedule filling the remainder (so the extra slopes interleave and
    never repeat one), as the JAX package's ``alibi_slopes``."""
    p = 2 ** math.floor(math.log2(num_heads))
    base = [2 ** (-8.0 * (i + 1) / p) for i in range(p)]
    if p < num_heads:
        base += [2 ** (-4.0 * (2 * i + 1) / p) for i in range(num_heads - p)]
    return torch.tensor(base[:num_heads], dtype=torch.float32)


@functools.lru_cache(maxsize=16)
def alibi_slopes_on(num_heads: int, device: torch.device) -> torch.Tensor:
    """``alibi_slopes(num_heads)`` on ``device``, made once per (H, device):
    the JAX runners' ``tp_alibi_slopes`` on one device. (A copy from
    pageable host memory each step would wait for the card's stream.)"""
    return alibi_slopes(num_heads).to(device)
