"""Shared pieces of the port's forward-only dense families (OPT, BLOOM,
GPT-NeoX, GPT-J, Falcon, Phi): a module over the JAX package's parameter
tree, and flax's Dense, LayerNorm, GELU and causal attention in plain
PyTorch.

The trees keep flax's paths and layouts (``checkpoint/jax_params.py``):
Dense kernels ``[in, out]`` with an optional ``bias``, LayerNorm
``scale`` / ``bias``, embeddings ``[V, M]``. A model adopts the tensors it
is given (no copy), so the full-sequence forward and a ragged engine
built from the same tree share one set of weights; the forward is the
oracle of the runners' prefill logits. The same forward is
differentiable (:meth:`TreeModel.logits` over any nested param dict, each
block under ``torch.utils.checkpoint`` when ``cfg.remat``), and each
family's ``make_model`` is ``make_causal_lm`` over it: full fp32 logits
and plain attention, as the JAX package trains these families (no Pallas
kernel on their path).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ._lm_utils import alibi_slopes_on
from .llama import _module_tree, _tree_module


class TreeModel(nn.Module):
    """A causal LM whose forward reads the nested parameter dict: a family
    defines ``embed(p, tokens)``, ``block(lp, x)`` and ``final(p, x)``
    (fp32 logits). Built without ``params`` it holds none (the training
    entry point passes them to :meth:`logits`)."""

    def __init__(self, cfg: Any, params: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.cfg = cfg
        self.tree = _tree_module(params or {})

    def params(self) -> Dict[str, Any]:
        """The nested-dict parameter tree (flax paths, torch tensors)."""
        return _module_tree(self.tree)

    def logits(self, p: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] fp32 over the tree ``p``,
        differentiable."""
        cfg = self.cfg
        x = self.embed(p, tokens)
        for li in range(cfg.num_layers):
            lp = p[f"layer_{li}"]
            if getattr(cfg, "remat", False) and torch.is_grad_enabled():
                x = checkpoint(self.block, lp, x, use_reentrant=False)
            else:
                x = self.block(lp, x)
        return self.final(p, x)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] in fp32 (the serving
        oracle)."""
        return self.logits(self.params(), tokens)


def dense(x: torch.Tensor, p: Dict[str, Any], dt) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dt)``: ``x @ kernel`` in ``dt``, then the
    bias."""
    y = x.to(dt) @ p["kernel"].to(dt)
    if "bias" in p:
        y = y + p["bias"].to(dt)
    return y


def layer_norm(x: torch.Tensor, p: Dict[str, Any], eps: float,
               dt) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dt)``: statistics, scale and bias in fp32,
    the result in ``dt``."""
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                        p["bias"].float(), eps).to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh form."""
    return F.gelu(x, approximate="tanh")


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.nn.dot_product_attention(..., is_causal=True)``'s plain path:
    q [B, T, H, D], k / v [B, T, KV, D] (KV heads repeated for GQA), fp32
    scores scaled by 1/sqrt(D), plus ``bias`` [H, T, T] (ALiBi), the causal
    mask, softmax in fp32, the probabilities in V's dtype. Returns [B, T,
    H * D]."""
    B, T, H, D = q.shape
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    if bias is not None:
        s = s + bias.float()
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, H * D)


def alibi_bias(num_heads: int, T: int, device=None) -> torch.Tensor:
    """[H, T, T] additive ALiBi bias, ``-slope[h] * (i - j)`` (the JAX
    package's ``alibi_bias``)."""
    i = torch.arange(T, device=device)
    dist = (i[:, None] - i[None, :]).float()
    return -alibi_slopes_on(num_heads, dist.device)[:, None, None] * dist


def head(x: torch.Tensor, p: Dict[str, Any], tied_key: str,
         head_key: str = "lm_head", leaf=lambda w: w) -> torch.Tensor:
    """The fp32 LM head: ``x @ lm_head.kernel`` (+ its bias) when the
    tree has ``head_key``, else ``x @ embedding.T`` of ``tied_key``;
    ``leaf`` maps each weight before use (the runners dequantize)."""
    x = x.float()
    if head_key in p:
        y = x @ leaf(p[head_key]["kernel"]).float()
        if "bias" in p[head_key]:
            y = y + p[head_key]["bias"].float()
        return y
    return x @ leaf(p[tied_key]["embedding"]).T.float()
