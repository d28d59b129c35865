"""Phi (phi-1.5 / phi-2) causal transformer (port of
``deepspeed_tpu/models/phi.py``): parallel attention and MLP over one
shared LayerNorm, partial rotary embedding (only the leading
``rotary_dim`` lanes of a head rotate, rotate-half convention), biased
projections, GELU MLP, an untied LM head with a bias. Phi-3 is the Llama
architecture (``models/registry.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ._dense import (TreeModel, causal_attention, dense, gelu, head,
                     layer_norm)
from .llama import apply_rope


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    vocab_size: int = 51200
    max_seq_len: int = 2048
    num_layers: int = 24
    num_heads: int = 32
    hidden_size: int = 2048
    intermediate_size: int = 8192
    rotary_fraction: float = 0.5        # partial_rotary_factor
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16         # compute dtype
    param_dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        d = int(self.head_dim * self.rotary_fraction)
        return d - d % 2

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        return PhiConfig(**kw)


def apply_partial_rope(x: torch.Tensor, positions: torch.Tensor,
                       theta: float, rotary_dim: int) -> torch.Tensor:
    """Rotate-half RoPE on the leading ``rotary_dim`` lanes of each head;
    the rest pass through."""
    rot, keep = x[..., :rotary_dim], x[..., rotary_dim:]
    return torch.cat([apply_rope(rot, positions, theta), keep], dim=-1)


class Phi(TreeModel):
    """Full-sequence forward over the flax tree of ``Phi(cfg)``:
    ``embed_tokens``, ``layer_i/{input_layernorm, self_attn/{q,k,v}_proj,
    self_attn/dense, fc1, fc2}``, ``final_layernorm``, ``lm_head``."""

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] in fp32."""
        cfg, p = self.cfg, self.params()
        dt, eps = cfg.dtype, cfg.layer_norm_eps
        B, T = tokens.shape
        H, D = cfg.num_heads, cfg.head_dim
        pos = torch.arange(T, device=tokens.device)[None, :]
        x = p["embed_tokens"]["embedding"][tokens.long()].to(dt)
        for li in range(cfg.num_layers):
            lp = p[f"layer_{li}"]
            h = layer_norm(x, lp["input_layernorm"], eps, dt)
            pa = lp["self_attn"]
            q, k, v = (dense(h, pa[f"{n}_proj"], dt).reshape(B, T, H, D)
                       for n in "qkv")
            q = apply_partial_rope(q, pos, cfg.rope_theta, cfg.rotary_dim)
            k = apply_partial_rope(k, pos, cfg.rope_theta, cfg.rotary_dim)
            attn = dense(causal_attention(q, k, v), pa["dense"], dt)
            m = dense(gelu(dense(h, lp["fc1"], dt)), lp["fc2"], dt)
            x = x + attn + m                       # parallel residual
        x = layer_norm(x, p["final_layernorm"], eps, torch.float32)
        return head(x, p, "embed_tokens")
