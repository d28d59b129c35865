"""BLOOM causal transformer (port of ``deepspeed_tpu/models/bloom.py``):
ALiBi attention (no positional embedding), q/k/v split from HF's per-head
fused ``query_key_value`` (the loader splits it), a LayerNorm on the
embedding, sequential pre-LN blocks, biased GELU MLP, a tied LM head by
default."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ._dense import (TreeModel, alibi_bias, causal_attention, dense, gelu,
                     head, layer_norm)


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    max_seq_len: int = 2048            # ALiBi: no hard positional limit
    num_layers: int = 30
    num_heads: int = 32
    hidden_size: int = 4096
    layer_norm_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16        # compute dtype
    param_dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("hidden_size", 64)
        return BloomConfig(**kw)


class Bloom(TreeModel):
    """Full-sequence forward over the flax tree of ``Bloom(cfg)``:
    ``word_embeddings``, ``word_embeddings_layernorm``, ``layer_i/{
    input_layernorm, self_attention/{q,k,v}_proj, self_attention/dense,
    post_attention_layernorm, dense_h_to_4h, dense_4h_to_h}``, ``ln_f``,
    ``lm_head`` when untied."""

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self.params()
        dt, eps = cfg.dtype, cfg.layer_norm_eps
        B, T = tokens.shape
        H, D = cfg.num_heads, cfg.head_dim
        bias = alibi_bias(H, T, tokens.device).to(dt)
        x = p["word_embeddings"]["embedding"][tokens.long()].to(dt)
        x = layer_norm(x, p["word_embeddings_layernorm"], eps, dt)
        for li in range(cfg.num_layers):
            lp = p[f"layer_{li}"]
            pa = lp["self_attention"]
            h = layer_norm(x, lp["input_layernorm"], eps, dt)
            q, k, v = (dense(h, pa[f"{n}_proj"], dt).reshape(B, T, H, D)
                       for n in "qkv")
            x = x + dense(causal_attention(q, k, v, bias), pa["dense"], dt)
            h = layer_norm(x, lp["post_attention_layernorm"], eps, dt)
            x = x + dense(gelu(dense(h, lp["dense_h_to_4h"], dt)),
                          lp["dense_4h_to_h"], dt)
        x = layer_norm(x, p["ln_f"], eps, torch.float32)
        return head(x, p, "word_embeddings")
