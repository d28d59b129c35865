"""Falcon causal transformer (port of ``deepspeed_tpu/models/falcon.py``):
rotary attention, multi-query on falcon-7b (71 query heads on one KV
head) or grouped-query with separate attention and MLP LayerNorms on the
40b ``new_decoder_architecture``, ALiBi instead of rotary on the rw
family, a parallel attention + MLP residual (or a serial one), bias-free
projections, a 4x GELU MLP, tied embeddings."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ._dense import (TreeModel, alibi_bias, causal_attention, dense, gelu,
                     head, layer_norm)
from .llama import apply_rope


@dataclasses.dataclass(frozen=True)
class FalconConfig:
    vocab_size: int = 65024
    max_seq_len: int = 2048
    num_layers: int = 32
    num_heads: int = 71
    num_kv_heads: int = 1              # MQA (falcon-7b); 8 on 40b
    hidden_size: int = 4544
    rope_theta: float = 10000.0
    alibi: bool = False                # falcon-rw: ALiBi, no rotary
    layer_norm_eps: float = 1e-5
    parallel_attn: bool = True
    new_decoder_architecture: bool = False   # 40b: ln_attn and ln_mlp
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
        kw.setdefault("num_kv_heads", 1)
        kw.setdefault("hidden_size", 64)
        return FalconConfig(**kw)


class Falcon(TreeModel):
    """Full-sequence forward over the flax tree of ``Falcon(cfg)``:
    ``word_embeddings``, ``layer_i/{input_layernorm | ln_attn and ln_mlp,
    self_attention/{q,k,v}_proj, self_attention/dense,
    post_attention_layernorm (serial), mlp/dense_h_to_4h,
    mlp/dense_4h_to_h}``, ``ln_f``, ``lm_head`` when untied."""

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self.params()
        dt, eps = cfg.dtype, cfg.layer_norm_eps
        B, T = tokens.shape
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        pos = torch.arange(T, device=tokens.device)[None, :]
        bias = alibi_bias(H, T, tokens.device).to(dt) if cfg.alibi else None
        x = p["word_embeddings"]["embedding"][tokens.long()].to(dt)
        for li in range(cfg.num_layers):
            lp = p[f"layer_{li}"]
            if cfg.new_decoder_architecture:
                attn_in = layer_norm(x, lp["ln_attn"], eps, dt)
                mlp_in = layer_norm(x, lp["ln_mlp"], eps, dt)
            else:
                attn_in = mlp_in = layer_norm(x, lp["input_layernorm"],
                                              eps, dt)
            pa = lp["self_attention"]
            q = dense(attn_in, pa["q_proj"], dt).reshape(B, T, H, D)
            k = dense(attn_in, pa["k_proj"], dt).reshape(B, T, KV, D)
            v = dense(attn_in, pa["v_proj"], dt).reshape(B, T, KV, D)
            if not cfg.alibi:
                q = apply_rope(q, pos, cfg.rope_theta)
                k = apply_rope(k, pos, cfg.rope_theta)
            attn = dense(causal_attention(q, k, v, bias), pa["dense"], dt)

            def mlp(z):
                return dense(gelu(dense(z, lp["mlp"]["dense_h_to_4h"], dt)),
                             lp["mlp"]["dense_4h_to_h"], dt)

            if cfg.parallel_attn or cfg.new_decoder_architecture:
                x = x + attn + mlp(mlp_in)
            else:
                x = x + attn
                x = x + mlp(layer_norm(x, lp["post_attention_layernorm"],
                                       eps, dt))
        x = layer_norm(x, p["ln_f"], eps, torch.float32)
        return head(x, p, "word_embeddings")
