"""GPT-NeoX and GPT-J causal transformers (port of
``deepspeed_tpu/models/gpt_neox.py``).

GPT-NeoX: partial rotary (``rotary_pct`` of the head, rotate-half), q/k/v
split from HF's per-head fused ``query_key_value`` (the loader splits
it), a parallel (or sequential) residual with separate input and
post-attention LayerNorms, biased GELU MLP, untied ``embed_out``.

GPT-J: partial rotary in the interleaved convention (each (even, odd)
lane pair rotates together), bias-free q/k/v/out projections, a parallel
residual sharing one LayerNorm, biased ``fc_in`` / ``fc_out``, an untied
LM head with a bias.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ._dense import (TreeModel, causal_attention, dense, gelu, head,
                     layer_norm)
from .llama import rope_frequencies
from .phi import apply_partial_rope


def apply_rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                           theta: float) -> torch.Tensor:
    """GPT-J's rotary convention: lanes (2i, 2i + 1) rotate together by
    angle ``pos * freq_i`` (llama and NeoX rotate the two halves).
    x [..., T, H, D]; positions [..., T]; angles in fp32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)         # [D/2]
    ang = positions[..., None].to(torch.float32) * freqs        # [..., T, D/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_partial_rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                                   theta: float,
                                   rotary_dim: int) -> torch.Tensor:
    """Interleaved RoPE on the leading ``rotary_dim`` lanes of each head."""
    rot, keep = x[..., :rotary_dim], x[..., rotary_dim:]
    return torch.cat([apply_rope_interleaved(rot, positions, theta), keep],
                     dim=-1)


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50432
    max_seq_len: int = 2048
    num_layers: int = 44
    num_heads: int = 64
    hidden_size: int = 6144
    intermediate_size: int = 24576
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16         # compute dtype
    param_dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        return GPTNeoXConfig(**kw)


class GPTNeoX(TreeModel):
    """Full-sequence forward over the flax tree of ``GPTNeoX(cfg)``:
    ``embed_in``, ``layer_i/{input_layernorm, {q,k,v}_proj, dense,
    post_attention_layernorm, dense_h_to_4h, dense_4h_to_h}``,
    ``final_layer_norm``, ``embed_out`` (untied)."""

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self.params()
        dt, eps = cfg.dtype, cfg.layer_norm_eps
        B, T = tokens.shape
        H, D = cfg.num_heads, cfg.head_dim
        pos = torch.arange(T, device=tokens.device)[None, :]
        x = p["embed_in"]["embedding"][tokens.long()].to(dt)
        for li in range(cfg.num_layers):
            lp = p[f"layer_{li}"]
            h = layer_norm(x, lp["input_layernorm"], eps, dt)
            q, k, v = (dense(h, lp[f"{n}_proj"], dt).reshape(B, T, H, D)
                       for n in "qkv")
            q = apply_partial_rope(q, pos, cfg.rope_theta, cfg.rotary_dim)
            k = apply_partial_rope(k, pos, cfg.rope_theta, cfg.rotary_dim)
            attn = dense(causal_attention(q, k, v), lp["dense"], dt)

            def mlp(z):
                return dense(gelu(dense(z, lp["dense_h_to_4h"], dt)),
                             lp["dense_4h_to_h"], dt)

            ln2 = lp["post_attention_layernorm"]
            if cfg.use_parallel_residual:
                x = x + attn + mlp(layer_norm(x, ln2, eps, dt))
            else:
                x = x + attn
                x = x + mlp(layer_norm(x, ln2, eps, dt))
        x = layer_norm(x, p["final_layer_norm"], eps, torch.float32)
        return head(x, p, "embed_in", head_key="embed_out")


@dataclasses.dataclass(frozen=True)
class GPTJConfig:
    vocab_size: int = 50400
    max_seq_len: int = 2048
    num_layers: int = 28
    num_heads: int = 16
    hidden_size: int = 4096
    intermediate_size: int = 16384
    rotary_dim: int = 64
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16         # compute dtype
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
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("rotary_dim", 8)
        return GPTJConfig(**kw)


class GPTJ(TreeModel):
    """Full-sequence forward over the flax tree of ``GPTJ(cfg)``: ``wte``,
    ``layer_i/{ln_1, {q,k,v,out}_proj, fc_in, fc_out}``, ``ln_f``,
    ``lm_head`` (untied, biased)."""

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self.params()
        dt, eps = cfg.dtype, cfg.layer_norm_eps
        B, T = tokens.shape
        H, D = cfg.num_heads, cfg.head_dim
        pos = torch.arange(T, device=tokens.device)[None, :]
        x = p["wte"]["embedding"][tokens.long()].to(dt)
        for li in range(cfg.num_layers):
            lp = p[f"layer_{li}"]
            h = layer_norm(x, lp["ln_1"], eps, dt)
            q, k, v = (dense(h, lp[f"{n}_proj"], dt).reshape(B, T, H, D)
                       for n in "qkv")
            q = apply_partial_rope_interleaved(q, pos, cfg.rope_theta,
                                               cfg.rotary_dim)
            k = apply_partial_rope_interleaved(k, pos, cfg.rope_theta,
                                               cfg.rotary_dim)
            attn = dense(causal_attention(q, k, v), lp["out_proj"], dt)
            m = dense(gelu(dense(h, lp["fc_in"], dt)), lp["fc_out"], dt)
            x = x + attn + m                   # parallel residual, one LN
        x = layer_norm(x, p["ln_f"], eps, torch.float32)
        return head(x, p, "wte")
