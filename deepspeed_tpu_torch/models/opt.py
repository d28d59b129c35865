"""OPT causal transformer (port of ``deepspeed_tpu/models/opt.py``):
learned positions with OPT's offset of 2, pre-LN decoder blocks (post-LN
on opt-350m, which also projects a 512-wide embedding in and out),
biased projections, ReLU MLP, a tied LM head by default."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ._dense import TreeModel, causal_attention, dense, head, layer_norm


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    max_seq_len: int = 2048
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    ffn_dim: int = 3072
    layer_norm_eps: float = 1e-5
    do_layer_norm_before: bool = True       # False on opt-350m (post-LN)
    word_embed_proj_dim: Optional[int] = None   # opt-350m: 512 != hidden
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16             # compute dtype
    param_dtype: Any = torch.float32

    #: OPT's learned positions start at index 2 (a pad-token legacy)
    POSITION_OFFSET = 2

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
        kw.setdefault("ffn_dim", 128)
        return OPTConfig(**kw)


class OPT(TreeModel):
    """Full-sequence forward over the flax tree of ``OPT(cfg)``:
    ``embed_tokens``, ``embed_positions`` [max_seq_len + 2, M], optional
    ``project_in`` / ``project_out``, ``layer_i/{self_attn/{q,k,v,out}_proj,
    self_attn_layer_norm, fc1, fc2, final_layer_norm}``, the pre-LN
    ``final_layer_norm``, and ``lm_head`` when untied."""

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self.params()
        dt, eps = cfg.dtype, cfg.layer_norm_eps
        pre = cfg.do_layer_norm_before
        B, T = tokens.shape
        H, D = cfg.num_heads, cfg.head_dim
        x = p["embed_tokens"]["embedding"][tokens.long()].to(dt)
        if "project_in" in p:
            x = dense(x, p["project_in"], dt)
        pos = torch.arange(T, device=tokens.device) + cfg.POSITION_OFFSET
        x = x + p["embed_positions"]["embedding"][pos].to(dt)
        for li in range(cfg.num_layers):
            lp = p[f"layer_{li}"]
            ln1, ln2 = lp["self_attn_layer_norm"], lp["final_layer_norm"]
            pa = lp["self_attn"]
            h = layer_norm(x, ln1, eps, dt) if pre else x
            q, k, v = (dense(h, pa[f"{n}_proj"], dt).reshape(B, T, H, D)
                       for n in "qkv")
            x = x + dense(causal_attention(q, k, v), pa["out_proj"], dt)
            if not pre:
                x = layer_norm(x, ln1, eps, dt)
            h = layer_norm(x, ln2, eps, dt) if pre else x
            x = x + dense(torch.relu(dense(h, lp["fc1"], dt)), lp["fc2"], dt)
            if not pre:
                x = layer_norm(x, ln2, eps, dt)
        if pre:
            x = layer_norm(x, p["final_layer_norm"], eps, torch.float32)
        if "project_out" in p:
            x = dense(x, p["project_out"], dt)
        return head(x, p, "embed_tokens")
