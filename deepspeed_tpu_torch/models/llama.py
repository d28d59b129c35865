"""Llama-family causal transformer (port of ``deepspeed_tpu/models/llama.py``).

RMSNorm, RoPE (split-halves rotation, angles in fp32), GQA attention,
SwiGLU MLP, optional sliding window and qkv bias, untied or tied LM head.

Parameters keep the JAX package's names and layouts so one tree serves
both packages: ``embed.embedding`` ``[V, M]``, ``layer_i.attn.q_proj.kernel``
``[in, out]`` (flax Dense layout), norm ``scale`` vectors in fp32. The
nested-dict form of that tree (``params()``) is what the ragged runner
reads; the full-sequence forward here is the oracle for prefill logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32            # < num_heads => GQA
    hidden_size: int = 4096
    intermediate_size: int = 11008
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    sliding_window: Optional[int] = None   # mistral local attention
    qkv_bias: bool = False                 # qwen2
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16            # compute dtype

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_kv_heads", 2)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_7b(**kw):
        """The Llama-2-7B shape (meta-llama/Llama-2-7b): the defaults."""
        return LlamaConfig(**kw)

    @staticmethod
    def tinyllama_1b(**kw):
        """The TinyLlama-1.1B shape (TinyLlama/TinyLlama-1.1B)."""
        kw.setdefault("vocab_size", 32000)
        kw.setdefault("max_seq_len", 2048)
        kw.setdefault("num_layers", 22)
        kw.setdefault("num_heads", 32)
        kw.setdefault("num_kv_heads", 4)
        kw.setdefault("hidden_size", 2048)
        kw.setdefault("intermediate_size", 5632)
        return LlamaConfig(**kw)


def rope_frequencies(head_dim: int, theta: float,
                     device: Any = None) -> torch.Tensor:
    """Inverse frequencies for rotary embedding, shape [head_dim // 2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary position embedding. x: [..., T, H, D]; positions: [..., T]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)          # [D/2]
    ang = positions[..., None].to(torch.float32) * freqs        # [..., T, D/2]
    cos = torch.cos(ang)[..., None, :]                          # [..., T, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics; returns fp32 (callers cast to the compute dtype)."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return y * scale


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Node(nn.Module):
    """A named level of the parameter tree (``attn``, ``q_proj``, ...)."""


def _tree_module(tree: Dict[str, Any]) -> nn.Module:
    node = _Node()
    for k, v in tree.items():
        if isinstance(v, dict):
            node.add_module(k, _tree_module(v))
        else:
            node.register_parameter(k, _param(v))
    return node


def _module_tree(mod: nn.Module) -> Dict[str, Any]:
    out: Dict[str, Any] = {k: p for k, p in mod.named_parameters(
        recurse=False)}
    for k, child in mod.named_children():
        out[k] = _module_tree(child)
    return out


class Llama(nn.Module):
    """Full-sequence forward over the JAX package's parameter tree. The
    tensors are adopted, not copied: ``Llama(cfg, params)`` and a ragged
    engine built from the same ``params`` share one set of weights."""

    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.tree = _tree_module(params)

    def params(self) -> Dict[str, Any]:
        """The nested-dict parameter tree (flax paths, torch tensors)."""
        return _module_tree(self.tree)

    def _attention(self, pa: Dict[str, Any], h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = h.shape
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = cfg.dtype

        def dense(name):
            y = h @ pa[name]["kernel"].to(dt)
            if cfg.qkv_bias:
                y = y + pa[name]["bias"].to(dt)
            return y

        q = dense("q_proj").reshape(B, T, H, D)
        k = dense("k_proj").reshape(B, T, KV, D)
        v = dense("v_proj").reshape(B, T, KV, D)
        pos = torch.arange(T, device=h.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        i = torch.arange(T, device=h.device)[:, None]
        j = torch.arange(T, device=h.device)[None, :]
        mask = j <= i
        if cfg.sliding_window is not None:
            mask = mask & (j > i - cfg.sliding_window)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (D ** 0.5)
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        y = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(dt)
        return y.reshape(B, T, H * D) @ pa["o_proj"]["kernel"].to(dt)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] in fp32."""
        cfg = self.cfg
        p = self.params()
        dt = cfg.dtype
        x = p["embed"]["embedding"][tokens.long()].to(dt)
        for li in range(cfg.num_layers):
            lp = p[f"layer_{li}"]
            h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_eps).to(dt)
            x = x + self._attention(lp["attn"], h)
            h = rms_norm(x, lp["post_attn_norm"]["scale"], cfg.rms_eps).to(dt)
            pm = lp["mlp"]
            m = F.silu(h @ pm["gate_proj"]["kernel"].to(dt)) \
                * (h @ pm["up_proj"]["kernel"].to(dt))
            x = x + m @ pm["down_proj"]["kernel"].to(dt)
        x = rms_norm(x, p["final_norm"]["scale"], cfg.rms_eps)
        if cfg.tie_embeddings:
            return x @ p["embed"]["embedding"].to(torch.float32).T
        return x @ p["lm_head"]["kernel"].to(torch.float32)
