"""Mixtral-style MoE transformer (port of ``deepspeed_tpu/models/mixtral.py``):
the Llama block with its MLP replaced by a routed mixture of SwiGLU
experts, and for Qwen2-MoE an always-on shared expert behind a sigmoid
gate.

The forward here is the eval forward of the flax ``Mixtral``: its MoE
layer at ``train=False`` with ``drop_tokens=False`` takes the dropless
grouped path (``moe/sharded_moe.grouped_moe_ffn``), with the weights of a
top-1 choice left at the softmax probability (the layer's
``normalize_weights and k > 1``). Parameters keep the flax tree's paths:
``layer_i/moe/{gate [M, E], wi_gate, wi_up [E, M, I], wo [E, I, M]}``
(``wi`` / ``wo`` for experts without a gate) and, with a shared expert,
``layer_i/shared_{gate,up,down}_proj/kernel`` and
``layer_i/shared_expert_gate/kernel [M, 1]``. Training (the capacity
gating, the aux loss in ``make_model``, remat) is queue item A7.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..moe.sharded_moe import grouped_moe_ffn
from .llama import Llama, LlamaConfig, rms_norm


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    experts_top_k: int = 2
    capacity_factor: float = 2.0
    drop_tokens: bool = False          # mixtral routes all tokens
    router_aux_loss_coef: float = 0.02
    shared_expert_size: int = 0        # qwen2-moe always-on expert width
    gated_experts: bool = True         # SwiGLU experts (HF mixtral layout)
    # True (mixtral): softmax over the selected top-k (renormalized).
    # False (qwen2-moe default): softmax over ALL experts, top-k taken
    # without renormalization.
    norm_topk_prob: bool = True

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_kv_heads", 2)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_experts", 4)
        return MixtralConfig(**kw)

    @staticmethod
    def mixtral_8x7b(**kw):
        """The Mixtral-8x7B shape (mistralai/Mixtral-8x7B-v0.1)."""
        kw.setdefault("vocab_size", 32000)
        kw.setdefault("max_seq_len", 32768)
        kw.setdefault("num_kv_heads", 8)
        kw.setdefault("intermediate_size", 14336)
        kw.setdefault("rope_theta", 1e6)
        return MixtralConfig(**kw)


def expert_weights(pm: Dict[str, Any]):
    """The stacked expert weights of a ``moe`` node, in the order
    ``grouped_moe_ffn`` takes them."""
    if "wi_gate" in pm:
        return pm["wi_gate"], pm["wi_up"], pm["wo"]
    return pm["wi"], pm["wo"]


def shared_expert(lp: Dict[str, Any], h: torch.Tensor, dt: torch.dtype,
                  mm=None) -> torch.Tensor:
    """Qwen2-MoE's always-on SwiGLU expert times its sigmoid scalar gate
    (the sigmoid in fp32). ``mm(h, leaf)`` is the matmul of its four
    weights (a plain cast-and-multiply by default)."""
    if mm is None:
        def mm(a, w):
            return a @ w.to(dt)
    shared = mm(F.silu(mm(h, lp["shared_gate_proj"]["kernel"]))
                * mm(h, lp["shared_up_proj"]["kernel"]),
                lp["shared_down_proj"]["kernel"])
    sg = torch.sigmoid(mm(h, lp["shared_expert_gate"]["kernel"]).float())
    return shared * sg.to(dt)


class Mixtral(Llama):
    """Full-sequence eval forward over the JAX package's Mixtral tree (the
    Llama attention; the tensors are adopted, not copied)."""

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] in fp32."""
        cfg = self.cfg
        p = self.params()
        dt = cfg.dtype
        x = p["embed"]["embedding"][tokens.long()].to(dt)
        B, T, M = x.shape
        for li in range(cfg.num_layers):
            lp = p[f"layer_{li}"]
            h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_eps).to(dt)
            x = x + self._attention(lp["attn"], h)
            h = rms_norm(x, lp["post_attn_norm"]["scale"], cfg.rms_eps).to(dt)
            h2 = h.reshape(B * T, M)
            pm = lp["moe"]
            y, _ = grouped_moe_ffn(
                h2, h2.float() @ pm["gate"].float(), cfg.experts_top_k,
                expert_weights(pm), F.silu, dt,
                normalize_weights=cfg.norm_topk_prob
                and cfg.experts_top_k > 1)
            if cfg.shared_expert_size:
                y = y + shared_expert(lp, h2, dt)
            x = x + y.reshape(B, T, M)
        x = rms_norm(x, p["final_norm"]["scale"], cfg.rms_eps)
        if cfg.tie_embeddings:
            return x @ p["embed"]["embedding"].to(torch.float32).T
        return x @ p["lm_head"]["kernel"].to(torch.float32)
