"""Mixtral-style MoE transformer (port of ``deepspeed_tpu/models/mixtral.py``):
the Llama block with its MLP replaced by a routed mixture of SwiGLU
experts, and for Qwen2-MoE an always-on shared expert behind a sigmoid
gate.

The serving oracle (:class:`Mixtral`) is the eval forward of the flax
``Mixtral``: its MoE layer at ``train=False`` with ``drop_tokens=False``
takes the dropless grouped path (``moe/sharded_moe.grouped_moe_ffn``),
with the weights of a top-1 choice left at the softmax probability (the
layer's ``normalize_weights and k > 1``). Parameters keep the flax
tree's paths:
``layer_i/moe/{gate [M, E], wi_gate, wi_up [E, M, I], wo [E, I, M]}``
(``wi`` / ``wo`` for experts without a gate) and, with a shared expert,
``layer_i/shared_{gate,up,down}_proj/kernel`` and
``layer_i/shared_expert_gate/kernel [M, 1]``.

Training: :func:`forward` is the flax ``Mixtral`` at ``train=True``, each
layer's MLP the ``MoE`` layer of ``moe/layer.py`` (Mixtral's top-2 with
second-expert sampling takes the capacity route, keyed by flax's
``make_rng("gating")`` at ``("layer_i", "moe")``; Qwen2-MoE's top-4
takes the grouped route through the grouped GEMM and its backward), with
``remat`` a checkpoint a block. :func:`make_model`'s loss is ``nll +
router_aux_loss_coef * sum of the layers' l_aux``, the head fused into
``lm_head_xent`` as ``[C, V]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..moe.layer import MoE
from ..utils.dtypes import resolve_dtype
from .llama import Llama, LlamaConfig, attention, lm_loss, rms_norm


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
    """The eval forward over the JAX package's Mixtral tree without
    gradients (:func:`forward` at ``train=False``, plain attention; the
    tensors are adopted, not copied)."""

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] in fp32."""
        return forward(dataclasses.replace(self.cfg, attention_impl="xla"),
                       self.params(), tokens, train=False)[0]


# ------------------------------------------------------------ training


def moe_layer(cfg: MixtralConfig) -> MoE:
    """The ``MoE`` layer a ``MixtralBlock`` builds."""
    return MoE(d_model=cfg.hidden_size, num_experts=cfg.num_experts,
               k=cfg.experts_top_k, hidden=cfg.intermediate_size,
               capacity_factor=cfg.capacity_factor,
               eval_capacity_factor=cfg.capacity_factor,
               drop_tokens=cfg.drop_tokens, dtype=resolve_dtype(cfg.dtype),
               activation=F.silu, gated=cfg.gated_experts,
               normalize_weights=cfg.norm_topk_prob)


def block(cfg: MixtralConfig, lp: Dict[str, Any], x: torch.Tensor,
          key: Optional[torch.Tensor], li: int, train: bool):
    """One ``MixtralBlock``: (x, the layer's l_aux)."""
    dt = resolve_dtype(cfg.dtype)
    x = x + attention(cfg, lp["attn"], rms_norm(
        x, lp["input_norm"]["scale"], cfg.rms_eps).to(dt))
    h = rms_norm(x, lp["post_attn_norm"]["scale"], cfg.rms_eps).to(dt)
    y, l_aux = moe_layer(cfg).forward(lp["moe"], h, train, key,
                                      (f"layer_{li}", "moe"))
    if cfg.shared_expert_size:
        y = y + shared_expert(lp, h, dt)
    return x + y, l_aux


def forward(cfg: MixtralConfig, params: Dict[str, Any], tokens: torch.Tensor,
            key: Optional[torch.Tensor] = None, train: bool = True,
            return_hidden: bool = False):
    """tokens [B, T] -> (logits [B, T, V] fp32, or the fp32 hidden states
    with ``return_hidden``; the sum of the layers' l_aux). ``key`` is the
    root ``gating`` key."""
    dt = resolve_dtype(cfg.dtype)
    x = F.embedding(tokens.long(), params["embed"]["embedding"].to(dt))
    aux = []
    for li in range(cfg.num_layers):
        lp = params[f"layer_{li}"]
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(block, cfg, lp, x, key, li, train,
                              use_reentrant=False)
        else:
            x, a = block(cfg, lp, x, key, li, train)
        aux.append(a)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
    moe_aux = sum(aux[1:], aux[0]) if aux else x.new_zeros(())
    if return_hidden:
        return x, moe_aux
    if "lm_head" not in params:                      # a tied tree
        return x @ params["embed"]["embedding"].float().t(), moe_aux
    return x @ params["lm_head"]["kernel"].float(), moe_aux


def make_model(cfg: MixtralConfig):
    """``(model, init_fn, loss_fn)``: ``loss_fn(params, batch, key)`` is
    the next-token NLL plus ``router_aux_loss_coef`` times the layers'
    summed l_aux, ``key`` the gating key (the engine passes each
    micro-batch's); ``init_fn(seed=0, device=None)`` makes seeded weights
    (``checkpoint.init_family_params``) in ``cfg.param_dtype``."""
    def model(params, tokens, key=None, train=True, return_hidden=False):
        return forward(cfg, params, tokens, key, train, return_hidden)

    def init_fn(seed: int = 0, device: Any = None):
        from ..checkpoint.jax_params import init_family_params
        return init_family_params(cfg, seed=seed, device=device,
                                  dtype=cfg.param_dtype)

    def loss_fn(params, batch, key=None):
        tokens = batch["tokens"]
        hidden, moe_aux = forward(cfg, params, tokens[:, :-1], key,
                                  return_hidden=True)
        nll = lm_loss(cfg, params, hidden, tokens[:, 1:])
        return nll + cfg.router_aux_loss_coef * moe_aux

    return model, init_fn, loss_fn
