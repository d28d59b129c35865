"""Ragged paged-KV runner for OPT (port of
``deepspeed_tpu/inference/v2/opt_runner.py``): learned positions with
OPT's offset of 2 (clamped to ``max_seq_len - 1`` before the offset),
pre-LN decoder blocks (or opt-350m's post-LN ones, with its embedding
projected in and out), biased q/k/v/out projections, ReLU MLP, the tied
head or an untied ``lm_head``. The RaggedBatch contract and the paged
attention are ``model_runner.py``'s."""

from __future__ import annotations

import torch

from ...models.opt import OPTConfig
from ..quantization import dequantize_leaf
from .config import RaggedInferenceConfig
from .model_runner import (RaggedBatch, RaggedRunnerBase, _layer_norm,
                           _linear, head_logits, last_token,
                           paged_attention, step_positions)


def _opt_ragged_step(params, pool, batch: RaggedBatch, *,
                     model_cfg: OPTConfig, cfg: RaggedInferenceConfig,
                     dtype, fused_woq: bool = False) -> torch.Tensor:
    """One ragged step of OPT (the JAX package's ``_opt_ragged_step``).
    Returns last-token logits [S, V] fp32."""
    mc = model_cfg
    S, C = batch.tokens.shape
    H, D = mc.num_heads, mc.head_dim
    scale = 1.0 / (D ** 0.5)
    eps = mc.layer_norm_eps
    pre_ln = mc.do_layer_norm_before

    pos, valid_q = step_positions(batch)
    pos_c = torch.clamp(pos, max=mc.max_seq_len - 1) + mc.POSITION_OFFSET

    wte = dequantize_leaf(params["embed_tokens"]["embedding"])
    wpe = dequantize_leaf(params["embed_positions"]["embedding"])
    x = wte[batch.tokens.long()].to(dtype)
    if "project_in" in params:
        x = _linear(x, params["project_in"], dtype)
    x = x + wpe[pos_c].to(dtype)

    for li in range(mc.num_layers):
        p = params[f"layer_{li}"]
        ln1, ln2 = p["self_attn_layer_norm"], p["final_layer_norm"]
        attn_in = _layer_norm(x, ln1, eps, dtype) if pre_ln else x
        pa = p["self_attn"]
        q, k, v = (_linear(attn_in, pa[f"{n}_proj"], dtype,
                           fused_woq).reshape(S, C, H, D) for n in "qkv")
        y = paged_attention(pool, li, q, k, v, batch, cfg, pos, valid_q,
                            scale, dtype)
        x = x + _linear(y, pa["out_proj"], dtype, fused_woq)
        if not pre_ln:
            x = _layer_norm(x, ln1, eps, dtype)

        mlp_in = _layer_norm(x, ln2, eps, dtype) if pre_ln else x
        m = torch.relu(_linear(mlp_in, p["fc1"], dtype, fused_woq))
        x = x + _linear(m, p["fc2"], dtype, fused_woq)
        if not pre_ln:
            x = _layer_norm(x, ln2, eps, dtype)

    if pre_ln:
        x = _layer_norm(x, params["final_layer_norm"], eps)
    x = x.float()
    if "project_out" in params:
        x = x @ dequantize_leaf(params["project_out"]["kernel"]).float()
    return head_logits(last_token(x, batch), params, "lm_head",
                       "embed_tokens")


class OPTRaggedRunner(RaggedRunnerBase):
    """Paged-KV prefill and decode over the OPT tree
    (``checkpoint/jax_params.py`` ``opt_param_shapes``); a packed leaf is
    dequantized at its use (``supports_fused_woq`` False, as in JAX)."""

    supports_fused_woq = False
    step_fn = staticmethod(_opt_ragged_step)
