"""Ragged paged-KV runners for Falcon and Phi, the parallel-residual
families (port of ``deepspeed_tpu/inference/v2/falcon_phi_runner.py``).

Falcon: rotary (or ALiBi on the rw family) attention with its K/V at
``num_kv_heads`` width (multi-query on falcon-7b: 71 query heads on one
KV head), one LayerNorm a block (two on the new decoder architecture:
``ln_attn`` and ``ln_mlp``), a parallel or a serial residual, bias-free
projections. Phi: one shared LayerNorm, partial rotary, biased
projections, an ``lm_head`` whose bias is added in fp32. The RaggedBatch
contract and the paged attention are ``model_runner.py``'s.
"""

from __future__ import annotations

import torch

from ...models._dense import gelu
from ...models._lm_utils import alibi_slopes_on
from ...models.falcon import FalconConfig
from ...models.llama import apply_rope
from ...models.phi import PhiConfig, apply_partial_rope
from ..quantization import dequantize_leaf
from .config import RaggedInferenceConfig
from .model_runner import (RaggedBatch, RaggedRunnerBase, _layer_norm,
                           _linear, head_logits, last_token,
                           paged_attention, step_positions)


def _falcon_ragged_step(params, pool, batch: RaggedBatch, *,
                        model_cfg: FalconConfig, cfg: RaggedInferenceConfig,
                        dtype, fused_woq: bool = False) -> torch.Tensor:
    """One ragged step of Falcon (the JAX package's
    ``_falcon_ragged_step``). Returns last-token logits [S, V] fp32."""
    mc = model_cfg
    S, C = batch.tokens.shape
    H, KV, D = mc.num_heads, mc.num_kv_heads, mc.head_dim
    scale = 1.0 / (D ** 0.5)
    eps = mc.layer_norm_eps
    pos, valid_q = step_positions(batch)
    slopes = alibi_slopes_on(H, batch.tokens.device) if mc.alibi else None

    x = dequantize_leaf(params["word_embeddings"]["embedding"])[
        batch.tokens.long()].to(dtype)
    for li in range(mc.num_layers):
        p = params[f"layer_{li}"]
        if mc.new_decoder_architecture:
            attn_in = _layer_norm(x, p["ln_attn"], eps, dtype)
            mlp_in = _layer_norm(x, p["ln_mlp"], eps, dtype)
        else:
            attn_in = mlp_in = _layer_norm(x, p["input_layernorm"], eps,
                                           dtype)
        pa = p["self_attention"]
        q = _linear(attn_in, pa["q_proj"], dtype, fused_woq).reshape(
            S, C, H, D)
        k = _linear(attn_in, pa["k_proj"], dtype, fused_woq).reshape(
            S, C, KV, D)
        v = _linear(attn_in, pa["v_proj"], dtype, fused_woq).reshape(
            S, C, KV, D)
        if not mc.alibi:
            q = apply_rope(q, pos, mc.rope_theta)
            k = apply_rope(k, pos, mc.rope_theta)
        y = paged_attention(pool, li, q, k, v, batch, cfg, pos, valid_q,
                            scale, dtype, alibi_slopes=slopes)
        attn_out = _linear(y, pa["dense"], dtype, fused_woq)

        def mlp(h):
            m = gelu(_linear(h, p["mlp"]["dense_h_to_4h"], dtype, fused_woq))
            return _linear(m, p["mlp"]["dense_4h_to_h"], dtype, fused_woq)

        if mc.parallel_attn or mc.new_decoder_architecture:
            x = x + attn_out + mlp(mlp_in)
        else:
            x = x + attn_out
            x = x + mlp(_layer_norm(x, p["post_attention_layernorm"], eps,
                                    dtype))

    x = _layer_norm(x, params["ln_f"], eps)
    return head_logits(last_token(x, batch), params, "lm_head",
                       "word_embeddings")


def _phi_ragged_step(params, pool, batch: RaggedBatch, *,
                     model_cfg: PhiConfig, cfg: RaggedInferenceConfig,
                     dtype, fused_woq: bool = False) -> torch.Tensor:
    """One ragged step of Phi (the JAX package's ``_phi_ragged_step``).
    Returns last-token logits [S, V] fp32."""
    mc = model_cfg
    S, C = batch.tokens.shape
    H, D = mc.num_heads, mc.head_dim
    scale = 1.0 / (D ** 0.5)
    eps = mc.layer_norm_eps
    pos, valid_q = step_positions(batch)

    x = dequantize_leaf(params["embed_tokens"]["embedding"])[
        batch.tokens.long()].to(dtype)
    for li in range(mc.num_layers):
        p = params[f"layer_{li}"]
        h = _layer_norm(x, p["input_layernorm"], eps, dtype)
        pa = p["self_attn"]
        q, k, v = (_linear(h, pa[f"{n}_proj"], dtype,
                           fused_woq).reshape(S, C, H, D) for n in "qkv")
        q = apply_partial_rope(q, pos, mc.rope_theta, mc.rotary_dim)
        k = apply_partial_rope(k, pos, mc.rope_theta, mc.rotary_dim)
        y = paged_attention(pool, li, q, k, v, batch, cfg, pos, valid_q,
                            scale, dtype)
        attn_out = _linear(y, pa["dense"], dtype, fused_woq)
        m = gelu(_linear(h, p["fc1"], dtype, fused_woq))
        m = _linear(m, p["fc2"], dtype, fused_woq)
        x = x + attn_out + m                      # parallel residual

    x = _layer_norm(x, params["final_layernorm"], eps)
    return head_logits(last_token(x, batch), params, "lm_head",
                       "embed_tokens")


class FalconRaggedRunner(RaggedRunnerBase):
    """Paged-KV prefill and decode over the Falcon tree
    (``falcon_param_shapes``); packed leaves dequantized at their use."""

    supports_fused_woq = False
    step_fn = staticmethod(_falcon_ragged_step)


class PhiRaggedRunner(RaggedRunnerBase):
    """Paged-KV prefill and decode over the Phi tree
    (``phi_param_shapes``); packed leaves dequantized at their use."""

    supports_fused_woq = False
    step_fn = staticmethod(_phi_ragged_step)
