"""Ragged paged-KV runners for BLOOM, GPT-NeoX and GPT-J (port of
``deepspeed_tpu/inference/v2/bloom_gptj_neox_runner.py``).

BLOOM attends with ALiBi: the slopes go into ``paged_attention``, so the
kernels add ``-slope[h] * (pos - j)`` to each score. NeoX rotates the
leading ``rotary_dim`` lanes of each head by halves and takes a parallel
or a sequential residual. GPT-J rotates its leading lanes in (even, odd)
pairs, shares one LayerNorm between attention and MLP in a parallel
residual, and adds its ``lm_head`` bias. The RaggedBatch contract and
the paged attention are ``model_runner.py``'s.
"""

from __future__ import annotations

import torch

from ...models._dense import gelu
from ...models._lm_utils import alibi_slopes_on
from ...models.bloom import BloomConfig
from ...models.gpt_neox import (GPTJConfig, GPTNeoXConfig,
                                apply_partial_rope_interleaved)
from ...models.phi import apply_partial_rope
from ..quantization import dequantize_leaf
from .config import RaggedInferenceConfig
from .model_runner import (RaggedBatch, RaggedRunnerBase, _layer_norm,
                           _linear, head_logits, last_token,
                           paged_attention, step_positions)


def _bloom_ragged_step(params, pool, batch: RaggedBatch, *,
                       model_cfg: BloomConfig, cfg: RaggedInferenceConfig,
                       dtype, fused_woq: bool = False) -> torch.Tensor:
    """One ragged step of BLOOM (the JAX package's ``_bloom_ragged_step``).
    Returns last-token logits [S, V] fp32."""
    mc = model_cfg
    S, C = batch.tokens.shape
    H, D = mc.num_heads, mc.head_dim
    scale = 1.0 / (D ** 0.5)
    eps = mc.layer_norm_eps
    slopes = alibi_slopes_on(H, batch.tokens.device)
    pos, valid_q = step_positions(batch)

    x = dequantize_leaf(params["word_embeddings"]["embedding"])[
        batch.tokens.long()].to(dtype)
    x = _layer_norm(x, params["word_embeddings_layernorm"], eps, dtype)
    for li in range(mc.num_layers):
        p = params[f"layer_{li}"]
        h = _layer_norm(x, p["input_layernorm"], eps, dtype)
        pa = p["self_attention"]
        q, k, v = (_linear(h, pa[f"{n}_proj"], dtype,
                           fused_woq).reshape(S, C, H, D) for n in "qkv")
        y = paged_attention(pool, li, q, k, v, batch, cfg, pos, valid_q,
                            scale, dtype, alibi_slopes=slopes)
        x = x + _linear(y, pa["dense"], dtype, fused_woq)
        h = _layer_norm(x, p["post_attention_layernorm"], eps, dtype)
        m = gelu(_linear(h, p["dense_h_to_4h"], dtype, fused_woq))
        x = x + _linear(m, p["dense_4h_to_h"], dtype, fused_woq)

    x = _layer_norm(x, params["ln_f"], eps)
    return head_logits(last_token(x, batch), params, "lm_head",
                       "word_embeddings")


def _neox_ragged_step(params, pool, batch: RaggedBatch, *,
                      model_cfg: GPTNeoXConfig, cfg: RaggedInferenceConfig,
                      dtype, fused_woq: bool = False) -> torch.Tensor:
    """One ragged step of GPT-NeoX (the JAX package's
    ``_neox_ragged_step``). Returns last-token logits [S, V] fp32."""
    mc = model_cfg
    S, C = batch.tokens.shape
    H, D = mc.num_heads, mc.head_dim
    scale = 1.0 / (D ** 0.5)
    eps = mc.layer_norm_eps
    pos, valid_q = step_positions(batch)

    x = dequantize_leaf(params["embed_in"]["embedding"])[
        batch.tokens.long()].to(dtype)
    for li in range(mc.num_layers):
        p = params[f"layer_{li}"]
        attn_in = _layer_norm(x, p["input_layernorm"], eps, dtype)
        q, k, v = (_linear(attn_in, p[f"{n}_proj"], dtype,
                           fused_woq).reshape(S, C, H, D) for n in "qkv")
        q = apply_partial_rope(q, pos, mc.rope_theta, mc.rotary_dim)
        k = apply_partial_rope(k, pos, mc.rope_theta, mc.rotary_dim)
        y = paged_attention(pool, li, q, k, v, batch, cfg, pos, valid_q,
                            scale, dtype)
        attn_out = _linear(y, p["dense"], dtype, fused_woq)
        if not mc.use_parallel_residual:
            x = x + attn_out            # sequential: the norm after it
        h = _layer_norm(x, p["post_attention_layernorm"], eps, dtype)
        m = gelu(_linear(h, p["dense_h_to_4h"], dtype, fused_woq))
        m = _linear(m, p["dense_4h_to_h"], dtype, fused_woq)
        x = (x + attn_out + m) if mc.use_parallel_residual else (x + m)

    x = _layer_norm(x, params["final_layer_norm"], eps)
    return head_logits(last_token(x, batch), params, "embed_out",
                       "embed_in")


def _gptj_ragged_step(params, pool, batch: RaggedBatch, *,
                      model_cfg: GPTJConfig, cfg: RaggedInferenceConfig,
                      dtype, fused_woq: bool = False) -> torch.Tensor:
    """One ragged step of GPT-J (the JAX package's ``_gptj_ragged_step``).
    Returns last-token logits [S, V] fp32."""
    mc = model_cfg
    S, C = batch.tokens.shape
    H, D = mc.num_heads, mc.head_dim
    scale = 1.0 / (D ** 0.5)
    eps = mc.layer_norm_eps
    pos, valid_q = step_positions(batch)

    x = dequantize_leaf(params["wte"]["embedding"])[
        batch.tokens.long()].to(dtype)
    for li in range(mc.num_layers):
        p = params[f"layer_{li}"]
        h = _layer_norm(x, p["ln_1"], eps, dtype)
        q, k, v = (_linear(h, p[f"{n}_proj"], dtype,
                           fused_woq).reshape(S, C, H, D) for n in "qkv")
        q = apply_partial_rope_interleaved(q, pos, mc.rope_theta,
                                           mc.rotary_dim)
        k = apply_partial_rope_interleaved(k, pos, mc.rope_theta,
                                           mc.rotary_dim)
        y = paged_attention(pool, li, q, k, v, batch, cfg, pos, valid_q,
                            scale, dtype)
        attn_out = _linear(y, p["out_proj"], dtype, fused_woq)
        m = _linear(gelu(_linear(h, p["fc_in"], dtype, fused_woq)),
                    p["fc_out"], dtype, fused_woq)
        x = x + attn_out + m                    # parallel residual

    x = _layer_norm(x, params["ln_f"], eps)
    return head_logits(last_token(x, batch), params, "lm_head", "wte")


class BloomRaggedRunner(RaggedRunnerBase):
    """Paged-KV prefill and decode over the BLOOM tree, ALiBi in the
    kernels; packed leaves dequantized at their use."""

    supports_fused_woq = False
    step_fn = staticmethod(_bloom_ragged_step)


class GPTNeoXRaggedRunner(RaggedRunnerBase):
    """Paged-KV prefill and decode over the GPT-NeoX tree; packed leaves
    dequantized at their use."""

    supports_fused_woq = False
    step_fn = staticmethod(_neox_ragged_step)


class GPTJRaggedRunner(RaggedRunnerBase):
    """Paged-KV prefill and decode over the GPT-J tree; packed leaves
    dequantized at their use."""

    supports_fused_woq = False
    step_fn = staticmethod(_gptj_ragged_step)
