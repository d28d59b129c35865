"""Ragged paged-KV runner for the dense Llama family (port of
``deepspeed_tpu/inference/v2/llama_runner.py``).

RoPE at each token's absolute position, GQA KV stored at kv-head width,
SwiGLU MLP, RMSNorm, last-token logits. Every matmul goes through
``woq_mm``, so weight-only-quantized leaves are dequantized at their use
and fused fp6 leaves stream through the fp6 GEMM kernel. The MoE
(Mixtral) branch is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...models.llama import LlamaConfig, apply_rope, rms_norm
from ...ops.kernels.fp6_gemm import Fp6GemmWeight
from ..quantization import dequantize_leaf
from .config import RaggedInferenceConfig
from .model_runner import (RaggedBatch, RaggedRunnerBase, paged_attention,
                           woq_mm)


def _llama_ragged_step(params, pool, batch: RaggedBatch, *,
                       model_cfg: LlamaConfig, cfg: RaggedInferenceConfig,
                       dtype) -> torch.Tensor:
    S, C = batch.tokens.shape
    H = model_cfg.num_heads
    KV = model_cfg.num_kv_heads
    D = model_cfg.head_dim
    scale = 1.0 / (D ** 0.5)
    dev = batch.tokens.device

    cols = torch.arange(C, device=dev)
    pos = batch.start_pos.long()[:, None] + cols[None, :]
    valid_q = cols[None, :] < batch.n_tokens.long()[:, None]

    x = dequantize_leaf(params["embed"]["embedding"])[
        batch.tokens.long()].to(dtype)

    for li in range(model_cfg.num_layers):
        p = params[f"layer_{li}"]
        h = rms_norm(x, p["input_norm"]["scale"],
                     model_cfg.rms_eps).to(dtype)
        pa = p["attn"]
        q = woq_mm(h, pa["q_proj"]["kernel"], dtype)
        k = woq_mm(h, pa["k_proj"]["kernel"], dtype)
        v = woq_mm(h, pa["v_proj"]["kernel"], dtype)
        if model_cfg.qkv_bias:
            q = q + pa["q_proj"]["bias"].to(dtype)
            k = k + pa["k_proj"]["bias"].to(dtype)
            v = v + pa["v_proj"]["bias"].to(dtype)
        q = apply_rope(q.reshape(S, C, H, D), pos, model_cfg.rope_theta)
        k = apply_rope(k.reshape(S, C, KV, D), pos, model_cfg.rope_theta)
        v = v.reshape(S, C, KV, D)

        y = paged_attention(pool, li, q, k, v, batch, cfg, pos, valid_q,
                            scale, dtype,
                            sliding_window=model_cfg.sliding_window)
        x = x + woq_mm(y, pa["o_proj"]["kernel"], dtype)

        h = rms_norm(x, p["post_attn_norm"]["scale"],
                     model_cfg.rms_eps).to(dtype)
        pm = p["mlp"]
        m = F.silu(woq_mm(h, pm["gate_proj"]["kernel"], dtype)) \
            * woq_mm(h, pm["up_proj"]["kernel"], dtype)
        x = x + woq_mm(m, pm["down_proj"]["kernel"], dtype)

    x = rms_norm(x, params["final_norm"]["scale"], model_cfg.rms_eps)
    last = torch.clamp(batch.n_tokens.long() - 1, min=0)
    x_last = x[torch.arange(S, device=dev), last]               # [S, M] fp32
    if model_cfg.tie_embeddings:
        # embedding tables are never fused-packed (the token gather needs
        # a dense array)
        w_out = dequantize_leaf(params["embed"]["embedding"]).T
    else:
        w_out = params["lm_head"]["kernel"]
        if isinstance(w_out, Fp6GemmWeight):
            return woq_mm(x_last, w_out, torch.float32)
        w_out = dequantize_leaf(w_out)
    return x_last @ w_out.to(torch.float32)


class LlamaRaggedRunner(RaggedRunnerBase):
    """Runner plumbing comes from RaggedRunnerBase; ``step_fn`` is the
    dense Llama step above, whose matmuls dispatch through ``woq_mm``."""

    step_fn = staticmethod(_llama_ragged_step)
