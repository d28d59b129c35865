"""Ragged paged-KV runner for the dense Llama family (port of
``deepspeed_tpu/inference/v2/llama_runner.py``).

RoPE at each token's absolute position, GQA KV stored at kv-head width,
SwiGLU MLP, RMSNorm, last-token logits. The MoE (Mixtral) branch and
weight-only-quantized matmuls are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...models.llama import LlamaConfig, apply_rope, rms_norm
from .config import RaggedInferenceConfig
from .model_runner import RaggedBatch, RaggedRunnerBase, paged_attention


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

    x = params["embed"]["embedding"][batch.tokens.long()].to(dtype)

    for li in range(model_cfg.num_layers):
        p = params[f"layer_{li}"]
        h = rms_norm(x, p["input_norm"]["scale"],
                     model_cfg.rms_eps).to(dtype)
        pa = p["attn"]
        q = h @ pa["q_proj"]["kernel"].to(dtype)
        k = h @ pa["k_proj"]["kernel"].to(dtype)
        v = h @ pa["v_proj"]["kernel"].to(dtype)
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
        x = x + y @ pa["o_proj"]["kernel"].to(dtype)

        h = rms_norm(x, p["post_attn_norm"]["scale"],
                     model_cfg.rms_eps).to(dtype)
        pm = p["mlp"]
        m = F.silu(h @ pm["gate_proj"]["kernel"].to(dtype)) \
            * (h @ pm["up_proj"]["kernel"].to(dtype))
        x = x + m @ pm["down_proj"]["kernel"].to(dtype)

    x = rms_norm(x, params["final_norm"]["scale"], model_cfg.rms_eps)
    last = torch.clamp(batch.n_tokens.long() - 1, min=0)
    x_last = x[torch.arange(S, device=dev), last]               # [S, M] fp32
    if model_cfg.tie_embeddings:
        w_out = params["embed"]["embedding"].T
    else:
        w_out = params["lm_head"]["kernel"]
    return x_last @ w_out.to(torch.float32)


class LlamaRaggedRunner(RaggedRunnerBase):
    """Runner plumbing comes from RaggedRunnerBase; ``step_fn`` is the
    dense Llama step above."""

    step_fn = staticmethod(_llama_ragged_step)
