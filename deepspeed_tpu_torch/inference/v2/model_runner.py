"""Ragged model runners — paged-KV forward passes over padded batches
(port of ``deepspeed_tpu/inference/v2/model_runner.py``).

One ``step`` does, per layer: KV append (one ``index_copy_`` into the
flat blocked pool, in place), attention over the paged context, MLP — then
keeps logits for each slot's last scheduled token only. Padded query
positions write into the trash row (the pool's last row), so they never
corrupt a live sequence's KV.

The decode loop is a Python loop of greedy steps that feeds each step's
tokens to the next on the device, with one host sync per ``n`` tokens.
The JAX package keeps fresh K/V in a ring buffer inside its fused loop
because TPU scatters are slow; here every step appends to the pool and
then attends, which is the same attention over the same keys.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ...ops.kernels.fp6_gemm import Fp6GemmWeight, fp6_matmul
from ..quantization import dequantize_leaf
from .config import RaggedInferenceConfig


class RaggedBatch(NamedTuple):
    """Device-side view of one scheduled step."""
    tokens: torch.Tensor        # [S, C] int32 (padded with 0)
    start_pos: torch.Tensor     # [S] int32 — absolute pos of tokens[s, 0]
    n_tokens: torch.Tensor      # [S] int32 — valid tokens this step (0 = idle)
    block_tables: torch.Tensor  # [S, MAXB] int32 (padded with 0)


def resolve_attention_impl(cfg: RaggedInferenceConfig,
                           device: torch.device) -> str:
    """``"auto"``: the paged kernels on a card, dense gather on the CPU."""
    impl = cfg.attention_impl
    if impl == "auto":
        return "paged_flash" if device.type == "cuda" else "dense"
    return impl


def _gather_ctx(pool, li, batch, cfg, S, KV, D, dtype):
    """[S, max_context, KV, D] context gathered through the block tables."""
    bs = cfg.block_size
    j = torch.arange(cfg.max_context, device=pool.device)
    ctx_idx = batch.block_tables.long()[:, j // bs] * bs + j % bs
    k_ctx = pool[li, 0][ctx_idx].reshape(S, -1, KV, D)
    v_ctx = pool[li, 1][ctx_idx].reshape(S, -1, KV, D)
    return k_ctx.to(dtype), v_ctx.to(dtype)


def _grouped_dense_attention(q, k_ctx, v_ctx, mask, scale, dtype):
    """Masked grouped-GQA attention core of the dense path. q [S, C, H, D];
    k/v_ctx [S, T, KV, D]; mask [S, C, T]. KV stays at native width."""
    S, C, H, D = q.shape
    KV = k_ctx.shape[2]
    g = H // KV
    qg = q.reshape(S, C, KV, g, D)
    s_att = torch.einsum("sckgd,stkd->skgct", qg, k_ctx) * scale
    s_att = s_att.to(torch.float32)
    s_att = s_att.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    p_att = torch.softmax(s_att, dim=-1).to(dtype)
    # fully-masked rows (idle slots) produce NaN softmax garbage that is
    # never read; keep numerics finite
    p_att = torch.nan_to_num(p_att, nan=0.0)
    return torch.einsum("skgct,stkd->sckgd", p_att, v_ctx).reshape(
        S, C, H * D)


def paged_attention(pool: torch.Tensor, li: int, q, k, v,
                    batch: RaggedBatch, cfg: RaggedInferenceConfig, pos,
                    valid_q, scale: float, dtype,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """Append this step's K/V through the block tables (in place), then
    attend. q: [S, C, H, D]; k/v: [S, C, KV, D]. Dispatches on
    ``cfg.attention_impl`` (``resolve_attention_impl``):

      "paged_flash" — the paged kernels (ops/kernels/paged_attention.py),
        reading only live blocks;
      "dense" — gather [S, max_context] context and mask.

    Returns y [S, C, H*D] in ``dtype``."""
    S, C, H, D = q.shape
    KV = k.shape[2]
    bs = cfg.block_size
    trash = pool.shape[2] - 1
    tables = batch.block_tables.long()
    blk = torch.gather(
        tables, 1, torch.clamp(pos // bs, max=cfg.max_blocks_per_seq - 1))
    write_idx = torch.where(valid_q, blk * bs + pos % bs,
                            torch.full_like(blk, trash)).reshape(-1)
    pool[li, 0].index_copy_(0, write_idx,
                            k.reshape(S * C, KV * D).to(pool.dtype))
    pool[li, 1].index_copy_(0, write_idx,
                            v.reshape(S * C, KV * D).to(pool.dtype))

    impl = resolve_attention_impl(cfg, pool.device)
    if impl == "paged_flash":
        from ...ops.kernels import flash_paged_attention
        seq_lens = torch.where(batch.n_tokens > 0,
                               batch.start_pos + batch.n_tokens,
                               torch.zeros_like(batch.n_tokens))
        # q joins the pool's dtype so the kernel reads one dtype (fp32
        # accumulation inside); the pool itself is never cast or copied
        y = flash_paged_attention(
            q.to(pool.dtype).contiguous(), pool[li, 0], pool[li, 1],
            batch.block_tables, batch.start_pos, seq_lens,
            block_size=bs, sm_scale=scale, sliding_window=sliding_window,
            num_kv_heads=KV)
        return y.reshape(S, C, H * D).to(dtype)
    if impl != "dense":
        raise ValueError(
            f"attention_impl must be 'auto', 'paged_flash' or 'dense', "
            f"got {cfg.attention_impl!r}")
    k_ctx, v_ctx = _gather_ctx(pool, li, batch, cfg, S, KV, D, dtype)
    j = torch.arange(cfg.max_context, device=pool.device)
    mask = j[None, None, :] <= pos[:, :, None]               # [S, C, T]
    if sliding_window is not None:
        mask = mask & ((pos[:, :, None] - j[None, None, :]) < sliding_window)
    return _grouped_dense_attention(q, k_ctx, v_ctx, mask, scale, dtype)


def woq_mm(h: torch.Tensor, w: Any, dtype) -> torch.Tensor:
    """``h @ w`` with weight-only-quantized dispatch: an
    ``Fp6GemmWeight`` goes through the fused fp6 GEMM (h in its dtype); a
    ``QuantizedTensor`` or ``FPQuantizedTensor`` is dequantized here, at
    its use, to f32 and cast to ``dtype`` (``bf16(f32(v) * scale)``, as
    the JAX runner's dequantize-then-cast); a dense tensor is cast to
    ``dtype``. The JAX runner dequantizes the whole tree at the top of its
    jitted step and XLA fuses each dequant into its matmul; eagerly, a
    whole-tree f32 view of a 7B model would be 27 GB a step."""
    if isinstance(w, Fp6GemmWeight):
        return fp6_matmul(h, w)
    return h @ dequantize_leaf(w).to(dtype)


class RaggedRunnerBase:
    """Shared runner plumbing: the step, its greedy variant and the decode
    loop around a family's ``step_fn(params, pool, batch, *, model_cfg,
    cfg, dtype) -> logits [S, V] fp32``. Counts the steps it runs by kind
    (``step_counts``: C > 1 is prefill, C == 1 is decode)."""

    step_fn = None

    def __init__(self, model_cfg: Any, cfg: RaggedInferenceConfig,
                 compute_dtype: Any = None):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.compute_dtype = compute_dtype or model_cfg.dtype
        self.num_layers = model_cfg.num_layers
        self.kv_heads = getattr(model_cfg, "num_kv_heads",
                                model_cfg.num_heads)
        self.head_dim = getattr(
            model_cfg, "head_dim",
            model_cfg.hidden_size // model_cfg.num_heads)
        self.step_counts = {"prefill": 0, "decode": 0}

    def _forward(self, params, pool, batch: RaggedBatch) -> torch.Tensor:
        kind = "decode" if batch.tokens.shape[1] == 1 else "prefill"
        self.step_counts[kind] += 1
        return type(self).step_fn(params, pool, batch,
                                  model_cfg=self.model_cfg, cfg=self.cfg,
                                  dtype=self.compute_dtype)

    @torch.inference_mode()
    def step(self, params, pool, batch: RaggedBatch) -> torch.Tensor:
        """Last-token logits [S, V] fp32; the pool is updated in place."""
        return self._forward(params, pool, batch)

    @torch.inference_mode()
    def step_greedy(self, params, pool, batch: RaggedBatch) -> torch.Tensor:
        """Argmax token ids [S] int32 (first index on ties)."""
        logits = self._forward(params, pool, batch)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    @torch.inference_mode()
    def decode_loop(self, params, pool, tok0, start_pos, active,
                    block_tables, n: int, *, eos_id: int = -1):
        """Greedy-decode ``n`` tokens per active slot, feeding each step's
        tokens to the next on the device. tok0 [S] int32: each slot's next
        input token (KV not yet appended); start_pos [S]: its position;
        active [S]: 1 live / 0 idle. ``eos_id`` >= 0 freezes a slot once
        it emits eos (it keeps emitting eos and stops appending KV).
        Slots must hold KV blocks for start_pos .. start_pos + n - 1.
        Returns (tokens [S, n] int32, consumed [S] int32 or None — KV
        positions each slot appended, None when EOS is off), on the
        device: the caller's readback is the loop's one host sync."""
        tok, pos = tok0, start_pos
        done = torch.zeros_like(active, dtype=torch.bool)
        use_eos = eos_id >= 0
        out = []
        for _ in range(n):
            alive = active * (~done).to(active.dtype) if use_eos else active
            batch = RaggedBatch(tokens=tok[:, None], start_pos=pos,
                                n_tokens=alive, block_tables=block_tables)
            nxt = torch.argmax(self._forward(params, pool, batch),
                               dim=-1).to(torch.int32)
            if use_eos:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                pos = pos + (~done).to(pos.dtype)
                done = done | (nxt == eos_id)
            else:
                pos = pos + 1
            out.append(nxt)
            tok = nxt
        toks = torch.stack(out, dim=1)
        return toks, (pos - start_pos if use_eos else None)
