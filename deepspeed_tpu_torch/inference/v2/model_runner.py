"""Ragged model runners — paged-KV forward passes over padded batches
(port of ``deepspeed_tpu/inference/v2/model_runner.py``).

One ``step`` does, per layer: KV append (one ``index_copy_`` into the
flat blocked pool, in place), attention over the paged context, MLP — then
keeps logits for each slot's last scheduled token only. Padded query
positions write into the trash row (the pool's last row), so they never
corrupt a live sequence's KV.

Token selection stays on the device: ``step_greedy`` takes the argmax,
``step_sample_fb`` the per-slot sampler (``_select_tokens``: temperature,
top-k, top-p and gumbel noise keyed by ``(seed, position)``, the JAX
package's function in plain PyTorch, as the JAX package computes it
outside any kernel). The ``_fb`` steps take each fed slot's input token
from the previous step's on-device token output (the pipelined serve
loop's feedback), so a steady decode needs no host round trip a token.

The decode loop is a Python loop of greedy or sampled steps that feeds
each step's tokens to the next on the device, with one host sync per
``n`` tokens. Given ``draft_toks`` it is speculative decoding's verify
pass instead: step t consumes the caller's ``draft_toks[:, t]``.
Over a bf16, fp16 or fp32 pool every step appends its K/V to the pool and
then attends: the JAX package's fused loop keeps its fresh K/V in a ring
buffer because TPU scatters are slow, and appending computes the same
attention over the same keys. Over an int8 pool the loop keeps the JAX
package's ring (``RingKV``): each step's K/V go into a compute-dtype ring,
attended unquantized after the settled pool, and the ring is quantized
into the pool once, when the loop ends. Appending would quantize the
loop's own tokens before they are attended, which is not what the JAX
package computes.

Runners: ``LlamaRaggedRunner`` (``llama_runner.py``),
:class:`GPT2RaggedRunner` (below), ``OPTRaggedRunner``
(``opt_runner.py``), ``BloomRaggedRunner`` / ``GPTNeoXRaggedRunner`` /
``GPTJRaggedRunner`` (``bloom_gptj_neox_runner.py``) and
``FalconRaggedRunner`` / ``PhiRaggedRunner`` (``falcon_phi_runner.py``),
picked by the engine from the model config.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

import torch.nn.functional as F

from ...models._dense import head
from ...models.gpt2 import GPT2Config
from ...ops.kernels.fp6_gemm import Fp6GemmWeight, fp6_matmul
from ..quantization import dequantize_leaf
from ...utils.random import PRNGKey, fold_in, gumbel
from .config import RaggedInferenceConfig
from .kv_quant import RingKV, pool_parts, quantize_rows
from .sampling import SAMPLE_CANDIDATES


# --------------------------------------------------------------------- #
# on-device per-slot token selection (sampling.py has the host half)
# --------------------------------------------------------------------- #


def _sample_keys(seeds: torch.Tensor, positions: torch.Tensor
                 ) -> torch.Tensor:
    """Per-slot threefry keys [S, 2], a pure function of (seed, absolute
    position of the token being selected): ``fold_in(PRNGKey(seed),
    position)``, bit for bit ``jax.random``'s."""
    return fold_in(PRNGKey(seeds), positions)


def _topk_by_index(logits: torch.Tensor, k: int):
    """``torch.topk`` with ``jax.lax.top_k``'s order: values descending,
    ties ranked by index. Each fp32 logit becomes an order-preserving
    int32 and joins its reversed index below it in one int64 key, so the
    keys are distinct and ``torch.topk`` over them has one answer."""
    V = logits.shape[-1]
    b = max(1, (V - 1).bit_length())
    bits = logits.to(torch.float32).contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    rev = (1 << b) - 1 - torch.arange(V, device=logits.device)
    _, idxs = torch.topk((ordered << b) | rev, k, dim=-1)
    return torch.gather(logits, -1, idxs), idxs


def _select_tokens(logits: torch.Tensor, keys: torch.Tensor,
                   temps: torch.Tensor, top_ks: torch.Tensor,
                   top_ps: torch.Tensor, *, cand: int) -> torch.Tensor:
    """Per-slot temperature / top-k / top-p categorical, [S, V] -> [S]
    int32 (JAX ``model_runner._select_tokens``). A slot at temperature
    <= 0 takes the argmax (first index on ties, as the greedy step).
    Otherwise, over the top-``cand`` logits in ``jax.lax.top_k``'s order:
    divide by the temperature, mask ranks >= top_k (0 = off), softmax,
    mask ranks whose mass before them reaches top_p (rank 0 always
    stays), add gumbel noise to the masked values, take the argmax."""
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    vals, idxs = _topk_by_index(logits, cand)
    x = (vals / torch.clamp(temps[:, None], min=1e-6)).to(torch.float32)
    ar = torch.arange(cand, device=logits.device)[None, :]
    x = x.masked_fill((top_ks[:, None] > 0) & (ar >= top_ks[:, None]),
                      float("-inf"))
    p = torch.softmax(x, dim=-1)
    mass_before = torch.cumsum(p, dim=-1) - p
    x = x.masked_fill(~(mass_before < top_ps[:, None]), float("-inf"))
    choice = torch.argmax(x + gumbel(keys, cand), dim=-1)
    samp = torch.gather(idxs, 1, choice[:, None])[:, 0]
    return torch.where(temps <= 0.0, greedy_tok, samp.to(torch.int32))


def _chosen_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """log p(tok) under the unmodified model distribution (the softmax
    of the full-width logits), [S] fp32."""
    lf = logits.to(torch.float32)
    picked = torch.gather(lf, 1, tok.long()[:, None])[:, 0]
    return picked - torch.logsumexp(lf, dim=-1)


def _feed_tokens(batch: "RaggedBatch", prev_tok, feed_mask, feed_idx
                 ) -> "RaggedBatch":
    """The batch with each fed slot's first token taken from
    ``prev_tok[feed_idx]`` (the previous step's on-device token output),
    the rest as staged. No host sync: a gather and a select."""
    fed = prev_tok[torch.clamp(feed_idx.long(), 0, prev_tok.shape[0] - 1)]
    tok0 = torch.where(feed_mask > 0, fed, batch.tokens[:, 0])
    tokens = torch.cat([tok0[:, None].to(batch.tokens.dtype),
                        batch.tokens[:, 1:]], dim=1)
    return batch._replace(tokens=tokens)


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
    """[S, max_context, KV, D] context gathered through the block tables.
    An int8 pool is dequantized per gathered row (the dense path only: the
    kernels scale scores and probabilities instead)."""
    data, scales = pool_parts(pool)
    bs = cfg.block_size
    j = torch.arange(cfg.max_context, device=data.device)
    ctx_idx = batch.block_tables.long()[:, j // bs] * bs + j % bs
    k_ctx = data[li, 0][ctx_idx].reshape(S, -1, KV, D)
    v_ctx = data[li, 1][ctx_idx].reshape(S, -1, KV, D)
    if scales is None:
        return k_ctx.to(dtype), v_ctx.to(dtype)
    ks = scales[li, 0].T[ctx_idx]                              # [S, T, KV]
    vs = scales[li, 1].T[ctx_idx]
    return ((k_ctx.float() * ks[..., None]).to(dtype),
            (v_ctx.float() * vs[..., None]).to(dtype))


def _grouped_dense_attention(q, k_ctx, v_ctx, mask, dist, scale, dtype,
                             alibi_slopes):
    """Masked grouped-GQA attention core of the dense paths. q [S, C, H,
    D]; k/v_ctx [S, T, KV, D]; mask/dist [S, C, T] (or [S, 1, T]
    broadcasting over C). KV stays at native width."""
    S, C, H, D = q.shape
    KV = k_ctx.shape[2]
    g = H // KV
    qg = q.reshape(S, C, KV, g, D)
    s_att = torch.einsum("sckgd,stkd->skgct", qg, k_ctx) * scale
    s_att = s_att.to(torch.float32)
    if alibi_slopes is not None:
        s_att = s_att - alibi_slopes.float().reshape(KV, g)[
            None, :, :, None, None] * dist[:, None, None]
    s_att = s_att.masked_fill(~mask[:, None, None], float("-inf"))
    p_att = torch.softmax(s_att, dim=-1).to(dtype)
    # fully-masked rows (idle slots) produce NaN softmax garbage that is
    # never read; keep numerics finite
    p_att = torch.nan_to_num(p_att, nan=0.0)
    return torch.einsum("skgct,stkd->sckgd", p_att, v_ctx).reshape(
        S, C, H * D)


def _dense_ring_attention(pool, ring, li, q, batch, cfg, settled_lens,
                          rcount, scale, dtype, alibi_slopes,
                          sliding_window):
    """Ring-mode attention on the dense path: the gathered settled context
    and the ring concatenate along the context axis, the settled part
    masked column-exactly at ``settled_lens``."""
    S, C, H, D = q.shape
    KV = ring.shape[4] // D
    T = cfg.max_context
    k_ctx, v_ctx = _gather_ctx(pool, li, batch, cfg, S, KV, D, dtype)
    R = ring.shape[0]
    ring_k = ring[:, li, 0].transpose(0, 1).reshape(S, R, KV, D)
    ring_v = ring[:, li, 1].transpose(0, 1).reshape(S, R, KV, D)
    k_full = torch.cat([k_ctx, ring_k.to(dtype)], dim=1)
    v_full = torch.cat([v_ctx, ring_v.to(dtype)], dim=1)
    # columns: [0, T) settled (valid below settled_lens), [T, T+R) ring
    # (valid below rcount); ring row r sits rcount-1-r behind the query
    jr = torch.arange(T + R, device=q.device)
    pool_col = jr[None, :] < T
    dist = torch.where(pool_col,
                       batch.start_pos.long()[:, None] - jr[None, :],
                       rcount - 1 - (jr[None, :] - T)).float()
    mask = torch.where(pool_col, jr[None, :] < settled_lens.long()[:, None],
                       (jr[None, :] - T) < rcount)
    if sliding_window is not None:
        mask = mask & (dist < sliding_window)
    return _grouped_dense_attention(q, k_full, v_full, mask[:, None],
                                    dist[:, None], scale, dtype,
                                    alibi_slopes)


def paged_attention(kv, li: int, q, k, v, batch: RaggedBatch,
                    cfg: RaggedInferenceConfig, pos, valid_q, scale: float,
                    dtype, alibi_slopes: Optional[torch.Tensor] = None,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """Append this step's K/V through the block tables (in place), then
    attend. q: [S, C, H, D]; k/v: [S, C, KV, D]. ``kv`` is the pool
    tensor, a :class:`KVPool` (int8 rows and scales: the step's K/V are
    quantized per (token, KV head) as they are written), or, inside the
    decode loop over an int8 pool, a :class:`RingKV`: the pool is then
    read-only and the step's K/V go into ring row ``t``, attended by the
    kernels' ring round. ``alibi_slopes`` [H] f32: ALiBi. Dispatches on
    ``cfg.attention_impl`` (``resolve_attention_impl``):

      "paged_flash" — the paged kernels (ops/kernels/paged_attention.py),
        reading only live blocks;
      "dense" — gather [S, max_context] context and mask.

    Returns y [S, C, H*D] in ``dtype``."""
    S, C, H, D = q.shape
    KV = k.shape[2]
    bs = cfg.block_size
    impl = resolve_attention_impl(cfg, q.device)
    if impl not in ("paged_flash", "dense"):
        raise ValueError(
            f"attention_impl must be 'auto', 'paged_flash' or 'dense', "
            f"got {cfg.attention_impl!r}")
    if isinstance(kv, RingKV):
        pool, ring, t, rcount = kv
        data, scales = pool_parts(pool)
        ring[t, li, 0] = k.reshape(S, KV * D).to(ring.dtype)
        ring[t, li, 1] = v.reshape(S, KV * D).to(ring.dtype)
        # the pool holds the settled tokens, the ring rows 0 .. t the rest
        seq_lens = torch.where(batch.n_tokens > 0, batch.start_pos - t,
                               torch.zeros_like(batch.start_pos))
        if impl == "dense":
            y = _dense_ring_attention(pool, ring, li, q, batch, cfg,
                                      seq_lens, rcount, scale, dtype,
                                      alibi_slopes, sliding_window)
            return y.reshape(S, C, H * D).to(dtype)
        ring_kw = dict(ring_k=ring[:, li, 0], ring_v=ring[:, li, 1],
                       ring_count=rcount)
    else:
        data, scales = pool_parts(kv)
        trash = data.shape[2] - 1
        tables = batch.block_tables.long()
        blk = torch.gather(tables, 1, torch.clamp(
            pos // bs, max=cfg.max_blocks_per_seq - 1))
        write_idx = torch.where(valid_q, blk * bs + pos % bs,
                                torch.full_like(blk, trash)).reshape(-1)
        for x, rows in ((0, k.reshape(S * C, KV * D)),
                        (1, v.reshape(S * C, KV * D))):
            if scales is None:
                data[li, x].index_copy_(0, write_idx, rows.to(data.dtype))
            else:
                codes, sc = quantize_rows(rows, KV)
                data[li, x].index_copy_(0, write_idx, codes)
                scales[li, x].index_copy_(1, write_idx, sc)
        if impl == "dense":
            k_ctx, v_ctx = _gather_ctx(kv, li, batch, cfg, S, KV, D, dtype)
            j = torch.arange(cfg.max_context, device=q.device)
            dist = (pos[:, :, None] - j[None, None, :]).float()  # [S, C, T]
            mask = dist >= 0
            if sliding_window is not None:
                mask = mask & (dist < sliding_window)
            return _grouped_dense_attention(q, k_ctx, v_ctx, mask, dist,
                                            scale, dtype, alibi_slopes)
        seq_lens = torch.where(batch.n_tokens > 0,
                               batch.start_pos + batch.n_tokens,
                               torch.zeros_like(batch.n_tokens))
        ring_kw = {}
    from ...ops.kernels import flash_paged_attention
    # q joins the pool's dtype so the kernel reads one dtype (fp32
    # accumulation inside); the pool itself is never cast or copied. Over
    # an int8 pool q stays in the compute dtype and the kernels scale
    # scores and probabilities by the scales.
    y = flash_paged_attention(
        q.to(data.dtype if scales is None else dtype).contiguous(),
        data[li, 0], data[li, 1], batch.block_tables, batch.start_pos,
        seq_lens, block_size=bs, sm_scale=scale,
        sliding_window=sliding_window, num_kv_heads=KV,
        alibi_slopes=alibi_slopes, scales_full=scales, pool_layer=li,
        **ring_kw)
    return y.reshape(S, C, H * D).to(dtype)


def woq_mm(h: torch.Tensor, w: Any, dtype, fused: bool = True
           ) -> torch.Tensor:
    """``h @ w`` with weight-only-quantized dispatch: with ``fused`` (the
    runner's ``supports_fused_woq``) an ``Fp6GemmWeight`` goes through the
    fused fp6 GEMM (h in its dtype); a ``QuantizedTensor`` or
    ``FPQuantizedTensor``, and an ``Fp6GemmWeight`` without ``fused``, is
    dequantized here, at its use, to f32 and cast to ``dtype``
    (``bf16(f32(v) * scale)``, as the JAX runner's dequantize-then-cast);
    a dense tensor is cast to ``dtype``. The JAX runner dequantizes the
    whole tree at the top of its jitted step and XLA fuses each dequant
    into its matmul; eagerly, a whole-tree f32 view of a 7B model would be
    27 GB a step."""
    if fused and isinstance(w, Fp6GemmWeight):
        return fp6_matmul(h, w)
    return h @ dequantize_leaf(w).to(dtype)


class RaggedRunnerBase:
    """Shared runner plumbing: the step, its greedy variant and the decode
    loop around a family's ``step_fn(params, pool, batch, *, model_cfg,
    cfg, dtype, fused_woq) -> logits [S, V] fp32``. Counts the steps it
    runs by kind (``step_counts``: C > 1 is prefill, C == 1 is decode).
    ``supports_fused_woq``: whether the family's matmuls take a packed fp6
    leaf through the fp6 GEMM (else it is dequantized at its use)."""

    step_fn = None
    supports_fused_woq = True

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
                                  dtype=self.compute_dtype,
                                  fused_woq=self.supports_fused_woq)

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
    def step_greedy_fb(self, params, pool, batch: RaggedBatch, prev_tok,
                       feed_mask, feed_idx) -> torch.Tensor:
        """Greedy step with device token feedback: slot i's input token
        is ``prev_tok[feed_idx[i]]`` where ``feed_mask[i]`` is set (the
        previous step's token output, still on the device), else
        ``batch.tokens[i, 0]``. Returns token ids [S] int32."""
        return self.step_greedy(params, pool, _feed_tokens(
            batch, prev_tok, feed_mask, feed_idx))

    @torch.inference_mode()
    def step_sample_fb(self, params, pool, batch: RaggedBatch, prev_tok,
                       feed_mask, feed_idx, seeds, spos, temps, top_ks,
                       top_ps):
        """The sampled sibling of :meth:`step_greedy_fb`: per-slot
        temperature / top-k / top-p selection with
        ``fold_in(PRNGKey(seeds[i]), spos[i])`` keys; slots at temperature
        0 take the argmax. Returns (token ids [S] int32, chosen-token
        logprobs [S] fp32); the tokens feed the next step."""
        logits = self._forward(params, pool, _feed_tokens(
            batch, prev_tok, feed_mask, feed_idx))
        cand = min(SAMPLE_CANDIDATES, logits.shape[-1])
        tok = _select_tokens(logits, _sample_keys(seeds, spos), temps,
                             top_ks, top_ps, cand=cand)
        return tok, _chosen_logprob(logits, tok)

    @torch.inference_mode()
    def decode_loop(self, params, pool, tok0, start_pos, active,
                    block_tables, n: int, *, seeds=None, temps=None,
                    top_ks=None, top_ps=None, eos_id: int = -1,
                    draft_toks=None):
        """Decode ``n`` tokens per active slot, feeding each step's
        tokens to the next on the device: greedy when ``temps`` is None,
        else the per-slot sampler (``seeds``, ``temps``, ``top_ks``,
        ``top_ps`` [S], keys from each slot's seed and the position of
        the token selected). tok0 [S] int32: each slot's next input token
        (KV not yet appended); start_pos [S]: its position; active [S]: 1
        live / 0 idle. ``eos_id`` >= 0 freezes a slot once it emits eos
        (it keeps emitting eos and stops appending KV). ``draft_toks``
        [S, n] int32 makes the loop speculative decoding's verify pass:
        step t consumes ``draft_toks[:, t]`` instead of the previous
        step's output (column 0 is each slot's last committed token), so
        the tokens are the model's choice after every draft prefix. Slots
        must hold KV blocks for start_pos .. start_pos + n - 1. Over an
        int8 pool (a
        KVPool) the steps' K/V ride a compute-dtype ring [n, L, 2, S,
        KV*D], flushed into the pool at the end (module docstring).
        Returns (tokens [S, n] int32, chosen-token logprobs [S, n] fp32 or
        None when greedy, consumed [S] int32 or None — KV positions each
        slot appended, None when EOS is off), on the device: the caller's
        readback is the loop's one host sync."""
        _, scales = pool_parts(pool)
        ring = None
        if scales is not None:
            ring = torch.zeros(
                (n, self.num_layers, 2, tok0.shape[0],
                 self.kv_heads * self.head_dim), dtype=self.compute_dtype,
                device=tok0.device)
        tok, pos = tok0, start_pos
        done = torch.zeros_like(active, dtype=torch.bool)
        use_eos = eos_id >= 0
        sample = temps is not None
        cand = min(SAMPLE_CANDIDATES, self.model_cfg.vocab_size)
        out, lps = [], []
        for t in range(n):
            if draft_toks is not None:
                tok = draft_toks[:, t]
            alive = active * (~done).to(active.dtype) if use_eos else active
            batch = RaggedBatch(tokens=tok[:, None], start_pos=pos,
                                n_tokens=alive, block_tables=block_tables)
            kv = pool if ring is None else RingKV(pool, ring, t, t + 1)
            logits = self._forward(params, kv, batch)
            if sample:
                # the key of the token that will sit at position pos + 1
                nxt = _select_tokens(logits, _sample_keys(seeds, pos + 1),
                                     temps, top_ks, top_ps, cand=cand)
                lps.append(_chosen_logprob(logits, nxt))
            else:
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if use_eos:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                pos = pos + (~done).to(pos.dtype)
                done = done | (nxt == eos_id)
            else:
                pos = pos + 1
            out.append(nxt)
            tok = nxt
        if ring is not None:
            self._flush_ring(pool, ring, block_tables, start_pos, active)
        toks = torch.stack(out, dim=1)
        return (toks, torch.stack(lps, dim=1) if sample else None,
                pos - start_pos if use_eos else None)

    def _flush_ring(self, pool, ring, block_tables, start0, active) -> None:
        """Quantize the loop's ring rows once and write them into the
        int8 pool and its scales, in place: ring row r of an active slot
        goes to position ``start0 + r`` through its block table (every
        row, also those an EOS-frozen slot wrote after it froze, as the
        JAX package's flush does: they lie past the slot's consumed
        positions and are overwritten before they are read); idle slots'
        rows go to the trash row."""
        data, scales = pool_parts(pool)
        R, L, _, S, KVD = ring.shape
        bs = self.cfg.block_size
        pos = start0.long()[:, None] + torch.arange(R, device=ring.device)
        blk = torch.gather(block_tables.long(), 1, torch.clamp(
            pos // bs, max=block_tables.shape[1] - 1))
        idx = torch.where(active[:, None] > 0, blk * bs + pos % bs,
                          torch.full_like(blk, data.shape[2] - 1))
        idx = idx.reshape(-1)
        # a layer at a time: the fp32 temporaries of the quantizer stay
        # 1/L of the ring's
        for li in range(L):
            rows = ring[:, li].permute(1, 2, 0, 3).reshape(2 * S * R, KVD)
            codes, sc = quantize_rows(rows, self.kv_heads)  # sc [KV, rows]
            data[li].index_copy_(1, idx, codes.reshape(2, S * R, KVD))
            scales[li].index_copy_(2, idx, sc.reshape(
                self.kv_heads, 2, S * R).transpose(0, 1))


# --------------------------------------------------------------------- #
# GPT-2
# --------------------------------------------------------------------- #


def _layer_norm(x: torch.Tensor, p, eps: float,
                dtype=torch.float32) -> torch.Tensor:
    """LayerNorm of ``x`` over its last dim in fp32 (the JAX runners'
    ``_layer_norm`` of ``x.astype(f32)``: the mean, the biased variance,
    rsqrt), the result cast to ``dtype``."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * p["scale"].float()
            + p["bias"].float()).to(dtype)


def _linear(h, p, dtype, fused: bool = False):
    """A flax ``{kernel[, bias]}`` node applied in ``dtype`` (the JAX
    runners' ``_linear``): the product through :func:`woq_mm` (a packed
    leaf dequantized at its use unless ``fused``), then the bias."""
    y = woq_mm(h, p["kernel"], dtype, fused)
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


def step_positions(batch: RaggedBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos [S, C] int64, valid_q [S, C] bool): each scheduled token's
    absolute position, and whether it is one of the slot's live tokens."""
    C = batch.tokens.shape[1]
    cols = torch.arange(C, device=batch.tokens.device)
    pos = batch.start_pos.long()[:, None] + cols[None, :]
    return pos, cols[None, :] < batch.n_tokens.long()[:, None]


def last_token(x: torch.Tensor, batch: RaggedBatch) -> torch.Tensor:
    """Each slot's row of its last scheduled token, x [S, C, M] -> [S, M]."""
    last = torch.clamp(batch.n_tokens.long() - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), last]


def head_logits(x_last: torch.Tensor, params, head_key: str,
                tied_key: str) -> torch.Tensor:
    """fp32 logits [S, V] of the last tokens' rows (``models._dense.head``),
    a packed leaf dequantized here."""
    return head(x_last, params, tied_key, head_key, leaf=dequantize_leaf)


def _gpt2_ragged_step(params, pool, batch: RaggedBatch, *,
                      model_cfg: GPT2Config, cfg: RaggedInferenceConfig,
                      dtype, fused_woq: bool = False) -> torch.Tensor:
    """One ragged step of GPT-2 (the JAX package's ``_gpt2_ragged_step``):
    token and position embeddings (positions clamped to ``max_seq_len -
    1``), per layer LayerNorm in fp32, the fused ``c_attn`` split q|k|v,
    paged attention, ``c_proj``, LayerNorm, the MLP with tanh GELU; the
    final LayerNorm in fp32 and the tied head ``x_last @ wte.T`` in
    fp32. Returns last-token logits [S, V] fp32."""
    S, C = batch.tokens.shape
    H = model_cfg.num_heads
    D = model_cfg.hidden_size // H
    scale = 1.0 / (D ** 0.5)
    eps = model_cfg.layer_norm_eps

    pos, valid_q = step_positions(batch)
    pos_c = torch.clamp(pos, max=model_cfg.max_seq_len - 1)

    wte = dequantize_leaf(params["wte"]["embedding"])
    wpe = dequantize_leaf(params["wpe"]["embedding"])
    # the sum in fp32: the JAX runner adds the (fp32) embedding rows
    x = (wte[batch.tokens.long()].float() + wpe[pos_c].float()).to(dtype)

    for li in range(model_cfg.num_layers):
        p = params[f"h_{li}"]
        h = _layer_norm(x, p["ln_1"], eps, dtype)
        qkv = _linear(h, p["attn"]["c_attn"], dtype, fused_woq)
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        y = paged_attention(pool, li, q.reshape(S, C, H, D),
                            k.reshape(S, C, H, D), v.reshape(S, C, H, D),
                            batch, cfg, pos, valid_q, scale, dtype)
        x = x + _linear(y, p["attn"]["c_proj"], dtype, fused_woq)

        h = _layer_norm(x, p["ln_2"], eps, dtype)
        m = F.gelu(_linear(h, p["mlp"]["c_fc"], dtype, fused_woq),
                   approximate="tanh")
        x = x + _linear(m, p["mlp"]["c_proj"], dtype, fused_woq)

    x = _layer_norm(x, params["ln_f"], eps)
    return last_token(x, batch) @ wte.T.float()


class GPT2RaggedRunner(RaggedRunnerBase):
    """Paged-KV prefill and decode over the GPT-2 tree
    (``checkpoint/jax_params.py``: wte / wpe / h_i / ln_f). Its matmuls
    dequantize a packed leaf at its use, fp6 too (``supports_fused_woq``
    False, as the JAX runner's ``dequantize_tree(keep_fused=False)``)."""

    supports_fused_woq = False
    step_fn = staticmethod(_gpt2_ragged_step)
