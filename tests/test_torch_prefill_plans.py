"""The wgmma K1's launch geometry on the CPU: its deal of work items
(``paged_attention.prefill_plan``), its route choice
(``paged_attention.prefill_route``), and a plain emulation of its order of
work against ``paged_attention_plain`` and the JAX package's Pallas K1 in
interpret mode.

The plan and the route come from shapes alone, so every (slot, head,
query tile) item, the balance of the persistent blocks and the kernel
each served shape reaches are checked here before a card runs them. The
emulation walks each item as ``paged_prefill_wgmma_kernel`` does: the
union of its rows' live ranges (the first row's lo, the last live row's
hi), 128-key tiles from a multiple of 128, the mask only on tiles that
cross a row's range, an online softmax per 128-key tile, the table read
only for keys inside the item's range. fp32 throughout: the tolerance
(1e-5) covers summation order only."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels import paged_attention as jax_pa
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.ops.kernels import paged_attention as pa

H100_SMS = 132
TOL = dict(rtol=1e-5, atol=1e-5)

# (slots, chunk, query heads, table capacity in keys) as chip_smoke.py
# serves them: TinyLlama's second prefill chunk (phase 5) and Llama-2-7B's
# prefill step (phase 17)
SERVED = {"tinyllama_1b": (16, 256, 32, 16 * 64),
          "llama2_7b": (64, 512, 32, 640)}


def _check_plan(S, C, H, cap, sms=H100_SMS):
    plan = pa.prefill_plan(S, C, H, cap, sms)
    nqt = -(-C // pa.PREFILL_ROWS)
    assert plan.items == nqt * S * H
    assert plan.grid == min(plan.items, sms) == len(plan.blocks)
    seen = {}
    for blk, items in enumerate(plan.blocks):
        for s, h, qt, tiles in items:
            assert (s, h, qt) not in seen, (S, C, H, s, h, qt)
            seen[(s, h, qt)] = blk
            assert 0 <= s < S and 0 <= h < H and 0 <= qt < nqt
            assert tiles == pa.prefill_worst_tiles(qt, C, cap)
    assert len(seen) == plan.items
    return plan


@pytest.mark.parametrize("S,C,H,cap", [
    (1, 64, 1, 64), (4, 100, 8, 1024), (3, 130, 4, 640), (2, 1000, 2, 4096),
    (16, 256, 32, 1024), (64, 512, 32, 640), (200, 64, 2, 64), (5, 257, 3, 300),
])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_prefill_plan_deals_every_item_once(S, C, H, cap, sms):
    _check_plan(S, C, H, cap, sms)


@pytest.mark.parametrize("name", sorted(SERVED))
def test_prefill_plan_keeps_a_heads_tiles_together_and_balances(name):
    """A (slot, head)'s query tiles are neighbouring items, last (the most
    keys when a slot is full) first, and the heads of a slot follow in
    order, so the blocks at work at one time share K/V; the alternating
    deal keeps the busiest block within 5% of the mean key tiles a
    block."""
    S, C, H, cap = SERVED[name]
    plan = _check_plan(S, C, H, cap)
    nqt = -(-C // pa.PREFILL_ROWS)
    order = [pa.prefill_item(i, S, C, H) for i in range(plan.items)]
    for i in range(0, plan.items, nqt):
        group = order[i:i + nqt]
        assert {(s, h) for s, h, _ in group} == {group[0][:2]}
        assert [qt for *_, qt in group] == list(range(nqt - 1, -1, -1))
    assert [order[i * nqt][:2] for i in range(H + 1)] \
        == [(0, h) for h in range(H)] + [(1, 0)]
    load = [sum(t for *_, t in b) for b in plan.blocks]
    assert max(load) <= 1.05 * (sum(load) / len(load)), (max(load), load)


def test_prefill_plan_depends_on_shapes_alone():
    """Integers in, the same plan out: nothing is read from the card."""
    params = inspect.signature(pa.prefill_plan.__wrapped__).parameters
    assert list(params) == ["S", "C", "H", "cap", "sms"]
    assert pa.prefill_plan(16, 256, 32, 1024, 132) \
        == pa.prefill_plan.__wrapped__(16, 256, 32, 1024, 132)
    with pytest.raises(ValueError):
        pa.prefill_plan(0, 256, 32, 1024, 132)


@pytest.mark.parametrize("C", [1, 16, 63, 64, 100, 256, 512])
@pytest.mark.parametrize("D", pa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("bs", [16, 64, 100, 640])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_route_is_a_function_of_the_shapes(C, D, bs, dtype):
    route = pa.prefill_route(C, D, dtype, bs)
    assert route in pa.PREFILL_ROUTES
    if dtype == torch.float32:
        assert route == "f32"
    elif D in (64, 128) and C >= 64:
        assert route == ("wgmma_tma" if bs % 64 == 0 else "wgmma_gather")
    else:
        assert route == "mma"


def _phi3_width():
    return LlamaConfig(vocab_size=32064, hidden_size=3072, num_heads=32,
                       num_kv_heads=32, intermediate_size=8192,
                       num_layers=2)


@pytest.mark.parametrize("cfg", [LlamaConfig.tiny(),
                                 LlamaConfig.tinyllama_1b(),
                                 LlamaConfig.llama2_7b(), _phi3_width()],
                         ids=["tiny", "tinyllama_1b", "llama2_7b", "phi3"])
@pytest.mark.parametrize("C", [1, 40, 64, 100, 256, 512])
@pytest.mark.parametrize("bs", [16, 64, 640])
def test_served_configs_reach_a_prefill_kernel(cfg, C, bs):
    """Every served head dim, any chunk and block size: bf16 reaches the
    wgmma kernel only at head dims 64 and 128, and the mma.sync kernel
    takes the rest (D 16, 32, 80, 96 and small chunks), so no shape that
    reached K1 before raises now."""
    D = cfg.head_dim
    pa.check_kernel_shape(cfg.num_heads, cfg.num_kv_heads, D, torch.bfloat16)
    route = pa.prefill_route(C, D, torch.bfloat16, bs)
    if route.startswith("wgmma"):
        assert D in pa.WGMMA_PREFILL_HEAD_DIMS and C >= 64
        assert pa.prefill_plan(4, C, cfg.num_heads, 8 * bs, H100_SMS).grid
    else:
        assert route == "mma" and D in pa.KERNEL_HEAD_DIMS


def _live_range(c, C, start, seq_len, window):
    if c >= C:
        return 0, 0
    pos = start + c
    hi = max(0, min(seq_len, pos + 1))
    lo = min(max(0, pos - window + 1), hi) if window else 0
    return lo, hi


def _emulate(q, kp, vp, tables, start, lens, *, bs, scale, window, KV,
             reads):
    """paged_prefill_wgmma_kernel's order of work in fp32: per item its
    rows' range union, 128-key tiles, per-tile online softmax, P cast to
    the pool dtype before P.V; ``reads`` collects the table
    entries the loads touch."""
    S, C, H, D = q.shape
    g = H // KV
    maxb = tables.shape[1]
    cap = maxb * bs
    out = torch.zeros(S, C, H, D)
    R, K = pa.PREFILL_ROWS, pa.PREFILL_KEYS
    for item in range(-(-C // R) * S * H):
        s, h, qt = pa.prefill_item(item, S, C, H)
        q0 = qt * R
        seq_len = min(int(lens[s]), cap)
        st = int(start[s])
        lo, _ = _live_range(q0, C, st, seq_len, window)
        _, hi = _live_range(min(C, q0 + R) - 1, C, st, seq_len, window)
        if hi <= lo:
            continue
        tbeg = lo // K * K
        rows = range(q0, min(C, q0 + R))
        rng = [_live_range(c, C, st, seq_len, window) for c in rows]
        m = torch.full((len(rng),), float("-inf"))
        l = torch.zeros(len(rng))
        acc = torch.zeros(len(rng), D)
        kvh = h // g
        for t0 in range(tbeg, hi, K):
            keys = torch.arange(t0, t0 + K)
            live = (keys >= lo) & (keys < hi)
            blk = torch.zeros(K, dtype=torch.long)
            for j in keys[live].tolist():
                reads.add((s, j // bs))
                blk[j - t0] = int(tables[s, j // bs]) * bs + j % bs
            kt = torch.where(live[:, None],
                             kp[blk].reshape(K, KV, D)[:, kvh].float(), 0.)
            vt = torch.where(live[:, None],
                             vp[blk].reshape(K, KV, D)[:, kvh].float(), 0.)
            sc = q[s, q0:q0 + len(rng), h].float() @ kt.T * scale
            mask = torch.tensor([[a <= j < b for j in keys.tolist()]
                                 for a, b in rng])
            sc = sc.masked_fill(~mask, float("-inf"))
            m_new = torch.maximum(m, sc.amax(1))
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.exp(sc - m_safe[:, None])
            alpha = torch.exp(m - m_safe)
            l = l * alpha + p.sum(1)
            acc = acc * alpha[:, None] + p.to(vp.dtype).float() @ vt
            m = m_new
        o = acc / torch.where(l == 0, torch.ones_like(l), l)[:, None]
        out[s, q0:q0 + len(rng), h] = o
    return out


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("bs", [16, 64])
def test_wgmma_order_of_work_matches_plain_and_pallas(window, bs):
    """Ragged chunk (C = 150: a query tile of 22 rows past 128), start
    positions inside a block, an idle slot, a window whose edge falls
    inside a tile, GQA 2: the emulation equals the plain version and the
    Pallas K1 in interpret mode, and reads no table entry past a slot's
    live blocks (nor, with a window, before its earliest row's window)."""
    rng = np.random.default_rng(bs + (window or 0))
    S, C, H, KV, D, maxb = 3, 150, 4, 2, 16, 32
    lens = np.array([150 + 70, 0, 300], np.int32)
    start = np.array([70, 0, 150], np.int32)
    nb = S * maxb
    slots = (nb + 1) * bs
    kp = rng.standard_normal((slots, KV * D)).astype(np.float32)
    vp = rng.standard_normal((slots, KV * D)).astype(np.float32)
    tables = rng.permutation(nb).astype(np.int32).reshape(S, maxb)
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=window,
              num_kv_heads=KV)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, start, lens)]
    reads = set()
    got = _emulate(*t, bs=bs, scale=D ** -0.5, window=window, KV=KV,
                   reads=reads)
    ref = pa.paged_attention_plain(*t, **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    assert not got[1].any(), "idle slot must emit zeros"
    for s, b in reads:
        assert b < -(-int(lens[s]) // bs), (s, b)
        if window:
            first = int(start[s]) - window + 1
            assert (b + 1) * bs > first, (s, b)
    pallas = jax_pa.flash_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(start), jnp.asarray(lens),
        block_size=bs, sm_scale=D ** -0.5, sliding_window=window,
        num_kv_heads=KV, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
