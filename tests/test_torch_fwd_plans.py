"""The launch geometry of the two forward kernels redesigned for Hopper, on
the CPU: the fused-xent forward's plan (``fused_xent.fwd_plan``) with a
plain emulation of its split partials and their merge, and the wgmma
flash forward's block schedule (``flash_attention.fwd_schedule``) and
its TMA stride check.

The plans come from shapes alone, so the coverage of every vocabulary
tile and every (batch, head, query tile) is checked here before a card
runs them. The emulation walks the vocabulary in the kernel's 256-row
tiles over the plan's contiguous split ranges, keeps each split's running
(max, sum, target logit, logit sum) as the kernel's consumers do (E's
rows past V zero, as TMA fills them), and merges the splits in split order
as ``xent_combine_kernel`` does; it must equal ``fused_xent_fwd_plain`` and
the JAX package's Pallas ``_fwd`` in interpret mode. fp32 throughout: the
tolerance (1e-5) covers summation order only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels import fused_xent as jax_fx
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels import fused_xent as fx

H100_SMS = 132
TOL = dict(rtol=1e-5, atol=1e-5)


def _split_ranges(V, splits):
    """The vocabulary tiles [jt0, jt1) of each split, as the kernel
    computes them from its blockIdx.y."""
    nvt = -(-V // fx.FWD_VOCAB)
    return [(sp * nvt // splits, (sp + 1) * nvt // splits)
            for sp in range(splits)]


def _check_fwd_plan(N, V, C, sms=H100_SMS):
    splits = fx.fwd_plan(N, V, C, sms)
    nvt = -(-V // fx.FWD_VOCAB)
    assert 1 <= splits <= min(nvt, 65535)
    covered = np.zeros(nvt, np.int32)
    for jt0, jt1 in _split_ranges(V, splits):
        assert jt0 < jt1, (N, V, C, splits)      # no empty split
        covered[jt0:jt1] += 1
    assert (covered == 1).all()
    return splits


def _tiny_tokens():
    cfg = GPT2Config.tiny()
    return 2 * cfg.max_seq_len, cfg.vocab_size, cfg.hidden_size


def _xl_tokens():
    cfg = GPT2Config.xl_1p3b()
    return 4 * cfg.max_seq_len, cfg.vocab_size, cfg.hidden_size


# (N, V, C) as the port's training paths and chip_smoke.py give them
SERVED = {
    "gpt1p3b_step": (2 * 2048, 50304, 2048),     # phase 11's micro batch
    "xent_timing": (4096, 50304, 2048),          # phase 13
    "xl_1p3b": _xl_tokens(),                     # phase 7, V = 50257
    "tiny": _tiny_tokens(),
    "llama_vocab": (4096, 32000, 4096),
    "parity_ragged": (1000, 50257, 768),
}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_fwd_plan_at_the_served_shapes(name):
    N, V, C = SERVED[name]
    splits = _check_fwd_plan(N, V, C)
    if name in ("gpt1p3b_step", "xent_timing"):
        # 32 token tiles, 4 splits: one wave of 128 blocks
        assert splits == 4


@pytest.mark.parametrize("N", [1, 127, 128, 129, 1000, 4097, 16384])
@pytest.mark.parametrize("V", [1, 255, 256, 257, 32000, 50257, 50304])
def test_fwd_plan_covers_every_vocab_tile(N, V):
    _check_fwd_plan(N, V, 64)


def test_fwd_plan_fills_the_card_and_refuses_bad_shapes():
    # one token tile: the vocabulary spreads over one wave of blocks
    splits = fx.fwd_plan(128, 50304, 2048, H100_SMS)
    assert 64 < splits <= H100_SMS
    # 512 token tiles fill about four waves on their own: few splits
    assert fx.fwd_plan(65536, 50304, 2048, H100_SMS) <= 16
    for bad in ((0, 10, 64), (10, 0, 64), (10, 10, 96), (10, 10, 0)):
        with pytest.raises(ValueError):
            fx.fwd_plan(*bad, H100_SMS)


def _emulate_fwd(h, e, t, splits):
    """The forward kernel's arithmetic in plain PyTorch: per split, 256-row
    vocabulary tiles in order, each folded into a running (m, l, g, s);
    then the splits merged in split order."""
    N, C = h.shape
    V = e.shape[0]
    nvt = -(-V // fx.FWD_VOCAB)
    ep = torch.zeros(nvt * fx.FWD_VOCAB, C, dtype=e.dtype)
    ep[:V] = e                                  # TMA's zero rows past V
    tl = t.long()
    parts = []
    for jt0, jt1 in _split_ranges(V, splits):
        m = torch.full((N,), float("-inf"))
        l, g, s = torch.zeros(N), torch.zeros(N), torch.zeros(N)
        for j in range(jt0, jt1):
            cols = j * fx.FWD_VOCAB + torch.arange(fx.FWD_VOCAB)
            x = h.float() @ ep[cols].float().t()
            g = g + torch.where(cols[None] == tl[:, None], x, 0.0).sum(1)
            s = s + x.sum(1)                    # zero logits past V
            xm = torch.where(cols[None] < V, x, float("-inf"))
            m_new = torch.maximum(m, xm.amax(1))
            m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
            l = l * torch.exp(m - m_safe) + torch.exp(
                xm - m_safe[:, None]).sum(1)
            m = m_new
        parts.append((m, l, g, s))
    mx = torch.stack([p[0] for p in parts]).amax(0)
    m_safe = torch.where(mx == float("-inf"), 0.0, mx)
    lsum = torch.zeros(N)
    g_all = torch.zeros(N)
    s_all = torch.zeros(N)
    for m, l, g, s in parts:
        lsum = lsum + l * torch.exp(m - m_safe)
        g_all = g_all + g
        s_all = s_all + s
    return mx + torch.log(lsum.clamp_min(1e-37)), g_all, s_all


@pytest.mark.parametrize("N,V,C", [(37, 1000, 64), (130, 300, 128),
                                   (5, 1537, 64)])
@pytest.mark.parametrize("splits", [1, 2, "plan", "all"])
def test_split_merge_emulation_matches_plain_and_pallas(N, V, C, splits):
    """Ragged V (the last tile holds columns past V), targets in the padded
    tile, beyond it and negative: the emulated partials merged in split
    order equal the plain version and the Pallas forward (interpret)."""
    rng = np.random.default_rng(N + V)
    h = (rng.standard_normal((N, C)) * 0.5).astype(np.float32)
    e = (rng.standard_normal((V, C)) * 0.2).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    t[0] = V + 5                                # inside the padded tile
    t[1] = 7000                                 # beyond it
    t[2] = -100
    nvt = -(-V // fx.FWD_VOCAB)
    sp = {"plan": fx.fwd_plan(N, V, C, H100_SMS), "all": nvt}.get(
        splits, splits)
    sp = min(sp, nvt)
    th, te, tt = torch.from_numpy(h), torch.from_numpy(e), torch.from_numpy(t)
    got = _emulate_fwd(th, te, tt, sp)
    plain = fx.fused_xent_fwd_plain(th, te, tt)
    # the Pallas forward takes whole 16-row token tiles, as its wrapper
    # pads them: zero rows with target -1, sliced off after
    pad = -N % 16
    pallas = jax_fx._fwd(jnp.asarray(np.pad(h, ((0, pad), (0, 0)))),
                         jnp.asarray(e),
                         jnp.asarray(np.pad(t, (0, pad), constant_values=-1)),
                         Tb=16, Vb=128, eps=0.1, interpret=True)
    for g, p, j in zip(got, plain, pallas):
        np.testing.assert_allclose(g.numpy(), p.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j)[:N], **TOL)
    assert (got[1].numpy()[:3] == 0).all()


# ------------------------------------------------- the flash forward


def _live(qt, rows, Tq, Tk, causal):
    """[rows, keys] live mask of query tile qt (rows past Tq dead)."""
    i = np.arange(qt * rows, (qt + 1) * rows)[:, None]
    j = np.arange(Tk)[None, :]
    live = np.broadcast_to(i < Tq, (rows, Tk)).copy()
    if causal:
        live &= j <= i + (Tk - Tq)
    return live


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,H,Tq,Tk,causal", [
    (4, 32, 2048, 2048, True),        # phase 9
    (2, 16, 2048, 2048, True),        # gpt1p3b's heads
    (2, 4, 200, 200, True),           # ragged T, fewer items than SMs
    (1, 8, 128, 384, True),           # causal offset, Tq < Tk
    (1, 2, 384, 128, True),           # Tq > Tk: rows with no live key
    (2, 3, 300, 500, False),
    (1, 1, 1, 1, True),
])
def test_flash_fwd_schedule_covers_each_tile_heaviest_first(B, H, Tq, Tk,
                                                           causal, D):
    rows = fa.FWD_ROWS[D]
    nqt = -(-Tq // rows)
    sched = fa.fwd_schedule(B, H, Tq, Tk, causal, D, H100_SMS)
    assert len(sched) == min(H100_SMS, B * H * nqt)
    seen = [(b, h, qt) for blk in sched for b, h, qt, _ in blk]
    assert len(seen) == len(set(seen)) == B * H * nqt
    assert set(seen) == {(b, h, qt) for b in range(B) for h in range(H)
                         for qt in range(nqt)}
    for blk in sched:                      # each block: heaviest first
        work = [n for *_, n in blk]
        assert work == sorted(work, reverse=True)
    for qt in range(nqt):
        n = fa.fwd_key_tiles(qt, rows, Tq, Tk, causal)
        live = _live(qt, rows, Tq, Tk, causal)
        keys = np.nonzero(live.any(0))[0]
        if len(keys) == 0:
            assert n == 0                  # no live row: nothing loaded
            continue
        # every live key is loaded; the last loaded tile holds one, so a
        # tile is skipped only where no row of the query tile is live
        assert keys.max() < n * fa.FWD_KEYS
        assert keys.max() >= (n - 1) * fa.FWD_KEYS


def test_flash_fwd_deal_evens_out_the_causal_triangle():
    """At the gpt1p3b heads (512 items of 1-16 tiles on 132 blocks) the
    alternating deal's busiest block walks 34 tiles, the lower bound
    being 4352 / 132 = 33; dealing in one direction gives one 40."""
    sched = fa.fwd_schedule(2, 16, 2048, 2048, True, 128, H100_SMS)
    loads = [sum(n for *_, n in blk) for blk in sched]
    assert sum(loads) == 32 * 136 and max(loads) == 34


def test_flash_fwd_tma_check_names_the_stride():
    """The wgmma forward's TMA maps need 16-byte base addresses and
    strides: the BTHD views of a fused qkv projection pass; a view whose
    time stride is not a multiple of 8 elements raises, naming it; a dim
    of extent 1 may have any stride."""
    B, T, H, D = 2, 64, 4, 64
    qkv = torch.zeros(B, T, 3 * H * D, dtype=torch.bfloat16)
    q, k, v = (x.unflatten(-1, (H, D)).transpose(1, 2)
               for x in qkv.split(H * D, dim=-1))
    fa._check_tma(q, k, v)
    odd = torch.zeros(B, T, H * D + 4, dtype=torch.bfloat16)[..., :H * D]
    bad = odd.unflatten(-1, (H, D)).transpose(1, 2)
    with pytest.raises(ValueError, match="q's time stride is 260"):
        fa._check_tma(bad, k, v)
    one = torch.zeros(1, T, H * D + 4, dtype=torch.bfloat16)[:, :1, :H * D]
    single = one.unflatten(-1, (H, D)).transpose(1, 2)   # T = 1, B = 1
    fa._check_tma(single, single, single)
