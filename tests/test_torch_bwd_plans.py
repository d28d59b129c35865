"""The wgmma flash backward's launch geometry and order of work, on the CPU.

``flash_attention.bwd_schedule`` (the persistent blocks' work items) and
``bwd_query_tiles`` (the query tiles that see a key tile) come from shapes
alone, so their coverage is checked here before a card runs them. A plain
emulation walks the schedule as the kernel does: one item is (batch, KV
head, 128-key tile), whose dK and dV accumulate in fp32 over every query
tile of every query head of the GQA group, head by head, with P cast to
dO's dtype before dV and dS to Q's and K's before dK and dQ; dQ is summed
over the key tiles in an fp32 workspace and cast at the end. It must
equal ``flash_bwd_plain`` and the JAX package's backward (the Pallas
kernels in interpret mode) on the same seeded numpy inputs: fp32 within
1e-5 (summation order only), bf16 against ``flash_bwd_plain`` within the
card's limits for the kernel (1.6e-2 max-abs and 2**-8 of the norm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

H100_SMS = 132
TOL = dict(rtol=1e-5, atol=1e-5)


def _live(Tq, Tk, causal):
    """[Tq, Tk] bool: query i sees key j (bottom-right diagonal)."""
    i = np.arange(Tq)[:, None]
    j = np.arange(Tk)[None, :]
    return (j <= i + Tk - Tq) if causal else np.ones((Tq, Tk), bool)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,H,Hk,Tq,Tk,causal", [
    (4, 32, 32, 2048, 2048, True),    # phase 9
    (2, 16, 16, 2048, 2048, True),    # gpt1p3b's heads
    (2, 8, 2, 200, 200, True),        # GQA 8 -> 2, ragged T
    (1, 4, 2, 128, 384, True),        # causal offset, Tq < Tk
    (1, 4, 1, 384, 128, True),        # Tq > Tk: rows with no live key
    (2, 6, 3, 300, 500, False),
    (1, 1, 1, 1, 1, True),
])
def test_bwd_schedule_covers_each_item_once(B, H, Hk, Tq, Tk, causal, D):
    """Every (batch, KV head, key tile) item exactly once, on
    ``min(items, sms)`` blocks, each with G times its key tile's query
    tiles; the items run head by head, key tiles in order."""
    nkt = -(-Tk // fa.BWD_KEYS)
    sched = fa.bwd_schedule(B, H, Hk, Tq, Tk, causal, D, H100_SMS)
    assert len(sched) == min(H100_SMS, B * Hk * nkt)
    seen = [(b, hk, kt) for blk in sched for b, hk, kt, _ in blk]
    assert len(seen) == len(set(seen)) == B * Hk * nkt
    for blk in sched:
        for b, hk, kt, n in blk:
            assert n == (H // Hk) * len(fa.bwd_query_tiles(kt, Tq, Tk,
                                                           causal, D))
    # the deal: block `blk` takes item r * grid + blk in even rounds and
    # r * grid + grid - 1 - blk in odd ones; items are (b, hk) major
    grid = len(sched)
    for blk, items in enumerate(sched):
        order = [(b * Hk + hk) * nkt + kt for b, hk, kt, _ in items]
        assert order == [r * grid + (grid - 1 - blk if r % 2 else blk)
                         for r in range(len(order))]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Tq,Tk,causal", [
    (2048, 2048, True), (200, 200, True), (128, 384, True),
    (384, 128, True), (300, 500, False), (1, 1, True), (129, 1000, True)])
def test_bwd_query_tiles_are_those_that_see_the_key_tile(Tq, Tk, causal, D):
    """Under a causal offset (Tq != Tk) the range holds exactly the query
    tiles with a row that sees a key of the tile: a skipped tile has no
    live (row, key) pair with it, a walked one has at least one."""
    rows, live = fa.BWD_ROWS[D], _live(Tq, Tk, causal)
    nqt = -(-Tq // rows)
    for kt in range(-(-Tk // fa.BWD_KEYS)):
        keys = slice(kt * fa.BWD_KEYS, (kt + 1) * fa.BWD_KEYS)
        want = [qt for qt in range(nqt)
                if live[qt * rows:(qt + 1) * rows, keys].any()]
        assert list(fa.bwd_query_tiles(kt, Tq, Tk, causal, D)) == want


def test_bwd_deal_evens_out_the_causal_triangle():
    """At phase 9's shape (2048 items of 1-16 query tiles on 132 blocks)
    the busiest block walks 136 query tiles against a mean of 131.9, at
    the gpt1p3b heads 68 against 65.9: each block's key tile moves by
    132 mod 16 = 4 from round to round, so its long and short items mix."""
    for args, most in (((4, 32, 32, 2048, 2048, True, 64), 136),
                       ((2, 16, 16, 2048, 2048, True, 128), 68)):
        sched = fa.bwd_schedule(*args, H100_SMS)
        loads = [sum(n for *_, n in blk) for blk in sched]
        assert max(loads) == most
        assert max(loads) <= 1.04 * sum(loads) / len(loads)


def emulate_bwd(q, k, v, do, o, lse, dlse, *, causal, sm_scale):
    """The wgmma backward's order of work in plain PyTorch (see the module
    docstring), [B, H, T, D] tensors, outputs in q's dtype."""
    B, H, Tq, D = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    G, rows, dt = H // Hk, fa.BWD_ROWS[D], q.dtype
    delta = fa.flash_bwd_delta_plain(o, do, dlse)           # the prep pass
    nqt = -(-Tq // rows)
    ws = torch.zeros(B, H, nqt * rows, D)                   # fp32 dQ
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    live_all = torch.from_numpy(_live(Tq, Tk, causal))
    for blk in fa.bwd_schedule(B, H, Hk, Tq, Tk, causal, D, H100_SMS):
        for b, hk, kt, n in blk:
            keys = slice(kt * fa.BWD_KEYS, min((kt + 1) * fa.BWD_KEYS, Tk))
            K, V = k[b, hk, keys].float(), v[b, hk, keys].float()
            dka = torch.zeros_like(K)
            dva = torch.zeros_like(V)
            tiles = fa.bwd_query_tiles(kt, Tq, Tk, causal, D)
            for h in range(hk * G, (hk + 1) * G):
                for qt in tiles:
                    r = slice(qt * rows, min((qt + 1) * rows, Tq))
                    Q, dO = q[b, h, r].float(), do[b, h, r].float()
                    ls = lse[b, h, r].float()[:, None]
                    live = live_all[r, keys] & torch.isfinite(ls)
                    s = Q @ K.T * sm_scale
                    p = torch.where(live, torch.exp(s - torch.where(
                        torch.isfinite(ls), ls, torch.zeros_like(ls))), 0.0)
                    dp = dO @ V.T
                    ds = p * (dp - delta[b, h, r][:, None]) * sm_scale
                    p_c, ds_c = p.to(dt).float(), ds.to(dt).float()
                    dva += p_c.T @ dO
                    dka += ds_c.T @ Q
                    ws[b, h, r] += ds_c @ K
            dk[b, hk, keys] = dka.to(dt)
            dv[b, hk, keys] = dva.to(dt)
    return ws[:, :, :Tq].to(dt), dk, dv


CASES = {
    # name: (B, Tq, Tk, H, Hk, D, causal, an lse cotangent)
    "gqa_8to2_causal": (1, 256, 256, 8, 2, 64, True, False),
    "causal_offset_Tq128_Tk384": (1, 128, 384, 4, 2, 64, True, False),
    "noncausal_ragged_T200": (2, 200, 200, 4, 4, 64, False, False),
    "no_live_rows_Tq300_Tk200": (1, 300, 200, 4, 1, 64, True, False),
    "lse_cotangent_d128_gqa": (1, 192, 192, 4, 2, 128, True, True),
}


def _inputs(seed, B, Tq, Tk, H, Hk, D):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, Tq, H, D), f(B, Tk, Hk, D), f(B, Tk, Hk, D),
            f(B, Tq, H, D), f(B, H, Tq) * 0.1)


def _port_bhtd(x):
    return torch.from_numpy(x).transpose(1, 2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_order_matches_plain_and_pallas(case):
    """The emulation against ``flash_bwd_plain`` and the JAX package's
    ``flash_attention`` VJP (Pallas in interpret mode), fp32; with an lse
    cotangent where lse is an output. Rows with no live key (Tq > Tk under
    the causal diagonal) get zero gradients; the JAX package's VJP gives
    NaN there (its forward's O of such a row is NaN), so that case is held
    against the plain version alone."""
    B, Tq, Tk, H, Hk, D, causal, with_dlse = CASES[case]
    q, k, v, do, dlse = _inputs(9, B, Tq, Tk, H, Hk, D)
    kw = dict(causal=causal, sm_scale=D ** -0.5)
    tq, tk, tv, tdo = (_port_bhtd(x) for x in (q, k, v, do))
    tdlse = torch.from_numpy(dlse) if with_dlse else None
    o, lse = fa.flash_fwd_plain(tq, tk, tv, **kw)
    got = emulate_bwd(tq, tk, tv, tdo, o, lse, tdlse, **kw)
    ref = fa.flash_bwd_plain(tq, tk, tv, tdo, o, lse, tdlse, **kw)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL,
                                   err_msg=f"{name} vs plain")

    if Tq > Tk and causal:                       # rows with no live key
        assert not got[0][:, :, :Tq - Tk].any()
        return

    def f(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, causal=causal, block_q=128,
                                   block_k=128, interpret=True,
                                   return_lse=with_dlse)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    cts = (jnp.asarray(do), jnp.asarray(dlse)) if with_dlse \
        else jnp.asarray(do)
    for name, g, r in zip(("dq", "dk", "dv"), got, vjp(cts)):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(r),
                                   **TOL, err_msg=f"{name} vs Pallas")


@pytest.mark.parametrize("case", ["gqa_8to2_causal",
                                  "lse_cotangent_d128_gqa"])
def test_emulated_kernel_order_matches_plain_in_bf16(case):
    """bf16 inputs: the kernel's casts and order against the plain
    version's, within the limits the card holds the kernel to."""
    B, Tq, Tk, H, Hk, D, causal, with_dlse = CASES[case]
    q, k, v, do, dlse = _inputs(10, B, Tq, Tk, H, Hk, D)
    kw = dict(causal=causal, sm_scale=D ** -0.5)
    tq, tk, tv, tdo = (_port_bhtd(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    tdlse = torch.from_numpy(dlse) if with_dlse else None
    o, lse = fa.flash_fwd_plain(tq, tk, tv, **kw)
    got = emulate_bwd(tq, tk, tv, tdo, o, lse, tdlse, **kw)
    ref = fa.flash_bwd_plain(tq, tk, tv, tdo, o, lse, tdlse, **kw)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16
        diff = g.float() - r.float()
        assert diff.abs().max() <= 1.6e-2, name
        assert diff.norm() <= 2.0 ** -8 * r.float().norm(), name


@pytest.mark.parametrize("with_dlse", [False, True])
def test_prep_delta_matches_jax(with_dlse):
    """The prep pass's function, rowsum(dO O) - dlse in fp32, against the
    JAX package's delta (``_bwd``: the sum before the first pallas_call)."""
    _, _, _, do, dlse = _inputs(11, 2, 100, 100, 4, 4, 64)
    o = np.random.default_rng(12).standard_normal(do.shape).astype(
        np.float32)
    got = fa.flash_bwd_delta_plain(
        _port_bhtd(o), _port_bhtd(do),
        torch.from_numpy(dlse) if with_dlse else None)
    ref = jnp.sum(jnp.asarray(do).astype(jnp.float32)
                  * jnp.asarray(o).astype(jnp.float32), axis=-1)
    ref = jnp.swapaxes(ref, 1, 2)
    if with_dlse:
        ref = ref - jnp.asarray(dlse)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert got.is_contiguous() and got.dtype == torch.float32


def test_bwd_workspace_and_routes():
    """The workspaces cover whole query tiles (67 MB of fp32 dQ at phase
    9's shape); the routes by head dim and dtype; the CPU wrapper runs the
    plain version and counts no launch."""
    n_dq, n_rows = fa.bwd_workspace_floats(4, 32, 2048, 64)
    assert n_dq * 4 == 4 * 32 * 2048 * 64 * 4 and n_rows == 4 * 32 * 16 * 256
    n_dq, _ = fa.bwd_workspace_floats(1, 2, 200, 128)
    assert n_dq == 2 * 4 * 64 * 128                # 200 rows -> 4 tiles
    assert fa.bwd_launch_names(64, torch.bfloat16) == (
        "flash_bwd_prep", "flash_bwd", "flash_bwd_cast")
    assert fa.bwd_launch_names(128, torch.float16)[1] == "flash_bwd"
    for D, dt in ((16, torch.bfloat16), (32, torch.float16),
                  (64, torch.float32)):
        assert fa.bwd_launch_names(D, dt) == ("flash_bwd_dq",
                                              "flash_bwd_dkv")
    fa.reset_launch_counts()
    q, k, v, do, _ = (_port_bhtd(x) if x.ndim == 4 else x
                      for x in _inputs(13, 1, 40, 40, 2, 1, 64))
    o, lse = fa.flash_fwd_plain(q, k, v, causal=True, sm_scale=0.125)
    got = fa.flash_bwd(q, k, v, do, o, lse, causal=True, sm_scale=0.125)
    ref = fa.flash_bwd_plain(q, k, v, do, o, lse, causal=True,
                             sm_scale=0.125)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert not any(fa.LAUNCHES.values())


def test_bwd_tma_check_names_dO():
    """The backward's TMA maps read dO too: a time stride that is not a
    multiple of 8 elements raises naming dO; the autograd Function gives
    the kernel a dense copy of such a dO instead (``_tma_ready``)."""
    B, T, H, D = 2, 64, 4, 64
    qkv = torch.zeros(B, T, 3 * H * D, dtype=torch.bfloat16)
    q, k, v = (x.unflatten(-1, (H, D)).transpose(1, 2)
               for x in qkv.split(H * D, dim=-1))
    odd = torch.zeros(B, T, H * D + 4, dtype=torch.bfloat16)[..., :H * D]
    bad = odd.unflatten(-1, (H, D)).transpose(1, 2)
    fa._check_tma(q, k, v, q, what="backward")
    with pytest.raises(ValueError, match="dO's time stride is 260"):
        fa._check_tma(q, k, v, bad, what="backward")
    assert fa._tma_ready(q) is q
    fixed = fa._tma_ready(bad)
    assert fixed.is_contiguous() and torch.equal(fixed, bad)
    zeros = torch.zeros(1, 1, 1, 1, dtype=torch.bfloat16).expand(B, H, T, D)
    assert fa._tma_ready(zeros).is_contiguous()
