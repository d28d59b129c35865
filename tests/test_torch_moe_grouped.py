"""Port parity for the dropless MoE's grouped path on the CPU: the port's
``grouped_moe_ffn`` and the plain ``ragged_dot`` (what the grouped GEMM
kernel computes; the wrapper runs it for CPU tensors) against the JAX
package's ``grouped_moe_ffn`` and ``jax.lax.ragged_dot``, all in fp32.

- ``grouped_moe_ffn``: gated and ungated experts, ``normalize_weights``
  both ways, k in {1, 2, 4}, with and without an expert that no token
  picks: ``out`` within 1e-5 and ``l_aux`` within 1e-6 (fp32 summation
  order).
- ``ragged_dot_plain``: group sizes with empty groups and rows that fill
  no tile evenly, against ``jax.lax.ragged_dot`` within 1e-5.
- ``grouped_plan``: the row tile follows the rows an expert (16 at
  decode, 128 at prefill), and its grid's row-tile slots cover every
  expert's tiles for any split of R rows over E experts.
- A plain emulation of the kernel's walk (each block's expert and rows
  found from the offsets as ``find_tile`` does, by a prefix sum of each
  expert's tile count) covers every row once and reads no empty expert.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu_torch.moe import sharded_moe as tmoe
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(rng, S, M, E, H, gated, dead):
    x = rng.standard_normal((S, M)).astype(np.float32)
    logits = rng.standard_normal((S, E)).astype(np.float32)
    if dead:
        logits[:, E - 1] -= 100.0                # no token picks it
    shapes = [(E, M, H), (E, M, H), (E, H, M)] if gated \
        else [(E, M, H), (E, H, M)]
    ws = [0.3 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    return x, logits, ws


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_grouped_moe_ffn_equals_jax(k, gated, norm, dead):
    rng = np.random.default_rng(100 * k + 10 * gated + 2 * norm + dead)
    x, logits, ws = _case(rng, 19, 16, 6, 24, gated, dead)
    jout, jl = jmoe.grouped_moe_ffn(
        jnp.asarray(x), jnp.asarray(logits), k, [jnp.asarray(w) for w in ws],
        jax.nn.silu, jnp.float32, normalize_weights=norm)
    out, l_aux = tmoe.grouped_moe_ffn(
        torch.from_numpy(x), torch.from_numpy(logits), k,
        [torch.from_numpy(w) for w in ws], F.silu, torch.float32,
        normalize_weights=norm)
    assert out.dtype == torch.float32 and out.shape == (19, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(l_aux.item(), float(jl), atol=1e-6)


def test_group_offsets_count_on_the_device_side():
    """Offsets from ``scatter_add_`` and ``cumsum`` (no bincount): the
    stable sort's runs, an expert nobody picks an empty run."""
    eid = torch.tensor([3, 0, 3, 1, 0, 3], dtype=torch.int64)
    off = tmoe.group_offsets(eid, 5)
    assert off.dtype == torch.int32
    assert off.tolist() == [0, 2, 3, 3, 6, 6]


@pytest.mark.parametrize("sizes", [
    (5, 0, 11, 4),                 # an empty group in the middle
    (0, 0, 7, 0),                  # one live group
    (17, 1, 1, 30, 0, 2),          # no size a tile multiple
    (1,) * 9,                      # a decode step: a row an expert
])
def test_ragged_dot_plain_equals_jax(sizes):
    rng = np.random.default_rng(sum(sizes) + len(sizes))
    R, E, K, N = sum(sizes), len(sizes), 24, 40
    x = rng.standard_normal((R, K)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    ref = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(gs)]).astype(
        np.int32))
    got = gg.ragged_dot(torch.from_numpy(x), torch.from_numpy(w), off)
    assert gg.LAUNCHES["grouped_gemm"] == 0          # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_ragged_dot_refuses_bad_inputs():
    x = torch.zeros(6, 8)
    w = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError, match="rise from 0"):
        gg.ragged_dot(x, w, torch.tensor([0, 4, 5], dtype=torch.int32))
    with pytest.raises(ValueError, match=r"want \[3\]"):
        gg.ragged_dot(x, w, torch.tensor([0, 6], dtype=torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        gg.ragged_dot(x, w.double(), torch.tensor([0, 3, 6],
                                                  dtype=torch.int32))


@pytest.mark.parametrize("R,E,bm", [
    (64, 60, 16), (32, 8, 16), (256, 8, 32), (512, 8, 64),
    (16384, 60, 128), (8192, 8, 128), (5, 60, 16)])
def test_grouped_plan_picks_the_row_tile(R, E, bm):
    """16 rows at decode (Qwen1.5-MoE's 64 rows over 60 experts,
    Mixtral's 32 over 8), 128 at prefill (16384 over 60, 8192 over 8)."""
    plan = gg.grouped_plan(R, E)
    assert plan.bm == bm
    assert plan.tiles >= -(-R // bm)


def _tiles(sizes, bm):
    return sum(-(-n // bm) for n in sizes)


@pytest.mark.parametrize("R,E", [(1, 1), (7, 3), (40, 4), (129, 2),
                                 (64, 60), (300, 9)])
def test_grouped_plan_slots_cover_every_split(R, E):
    """The grid's row-tile slots bound sum(ceil(n_e / bm)) for every way
    of splitting R rows over E experts, and equal it for one of the
    worst: a row for each of min(E, R) experts, the rest on the first."""
    rng = np.random.default_rng(R * 31 + E)
    plan = gg.grouped_plan(R, E)
    live = min(E, R)
    worst = [1] * live + [0] * (E - live)
    worst[0] += R - live
    assert _tiles(worst, plan.bm) == plan.tiles
    for _ in range(50):
        cuts = np.sort(rng.integers(0, R + 1, E - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [R]]))
        assert _tiles(sizes, plan.bm) <= plan.tiles


def _emulate_kernel(x, w, off, bm):
    """The kernel's order of work in plain PyTorch: block t of the grid's
    row-tile slots finds its expert as ``find_tile`` does (a running sum
    over experts of ceil(rows / bm), 32 experts a warp step), multiplies
    its rows and stores them; blocks past the last tile exit. Returns
    (y, rows written per row, experts read)."""
    R, E = x.shape[0], w.shape[0]
    plan = gg.grouped_plan(R, E)
    assert plan.bm == bm
    y = torch.zeros(R, w.shape[2])
    written = torch.zeros(R, dtype=torch.int64)
    read = set()
    o = off.tolist()
    for t in range(plan.tiles):
        base, found = 0, None
        for e0 in range(0, E, 32):
            lane = list(range(e0, min(e0 + 32, E)))
            tiles = [-(-(o[e + 1] - o[e]) // bm) for e in lane]
            inc = list(itertools.accumulate(tiles))
            for i, e in enumerate(lane):
                first = base + inc[i] - tiles[i]
                if tiles[i] and first <= t < first + tiles[i]:
                    found = (e, o[e] + (t - first) * bm, o[e + 1])
            base += inc[-1]
            if found:
                break
        if found is None:
            continue
        e, r0, r1 = found
        r1 = min(r0 + bm, r1)
        read.add(e)
        y[r0:r1] = x[r0:r1] @ w[e]
        written[r0:r1] += 1
    return y, written, read


@pytest.mark.parametrize("sizes", [
    (1,) * 60 + (4,),                          # 64 rows over 61 experts
    tuple([0] * 20 + [300] + [0] * 20 + [5]),  # empty experts, long runs
    (130, 0, 129, 1, 0, 0, 127),
])
def test_kernel_walk_emulation_equals_plain(sizes):
    rng = np.random.default_rng(len(sizes))
    R, E = sum(sizes), len(sizes)
    x = torch.from_numpy(rng.standard_normal((R, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, 16, 8)).astype(np.float32))
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(
        np.int32))
    bm = gg.grouped_plan(R, E).bm
    y, written, read = _emulate_kernel(x, w, off, bm)
    assert written.eq(1).all()
    assert read == {e for e, n in enumerate(sizes) if n}
    np.testing.assert_allclose(y.numpy(), gg.ragged_dot_plain(x, w, off)
                               .numpy(), **TOL)
