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
- ``grouped_plan``'s route and column tile at the served shapes
  (Qwen1.5-MoE-A2.7B and Mixtral-8x7B, prefill and decode) and at the
  32 / 64 row-tile boundary.
- A plain emulation of the wgmma route's persistent walk (tile L =
  block + i grid, expert -> column tile -> row tile, each K step a TMA box
  of x and a 3-D box of w[e] zero-filled past K): every output element
  written once, empty (NaN-poisoned) experts never read, tiles in that
  order, and its slots cover every split of R rows over E experts.
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


@pytest.mark.parametrize("R,E,N,dtype,want", [
    # Qwen1.5-MoE-A2.7B: 16 x 256 prompt tokens top-4 over 60 experts,
    # 2048 -> 1408 (gate / up) and 1408 -> 2048 (down); 16 decode tokens
    (16384, 60, 1408, torch.bfloat16, (128, "wgmma", 256, 6)),
    (16384, 60, 2048, torch.bfloat16, (128, "wgmma", 256, 8)),
    (64, 60, 1408, torch.bfloat16, (16, "mma", 128, 11)),
    (64, 60, 2048, torch.bfloat16, (16, "mma", 128, 16)),
    # Mixtral-8x7B: 4096 prompt tokens top-2 over 8, 4096 -> 14336 and
    # back; 16 decode tokens
    (8192, 8, 14336, torch.bfloat16, (128, "wgmma", 256, 56)),
    (8192, 8, 4096, torch.float16, (128, "wgmma", 256, 16)),
    (32, 8, 14336, torch.bfloat16, (16, "mma", 128, 112)),
    (32, 8, 4096, torch.float32, (16, "f32", 64, 64)),
    # the 32 / 64 boundary: 32 rows an expert stay on mma.sync, 33 go to
    # 64-row wgmma tiles; the column tile by bytes a K step over all
    # column tiles, ceil(N / bn) (bm + bn): N = 136 one 256-column tile
    # (384) against two of 128 (512), N = 24 one 128-column tile
    (256, 8, 512, torch.bfloat16, (32, "mma", 128, 4)),
    (264, 8, 512, torch.float16, (64, "wgmma", 256, 2)),
    (512, 8, 136, torch.bfloat16, (64, "wgmma", 256, 1)),
    (520, 8, 136, torch.bfloat16, (128, "wgmma", 256, 1)),
    (520, 8, 24, torch.bfloat16, (128, "wgmma", 128, 1)),
    (520, 8, 136, torch.float32, (128, "f32", 64, 3)),
])
def test_grouped_plan_routes_at_the_served_shapes(R, E, N, dtype, want):
    plan = gg.grouped_plan(R, E, N, dtype, 132)
    assert (plan.bm, plan.route, plan.bn, plan.col_tiles) == want
    slots = plan.tiles * plan.col_tiles
    assert plan.grid == (min(132, slots + slots % 2)
                         if plan.route == "wgmma" else slots)
    assert plan.route != "wgmma" or plan.grid % 2 == 0    # pairs


def _expert_of(o, t, bm):
    """``find_expert``: the expert owning row tile t, 32 experts a warp
    step (e, first row, rows, first tile), or None past the last tile."""
    E, base = len(o) - 1, 0
    for e0 in range(0, E, 32):
        lane = list(range(e0, min(e0 + 32, E)))
        tiles = [-(-(o[e + 1] - o[e]) // bm) for e in lane]
        inc = list(itertools.accumulate(tiles))
        for i, e in enumerate(lane):
            first = base + inc[i] - tiles[i]
            if tiles[i] and first <= t < first + tiles[i]:
                return e, o[e], o[e + 1] - o[e], first
        base += inc[-1]
    return None


def _tile_of(o, L, plan):
    """``w_tile``: tile L's (e, ct, rt, r0, r1, n0), or None past the
    last real tile."""
    NT, bm = plan.col_tiles, plan.bm
    found = _expert_of(o, L // NT, bm)
    if found is None:
        return None
    e, lo, n, first = found
    tiles, local = -(-n // bm), L - first * NT
    ct, rt = local // tiles, local % tiles
    return e, ct, rt, lo + rt * bm, lo + n, ct * plan.bn


def _wgmma_walk(o, plan):
    """Each block's tiles in the wgmma route's persistent order, in
    clusters of two as the kernel walks them: the pair of blocks (2q, 2q
    + 1) takes tiles L, L + 1 for L = 2q, 2q + grid, ... while tile L is
    real (rank 1 idles a step whose tile is past the last). Returns
    ({block: [(L, e, ct, rt, r0, r1, n0)]}, steps whose two tiles share
    their weight boxes, steps in all)."""
    walk, shared, steps = {}, 0, 0
    for b in range(0, plan.grid, 2):
        walk[b], walk[b + 1] = [], []
        for L in range(b, plan.tiles * plan.col_tiles, plan.grid):
            t0 = _tile_of(o, L, plan)
            if t0 is None:
                break
            t1 = _tile_of(o, L + 1, plan)
            steps += 1
            shared += t1 is not None and t1[:2] == t0[:2]
            walk[b].append((L, *t0))
            if t1 is not None:
                walk[b + 1].append((L + 1, *t1))
    return walk, shared, steps


def _emulate_wgmma(x, w, off, plan):
    """The wgmma route in plain PyTorch: each tile's 64-deep K steps as
    its TMA boxes (x rows r0 .. r0 + bm, zeros past R; w[e] rows of the
    step, zeros past K, never another expert's), fp32 sums in K order,
    rows r < r1 and columns c < N stored. Returns (y, writes per element,
    experts read, the walk)."""
    R, K = x.shape
    E, _, N = w.shape
    o = off.tolist()
    walk, _, _ = _wgmma_walk(o, plan)
    xp = torch.cat([x, torch.zeros(plan.bm, K)])
    y = torch.full((R, N), float("nan"))
    written = torch.zeros(R, N, dtype=torch.int64)
    read = set()
    for tiles in walk.values():
        for L, e, ct, rt, r0, r1, n0 in tiles:
            read.add(e)
            acc = torch.zeros(plan.bm, plan.bn)
            for k0 in range(0, K, 64):
                a = torch.zeros(plan.bm, 64)
                b = torch.zeros(64, plan.bn)
                k1 = min(k0 + 64, K)
                a[:, :k1 - k0] = xp[r0:r0 + plan.bm, k0:k1]
                n1 = min(n0 + plan.bn, N)
                b[:k1 - k0, :n1 - n0] = w[e, k0:k1, n0:n1]
                acc += a @ b
            rows, cols = min(r1, r0 + plan.bm) - r0, min(N, n0 + plan.bn) - n0
            y[r0:r0 + rows, n0:n0 + cols] = acc[:rows, :cols]
            written[r0:r0 + rows, n0:n0 + cols] += 1
    return y, written, read, walk


@pytest.mark.parametrize("sizes,K,N,sms", [
    ((300, 0, 257, 0, 129, 0, 0, 511), 200, 136, 5),   # K past the step
    ((0, 0, 700, 0), 72, 1408 // 4, 3),                 # one live expert
    ((130, 70, 0, 200, 64, 65), 64, 264, 132),          # grid > tiles
])
def test_wgmma_walk_emulation_equals_plain(sizes, K, N, sms):
    rng = np.random.default_rng(sum(sizes) + K)
    R, E = sum(sizes), len(sizes)
    x = torch.from_numpy(rng.standard_normal((R, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32))
    for e, n in enumerate(sizes):
        if not n:
            w[e] = float("nan")                   # read would poison y
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(
        np.int32))
    plan = gg.grouped_plan(R, E, N, torch.bfloat16, sms)
    assert plan.route == "wgmma"
    y, written, read, walk = _emulate_wgmma(x, w, off, plan)
    assert written.eq(1).all()
    assert read == {e for e, n in enumerate(sizes) if n}
    np.testing.assert_allclose(y.numpy(), gg.ragged_dot_plain(x, w, off)
                               .numpy(), atol=1e-4, rtol=1e-5)
    # the tiles by L: expert -> column tile -> row tile, each once
    order = sorted(t for tiles in walk.values() for t in tiles)
    assert [t[0] for t in order] == list(range(len(order)))
    keys = [(e, ct, rt) for _, e, ct, rt, *_ in order]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    for b, tiles in walk.items():
        assert [t[0] for t in tiles] == list(range(b, b + plan.grid * len(
            tiles), plan.grid))
        # a pair's two tiles are neighbours in the walk
        if b % 2:
            assert len(tiles) <= len(walk[b - 1])


@pytest.mark.parametrize("R,E,N", [(70, 1, 8), (129, 2, 264), (300, 4, 136),
                                   (300, 6, 136), (2000, 9, 1408),
                                   (4096, 60, 520)])
def test_wgmma_walk_slots_cover_every_split(R, E, N):
    """The persistent walk's slots (row-tile slots x column tiles) hold
    every tile of any split of R rows over E experts, so each block's walk
    reaches the last real tile; a split's tiles all appear once."""
    rng = np.random.default_rng(R + E + N)
    plan = gg.grouped_plan(R, E, N, torch.float16, 7)
    assert plan.route == "wgmma"
    for _ in range(20):
        cuts = np.sort(rng.integers(0, R + 1, E - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [R]]))
        o = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        real = _tiles(sizes, plan.bm) * plan.col_tiles
        assert real <= plan.tiles * plan.col_tiles
        walk, shared, steps = _wgmma_walk(o, plan)
        assert sum(len(t) for t in walk.values()) == real
        assert steps == -(-real // 2) and shared <= steps


@pytest.mark.parametrize("tokens,k,E,N,dead,share", [
    (4096, 4, 60, 1408, 3, 0.60),     # Qwen1.5-MoE-A2.7B gate / up
    (4096, 4, 60, 2048, 3, 0.60),     # its down
    (4096, 2, 8, 14336, 1, 0.90),     # Mixtral-8x7B gate / up
])
def test_wgmma_pairs_share_weights_at_the_served_prefill(tokens, k, E, N,
                                                         dead, share):
    """At phase 29's prefill shapes (top-k of random logits, the last
    ``dead`` experts never picked) most steps of a cluster pair are two
    row tiles of one (expert, column tile), whose weight boxes the kernel
    multicasts: 67% at Qwen1.5-MoE's (3 row tiles an expert and column
    tile), 97% at Mixtral's."""
    rng = np.random.default_rng(tokens + E + N)
    logits = rng.standard_normal((tokens, E))
    logits[:, E - dead:] = -1e4
    top = np.argsort(-logits, axis=1)[:, :k].reshape(-1)
    o = np.concatenate([[0], np.cumsum(np.bincount(top, minlength=E))])
    plan = gg.grouped_plan(tokens * k, E, N, torch.bfloat16, 132)
    _, shared, steps = _wgmma_walk(o.tolist(), plan)
    assert shared / steps >= share, (shared, steps)


# ------------------------------------------------------------- backward


def _jax_vjp(x, w, sizes, dy):
    """(dx, dw) of ``jax.lax.ragged_dot`` by ``jax.vjp``."""
    gs = jnp.asarray(np.asarray(sizes, np.int32))
    _, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, gs),
                     jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(dy))
    return np.asarray(dx), np.asarray(dw)


def _wgrad_tile(L, plan):
    """Tile L's (e, k0, n0): expert L // (k_tiles x col_tiles), then K
    tile and column tile (fastest)."""
    per, NT = plan.k_tiles * plan.col_tiles, plan.col_tiles
    rem = L % per
    return L // per, rem // NT * gg.WGRAD_K_TILE, rem % NT * plan.bn


def _wgrad_walk(E, plan):
    """Each block's tiles in the weight gradient's persistent order: block
    b takes L = b, b + grid, ... Returns {block: [(L, e, k0, n0)]}."""
    slots = E * plan.k_tiles * plan.col_tiles
    return {b: [(L, *_wgrad_tile(L, plan))
                for L in range(b, slots, plan.grid)]
            for b in range(plan.grid)}


def _emulate_wgrad(x, dy, off, plan):
    """The weight gradient's kernel in plain PyTorch: each tile's 64-row
    steps over its expert's rows as its TMA boxes (two 64 x 64 boxes of x
    at K columns k0 and k0 + 64, the second not loaded past K; BN / 64
    boxes of dy, those wholly past N not loaded; rows past R zeros, rows
    past the expert's end the next expert's rows), the boxes not loaded
    holding NaN (stale shared memory), the rows past the expert's end
    zeroed in every box before the step's product, fp32 sums in row order,
    rows past K and columns past N of the tile not stored. Returns (dw,
    writes per element, the walk)."""
    R, K = x.shape
    N = dy.shape[1]
    E = off.shape[0] - 1
    o = off.tolist()
    walk = _wgrad_walk(E, plan)
    pad = lambda t: torch.cat([t, torch.zeros(64, t.shape[1])])  # noqa
    xp, dyp = pad(x), pad(dy)
    dw = torch.full((E, K, N), float("nan"))
    written = torch.zeros(E, K, N, dtype=torch.int64)
    for tiles in walk.values():
        for L, e, k0, n0 in tiles:
            boxes = sum(n0 + 64 * j < N for j in range(plan.bn // 64))
            acc = torch.zeros(gg.WGRAD_K_TILE, plan.bn)
            for r in range(o[e], o[e + 1], 64):
                a = torch.full((64, gg.WGRAD_K_TILE), float("nan"))
                b = torch.full((64, plan.bn), float("nan"))
                for j in range(2 if k0 + 64 < K else 1):
                    c0, c1 = k0 + 64 * j, min(k0 + 64 * j + 64, K)
                    a[:, 64 * j:64 * j + 64] = 0.0
                    a[:, 64 * j:64 * j + c1 - c0] = xp[r:r + 64, c0:c1]
                for j in range(boxes):
                    c0, c1 = n0 + 64 * j, min(n0 + 64 * j + 64, N)
                    b[:, 64 * j:64 * j + 64] = 0.0
                    b[:, 64 * j:64 * j + c1 - c0] = dyp[r:r + 64, c0:c1]
                live = min(64, o[e + 1] - r)
                a[live:] = 0.0
                b[live:] = 0.0
                acc += a.t() @ b
            for h in range(2):                    # the two consumers
                rows = min(K - k0 - 64 * h, 64)
                if rows <= 0:
                    continue
                for j in range(boxes):
                    cols = min(N - n0 - 64 * j, 64)
                    sl = (e, slice(k0 + 64 * h, k0 + 64 * h + rows),
                          slice(n0 + 64 * j, n0 + 64 * j + cols))
                    dw[sl] = acc[64 * h:64 * h + rows, 64 * j:64 * j + cols]
                    written[sl] += 1
    return dw, written, walk


#: groups for the backward's walks: empty first and last experts, a
#: 1-row group, a group of exactly 64 rows, groups that are no multiple
#: of the 64-row step
WGRAD_SIZES = [
    (0, 1, 64, 0, 130, 7, 0),
    (0, 200, 0, 0, 65, 0),
    (64, 64, 1, 63, 0, 129),
    (0, 600, 257, 0, 511),          # 274 rows an expert: 5-10 steps a tile
]


@pytest.mark.parametrize("sizes", WGRAD_SIZES)
@pytest.mark.parametrize("K,N,sms", [(200, 136, 5), (40, 24, 3),
                                     (128, 264, 132)])
def test_wgrad_walk_emulation_equals_plain_and_jax(sizes, K, N, sms):
    """The weight gradient's walk (tile order, each tile's 64-row steps,
    the tail zeroing, the boxes not loaded) equals ``ragged_dot_wgrad_
    plain`` and the VJP of ``jax.lax.ragged_dot``; every element of dW is
    stored once, an empty expert's as exact zeros."""
    rng = np.random.default_rng(sum(sizes) + K + N)
    R, E = sum(sizes), len(sizes)
    x = rng.standard_normal((R, K)).astype(np.float32)
    dy = rng.standard_normal((R, N)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(
        np.int32))
    plan = gg.wgrad_plan(R, E, K, N, torch.bfloat16, sms)
    assert plan.route == "wgmma" and plan.grid <= sms
    assert plan.k_tiles == -(-K // gg.WGRAD_K_TILE)
    assert plan.col_tiles == -(-N // plan.bn)
    dw, written, walk = _emulate_wgrad(torch.from_numpy(x),
                                       torch.from_numpy(dy), off, plan)
    assert written.eq(1).all()
    for e, n in enumerate(sizes):
        if not n:
            assert dw[e].eq(0).all()
    plain = gg.ragged_dot_wgrad_plain(torch.from_numpy(x),
                                      torch.from_numpy(dy), off)
    np.testing.assert_allclose(dw.numpy(), plain.numpy(), atol=1e-4,
                               rtol=1e-5)
    _, jdw = _jax_vjp(x, w, sizes, dy)
    np.testing.assert_allclose(dw.numpy(), jdw, atol=1e-4, rtol=1e-5)
    # the tiles by L: expert -> K tile -> column tile, each once
    order = sorted(t for tiles in walk.values() for t in tiles)
    assert [t[0] for t in order] == list(range(len(order)))
    keys = [(e, k0, n0) for _, e, k0, n0 in order]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    for b, tiles in walk.items():
        assert [t[0] for t in tiles] == list(range(
            b, b + plan.grid * len(tiles), plan.grid))


@pytest.mark.parametrize("R,E,K,N,experts", [
    # Qwen1.5-MoE-A2.7B at phase 32 (b) (136 rows an expert): 96 and 88
    # tiles an expert, so a wave of 132 blocks spans two or three experts
    (8192, 60, 2048, 1408, 3),
    (8192, 60, 1408, 2048, 2),
    # Mixtral-8x7B's expert product (512 rows an expert): 32 x 56 tiles
    # an expert, a wave within one or across two
    (4096, 8, 4096, 14336, 2),
    # 300 rows an expert over 11 K tiles and 8 column tiles
    (18000, 60, 1408, 2048, 2),
])
def test_wgrad_walk_covers_every_tile_at_the_served_shapes(R, E, K, N,
                                                           experts):
    """At the served shapes the weight gradient's persistent blocks walk
    every tile once, and the tiles one wave of blocks runs at once (L in
    [i grid, (i + 1) grid)) belong to at most ``experts`` experts, whose
    x and dy slabs they share in L2; neighbouring blocks take
    neighbouring column tiles of one K tile."""
    plan = gg.wgrad_plan(R, E, K, N, torch.bfloat16, 132)
    assert plan.grid == 132
    walk = _wgrad_walk(E, plan)
    tiles = sorted(t for ts in walk.values() for t in ts)
    assert [t[0] for t in tiles] == list(range(
        E * plan.k_tiles * plan.col_tiles))
    for i in range(0, len(tiles), plan.grid):
        wave = tiles[i:i + plan.grid]
        assert len({t[1] for t in wave}) <= experts
    for (_, e0, k0, n0), (_, e1, k1, n1) in zip(tiles, tiles[1:]):
        if (e1, k1) == (e0, k0):
            assert n1 == n0 + plan.bn


def test_wgrad_tail_zeroing_is_what_keeps_the_next_expert_out():
    """Without the zeroing of the rows past an expert's end, its last
    step sums the next expert's rows into its dW: the emulation with the
    zeroing taken out differs from the plain version exactly where a
    ragged expert has a neighbour."""
    sizes = (3, 70, 0, 5)
    rng = np.random.default_rng(7)
    R, E, K, N = sum(sizes), len(sizes), 64, 64
    x = torch.from_numpy(rng.standard_normal((R, K)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((R, N)).astype(np.float32))
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(
        np.int32))
    plan = gg.wgrad_plan(R, E, K, N, torch.bfloat16, 4)
    o = off.tolist()
    plain = gg.ragged_dot_wgrad_plain(x, dy, off)
    for e in range(E):
        lo, hi = o[e], o[e + 1]
        steps = range(lo, hi, 64)
        unzeroed = sum(x[r:r + 64].t() @ dy[r:r + 64] for r in steps) \
            if hi > lo else torch.zeros(K, N)
        leaks = hi > lo and hi % 64 != lo % 64 and hi < R
        assert torch.allclose(unzeroed, plain[e], atol=1e-4) != leaks, e
    dw, _, _ = _emulate_wgrad(x, dy, off, plan)
    np.testing.assert_allclose(dw.numpy(), plain.numpy(), atol=1e-4)


@pytest.mark.parametrize("R,E,K,N,dtype,want", [
    # Qwen1.5-MoE-A2.7B's gate / up (2048 -> 1408) and down at phase 32
    # (b)'s 8192 rows; Mixtral-8x7B's gate / up (4096 -> 14336) and down
    # at 4096 rows: 256 columns by bytes a step
    (8192, 60, 2048, 1408, torch.bfloat16, ("wgmma", 256, 16, 6, 132)),
    (8192, 60, 1408, 2048, torch.bfloat16, ("wgmma", 256, 11, 8, 132)),
    (4096, 8, 4096, 14336, torch.bfloat16, ("wgmma", 256, 32, 56, 132)),
    (4096, 8, 14336, 4096, torch.float16, ("wgmma", 256, 112, 16, 132)),
    # one 128-column tile (256) against one of 256 (384): 128; a block a
    # tile, whatever the rows an expert
    (20, 4, 40, 24, torch.bfloat16, ("wgmma", 128, 1, 1, 4)),
    (20, 3, 40, 24, torch.bfloat16, ("wgmma", 128, 1, 1, 3)),
    (768, 3, 40, 24, torch.bfloat16, ("wgmma", 128, 1, 1, 3)),
    (20, 4, 40, 24, torch.float32, ("f32", 64, 1, 1, 4)),
])
def test_wgrad_plan_at_the_served_shapes(R, E, K, N, dtype, want):
    plan = gg.wgrad_plan(R, E, K, N, dtype, 132)
    assert tuple(plan) == want


#: dX's shapes: (R, E, dX's columns = the forward's K) at phase 32 (b)'s
#: Qwen1.5-MoE-A2.7B (2 x 1024 tokens top-4 over 60) gate / up and down,
#: and Mixtral-8x7B's expert product (2048 tokens top-2 over 8)
DGRAD_SHAPES = [(8192, 60, 2048, (128, "wgmma", 256, 8)),
                (8192, 60, 1408, (128, "wgmma", 256, 6)),
                (4096, 8, 4096, (128, "wgmma", 256, 16)),
                (4096, 8, 14336, (128, "wgmma", 256, 56)),
                (64, 60, 2048, (16, "mma", 128, 16)),
                (300, 6, 136, (64, "wgmma", 256, 1))]


@pytest.mark.parametrize("R,E,N,want", DGRAD_SHAPES)
def test_dgrad_plan_routes_and_slots_cover_every_split(R, E, N, want):
    """dX takes the forward's plan for R rows over E experts into its K
    columns: the route and tiles above, and slots holding every tile of
    any split of R rows over E experts (each tile once in the walk)."""
    plan = gg.grouped_plan(R, E, N, torch.bfloat16, 132)
    assert (plan.bm, plan.route, plan.bn, plan.col_tiles) == want
    rng = np.random.default_rng(R + E + N)
    for _ in range(10):
        cuts = np.sort(rng.integers(0, R + 1, E - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [R]]))
        real = _tiles(sizes, plan.bm) * plan.col_tiles
        assert real <= plan.tiles * plan.col_tiles
        if plan.route == "wgmma":
            o = np.concatenate([[0], np.cumsum(sizes)]).tolist()
            walk, _, _ = _wgmma_walk(o, plan)
            assert sum(len(t) for t in walk.values()) == real


@pytest.mark.parametrize("sizes,K,N,sms", [
    ((0, 1, 64, 0, 230, 7, 0), 200, 136, 5),      # 64-row tiles
    ((0, 0, 300, 0, 129), 72, 264, 132),          # 128-row tiles
])
def test_dgrad_walk_emulation_equals_plain_and_jax(sizes, K, N, sms):
    """dX = dy @ w_e^T on the wgmma route's walk (the forward's, w read in
    place as its transpose: K-major weight boxes of 64 output columns x
    64 of the reduction) equals the plain version and the VJP of
    ``jax.lax.ragged_dot``."""
    rng = np.random.default_rng(sum(sizes) + K + N)
    R, E = sum(sizes), len(sizes)
    x = rng.standard_normal((R, K)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    dy = rng.standard_normal((R, N)).astype(np.float32)
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(
        np.int32))
    plan = gg.grouped_plan(R, E, K, torch.bfloat16, sms)
    assert plan.route == "wgmma"
    wt = torch.from_numpy(w).transpose(1, 2)      # [E, N, K] read as w^T
    dx, written, read, _ = _emulate_wgmma(torch.from_numpy(dy), wt, off,
                                          plan)
    assert written.eq(1).all()
    assert read == {e for e, n in enumerate(sizes) if n}
    plain = gg.ragged_dot_dgrad(torch.from_numpy(dy), torch.from_numpy(w),
                                off)
    np.testing.assert_allclose(dx.numpy(), plain.numpy(), atol=1e-4,
                               rtol=1e-5)
    jdx, _ = _jax_vjp(x, w, sizes, dy)
    np.testing.assert_allclose(dx.numpy(), jdx, atol=1e-4, rtol=1e-5)
