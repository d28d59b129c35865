"""The launch plans of the redesigned norm kernel and group quantizer, and
plain emulations of their order of work against the JAX package's Pallas
kernels (interpret mode), on the CPU.

- ``normalization.norm_plan``: the route by shape (the rows route for
  16-byte rows whose f32 weights fit in shared memory, else the scalar
  route), the launch limits the C entry checks, every vector of a row
  owned by one lane once, every row by one team once under the
  persistent grid-stride walk, and the choices ``chip_smoke.py
  --norm-sweep`` timed fastest at the served shapes.
- ``quantization.quant_plan``: the route by shape (the vector route for
  groups of 2^k 16-byte vectors, k <= 8), every group, and every element
  of the ragged tail, owned once under the tile walk.
- Emulations (numpy float32) of the rows route's sums -- each lane its
  columns in order (squares by fma), the xor-shuffle tree, the team's
  warps in order -- and of the vector route's codes -- the product by the
  reciprocal (correctly rounded here; the kernel's MUFU reciprocal is
  within 1 ulp of it, inside the guard's margin), the IEEE quotient only
  near a half-integer -- held against ``_ln_kernel`` / ``_rms_kernel`` /
  ``_quant_kernel`` / ``_quant_asym_kernel``. Tolerances: norms in fp32
  within 1e-6 of the largest output magnitude (both take f32 statistics
  and differ in summation order, and the kernel's rsqrt by 2 ulp, which
  the emulation takes as the exact reciprocal square root), bf16 equal or
  one bf16 ulp apart; the quantizer's codes, scales and zeros identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels import normalization as jn
from deepspeed_tpu.ops.kernels import quantization as jq
from deepspeed_tpu_torch.ops.kernels import normalization as nm
from deepspeed_tpu_torch.ops.kernels import quantization as qz

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16}
JDTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}


def _per_vector(dtype) -> int:
    return 16 // torch.empty((), dtype=dtype).element_size()


# ------------------------------------------------------------ norm_plan


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("ln", [True, False])
def test_norm_plan_route_and_limits(dt, ln):
    """Over hidden sizes 1-50000: the rows route exactly where a row is
    whole 16-byte vectors, the weights fit and a team of 16 warps of 16
    vectors a lane covers it; its launch inside what the
    C entry takes (a team of at most 16 warps, at most 15 teams where a
    team needs a named barrier, at most 512 threads, an instantiated
    vector count) and covering the row."""
    dtype = DTYPES[dt]
    n = _per_vector(dtype)
    for hidden in list(range(1, 600)) + list(range(600, 50001, 97)) + [
            2048, 4096, 4100, 8192, 16384, 20480, 24576, 40960]:
        p = nm.norm_plan(1000, hidden, dtype, ln)
        fits = hidden * 4 * (2 if ln else 1) <= nm.NORM_SMEM_LIMIT and \
            hidden // n <= 32 * nm.NORM_MAX_TEAM_WARPS * nm.NORM_VPLS[-1]
        assert (p.route == "rows") == (hidden % n == 0 and fits), hidden
        if p.route == "scalar":
            assert p == nm.NormPlan("scalar", 0, 0, 0, 0, 0)
            continue
        nv = hidden // n
        assert 1 <= p.wpr <= nm.NORM_MAX_TEAM_WARPS
        assert p.vpl in nm.NORM_VPLS
        assert 32 * p.wpr * p.vpl >= nv
        assert p.threads == 32 * p.wpr * p.teams <= 512
        assert p.teams >= 1 and (p.wpr == 1 or p.teams <= 15)
        assert p.smem_bytes == hidden * 4 * (2 if ln else 1)
        # the fewest warps a row at NORM_LANE_VECTORS vectors a lane
        if p.wpr > 1 and p.vpl == nm.NORM_LANE_VECTORS:
            assert 32 * (p.wpr - 1) * p.vpl < nv


@pytest.mark.parametrize("hidden", [64, 200, 2048, 4096, 4100, 8192, 16384])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_norm_plan_owns_every_vector_once(hidden, dt):
    """Lane L of a team (L < 32 wpr) takes vectors L + 32 wpr j, j < vpl,
    those below nv: each vector of the row exactly once."""
    dtype = DTYPES[dt]
    p = nm.norm_plan(10, hidden, dtype, True)
    if p.route == "scalar":
        assert hidden % _per_vector(dtype)
        return
    nv = hidden // _per_vector(dtype)
    owned = [L + 32 * p.wpr * j for L in range(32 * p.wpr)
             for j in range(p.vpl) if L + 32 * p.wpr * j < nv]
    assert sorted(owned) == list(range(nv))


@pytest.mark.parametrize("rows", [1, 7, 1000, 8192, 32768])
@pytest.mark.parametrize("grid", [1, 3, 132, 264, 5000])
def test_norm_rows_walk_owns_every_row_once(rows, grid):
    """The persistent walk: team t of block b starts at row b teams + t
    and steps by grid teams; every row once, whatever the grid the
    occupancy gives."""
    p = nm.norm_plan(rows, 2048, torch.bfloat16, True)
    grid = min(grid, -(-rows // p.teams))
    seen = []
    for b in range(grid):
        for t in range(p.teams):
            seen += range(b * p.teams + t, rows, grid * p.teams)
    assert sorted(seen) == list(range(rows))


@pytest.mark.parametrize("R,C,ln,plan", [
    (8192, 2048, True, (2, 4, 8)),      # GPT2Config.xl_1p3b's LayerNorm
    (32768, 4096, False, (4, 4, 4)),    # Llama-2-7B's RMSNorm at prefill
    (8192, 4096, True, (4, 4, 4)),
    (8192, 8192, True, (8, 4, 2)),
    (8192, 16384, True, (16, 4, 1)),
    (8192, 64, True, (1, 1, 16)),       # a warp a row, 8 lanes busy
])
def test_norm_plan_at_the_served_shapes(R, C, ln, plan):
    """bf16 at the shapes of phase 18 and LayerNorm's wider widths: 4
    vectors a lane and the fewest warps a row, the launches the
    ``--norm-sweep`` table timed fastest (within its spread)."""
    p = nm.norm_plan(R, C, torch.bfloat16, ln)
    assert p.route == "rows" and (p.wpr, p.vpl, p.teams) == plan


def test_norm_plan_refuses_what_no_launch_takes():
    with pytest.raises(ValueError, match="positive"):
        nm.norm_plan(0, 64, torch.bfloat16, True)
    with pytest.raises(ValueError, match="dtype"):
        nm.norm_plan(4, 64, torch.float64, True)


# ------------------------------------------------------ norm emulation


def _xor_tree(parts: np.ndarray) -> np.float32:
    """The warp's shuffle tree: offsets 16, 8, 4, 2, 1, every lane adding
    its partner's value (all lanes end equal; fp32 addition commutes)."""
    v = parts.astype(np.float32).copy()
    off = 16
    while off:
        v = (v + v[np.arange(32) ^ off]).astype(np.float32)
        off //= 2
    return v[0]


def _fma32(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _team_sum(row, wpr, vpl, n, term):
    """The rows route's sum of term(x) over one row: lane L of the team
    its vectors L + 32 wpr j in order, elements in order, then each warp's
    shuffle tree, then the warps in order."""
    nv = row.shape[0] // n
    warps = []
    for w in range(wpr):
        lanes = np.zeros(32, np.float32)
        for lane in range(32):
            acc = np.float32(0)
            L = w * 32 + lane
            for j in range(vpl):
                c = L + 32 * wpr * j
                if c >= nv:
                    continue
                for k in range(n):
                    acc = term(acc, row[c * n + k])
            lanes[lane] = acc
        warps.append(_xor_tree(lanes))
    s = np.float32(0)
    for v in warps:
        s = np.float32(s + v)
    return s


def _norm_emulated(x, w, b, eps, plan, n):
    """The rows route's output in f32 for x [rows, hidden] (f32 values of
    the input dtype): mean, then the centred sum of squares (LayerNorm)
    or the sum of squares (RMSNorm), each divided by hidden, the exact
    rsqrt, the epilogue's separate roundings."""
    rows, hidden = x.shape
    out = np.empty_like(x)
    for r in range(rows):
        row = x[r]
        if b is not None:
            mu = np.float32(_team_sum(row, plan.wpr, plan.vpl, n,
                                      lambda a, v: np.float32(a + v))
                            / np.float32(hidden))
            var = _team_sum(row, plan.wpr, plan.vpl, n,
                            lambda a, v: _fma32(np.float32(v - mu),
                                                np.float32(v - mu), a))
            xc = (row - mu).astype(np.float32)
        else:
            var = _team_sum(row, plan.wpr, plan.vpl, n,
                            lambda a, v: _fma32(v, v, a))
            xc = row
        var = np.float32(var / np.float32(hidden))
        rstd = np.float32(1.0 / np.sqrt(np.float64(var + np.float32(eps))))
        y = (xc * rstd).astype(np.float32) * w
        out[r] = (y + b).astype(np.float32) if b is not None else y
    return out


def _norm_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    w = (1 + 0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(6, 256), (5, 1024), (3, 2048)])
def test_norm_rows_emulation_matches_pallas(kind, dt, shape):
    """The rows route's order of work (at the plan ``norm_plan`` gives:
    a warp a row at 256, teams of 2-4 warps above) against the Pallas
    kernels in interpret mode."""
    x, w, b = _norm_inputs(shape, sum(shape))
    dtype, jdt = DTYPES[dt], JDTYPES[dt]
    xt = torch.from_numpy(x).to(dtype)
    xf = xt.float().numpy()
    ln = kind == "ln"
    plan = nm.norm_plan(shape[0], shape[1], dtype, ln)
    assert plan.route == "rows"
    eps = 1e-5 if ln else 1e-6
    got = _norm_emulated(xf, w, b if ln else None, eps, plan,
                         _per_vector(dtype))
    jx = jnp.asarray(xf).astype(jdt)
    want = (jn.fused_layer_norm(jx, jnp.asarray(w), jnp.asarray(b),
                                interpret=True) if ln else
            jn.fused_rms_norm(jx, jnp.asarray(w), interpret=True))
    want = np.asarray(want.astype(jnp.float32))
    if dt == "fp32":
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        g16 = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
        ulp = np.abs(want) * 2.0 ** -7
        assert (np.abs(g16 - want) <= np.maximum(ulp, 1e-6)).all()


# ------------------------------------------------------------ quant_plan


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_quant_plan_route_by_shape(dt):
    """The vector route exactly for groups of G = 2^k 16-byte vectors with
    G <= 256; min(G, 32) lanes a group and G / lanes vectors a lane (an
    instantiated count), 32 / lanes groups a warp tile, 4 vectors in
    flight a lane."""
    dtype = DTYPES[dt]
    n = _per_vector(dtype)
    for gs in range(1, 4200):
        p = qz.quant_plan(gs, dtype)
        g = gs // n
        vec = gs % n == 0 and g & (g - 1) == 0 and g <= 256
        assert (p.route == "vector") == vec, gs
        if not vec:
            assert p == qz.QuantPlan("scalar", 0, 0, 0, 0)
            continue
        assert p.lanes == min(g, 32) and p.lanes * p.vpl * n == gs
        assert p.vpl in qz.QUANT_VPLS
        assert p.groups_per_tile * p.lanes == 32
        assert p.tiles_in_flight == max(1, qz.QUANT_IN_FLIGHT // p.vpl)


def _vector_walk(n, gs, dtype, warps):
    """The vector route's ownership: for each (warp, step, tile in flight,
    lane, vector) the flat element range it loads. Returns a count of
    owners per group and per element index below n."""
    p = qz.quant_plan(gs, dtype)
    N = _per_vector(dtype)
    ng = -(-n // gs)
    tiles = -(-ng // p.groups_per_tile)
    U = p.tiles_in_flight
    group_owner = np.zeros(ng, int)
    elem_owner = np.zeros(ng * gs, int)
    for wid in range(warps):
        for t0 in range(wid, tiles, warps * U):
            for uu in range(U):
                for lane in range(32):
                    g = (t0 + uu * warps) * p.groups_per_tile + \
                        lane // p.lanes
                    if g >= ng:
                        continue
                    if lane % p.lanes == 0:
                        group_owner[g] += 1
                    for j in range(p.vpl):
                        i = g * gs + (lane % p.lanes + p.lanes * j) * N
                        elem_owner[i:i + N] += 1
    return group_owner, elem_owner


@pytest.mark.parametrize("n,gs,dt,warps", [
    (300 * 517, 128, "bf16", 40),     # a ragged tail, no 16-byte end
    (300 * 517, 64, "fp32", 7),
    (5000, 256, "fp16", 3),
    (4096 * 11, 512, "bf16", 16),     # 2 vectors a lane, 2 tiles in flight
    (100, 8, "bf16", 64),             # more warps than tiles
])
def test_quant_vector_walk_owns_every_group_once(n, gs, dt, warps):
    """Each group's scale is written by one lane once and each element,
    the tail's zeros included, is loaded and coded once."""
    groups, elems = _vector_walk(n, gs, DTYPES[dt], warps)
    assert (groups == 1).all() and (elems == 1).all()


# -------------------------------------------------------- quant emulation


def _codes_emulated(x, gs, bits, symmetric, lanes):
    """The vector route's arithmetic in numpy float32 for flat x (f32
    values): each segment's statistic (max and min commute, so any
    reduction order), the scale as the product by f32(1 / qmax), the
    quotient as the product by the reciprocal rounded half to even by a
    fused add of 1.5 * 2^23 (the product exact in float64), replaced by the
    rint of the IEEE quotient within 1e-3 of a half-integer, the clip; and, for 4 bits, the kernel's nibble packing."""
    n = x.shape[0]
    ng = -(-n // gs)
    g = np.zeros(ng * gs, np.float32)
    g[:n] = x
    g = g.reshape(ng, gs)
    qmax = np.float32(2 ** (bits - 1) - 1)
    if symmetric:
        recip = np.float32(1) / qmax
        scale = (np.maximum(np.abs(g).max(1), np.float32(1e-12)) * recip
                 ).astype(np.float32)
        zero = np.zeros(ng, np.float32)
        d = g
    else:
        recip = np.float32(1) / (2 * qmax)
        zero = g.min(1)
        scale = (np.maximum(g.max(1) - zero, np.float32(1e-12)) * recip
                 ).astype(np.float32)
        d = (g - zero[:, None]).astype(np.float32)
    rcp = (np.float32(1) / scale).astype(np.float32)
    prod = d.astype(np.float64) * rcp[:, None].astype(np.float64)  # exact
    m = (prod + 1.5 * 2 ** 23).astype(np.float32)
    r = (m - np.float32(1.5 * 2 ** 23)).astype(np.float32)
    near = ~(np.abs((prod - r).astype(np.float32)) < np.float32(0.499))
    exact = np.rint((d / scale[:, None]).astype(np.float32))
    q = np.where(near, exact, r)
    if not symmetric:
        q = q - qmax
    codes = np.clip(q, -qmax, qmax).astype(np.int8)
    if bits == 4:
        u = codes.astype(np.int32) & 0xF
        codes = (u[:, 0::2] | (u[:, 1::2] << 4)).astype(np.uint8).view(
            np.int8)
    return codes, scale[:, None], None if symmetric else zero[:, None], near


def _quant_input(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:256] = 0.0
    x.reshape(-1)[1000:3000] *= 40.0
    x.reshape(-1)[5000:7000] *= 1e-3
    return x


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("gs", [64, 128, 256])
def test_quant_vector_emulation_identical_to_pallas(dt, bits, symmetric, gs):
    """The vector route's codes, scales and zeros against the Pallas
    kernels in interpret mode on a ragged [333, 517] input: identical;
    and the half-integer guard is taken somewhere (the IEEE quotient is
    exercised) without deciding anything."""
    dtype = DTYPES[dt]
    assert qz.quant_plan(gs, dtype).route == "vector"
    x = _quant_input((333, 517), gs + bits)
    xt = torch.from_numpy(x).to(dtype)
    xf = xt.float().numpy().reshape(-1)
    codes, scale, zero, near = _codes_emulated(
        xf, gs, bits, symmetric, qz.quant_plan(gs, dtype).lanes)
    want = jq.quantize_blockwise(jnp.asarray(xf).astype(JDTYPES[dt]),
                                 bits=bits, group_size=gs,
                                 symmetric=symmetric, interpret=True)
    np.testing.assert_array_equal(codes, np.asarray(want.values))
    np.testing.assert_array_equal(scale, np.asarray(want.scale))
    if not symmetric:
        np.testing.assert_array_equal(zero, np.asarray(want.zero))
    assert near.any()
