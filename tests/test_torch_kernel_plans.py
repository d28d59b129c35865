"""The launch plans of K2 (``paged_attention.decode_plan``) and of the fp6
GEMM (``fp6_gemm.fp6_plan``) at the shapes the port serves, and a plain
PyTorch emulation of K2's split-and-merge against the plain version.

CPU only: the plans come from shapes alone, so the launch geometry and the
coverage of every key and every K index are checked here before a card
runs them; the emulation shows that merging per-split (m, l, o) partials
in split order gives the plain version's output, empty splits and idle
slots included."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.ops.kernels import fp6_gemm as f6
from deepspeed_tpu_torch.ops.kernels import paged_attention as pa

H100_SMS = 132
GRID_X_MAX = 2 ** 31 - 1


def _phi3_width():
    return LlamaConfig(vocab_size=32064, hidden_size=3072, num_heads=32,
                       num_kv_heads=32, intermediate_size=8192,
                       num_layers=2)


# (config, sequences, block table capacity in keys) as chip_smoke.py and
# the tests serve them
DECODE_SHAPES = {
    "tinyllama_1b": (LlamaConfig.tinyllama_1b(), 16, 16 * 64),
    "llama2_7b": (LlamaConfig.llama2_7b(), 64, 640),
    "tiny": (LlamaConfig.tiny(), 4, 8 * 16),
    "phi3_width": (_phi3_width(), 4, 4 * 64),
}


def _check_decode_plan(S, KV, g, cap, sms):
    hc, splits, kps = pa.decode_plan(S, KV, g, cap, sms)
    assert hc == -(-g // pa.DEC_HEADS)
    assert kps % pa.DEC_TILE == 0 and kps >= pa.DEC_TILE
    # the splits cover [0, cap) exactly once, none wholly past it
    covered = np.zeros(cap, np.int32)
    for sp in range(splits):
        lo, hi = sp * kps, min(cap, (sp + 1) * kps)
        assert lo < hi, (S, KV, g, cap, sp)
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if splits > 1:
        assert kps >= pa.DEC_MIN_SPLIT_KEYS
    assert splits <= pa.DEC_MAX_SPLITS
    # grid (splits, KV x head chunks, S) within CUDA's limits
    assert 1 <= splits <= GRID_X_MAX
    assert KV * hc <= pa.GRID_YZ_MAX and S <= pa.GRID_YZ_MAX
    return hc, splits, kps


@pytest.mark.parametrize("name", sorted(DECODE_SHAPES))
def test_decode_plan_at_the_served_shapes(name):
    cfg, S, cap = DECODE_SHAPES[name]
    KV, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    hc, splits, kps = _check_decode_plan(S, KV, g, cap, H100_SMS)
    if name == "llama2_7b":
        # 2048 (sequence, KV head) pairs already fill the card
        assert (hc, splits) == (1, 1)
    if name == "tinyllama_1b":
        # 64 pairs do not: the context splits
        assert splits > 1


@pytest.mark.parametrize("S", [1, 16, 64, 256])
@pytest.mark.parametrize("KV,g", [(4, 8), (32, 1), (1, 32), (8, 16),
                                  (2, 33)])
@pytest.mark.parametrize("cap", [1, 63, 64, 65, 640, 1024, 8192, 32768,
                                 131072])
def test_decode_plan_covers_every_key(S, KV, g, cap):
    _check_decode_plan(S, KV, g, cap, H100_SMS)


def test_decode_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        pa.decode_plan(0, 4, 8, 1024, H100_SMS)


# the four Llama-2-7B weights as [K, N]
FP6_WEIGHTS = {"q/k/v/o_proj": (4096, 4096), "gate/up_proj": (4096, 11008),
               "down_proj": (11008, 4096), "lm_head": (4096, 32000),
               "ragged": (1000, 1040), "no 16-byte rows": (100, 40)}
FP6_MS = [1, 16, 63, 64, 65, 127, 128, 129, 333, 512, 4096, 32768]


@pytest.mark.parametrize("weight", sorted(FP6_WEIGHTS))
@pytest.mark.parametrize("M", FP6_MS)
def test_fp6_plan_at_the_served_shapes(weight, M):
    K, N = FP6_WEIGHTS[weight]
    J = N // 4
    plan = f6.fp6_plan(M, K, J, H100_SMS)
    vec = K % 8 == 0 and J % 16 == 0
    assert plan.route == ("mma" if not vec else "prefill"
                          if M > f6.FP6_DECODE_MAX_M else "decode")
    gx, gy, gz = plan.grid
    assert gx <= GRID_X_MAX and gy <= f6.GRID_YZ_MAX \
        and gz <= f6.GRID_YZ_MAX
    assert plan.block <= 1024
    assert gy == -(-J // f6.SK_JT)
    assert plan.mt in ((1, 2, 4) if plan.route == "prefill" else (1, 2))
    # no block more than half empty, but for a single 64-row tile
    assert plan.mt == 1 or M > f6.SK_BM * plan.mt // 2
    assert gz * f6.SK_BM * plan.mt >= M > (gz - 1) * f6.SK_BM * plan.mt
    assert plan.block == (256 if plan.route == "mma" or plan.mt == 1
                          else 512)
    if plan.ks > 1 and plan.route != "mma":
        # a split's blocks wait for each other: one wave holds them all
        # (two blocks an SM at one row tile, one otherwise)
        assert gx * gy * gz <= (2 if plan.mt == 1 else 1) * H100_SMS
    # K split into ks ranges of kps (a multiple of the 64-deep step)
    # covering each index exactly once, at most 8 of them (the mma.sync
    # kernel's ranges one cluster)
    assert gx == plan.ks and 1 <= plan.ks <= f6.SK_MAX_CLUSTER
    assert plan.kps % f6.SK_BK == 0
    covered = np.zeros(K, np.int32)
    for r in range(plan.ks):
        lo, hi = r * plan.kps, min(K, (r + 1) * plan.kps)
        assert lo < hi, (M, K, r)
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_fp6_plan_splits_k_at_decode():
    """At M = 64 the narrow projections split K so that the grid fills
    one wave of two blocks an SM (it held 32 to 86 blocks before) and no
    more (a second wave of a few blocks would double the time)."""
    for K, N in ((4096, 4096), (11008, 4096), (4096, 11008)):
        plan = f6.fp6_plan(64, K, N // 4, H100_SMS)
        gx, gy, gz = plan.grid
        assert plan.route == "decode" and plan.ks > 1
        assert H100_SMS <= gx * gy * gz <= 2 * H100_SMS, (K, N, plan)


# the launch that read fastest of every one the wgmma kernel takes, (row
# tiles, K ranges), in a CUDA graph on an H100 80GB HBM3 at 700 W
# (``chip_smoke.py --fp6-sweep``), from M = 128 across the route
# threshold to 4096
FP6_SWEEP_BEST = {
    "q/k/v/o_proj": {128: (2, 4), 129: (4, 4), 192: (4, 4), 256: (4, 4),
                     384: (4, 2), 512: (4, 2), 768: (4, 1), 1024: (4, 1),
                     1536: (4, 1), 2048: (4, 1), 4096: (4, 1)},
    "gate/up_proj": {128: (2, 1), 129: (1, 1), 192: (1, 1), 256: (4, 1),
                     384: (2, 1), 512: (4, 1), 768: (4, 1), 1024: (4, 1),
                     1536: (4, 1), 2048: (4, 1), 4096: (4, 1)},
    "down_proj": {128: (2, 4), 129: (4, 4), 192: (4, 4), 256: (4, 4),
                  384: (4, 2), 512: (4, 2), 768: (4, 1), 1024: (4, 1),
                  1536: (4, 1), 2048: (4, 1), 4096: (4, 1)},
}


@pytest.mark.parametrize("weight", sorted(FP6_SWEEP_BEST))
def test_fp6_plan_picks_the_fastest_measured_launch(weight):
    """Across the route threshold and through prefill chunks (M = 128 to
    4096) the plan's model of the card picks the launch that read fastest
    on it: before, every M > 128 took 256-row tiles without a K split,
    and at M = 129-512 left 68-100 of 132 SMs idle on q/k/v/o and
    down_proj (4.0x and 4.6x torch.matmul at M = 129 in the sweep)."""
    K, N = FP6_WEIGHTS[weight]
    for M, best in FP6_SWEEP_BEST[weight].items():
        plan = f6.fp6_plan(M, K, N // 4, H100_SMS)
        assert (plan.mt, plan.ks) == best, (M, plan)


# ---------------------------------------------- K2's split-and-merge


def _split_merge(q, kp, vp, tables, start, lens, *, block_size, sm_scale,
                 window, KV, splits, kps):
    """K2's function computed split by split in plain PyTorch: per split,
    fp32 scores over its live keys, m = the split's max, l = the sum of
    exp(s - m) taken before p is cast to the pool dtype, o = cast p . V
    (unnormalised); an empty split gives (-inf, 0, 0). The splits merge in
    split order: m = max m_i, l = sum l_i e^(m_i - m), o = sum o_i
    e^(m_i - m) / l, zeros where l == 0."""
    S, C, H, D = q.shape
    g = H // KV
    bs = block_size
    T = tables.shape[1] * bs
    j = torch.arange(T)
    rows = tables.long()[:, j // bs] * bs + j % bs
    k = kp[rows].reshape(S, T, KV, D).float()
    v = vp[rows].reshape(S, T, KV, D).float()
    qg = q.float().reshape(S, KV, g, D)
    out = torch.zeros(S, KV, g, D)
    for s in range(S):
        pos = int(start[s])
        hi = max(0, min(int(lens[s]), T, pos + 1))
        lo = min(max(0, pos - window + 1), hi) if window else 0
        parts = []
        for sp in range(splits):
            a, b = max(lo, sp * kps), min(hi, (sp + 1) * kps)
            if a >= b:
                parts.append((torch.full((KV, g), float("-inf")),
                              torch.zeros(KV, g), None))
                continue
            sc = torch.einsum("kgd,tkd->kgt", qg[s], k[s, a:b]) * sm_scale
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            l_ = p.sum(-1)
            p = p.to(vp.dtype).float()
            parts.append((m, l_, torch.einsum("kgt,tkd->kgd", p,
                                              v[s, a:b])))
        mm = torch.stack([m for m, _, _ in parts]).amax(0)
        ll, oo = torch.zeros(KV, g), torch.zeros(KV, g, D)
        for m, l_, o in parts:
            if o is None:              # an empty split adds nothing
                continue
            w = torch.exp(m - mm)
            ll += l_ * w
            oo += o * w[..., None]
        out[s] = torch.where(ll[..., None] == 0, torch.zeros_like(oo),
                             oo / torch.where(ll == 0, 1.0, ll)[..., None])
    return out.reshape(S, 1, H, D).to(q.dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("window", [None, 150])
@pytest.mark.parametrize("bs,maxb", [(16, 32), (512, 1)])
def test_split_merge_emulation_matches_plain(dtype, tol, window, bs, maxb):
    """Contexts of 1, 63, 64, 65 and 512 keys and an idle slot, split as
    decode_plan splits them on a small card (so that several splits, some
    empty, some cut by the window, arise); the merge against
    paged_attention_plain within K2's limits (bf16 8e-3 max-abs and 2**-8
    of the norm; fp32 1e-5 here, where only the sum order differs)."""
    rng = np.random.default_rng(7)
    H, KV, D = 8, 2, 32
    lens = np.array([1, 63, 64, 65, 512, 0], np.int32)
    S = len(lens)
    cap = maxb * bs
    nb = S * cap // bs
    tables = np.zeros((S, maxb), np.int32)
    perm = rng.permutation(nb)
    for s in range(S):
        tables[s] = perm[s * maxb:(s + 1) * maxb]
    slots = (nb + 1) * bs
    kp = torch.from_numpy(rng.standard_normal((slots, KV * D)).astype(
        np.float32)).to(dtype)
    vp = torch.from_numpy(rng.standard_normal((slots, KV * D)).astype(
        np.float32)).to(dtype)
    q = torch.from_numpy(rng.standard_normal((S, 1, H, D)).astype(
        np.float32)).to(dtype)
    start = torch.from_numpy(np.maximum(lens - 1, 0))
    lens_t = torch.from_numpy(lens)
    tables_t = torch.from_numpy(tables)
    _, splits, kps = pa.decode_plan(S, KV, H // KV, cap, sms=4)
    assert splits > 1
    kw = dict(block_size=bs, sm_scale=D ** -0.5)
    got = _split_merge(q, kp, vp, tables_t, start, lens_t, window=window,
                       KV=KV, splits=splits, kps=kps, **kw)
    ref = pa.paged_attention_plain(q, kp, vp, tables_t, start, lens_t,
                                   sliding_window=window, num_kv_heads=KV,
                                   **kw)
    assert not got[lens == 0].any(), "idle slot must emit zeros"
    assert torch.isfinite(got.float()).all()
    diff = got.float() - ref.float()
    assert diff.abs().max().item() <= tol
    assert (diff.norm() / ref.float().norm()).item() <= 2.0 ** -8


# ------------------------------------------- the Evoformer kernel's plan

from deepspeed_tpu_torch.ops.kernels import evoformer as ev  # noqa: E402

# AlphaFold 2 fine-tuning (chip_smoke.py phase 21): MSA row attention with
# pair bias and triangle attention, as (B, N, S, H, D)
EVO_MSA, EVO_TRI = (1, 512, 384, 8, 32), (1, 384, 384, 4, 32)
#: an H100 SM's shared memory, and what the runtime keeps of it a block
SM_SMEM, BLOCK_RESERVED = 233472, 1024


@pytest.mark.parametrize("D", ev.KERNEL_HEAD_DIMS)
def test_evo_plan_rows_a_block(D):
    """Two MSA rows a block at every head dim: one warp set each."""
    plan = ev.evo_plan(D, 1, 512, 8, 384, 384)
    assert plan.rows == ev.EVO_ROWS == 2
    assert plan.groups == 256


@pytest.mark.parametrize("N", [1, 2, 5, 384, 512, 513])
@pytest.mark.parametrize("B,H,Sq", [(1, 4, 40), (2, 3, 300), (1, 8, 384)])
def test_evo_plan_covers_every_row_once(N, B, H, Sq):
    """Each (b, n, h, query tile) belongs to exactly one block's warp set;
    the sets past N in the last group (an N tail) own nothing."""
    plan = ev.evo_plan(32, B, N, H, Sq, Sq)
    nqt, gh, gz = plan.grid
    assert nqt == -(-Sq // ev.EVO_TILE) and gh == H
    assert gz == B * plan.groups <= 65535
    owned = np.zeros((B, N, H, nqt), np.int32)
    tail = 0
    for qt in range(nqt):
        for h in range(H):
            for z in range(gz):
                b, grp = divmod(z, plan.groups)
                for ws in range(plan.rows):
                    n = grp * plan.rows + ws
                    if n < N:
                        owned[b, n, h, qt] += 1
                    else:
                        tail += 1
    assert (owned == 1).all()
    assert tail == (plan.groups * plan.rows - N) * B * H * nqt


@pytest.mark.parametrize("shape", [EVO_MSA, EVO_TRI, (1, 64, 300, 8, 32),
                                   (1, 16, 130, 4, 64), (1, 128, 1024, 4, 32),
                                   (1, 128, 1024, 4, 64),
                                   (1, 128, 1024, 4, 16)])
def test_evo_plan_shared_memory_fits(shape):
    """At most 227 KB a block at the AlphaFold shapes and at Sk = 1024 (the
    key loop streams tiles: nothing grows with Sk), and two blocks an SM
    at head dims 16 and 32."""
    B, N, S, H, D = shape
    plan = ev.evo_plan(ev.kernel_head_dim(D), B, N, H, S, S)
    assert plan.smem_bytes <= ev.SMEM_LIMIT
    assert plan.smem_bytes == ev.evo_plan(ev.kernel_head_dim(D), B, N, H,
                                          S, 64).smem_bytes
    if D <= 32:
        assert 2 * (plan.smem_bytes + BLOCK_RESERVED) <= SM_SMEM


def test_evo_plan_pair_bias_crosses_l2_once_a_row_group():
    """The MSA shape's f32 pair bias [1, 8, 384, 384] (4.72 MB) is read
    once per two MSA rows: 1.21 GB a call where one row a block read 2.42
    GB."""
    B, N, S, H, D = EVO_MSA
    plan = ev.evo_plan(D, B, N, H, S, S)
    assert plan.pair_bias_bytes == B * H * S * S * 4 * (N // 2)
    assert abs(plan.pair_bias_bytes - 1.208e9) < 1e6
    with pytest.raises(ValueError):
        ev.evo_plan(48, B, N, H, S, S)
