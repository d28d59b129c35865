"""Port parity for block-sparse attention: the sparsity configs' layouts,
the layout coarsening, the masked path (``impl="xla"``) and the
block-sparse flash path (``impl="flash"``, whose CPU path is the kernel's
plain version) against the JAX package's, the latter with its Pallas
kernel in interpret mode, on the same numpy inputs.

Tolerances: layouts and coarsened layouts identical; the masked path fp32
within 1e-5 max-abs; the flash path within 2e-5 max-abs (the JAX kernel
takes an online softmax over 128-key blocks, the plain version one
softmax over the row: fp32 rounding apart)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.kernels import flash_attention_sparse as jfas
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa


def _configs(pkg, seed):
    """(name, config) pairs covering every config class and option."""
    return [
        ("base", pkg.SparsityConfig(4)),
        ("dense", pkg.DenseSparsityConfig(4, block=16)),
        ("fixed-bi", pkg.FixedSparsityConfig(
            4, block=16, num_local_blocks=4, num_global_blocks=1,
            horizontal_global_attention=True)),
        ("fixed-uni", pkg.FixedSparsityConfig(
            4, block=16, different_layout_per_head=True, num_local_blocks=3,
            num_global_blocks=1, attention="unidirectional",
            num_different_global_patterns=2)),
        ("variable-bi", pkg.VariableSparsityConfig(
            4, block=16, num_random_blocks=2, local_window_blocks=[2, 3],
            global_block_indices=[0, 5], global_block_end_indices=[2, 7],
            horizontal_global_attention=True, seed=seed)),
        ("variable-uni", pkg.VariableSparsityConfig(
            4, block=16, different_layout_per_head=True, num_random_blocks=1,
            attention="unidirectional", seed=seed)),
        ("bigbird-bi", pkg.BigBirdSparsityConfig(
            4, block=16, different_layout_per_head=True, num_random_blocks=2,
            seed=seed)),
        ("bigbird-uni", pkg.BigBirdSparsityConfig(
            4, block=16, num_random_blocks=1, attention="unidirectional",
            seed=seed)),
        ("longformer-bi", pkg.BSLongformerSparsityConfig(
            4, block=16, num_sliding_window_blocks=3,
            global_block_indices=[0, 9])),
        ("longformer-uni", pkg.BSLongformerSparsityConfig(
            4, block=16, different_layout_per_head=True,
            global_block_indices=[2], global_block_end_indices=[4],
            attention="unidirectional")),
    ]


CONFIG_NAMES = [n for n, _ in _configs(sa, 0)]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_layouts_identical_to_jax(name, seed):
    port = dict(_configs(sa, seed))[name]
    ref = dict(_configs(jsa, seed))[name]
    for seq in (256, 400):
        a, b = port.make_layout(seq), ref.make_layout(seq)
        assert a.dtype == b.dtype and a.shape == b.shape, (name, seq)
        np.testing.assert_array_equal(a, b, err_msg=f"{name} seq={seq}")
    with pytest.raises(ValueError, match="divisible"):
        port.setup_layout(250)


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_coarsening_identical_to_jax(name):
    layout = dict(_configs(sa, 3))[name].make_layout(256)
    for to in (32, 64, 128):
        np.testing.assert_array_equal(sa.coarsen_layout(layout, 16, to),
                                      jsa.coarsen_layout(layout, 16, to))
        assert sa.coarsening_is_exact(layout, 16, to) == \
            jsa.coarsening_is_exact(layout, 16, to)
    np.testing.assert_array_equal(sa.coarsen_layout(layout, 256, 128),
                                  jsa.coarsen_layout(layout, 256, 128))
    with pytest.raises(ValueError, match="multiple"):
        sa.coarsen_layout(layout, 16, 40)


def _qkv(rng, shape, n=3):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("name", ["fixed-uni", "bigbird-bi",
                                  "variable-bi", "longformer-uni"])
def test_masked_path_matches_jax(name):
    """``impl="xla"`` (the JAX package's default and name) and
    ``SparseSelfAttention`` against the JAX package's, with gradients of
    the port's path finite (it is the differentiable one)."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, (2, 4, 256, 32))
    port_cfg = dict(_configs(sa, 5))[name]
    jax_cfg = dict(_configs(jsa, 5))[name]
    want = np.asarray(jsa.sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jax_cfg))
    tq = torch.from_numpy(q).requires_grad_(True)
    got = sa.sparse_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                              port_cfg)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5
    got.sum().backward()
    assert torch.isfinite(tq.grad).all()
    mod = sa.SparseSelfAttention(port_cfg)
    want2 = np.asarray(jsa.SparseSelfAttention(jax_cfg)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    for _ in range(2):                                  # the cached mask
        out = mod(*(torch.from_numpy(a) for a in (q, k, v)))
        assert np.abs(out.numpy() - want2).max() <= 1e-5
    assert list(mod._layout_cache) == [(256, "cpu")]


@pytest.mark.parametrize("B,H,Hk,T,D", [
    (2, 2, 2, 384, 64),       # the JAX package's own test shape
    (1, 4, 2, 384, 32),       # GQA 4 -> 2 (the JAX wrapper repeats K/V)
    (2, 2, 1, 300, 32),       # ragged T: padded keys masked
    (1, 2, 2, 200, 64),       # ragged T, two q-blocks
])
def test_flash_plain_matches_jax_kernel(B, H, Hk, T, D):
    """``flash_attention_sparse`` on the CPU (the kernel's plain version)
    against the JAX kernel in interpret mode, BTHD and BHTD, with a query
    block that no key block reaches (zeros)."""
    rng = np.random.default_rng(T + D)
    nb = -(-T // 128)
    bm = rng.random((H, nb, nb)) < 0.6
    bm[:, 0, 0] = True
    bm[H - 1, nb - 1] = False                     # a fully masked q-block
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = _qkv(rng, (B, T, Hk, D), 2)
    want = np.asarray(jfas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bm.astype(np.int32),
        interpret=True))
    got = fa.flash_attention_sparse(*(torch.from_numpy(a) for a in (q, k, v)),
                                    bm).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-5
    assert not got[:, (nb - 1) * 128:, H - 1].any()
    got2 = fa.flash_attention_sparse(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)), bm,
        layout="BHTD", sm_scale=0.2)
    want2 = np.asarray(jfas(
        *(jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v)), bm,
        layout="BHTD", sm_scale=0.2, interpret=True))
    assert np.abs(got2.numpy() - want2).max() <= 2e-5


def test_sparse_attention_flash_impl_matches_jax():
    """``sparse_attention(impl="flash")`` and ``SparseSelfAttention(...,
    impl="flash")`` on a 128-block BigBird layout against the JAX
    package's flash impl; the masked path agrees with it too."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, (1, 2, 384, 32))
    kw = dict(num_heads=2, block=128, num_sliding_window_blocks=1,
              num_global_blocks=1)
    cfg, jcfg = sa.BigBirdSparsityConfig(**kw), jsa.BigBirdSparsityConfig(**kw)
    want = np.asarray(jsa.sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, impl="flash"))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = sa.sparse_attention(tq, tk, tv, cfg, impl="flash")
    assert np.abs(got.numpy() - want).max() <= 2e-5
    masked = sa.sparse_attention(tq, tk, tv, cfg)
    assert (got - masked).abs().max().item() <= 2e-5
    mod = sa.SparseSelfAttention(cfg, impl="flash")
    assert (mod(tq, tk, tv) - got).abs().max().item() == 0


def test_same_value_errors_as_jax():
    q = torch.zeros(1, 1, 256, 32)
    cfg = sa.FixedSparsityConfig(num_heads=1, block=16,
                                 attention="unidirectional")
    jcfg = jsa.FixedSparsityConfig(num_heads=1, block=16,
                                   attention="unidirectional")
    jq = jnp.zeros((1, 1, 256, 32))
    for call in (lambda: sa.sparse_attention(q, q, q, cfg, impl="flash"),
                 lambda: jsa.sparse_attention(jq, jq, jq, jcfg,
                                              impl="flash")):
        with pytest.raises(ValueError, match="128-block"):
            call()
    for call in (lambda: sa.sparse_attention(
            q, q, q, cfg, impl="flash",
            layout_mask=torch.ones(1, 256, 256, dtype=torch.bool)),
            lambda: jsa.sparse_attention(
                jq, jq, jq, jcfg, impl="flash",
                layout_mask=jnp.ones((1, 256, 256), bool))):
        with pytest.raises(ValueError, match="layout_mask"):
            call()
    bad = np.ones((1, 3, 2), bool)
    for call in (lambda: fa.flash_attention_sparse(q, q, q, bad,
                                                   layout="BHTD"),
                 lambda: jfas(jq, jq, jq, bad,
                                                    layout="BHTD",
                                                    interpret=True)):
        with pytest.raises(ValueError, match="block_mask shape"):
            call()
    for call in (lambda: fa.flash_attention_sparse(q, q, q, bad,
                                                   layout="TBHD"),
                 lambda: jfas(jq, jq, jq, bad,
                                                    layout="TBHD",
                                                    interpret=True)):
        with pytest.raises(ValueError, match="layout"):
            call()
    k3 = torch.zeros(1, 3, 256, 32)
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_attention_sparse(torch.zeros(1, 4, 256, 32), k3, k3,
                                  np.ones((4, 2, 2), bool), layout="BHTD")


def test_flash_backward_raises_and_counts_no_launch():
    """The flash path is forward-only, as the JAX kernel: a backward
    through it raises instead of returning the plain version's
    gradient. The CPU path launches nothing."""
    fa.reset_launch_counts()
    q = torch.randn(1, 1, 256, 32, requires_grad=True)
    o = fa.flash_attention_sparse(q, q, q, np.ones((1, 2, 2), bool),
                                  layout="BHTD")
    with pytest.raises(RuntimeError, match="forward-only"):
        o.sum().backward()
    cfg = sa.BigBirdSparsityConfig(num_heads=1, block=128)
    with pytest.raises(RuntimeError, match="forward-only"):
        sa.sparse_attention(q, q, q, cfg, impl="flash").sum().backward()
    assert fa.SPARSE_LAUNCHES == {"flash_sparse_fwd": 0}


def test_tile_lists():
    """The kernel's CSR: for each (head, q-block) the 64-key tiles of its
    allowed blocks that start below Tk, ascending; cached per mask."""
    bm = np.array([[[1, 0, 1], [0, 0, 0], [1, 1, 0]]], bool)
    row_ptr, tiles = fa.sparse_tile_csr(bm, 128, 300, "cpu")
    assert row_ptr.tolist() == [0, 3, 3, 7]
    assert tiles.tolist()[:7] == [0, 1, 4, 0, 1, 2, 3]
    again = fa.sparse_tile_csr(bm.astype(np.int32), 128, 300, "cpu")
    assert again[0] is row_ptr
    _, tiles2 = fa.sparse_tile_csr(bm, 128, 384, "cpu")
    assert tiles2.tolist()[:4] == [0, 1, 4, 5]


# ------------------------------------- fault C3: the widened sparse kernels

C3_LIMITS = {torch.float32: 2e-5, torch.bfloat16: 8e-3, torch.float16: 4e-3}


@pytest.mark.parametrize("D", [16, 48, 80, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_c3_cpu_path_matches_jax_kernel(D, dtype):
    """Fault C3: inputs the card refused before (fp16; head dims 16, 48,
    80, 96) and that the JAX package computes: the port's CPU path (the
    kernels' plain version) against the JAX kernel in interpret mode, in
    the same dtype, with GQA, a ragged T and an empty query block. fp32
    within 2e-5 (the flash path's limit above); bf16 / fp16 within the
    card's limits for the kernel against its plain version (8e-3 / 4e-3
    max-abs and 2**-8 of the norm: P is rounded to the 16-bit type against
    the JAX kernel's running max, the plain version's row max)."""
    rng = np.random.default_rng(D)
    B, H, Hk, T = 1, 4, 2, 300
    nb = -(-T // 128)
    bm = rng.random((H, nb, nb)) < 0.6
    bm[:, :, 0] = True
    bm[1, nb - 1] = False
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = _qkv(rng, (B, T, Hk, D), 2)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    want = np.array(jfas(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                         bm, interpret=True).astype(jnp.float32))
    got = fa.flash_attention_sparse(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), bm)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert not got[:, (nb - 1) * 128:, 1].any()
    diff = got.float().numpy() - want
    assert np.abs(diff).max() <= C3_LIMITS[dtype], (D, dtype)
    if dtype != torch.float32:
        assert np.linalg.norm(diff) <= 2.0 ** -8 * np.linalg.norm(want)


@pytest.mark.parametrize("D", [8, 40, 48, 72, 100, 112])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_c3_padded_head_dim_gives_the_unpadded_result(D, dtype):
    """What the card path does at a head dim without an instance: q, k, v
    zero-padded to ``sparse_head_dim(D)`` with the caller's scale, the
    extra output columns sliced away. Zero columns add exact zeros to
    every score, so the plain version gives the unpadded result (within
    fp32 rounding of the longer sums, 1e-6; the 16-bit outputs to one
    unit in the last place of their type)."""
    rng = np.random.default_rng(D + 1)
    B, H, T = 2, 2, 200
    dk = fa.sparse_head_dim(D)
    assert dk > D and dk in fa.SPARSE_HEAD_DIMS
    bm = rng.random((H, 2, 2)) < 0.7
    bm[:, :, 0] = True
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(rng, (B, H, T, D)))
    kw = dict(sm_scale=D ** -0.5)
    ref = fa.flash_attention_sparse_plain(q, k, v, bm, **kw)
    padded = fa.flash_attention_sparse_plain(
        *(torch.nn.functional.pad(t, (0, dk - D)) for t in (q, k, v)), bm,
        **kw)
    assert not padded[..., D:].any()
    got = padded[..., :D]
    ulp = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7,
           torch.float16: 2.0 ** -10}[dtype]
    tol = ulp * ref.float().abs().clamp_min(1.0)
    assert ((got.float() - ref.float()).abs() <= tol).all(), (D, dtype)
