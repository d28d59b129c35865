"""Port parity: the port's paged attention (plain version, CPU) against the
JAX package's ``flash_paged_attention`` run in Pallas interpret mode.

Inputs are made once with numpy from a seed and handed to both. fp32
throughout; the tolerance (1e-5) covers summation order only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels.paged_attention import \
    flash_paged_attention as jax_flash_paged_attention
from deepspeed_tpu_torch.ops.kernels import paged_attention as port

TOL = dict(atol=1e-5, rtol=1e-5)


def _pool(rng, nb, bs, KV, D):
    slots = (nb + 1) * bs
    return (rng.standard_normal((slots, KV * D)).astype(np.float32),
            rng.standard_normal((slots, KV * D)).astype(np.float32))


def _both(q, kp, vp, tables, start, lens, *, bs, KV, window=None):
    ref = jax_flash_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(start), jnp.asarray(lens),
        block_size=bs, sliding_window=window, num_kv_heads=KV,
        interpret=True)
    got = port.flash_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(start),
        torch.from_numpy(lens), block_size=bs, sliding_window=window,
        num_kv_heads=KV)
    return np.asarray(ref), got.numpy()


def test_decode_linear_layout_matches_grouped_kernel():
    """C = 1 and one block per sequence: the JAX side runs
    ``_decode_grouped_kernel``. Slot 2 is idle (seq_len 0 -> zeros)."""
    rng = np.random.default_rng(0)
    S, H, KV, D, bs = 4, 4, 2, 8, 16
    kp, vp = _pool(rng, S, bs, KV, D)
    tables = rng.permutation(S).astype(np.int32)[:, None]     # MAXB = 1
    lens = np.array([5, 16, 0, 9], np.int32)
    start = np.maximum(lens - 1, 0).astype(np.int32)
    q = rng.standard_normal((S, 1, H, D)).astype(np.float32)
    ref, got = _both(q, kp, vp, tables, start, lens, bs=bs, KV=KV)
    np.testing.assert_allclose(got, ref, **TOL)
    assert not np.any(got[2])


@pytest.mark.parametrize("window", [None, 3])
def test_prefill_multiblock_matches_paged_kernel(window):
    """C > 1 over a shuffled multi-block table with GQA (H=4, KV=2) and
    one idle slot: the JAX side runs ``_paged_kernel``."""
    rng = np.random.default_rng(1)
    S, C, H, KV, D, bs, nb, maxb = 2, 5, 4, 2, 8, 4, 8, 4
    kp, vp = _pool(rng, nb, bs, KV, D)
    tables = np.zeros((S, maxb), np.int32)
    tables[0, :4] = rng.permutation(nb)[:4]                   # 16 tokens
    start = np.array([6, 0], np.int32)
    lens = np.array([6 + C, 0], np.int32)                     # slot 1 idle
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    ref, got = _both(q, kp, vp, tables, start, lens, bs=bs, KV=KV,
                     window=window)
    np.testing.assert_allclose(got, ref, **TOL)
    assert not np.any(got[1])


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 2, 8)
    pool = torch.zeros(8, 16)
    tabs = torch.zeros(1, 2, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="alibi_slopes"):
        port.flash_paged_attention(q, pool, pool, tabs, pos, pos,
                                   block_size=4, num_kv_heads=2,
                                   alibi_slopes=torch.ones(3))   # not [H]
    with pytest.raises(ValueError):
        port.paged_decode(q, pool, pool, tabs, pos, pos, block_size=4,
                          sm_scale=1.0, num_kv_heads=2)       # C != 1
    with pytest.raises(ValueError):
        port.flash_paged_attention(q, pool, pool, tabs, pos, pos,
                                   block_size=3, num_kv_heads=2)


def test_cpu_path_counts_no_launch():
    port.reset_launch_counts()
    q = torch.randn(1, 1, 2, 8)
    pool = torch.randn(8, 16)
    tabs = torch.zeros(1, 1, dtype=torch.int32)
    out = port.flash_paged_attention(
        q, pool, pool, tabs, torch.zeros(1, dtype=torch.int32),
        torch.ones(1, dtype=torch.int32), block_size=4, num_kv_heads=2)
    assert out.shape == q.shape
    assert port.LAUNCHES == {"paged_prefill": 0, "paged_decode": 0}
