"""Port parity for the fused fp6 GEMM: the port's packing (plain PyTorch)
and ``fp6_matmul``'s plain version (CPU) against the JAX package's
``fp6_gemm_pack`` / ``fp6_gemm_unpack`` and ``fp6_matmul`` run in Pallas
interpret mode, on the same numpy inputs.

The byte planes and scales must be the same bits (the packing divides by
14 truly, as the JAX package's XLA program does). The products agree
within 3e-4, the JAX test's own tolerance (``tests/unit/
test_kernels.py:727``): fp32 sums in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels import fp6_gemm as jfp6
from deepspeed_tpu_torch.ops.kernels import fp6_gemm as port

TOL = dict(atol=3e-4, rtol=3e-4)


def _w(K, N, seed=0):
    return (np.random.default_rng(seed).standard_normal((K, N)) * 0.1
            ).astype(np.float32)


@pytest.mark.parametrize("K,N", [(256, 512), (100, 40), (64, 11008),
                                 (128, 32000)])
def test_pack_and_unpack_identical_to_jax(K, N):
    """Square, unaligned (no 128-multiple tile), and Llama-2-7B's
    gate/up (N/4 = 2752) and LM-head (N/4 = 8000) widths."""
    w = _w(K, N, seed=K)
    want = jfp6.fp6_gemm_pack(jnp.asarray(w))
    got = port.fp6_gemm_pack(torch.from_numpy(w))
    assert got.bytes3.dtype == torch.uint8 and got.shape == (K, N)
    np.testing.assert_array_equal(got.bytes3.numpy(),
                                  np.asarray(want.bytes3))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(port.fp6_gemm_unpack(got).numpy(),
                                  np.asarray(jfp6.fp6_gemm_unpack(want)))
    assert got.bytes3.numel() == K * N * 6 // 8


@pytest.mark.parametrize("xshape,K,N", [
    ((24, 256), 256, 512),            # the JAX test's aligned case
    ((3, 5, 256), 256, 512),          # batched leading dims, M = 15
    ((4, 100), 100, 40),              # K and N/4 with no 128-multiple tile
    ((7, 64), 64, 11008),             # N/4 = 2752, Llama-2-7B's gate/up
])
def test_matmul_plain_matches_jax_interpret(xshape, K, N):
    fw_np = jfp6.fp6_gemm_pack(jnp.asarray(_w(K, N, seed=N)))
    x = np.random.default_rng(K).standard_normal(xshape).astype(np.float32)
    want = np.asarray(jfp6.fp6_matmul(jnp.asarray(x), fw_np, interpret=True))
    fw = port.Fp6GemmWeight(torch.from_numpy(np.array(fw_np.bytes3)),
                            torch.from_numpy(np.array(fw_np.scale)), (K, N))
    got = port.fp6_matmul(torch.from_numpy(x), fw)
    assert got.shape == (*xshape[:-1], N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        got.numpy(), port.fp6_matmul_plain(torch.from_numpy(x), fw).numpy())


def test_bf16_plain_casts_the_scaled_weight_before_the_product():
    """The scale multiplies the decoded weight in f32, the product is cast
    to x's dtype, then the matmul sums in f32: not ``(x @ codes) *
    scale``."""
    fw = port.fp6_gemm_pack(torch.from_numpy(_w(64, 128, seed=3)))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (5, 64)).astype(np.float32)).to(torch.bfloat16)
    got = port.fp6_matmul(x, fw)
    w = port.fp6_gemm_unpack(fw).to(torch.bfloat16).double()
    want = (x.double() @ w).to(torch.float32).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=2 ** -8)


def test_matmul_shapes_and_errors():
    fw = port.fp6_gemm_pack(torch.from_numpy(_w(32, 16)))
    assert port.fp6_matmul(torch.zeros(0, 32), fw).shape == (0, 16)
    with pytest.raises(ValueError):
        port.fp6_matmul(torch.zeros(2, 31), fw)
    bad = fw._replace(scale=fw.scale[:, :-1])
    with pytest.raises(ValueError, match="malformed"):
        port.fp6_matmul(torch.zeros(2, 32), bad)
    with pytest.raises(ValueError):
        port.fp6_gemm_pack(torch.zeros(4, 6))
