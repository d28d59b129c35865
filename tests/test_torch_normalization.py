"""Port parity for the fused norms: ``fused_rms_norm`` / ``fused_layer_norm``
of the port (plain versions, CPU) against the JAX package's, whose Pallas
kernels run in interpret mode, on the same numpy inputs; and the port's
backward (the JAX package's hand-written VJP in plain PyTorch) against
``jax.grad`` of the JAX functions.

Tolerances: fp32 forward within 1e-6 of the largest output magnitude
(both take f32 statistics; the sums differ in order); bf16 forward equal
or one bf16 ulp apart (the same f32 values round to the same or a
neighbouring bf16); gradients of x, w and b within 1e-5 of the largest
gradient magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels import normalization as jn
from deepspeed_tpu_torch.ops.kernels import normalization as nm

SHAPES = [(64, 256), (48, 192), (2, 24, 256), (37, 96)]   # last: ragged rows


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    hidden = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    w = (1 + 0.2 * rng.standard_normal(hidden)).astype(np.float32)
    b = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, g


def _run(kind, x, w, b, dtype):
    jx = jnp.asarray(x).astype(dtype[0])
    tx = torch.from_numpy(x).to(dtype[1])
    if kind == "rms":
        want = jn.fused_rms_norm(jx, jnp.asarray(w), interpret=True)
        got = nm.fused_rms_norm(tx, torch.from_numpy(w))
    else:
        want = jn.fused_layer_norm(jx, jnp.asarray(w), jnp.asarray(b),
                                   interpret=True)
        got = nm.fused_layer_norm(tx, torch.from_numpy(w),
                                  torch.from_numpy(b))
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_f32_matches_jax(kind, shape):
    x, w, b, _ = _inputs(shape, 0)
    want, got = _run(kind, x, w, b, (jnp.float32, torch.float32))
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-6 * np.abs(want).max(), err


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_bf16_matches_jax(kind, shape):
    x, w, b, _ = _inputs(shape, 1)
    want, got = _run(kind, x, w, b, (jnp.bfloat16, torch.bfloat16))
    assert got.shape == want.shape
    diff = np.abs(got - want)
    # equal, or one bf16 ulp apart (2**-7 of the magnitude bounds it)
    assert (diff <= 2.0 ** -7 * np.abs(want)).all(), diff.max()
    assert (diff == 0).mean() > 0.97


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_jax_grad(kind, shape):
    x, w, b, g = _inputs(shape, 2)
    jg = jnp.asarray(g)
    if kind == "rms":
        f = lambda x, w, b: jnp.sum(                           # noqa: E731
            jn.fused_rms_norm(x, w, interpret=True) * jg)
    else:
        f = lambda x, w, b: jnp.sum(                           # noqa: E731
            jn.fused_layer_norm(x, w, b, interpret=True) * jg)
    want = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out = (nm.fused_rms_norm(tx, tw) if kind == "rms"
           else nm.fused_layer_norm(tx, tw, tb))
    (out * torch.from_numpy(g)).sum().backward()
    names = ("x", "w", "b") if kind == "ln" else ("x", "w")
    for name, wg, t in zip(names, want, (tx, tw, tb)):
        wg = np.asarray(wg)
        err = np.abs(t.grad.numpy() - wg).max()
        assert err <= 1e-5 * np.abs(wg).max(), (name, err)
    if kind == "rms":
        assert tb.grad is None


def test_cpu_path_counts_no_launch_and_checks_shapes():
    nm.reset_launch_counts()
    x = torch.randn(4, 8)
    nm.fused_rms_norm(x, torch.ones(8))
    nm.fused_layer_norm(x, torch.ones(8), torch.zeros(8))
    assert nm.LAUNCHES == {"rms_norm": 0, "layer_norm": 0}
    with pytest.raises(ValueError, match="weight"):
        nm.fused_rms_norm(x, torch.ones(9))
    with pytest.raises(ValueError, match="bias"):
        nm.fused_layer_norm(x, torch.ones(8), torch.zeros(7))
