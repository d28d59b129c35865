"""Port parity for the fused LM-head cross-entropy on the CPU: the port's
plain path (``deepspeed_tpu_torch/ops/kernels/fused_xent.py``) against the
JAX package's Pallas kernels run in interpret mode (token_block 16,
vocab_block 128, so the JAX side pads both axes), on numpy-seeded inputs.

The cases are those of ``tests/unit/test_kernels.py::TestFusedXent``:
ragged N and V, ``ignore_index``, out-of-range ids (one inside the padded
vocab tile, one beyond it), z-loss and label smoothing. Tolerance: fp32
1e-5 (relative and absolute; only the summation order differs); bf16
inputs as stated in their test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels import fused_xent as jax_fx
from deepspeed_tpu_torch.models._lm_utils import lm_head_xent
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.ops.kernels import fused_xent as fx

BLOCKS = dict(token_block=16, vocab_block=128)


def _data(B=2, T=24, C=64, V=300, seed=0):
    rng = np.random.RandomState(seed)
    h = (rng.randn(B, T, C) * 0.5).astype(np.float32)
    emb = (rng.randn(V, C) * 0.2).astype(np.float32)
    tgt = rng.randint(0, V, size=(B, T)).astype(np.int32)
    return h, emb, tgt


def _jax(h, emb, tgt, **kw):
    """JAX loss and (dh, dE) in interpret mode."""
    f = lambda a, b: jax_fx.fused_lm_xent(a, b, jnp.asarray(tgt),  # noqa
                                          interpret=True, **BLOCKS, **kw)
    loss, (dh, de) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(emb))
    return float(loss), np.asarray(dh, np.float32), np.asarray(de, np.float32)


def _port(h, emb, tgt, dtype=torch.float32, **kw):
    th = torch.tensor(h).to(dtype).requires_grad_()
    te = torch.tensor(emb).to(dtype).requires_grad_()
    loss = fx.fused_lm_xent(th, te, torch.from_numpy(tgt), **BLOCKS, **kw)
    loss.backward()
    return (loss.item(), th.grad.float().numpy(), te.grad.float().numpy())


def _bad_ids(tgt, V):
    bad = np.zeros(tgt.shape, bool)
    bad[0, 2] = bad[0, 11] = bad[1, 0] = True
    return np.where(bad, np.array([[V + 5] * tgt.shape[1],
                                   [7000] * tgt.shape[1]]), tgt).astype(
        np.int32)


def _ignored(tgt):
    t = tgt.copy()
    t[0, 3:7] = -100
    t[1, -5:] = -100
    return t


CASES = {
    "plain": (dict(), {}),
    "ragged_n": (dict(T=19), {}),
    "ignore_index": (dict(T=20), dict(ignore_index=-100)),
    "out_of_range": (dict(T=20), {}),
    "z_loss": (dict(), dict(z_loss=1e-2)),
    "label_smoothing": (dict(), dict(label_smoothing=0.1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_xent_loss_and_grads_match_jax(case):
    shape, kw = CASES[case]
    h, emb, tgt = _data(**shape)
    if case == "ignore_index":
        tgt = _ignored(tgt)
    if case == "out_of_range":
        tgt = _bad_ids(tgt, emb.shape[0])
    jl, jdh, jde = _jax(h, emb, tgt, **kw)
    tl, tdh, tde = _port(h, emb, tgt, **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tdh, jdh, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tde, jde, rtol=1e-5, atol=1e-5)
    if case in ("ignore_index", "out_of_range"):
        dropped = (tgt < 0) | (tgt >= emb.shape[0])
        assert np.abs(tdh[dropped]).max() == 0.0


def test_forward_plain_matches_the_pallas_forward():
    """``fused_xent_fwd_plain`` against the Pallas ``_fwd`` (interpret)
    row by row: lse, the target logit read before the vocab mask (0 for
    an id in the padded tile [V, 384) or beyond it) and the sum of the
    real vocabulary's logits (label smoothing on, so it is computed)."""
    h, emb, tgt = _data(T=16)
    t = _bad_ids(tgt, emb.shape[0]).reshape(-1)
    h2 = h.reshape(-1, h.shape[-1])
    jl, jt, js = jax_fx._fwd(jnp.asarray(h2), jnp.asarray(emb),
                             jnp.asarray(t), Tb=16, Vb=128, eps=0.1,
                             interpret=True)
    tl, tt, ts = fx.fused_xent_fwd_plain(torch.tensor(h2), torch.tensor(emb),
                                         torch.from_numpy(t))
    for got, want in ((tl, jl), (tt, jt), (ts, js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert (tt.numpy()[(t < 0) | (t >= emb.shape[0])] == 0).all()


def test_bf16_inputs_match_jax():
    """bf16 h and E: the same bf16 operands, fp32 logits and fp32 sums on
    both sides, P' cast to bf16 before both products; the loss within
    1e-5 relative, the bf16 gradients within one bf16 ulp (2^-8 relative)
    of the largest element."""
    h, emb, tgt = _data(T=19)
    hb = np.asarray(jnp.asarray(h, jnp.bfloat16).astype(jnp.float32))
    eb = np.asarray(jnp.asarray(emb, jnp.bfloat16).astype(jnp.float32))
    f = lambda a, b: jax_fx.fused_lm_xent(  # noqa: E731
        a, b, jnp.asarray(tgt), interpret=True, **BLOCKS)
    jl, (jdh, jde) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(hb, jnp.bfloat16), jnp.asarray(eb, jnp.bfloat16))
    tl, tdh, tde = _port(hb, eb, tgt, dtype=torch.bfloat16)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    for got, want in ((tdh, jdh), (tde, jde)):
        want = np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("head_layout", ["vc", "cv"])
def test_lm_head_xent_routes_fused(head_layout):
    """``lm_head_xent`` with ``xent_impl="fused"`` and an ignore id, for
    the tied [V, C] head and a [C, V] Dense kernel (one transposed copy),
    against the JAX kernels on the same head."""
    h, emb, tgt = _data(T=20)
    tgt = _ignored(tgt)
    head = emb if head_layout == "vc" else np.ascontiguousarray(emb.T)
    jl, jdh, jde = _jax(h, emb, tgt, ignore_index=-100)
    cfg = GPT2Config.tiny(xent_impl="fused", xent_ignore_index=-100)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(head, requires_grad=True)
    loss = lm_head_xent(th, tw, torch.from_numpy(tgt), cfg,
                        head_layout=head_layout)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), jdh, rtol=1e-5, atol=1e-5)
    want = jde if head_layout == "vc" else jde.T
    np.testing.assert_allclose(tw.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    fx.reset_launch_counts()
    h, emb, tgt = _data(T=8)
    _port(h, emb, tgt)
    assert fx.LAUNCHES == {"xent_fwd": 0, "xent_bwd_dh": 0,
                           "xent_bwd_de": 0}
    with pytest.raises(ValueError):
        fx.fused_lm_xent(torch.tensor(h), torch.tensor(emb),
                         torch.from_numpy(tgt), token_block=0)
    with pytest.raises(ValueError):
        fx.xent_fwd(torch.zeros(4, 8), torch.zeros(5, 6),
                    torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        fx.xent_bwd_dh(torch.ones(1), torch.zeros(4, 8), torch.zeros(5, 8),
                       torch.zeros(4, dtype=torch.int32), torch.zeros(3),
                       ignore=None, z=0.0, eps=0.0)
