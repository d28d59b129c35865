"""Port parity: the port's ``flash_attention`` (its plain versions, on the
CPU, under its autograd Function) against the JAX package's
``flash_attention`` with the Pallas kernels in interpret mode.

Inputs are made once with numpy from a seed and handed to both. fp32
throughout; the tolerance (1e-5) covers summation order only. The JAX side
runs 128-row tiles, so T = 200 is padded there (and masked in the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from deepspeed_tpu_torch.ops.kernels import flash_attention as port

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = {
    # name: (B, Tq, Tk, H, Hk, D, causal, return_lse)
    "causal_padded_T200": (2, 200, 200, 4, 4, 16, True, False),
    "noncausal_gqa_8to2": (1, 100, 100, 8, 2, 16, False, False),
    "causal_offset_Tq128_Tk384_gqa": (1, 128, 384, 4, 2, 16, True, False),
    "lse_cotangent_causal": (1, 64, 64, 2, 1, 8, True, True),
    "lse_cotangent_offset_noncausal": (1, 96, 160, 4, 2, 8, False, True),
}


def _inputs(seed, B, Tq, Tk, H, Hk, D):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, Tq, H, D), f(B, Tk, Hk, D), f(B, Tk, Hk, D),
            f(B, Tq, H, D), f(B, H, Tq))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_pallas_interpret(case):
    """O (and lse) and dQ/dK/dV through ``jax.vjp`` against autograd,
    BTHD layout, with an lse cotangent where lse is an output."""
    B, Tq, Tk, H, Hk, D, causal, lse = CASES[case]
    q, k, v, do, dlse = _inputs(3, B, Tq, Tk, H, Hk, D)

    def f(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, causal=causal, block_q=128,
                                   block_k=128, interpret=True,
                                   return_lse=lse)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    cts = (jnp.asarray(do), jnp.asarray(dlse)) if lse else jnp.asarray(do)
    jdq, jdk, jdv = vjp(cts)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = port.flash_attention(tq, tk, tv, causal=causal, return_lse=lse)
    if lse:
        o, l_ = got
        torch.autograd.backward([o, l_], [torch.tensor(do),
                                          torch.tensor(dlse)])
        np.testing.assert_allclose(l_.detach().numpy(), np.asarray(out[1]),
                                   **TOL)
        out = out[0]
    else:
        o = got
        o.backward(torch.tensor(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), **TOL)
    for name, g, ref in (("dq", tq.grad, jdq), ("dk", tk.grad, jdk),
                         ("dv", tv.grad, jdv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **TOL,
                                   err_msg=name)


def test_bhtd_layout_matches_bthd():
    """The BHTD layout computes the same attention as BTHD."""
    q, k, v, do, _ = _inputs(4, 1, 40, 40, 4, 2, 8)
    a = port.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    b = port.flash_attention(*(torch.from_numpy(x).transpose(1, 2)
                               for x in (q, k, v)), layout="BHTD")
    torch.testing.assert_close(a, b.transpose(1, 2), atol=0, rtol=0)


def test_plain_versions_match_jax_kernels_from_lse_and_delta():
    """The three plain versions, called directly on [B, H, T, D] tensors
    (the kernels' interface), against the JAX package's ``_fwd`` and
    ``_bwd`` (the three Pallas kernels in interpret mode)."""
    import importlib
    jfa = importlib.import_module("deepspeed_tpu.ops.kernels.flash_attention")
    B, T, H, Hk, D = 1, 128, 4, 2, 16
    q, k, v, do, _ = _inputs(5, B, T, T, H, Hk, D)
    qh, kh, vh, doh = (np.swapaxes(x, 1, 2) for x in (q, k, v, do))
    scale = D ** -0.5
    jo, jlse = jfa._fwd(*(jnp.asarray(x) for x in (qh, kh, vh)), True, scale,
                        128, 128, T, 0, True, H // Hk)
    jdq, jdk, jdv = jfa._bwd(True, scale, 128, 128, T, 0, True,
                             (jnp.asarray(qh), jnp.asarray(kh),
                              jnp.asarray(vh), jo, jlse),
                             (jnp.asarray(doh),), group=H // Hk)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (qh, kh, vh, doh)]
    o, lse = port.flash_fwd_plain(*t[:3], causal=True, sm_scale=scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **TOL)
    delta = (t[3] * o).sum(-1)
    kw = dict(causal=True, sm_scale=scale)
    dq = port.flash_bwd_dq_plain(*t, lse, delta, **kw)
    dk, dv = port.flash_bwd_dkv_plain(*t, lse, delta, **kw)
    for g, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **TOL)


def test_fully_masked_rows_give_zero_and_neg_inf_lse():
    """Tq > Tk under the bottom-right causal diagonal: the first Tq - Tk
    query rows see no key; they give O = 0, lse = -inf and zero grads."""
    q, k, v, do, _ = _inputs(6, 1, 12, 8, 2, 2, 8)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, lse = port.flash_attention(tq, tk, tv, return_lse=True)
    assert torch.all(o[:, :4] == 0) and torch.all(torch.isinf(lse[..., :4]))
    assert torch.isfinite(lse[..., 4:]).all()
    o.backward(torch.from_numpy(do))
    assert torch.all(tq.grad[:, :4] == 0)
    assert all(torch.isfinite(g).all() for g in (tq.grad, tk.grad, tv.grad))


def test_cpu_path_counts_no_launch_and_refuses_bad_input():
    port.reset_launch_counts()
    x = torch.randn(1, 8, 2, 8)
    port.flash_attention(x, x, x)
    assert port.LAUNCHES == {"flash_fwd": 0, "flash_bwd_prep": 0,
                             "flash_bwd": 0, "flash_bwd_cast": 0,
                             "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    with pytest.raises(ValueError):
        port.flash_attention(x, x, x, layout="TBHD")
    with pytest.raises(ValueError):               # 2 query heads over 3
        port.flash_attention(x, torch.randn(1, 8, 3, 8),
                             torch.randn(1, 8, 3, 8))
