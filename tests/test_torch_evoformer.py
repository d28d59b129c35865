"""Port parity for Evoformer attention: ``DS4Sci_EvoformerAttention``
(fused and chunked paths) and ``evoformer_flash`` of the port (the
kernel's plain version on the CPU) against the JAX package's, whose Pallas
kernel runs in interpret mode, on the same numpy inputs; and the port's
backward (the VJP of the chunked plain path, as ``_evo_bwd_rule``) against
``jax.grad``.

Tolerances: fp32 outputs within 1e-5 max-abs, gradients within 1e-5 of
the largest gradient magnitude (the JAX kernel's online softmax over
128-key tiles and the plain versions' single softmax differ in fp32
rounding only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import evoformer_attn as jev
from deepspeed_tpu.ops.kernels import evoformer as jevk
from deepspeed_tpu_torch.ops import evoformer_attn as ev
from deepspeed_tpu_torch.ops.kernels import evoformer as evk

B, N, H, D = 1, 3, 2, 32


def _inputs(S, seed, full_mask_row=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, N, S, H, D)).astype(np.float32)
               for _ in range(3))
    mask = np.where(rng.random((B, N, 1, 1, S)) < 0.2, -1e9, 0.0
                    ).astype(np.float32)
    if full_mask_row:
        mask[0, 1] = -np.inf                     # every key of row n = 1
    pair = rng.standard_normal((B, 1, H, S, S)).astype(np.float32)
    return q, k, v, mask, pair


def _biases(which, mask, pair):
    return {"none": [], "mask": [mask], "pair": [pair],
            "both": [mask, pair]}[which]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("which,S", [("none", 40), ("mask", 40),
                                     ("pair", 40), ("both", 40),
                                     ("both", 130)])    # two JAX key tiles
def test_ds4sci_paths_match_jax(which, S):
    """The fused path (``use_kernel=True``: the kernel's plain version on
    the CPU; the JAX kernel in interpret mode) and the chunked plain path
    (``chunk_size=16``, a clamped last chunk) against the JAX package's
    same paths; fully masked rows give zeros in both."""
    q, k, v, mask, pair = _inputs(S, S)
    bs = _biases(which, mask, pair)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    targs = [_t(a) for a in (q, k, v)]
    for kw in (dict(use_kernel=True), dict(use_kernel=False, chunk_size=16),
               dict(use_kernel=False)):
        want = np.asarray(jev.DS4Sci_EvoformerAttention(
            *jargs, [jnp.asarray(b) for b in bs], **kw))
        got = ev.DS4Sci_EvoformerAttention(*targs, [_t(b) for b in bs],
                                           **kw).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5, (which, kw)
        if which in ("mask", "both"):
            assert not got[0, 1].any()


def test_non_canonical_bias_takes_the_plain_path():
    """A bias that is neither canonical layout ([B, N, H, Sq, Sk] here,
    and a second mask bias) takes the plain path in both packages, even
    with ``use_kernel=True``; it launches nothing."""
    S = 40
    q, k, v, mask, pair = _inputs(S, 3, full_mask_row=False)
    rng = np.random.default_rng(4)
    full = rng.standard_normal((B, N, H, S, S)).astype(np.float32)
    evk.reset_launch_counts()
    for bs in ([full], [mask, mask]):
        want = np.asarray(jev.DS4Sci_EvoformerAttention(
            *(jnp.asarray(a) for a in (q, k, v)),
            [jnp.asarray(b) for b in bs], use_kernel=True))
        got = ev.DS4Sci_EvoformerAttention(
            *(_t(a) for a in (q, k, v)), [_t(b) for b in bs],
            use_kernel=True).numpy()
        assert np.abs(got - want).max() <= 1e-5
    assert evk.LAUNCHES == {"evoformer_fwd": 0}
    with pytest.raises(ValueError, match="5-D"):
        ev.DS4Sci_EvoformerAttention(*(_t(a) for a in (q, k, v)),
                                     [_t(mask[0])])


@pytest.mark.parametrize("S", [40, 7])
@pytest.mark.parametrize("which", ["none", "mask", "pair", "both"])
def test_evoformer_flash_plain_matches_jax_kernel(which, S):
    """``evoformer_flash`` with squeezed biases, ragged S, -1e9 mask
    biases and a fully -inf row: the plain version against the JAX kernel
    in interpret mode."""
    q, k, v, mask, pair = _inputs(S, 10 + S)
    mb = mask[:, :, 0, 0] if which in ("mask", "both") else None
    pb = pair[:, 0] if which in ("pair", "both") else None
    want = np.asarray(jevk.evoformer_flash(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if mb is None else jnp.asarray(mb),
        None if pb is None else jnp.asarray(pb), interpret=True))
    got = evk.evoformer_flash(*(_t(a) for a in (q, k, v)),
                              None if mb is None else _t(mb),
                              None if pb is None else _t(pb)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("which", ["none", "mask", "pair", "both"])
def test_grads_match_jax_grad(which):
    """dq, dk, dv and the given biases' gradients through
    ``evoformer_flash`` against ``jax.grad`` of the JAX package's."""
    S = 40
    q, k, v, mask, pair = _inputs(S, 20)
    rng = np.random.default_rng(21)
    cot = rng.standard_normal((B, N, S, H, D)).astype(np.float32)
    mb = mask[:, :, 0, 0] if which in ("mask", "both") else None
    pb = pair[:, 0] if which in ("pair", "both") else None
    extra = [a for a in (mb, pb) if a is not None]

    def f(q, k, v, *rest):
        rest = list(rest)
        m = rest.pop(0) if mb is not None else None
        p = rest.pop(0) if pb is not None else None
        return jnp.sum(jevk.evoformer_flash(q, k, v, m, p, interpret=True)
                       * jnp.asarray(cot))

    want = jax.grad(f, argnums=tuple(range(3 + len(extra))))(
        *(jnp.asarray(a) for a in (q, k, v, *extra)))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v, *extra)]
    rest = iter(ts[3:])
    tm = next(rest) if mb is not None else None
    tp = next(rest) if pb is not None else None
    out = evk.evoformer_flash(ts[0], ts[1], ts[2], tm, tp)
    (out * _t(cot)).sum().backward()
    for i, (t, w) in enumerate(zip(ts, want)):
        w = np.asarray(w)
        g = t.grad.numpy()
        assert np.isfinite(g).all(), i
        assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0), i


def test_cpu_path_counts_no_launch_and_checks_shapes():
    evk.reset_launch_counts()
    q, k, v, mask, pair = _inputs(8, 30, full_mask_row=False)
    evk.evoformer_flash(_t(q), _t(k), _t(v))
    assert evk.LAUNCHES == {"evoformer_fwd": 0}
    with pytest.raises(ValueError, match="mask_bias"):
        evk.evoformer_flash(_t(q), _t(k), _t(v), _t(mask))
    with pytest.raises(ValueError, match="pair_bias"):
        evk.evoformer_flash(_t(q), _t(k), _t(v), None, _t(pair))
