"""Port parity for the fused AdamW update: ``fused_adamw_update`` of the
port (plain version, CPU) against the JAX package's, whose Pallas kernel
runs in interpret mode, over three steps from the same numpy buffers; and
both packages' ``adamw_reference``.

Tolerances: p, m and v within 1e-6 of the largest magnitude of each
buffer (both evaluate the kernel's f32 arithmetic; the hyper-parameters'
f32 powers and XLA's fusion may round a last bit differently). Against the
textbook ``adamw_reference`` (``m / (1 - b1^t)`` instead of ``m * c1``)
the JAX package's own kernel test's limits, 1e-6 absolute plus 1e-6
relative (``tests/unit/test_kernels.py``): the kernel takes ``1 - b2`` in
f32 from b2's f32 value (9.9998713e-4), the reference in double (1e-3),
1.3e-5 apart, so a v made mostly of ``(1 - b2) g^2`` differs by that
share of it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels import fused_optimizer as jfo
from deepspeed_tpu_torch.ops.kernels import fused_optimizer as fo

KW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)


def _buffers(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    m = (0.01 * rng.standard_normal(n)).astype(np.float32)
    v = (1e-4 * rng.random(n)).astype(np.float32)
    gs = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    return p, m, v, gs


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= 1e-6 * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("gdtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1024, 1000, 1])
def test_three_steps_match_jax_kernel(n, gdtype):
    p, m, v, gs = _buffers(n, n)
    jp, jm, jv = (jnp.asarray(a) for a in (p, m, v))
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    for step, g in enumerate(gs, start=1):
        jg = jnp.asarray(g)
        tg = torch.from_numpy(g)
        if gdtype == "bf16":
            jg, tg = jg.astype(jnp.bfloat16), tg.to(torch.bfloat16)
        jp, jm, jv = jfo.fused_adamw_update(jp, jg, jm, jv, step,
                                            interpret=True, **KW)
        out = fo.fused_adamw_update(tp, tg, tm, tv, step, **KW)
        assert out[0] is tp and out[1] is tm and out[2] is tv   # in place
    for what, a, b in (("p", tp, jp), ("m", tm, jm), ("v", tv, jv)):
        _close(a.numpy(), b, f"{what} n={n} g={gdtype}")


@pytest.mark.parametrize("n", [1024, 1000])
def test_matches_adamw_reference(n):
    """The kernel's arithmetic against the textbook update, in both
    packages, and the two packages' references against each other."""
    p, m, v, gs = _buffers(n, 7)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    rp, rm, rv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    jp, jm, jv = (jnp.asarray(a) for a in (p, m, v))
    for step, g in enumerate(gs, start=1):
        fo.fused_adamw_update(tp, torch.from_numpy(g), tm, tv, step, **KW)
        rp, rm, rv = fo.adamw_reference(rp, torch.from_numpy(g), rm, rv,
                                        step, **KW)
        jp, jm, jv = jfo.adamw_reference(jp, jnp.asarray(g), jm, jv, step,
                                         **KW)
    for what, a, r, j in (("p", tp, rp, jp), ("m", tm, rm, jm),
                          ("v", tv, rv, jv)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=f"{what} vs reference")
        _close(r.numpy(), j, f"{what} reference vs JAX reference")


def test_device_scalars_and_in_place():
    """``lr`` and ``step`` as 0-d tensors give the same bits as floats;
    the update writes into the given buffers (their storage is kept)."""
    p, m, v, gs = _buffers(300, 3)
    a = [torch.from_numpy(x.copy()) for x in (p, m, v)]
    b = [torch.from_numpy(x.copy()) for x in (p, m, v)]
    ptrs = [t.data_ptr() for t in a]
    g = torch.from_numpy(gs[0])
    fo.fused_adamw_update(a[0], g, a[1], a[2], 2, **KW)
    fo.fused_adamw_update(b[0], g, b[1], b[2], torch.tensor(2),
                          **{**KW, "lr": torch.tensor(1e-3)})
    assert [t.data_ptr() for t in a] == ptrs
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], torch.from_numpy(p))


def test_cpu_path_counts_no_launch_and_checks_input():
    fo.reset_launch_counts()
    p = torch.zeros(16)
    fo.fused_adamw_update(p, torch.ones(16), torch.zeros(16),
                          torch.zeros(16), 1, lr=0.1)
    assert fo.LAUNCHES == {"adamw": 0}
    with pytest.raises(ValueError, match="fp32"):
        fo.fused_adamw_update(p.double(), p, p, p, 1, lr=0.1)
    with pytest.raises(ValueError, match="shapes"):
        fo.fused_adamw_update(p, torch.ones(15), p.clone(), p.clone(), 1,
                              lr=0.1)
