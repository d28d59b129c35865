"""The CUDA kernels against their plain version, on the card only.

This file imports no JAX (the card's machine has none), so it runs there:
``python -m pytest tests/test_torch_kernels_cuda.py -q``. Without a card
each test skips at run time."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.kernels import paged_attention as port


def _pool(rng, nb, bs, KV, D):
    slots = (nb + 1) * bs
    return (rng.standard_normal((slots, KV * D)).astype(np.float32),
            rng.standard_normal((slots, KV * D)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 24])
def test_kernels_match_plain_on_card(window):
    """Both CUDA kernels against the plain version on the card, bf16 and
    fp32 (limits as in chip_smoke.py: bf16 8e-3 max-abs and 2**-8 of the
    plain output's norm, fp32 1e-4 max-abs): a ragged last
    query tile (C = 40), three live slots and one idle slot, which must
    come out zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(2)
    S, C, H, KV, D, bs, nb, maxb = 4, 40, 8, 2, 64, 16, 24, 8
    kp, vp = _pool(rng, nb, bs, KV, D)
    tables = np.zeros((S, maxb), np.int32)
    perm = rng.permutation(nb)
    for s in range(3):
        tables[s, :8] = perm[s * 8:(s + 1) * 8]
    start = np.array([0, 30, 88, 0], np.int32)
    lens = np.array([C, 30 + C, 88 + C, 0], np.int32)        # slot 3 idle
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    for dt, tol, rel_tol in ((torch.float32, 1e-4, 1.0),
                             (torch.bfloat16, 8e-3, 2.0 ** -8)):
        args = [torch.from_numpy(a).cuda() for a in
                (q, kp, vp, tables, start, lens)]
        args[:3] = [a.to(dt) for a in args[:3]]
        for qq, st, ln in ((args[0], args[4], args[5]),
                           (args[0][:, :1].contiguous(),
                            torch.clamp(args[5] - 1, min=0), args[5])):
            kw = dict(block_size=bs, sm_scale=D ** -0.5,
                      sliding_window=window, num_kv_heads=KV)
            got = port.flash_paged_attention(
                qq, args[1], args[2], args[3], st, ln, **kw)
            ref = port.paged_attention_plain(
                qq.cpu(), args[1].cpu(), args[2].cpu(), args[3].cpu(),
                st.cpu(), ln.cpu(), **kw)
            torch.cuda.synchronize()
            diff = got.float().cpu() - ref.float()
            err = diff.abs().max().item()
            rel = (diff.norm() / ref.float().norm()).item()
            assert err <= tol and rel <= rel_tol, (dt, qq.shape, err, rel)
            assert not got[3].any(), "idle slot must emit zeros"
