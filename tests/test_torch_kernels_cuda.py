"""The CUDA kernels against their plain versions, on the card only.

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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 200, 200, 4, 4, 64, True),        # T not a multiple of the tile
    (2, 128, 384, 8, 2, 64, True),        # causal offset, GQA 8 -> 2
    (2, 200, 200, 8, 2, 64, False),       # non-causal
    (1, 256, 256, 2, 2, 128, True),       # head_dim 128
    (1, 320, 320, 16, 16, 128, True),     # the gpt1p3b heads (16 x 128)
    (2, 256, 256, 8, 2, 128, True),       # GQA 8 -> 2 at head_dim 128
])
def test_flash_kernels_match_plain_on_card(shape):
    """The flash forward and backward (``flash_bwd``) against their plain
    versions on the card, with BTHD views (strided rows) as the model
    passes them: fp32 (the CUDA-core parity kernels), bf16 and fp16 (at
    these head dims the wgmma backward, which must give dK and dV
    bit-identical from a second call). Limits as in chip_smoke.py: bf16
    1.6e-2 max-abs, fp16 4e-3, both 2**-8 of the plain output's norm;
    fp32 1e-5 max-abs, TF32 off for the plain fp32 products."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Tq, Tk, H, Hk, D, causal = shape
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Tq, H, D), (B, Tk, Hk, D), (B, Tk, Hk, D), (B, Tq, H, D))]
    kw = dict(causal=causal, sm_scale=D ** -0.5)
    for dt, tol, rel_tol in ((torch.float32, 1e-5, 1.0),
                             (torch.bfloat16, 1.6e-2, 2.0 ** -8),
                             (torch.float16, 4e-3, 2.0 ** -8)):
        q, k, v, do = (torch.from_numpy(a).cuda().to(dt).transpose(1, 2)
                       for a in arrs)
        fa.reset_launch_counts()
        o, lse = fa.flash_fwd(q, k, v, **kw)
        ro, rlse = fa.flash_fwd_plain(q, k, v, **kw)
        got = [o, lse, *fa.flash_bwd(q, k, v, do, ro, rlse, **kw)]
        ref = [ro, rlse, *fa.flash_bwd_plain(q, k, v, do, ro, rlse, **kw)]
        torch.cuda.synchronize()
        for name in fa.bwd_launch_names(D, dt):
            assert fa.LAUNCHES[name] == 1, (dt, fa.LAUNCHES)
        for name, g, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
            diff = g.float() - r.float()
            err = diff.abs().max().item()
            rel = (diff.norm() / r.float().norm()).item()
            assert err <= tol and rel <= rel_tol, (dt, name, err, rel)
        if dt != torch.float32:
            again = fa.flash_bwd(q, k, v, do, ro, rlse, **kw)
            assert torch.equal(again[1], got[3])
            assert torch.equal(again[2], got[4])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (200, 1000, 256, None, 0.0, 0.0),     # ragged token and vocab tiles
    (130, 777, 192, -100, 1e-4, 0.1),     # C % 128 != 0: 64-column slabs
    (100, 3001, 64, -100, 0.0, 0.0),      # a cluster of one block
    (333, 1500, 768, -100, 0.0, 0.1),     # an odd cluster (3 x 256)
    (260, 2100, 2048, None, 1e-4, 0.0),   # the gpt1p3b cluster (8 x 256)
    (150, 1300, 4096, -100, 0.0, 0.0),    # two slab groups of 8 x 256
])
def test_xent_kernels_match_plain_on_card(shape):
    """The three fused-xent kernels against their plain versions on the
    card at small ragged shapes, with ignore ids and an id >= V among the
    targets, at hidden sizes that cover each backward cluster plan
    (``fused_xent.bwd_plan``). Limits as in chip_smoke.py: fp32 (the
    CUDA-core kernels) and
    the bf16 logit sum within 1e-5 of the plain output's norm; bf16 lse
    and target logit within 1e-3 absolute, dh and dE within 2**-8 of the
    plain output's norm and 9e-3 of its largest magnitude; TF32 off for
    the plain fp32 products."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    torch.backends.cuda.matmul.allow_tf32 = False
    N, V, C, ignore, z, eps = shape
    rng = np.random.default_rng(4)
    h = rng.standard_normal((N, C)).astype(np.float32)
    e = (rng.standard_normal((V, C)) * 2 / np.sqrt(C)).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    t[::7] = -100
    t[3] = V + 2
    kw = dict(ignore=ignore, z=z, eps=eps)
    for dt, rows_tol in ((torch.float32, None), (torch.bfloat16, 1e-3)):
        hh, ee = (torch.from_numpy(a).cuda().to(dt) for a in (h, e))
        tt = torch.from_numpy(t).cuda()
        scale = torch.tensor([0.37], device="cuda")
        ref = fx.fused_xent_fwd_plain(hh, ee, tt)
        got = fx.xent_fwd(hh, ee, tt)
        lse = ref[0]
        ref += (fx.fused_xent_dh_plain(scale, hh, ee, tt, lse, **kw),
                fx.fused_xent_de_plain(scale, hh, ee, tt, lse, **kw))
        got += (fx.xent_bwd_dh(scale, hh, ee, tt, lse, **kw),
                fx.xent_bwd_de(scale, hh, ee, tt, lse, **kw))
        torch.cuda.synchronize()
        for i, (name, g, r) in enumerate(zip(
                ("lse", "tgt", "lsum", "dh", "de"), got, ref)):
            assert g.dtype == r.dtype and g.shape == r.shape, name
            diff = g.float() - r.float()
            rel = (diff.norm() / r.float().norm()).item()
            err = diff.abs().max().item()
            if dt is torch.float32 or name == "lsum":
                assert rel <= 1e-5, (dt, name, rel)
            elif i < 3:
                assert err <= rows_tol, (dt, name, err)
            else:
                top = r.float().abs().max().item()
                assert rel <= 2.0 ** -8 and err <= 9e-3 * top, (name, err)


def _close_bf16(got, ref):
    """bf16 kernel output against its plain version: within 2**-8 of the
    plain output's norm, and each element within one bf16 ulp of the
    plain output's largest magnitude (2**-7 of it): both sum the same
    exact products in f32, in another order, then round."""
    diff = got.float() - ref.float()
    top = ref.float().abs().max().item()
    rel = (diff.norm() / ref.float().norm()).item()
    return rel <= 2.0 ** -8 and diff.abs().max().item() <= 2.0 ** -7 * top


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kernels_match_plain_on_card(symmetric, bits):
    """Both group-quantization kernels against their plain version on the
    same CUDA tensor: codes, scales and zeros identical, fp32 and bf16,
    groups of 64 and 128, a ragged tail group and an all-zero group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    rng = np.random.default_rng(5)
    x = rng.standard_normal((300, 517)).astype(np.float32)
    x.reshape(-1)[:128] = 0.0
    x.reshape(-1)[1000:3000] *= 40.0
    name = "quantize_sym" if symmetric else "quantize_asym"
    for dt in (torch.float32, torch.bfloat16):
        xx = torch.from_numpy(x).cuda().to(dt)
        for gs in (64, 128):
            qz.reset_launch_counts()
            got = qz.quantize_blockwise(xx, bits=bits, group_size=gs,
                                        symmetric=symmetric)
            ref = qz.quantize_blockwise_plain(xx, bits=bits, group_size=gs,
                                              symmetric=symmetric)
            torch.cuda.synchronize()
            assert qz.LAUNCHES[name] == 1
            assert torch.equal(got.values, ref.values), (dt, gs)
            assert torch.equal(got.scale, ref.scale), (dt, gs)
            assert (got.zero is None) == symmetric
            if not symmetric:
                assert torch.equal(got.zero, ref.zero), (dt, gs)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (1, 256, 512),
    (64, 512, 11008),     # N/4 = 2752 (Llama-2-7B's gate/up)
    (333, 1000, 1040),    # K % 32 != 0, N/4 = 260 (plain loads, ragged)
    (40, 100, 40),        # no 16-byte chunks at all
    # Llama-2-7B's down and gate/up at both routes (fp6_plan): the decode
    # route's one and two row tiles, the threshold, the ragged K split of
    # K = 11008 and J = 2752's ragged column tile, the prefill route with
    # its K split (M = 129, 384: a ragged second row tile) and without
    *[(M, K, N) for K, N in ((11008, 4096), (4096, 11008))
      for M in (16, 64, 65, 128, 129, 384, 4096)],
])
def test_fp6_kernel_matches_plain_on_card(M, K, N):
    """fp6_matmul against its plain version on the card: bf16 on the
    tensor cores (``_close_bf16``), fp32 on the CUDA-core kernel within
    1e-5 of the plain output's norm (TF32 off); a second call gives the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import fp6_gemm as f6
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(M)
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K)).astype(
        np.float32)).cuda()
    fw = f6.fp6_gemm_pack(w)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        xx = x.cuda().to(dt)
        f6.reset_launch_counts()
        got = f6.fp6_matmul(xx, fw)
        ref = f6.fp6_matmul_plain(xx, fw)
        torch.cuda.synchronize()
        assert f6.LAUNCHES["fp6_matmul"] == 1
        assert torch.equal(got, f6.fp6_matmul(xx, fw)), (M, K, N, dt)
        assert got.dtype == dt and got.shape == (M, N)
        if dt is torch.bfloat16:
            assert _close_bf16(got, ref), (M, K, N)
        else:
            rel = ((got - ref).norm() / ref.norm()).item()
            assert rel <= 1e-5, (M, K, N, rel)


@pytest.mark.cuda
def test_woq_kernels_raise_on_unsupported_dtype():
    """A CUDA tensor of a dtype the kernels do not take raises (fp64 for
    the quantizer, which takes fp32, bf16 and fp16; fp16 for the fp6
    GEMM); nothing falls back to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import fp6_gemm as f6
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    x = torch.randn(8, 64, device="cuda", dtype=torch.float16)
    qz.reset_launch_counts()
    f6.reset_launch_counts()
    with pytest.raises(ValueError, match="dtype"):
        qz.quantize_blockwise(x.double(), bits=8, group_size=64)
    fw = f6.fp6_gemm_pack(torch.randn(64, 32, device="cuda"))
    with pytest.raises(ValueError, match="dtype"):
        f6.fp6_matmul(x, fw)
    with pytest.raises(ValueError):
        f6.fp6_matmul(x.float(), fw._replace(scale=fw.scale.cpu()))
    assert not any(qz.LAUNCHES.values()) and not any(f6.LAUNCHES.values())


def _within_ulp_bf16(got, ref):
    """Each bf16 element within one bf16 ulp of the plain output (2**-7 of
    its magnitude bounds the ulp of its binade and the one below), or
    within 1e-5 of the output's largest magnitude: where x - mean or
    w x^ + b cancels to near zero the ulp falls below the f32 statistics'
    own rounding, which differs between the two in summation order."""
    diff = (got.float() - ref.float()).abs()
    floor = 1e-5 * ref.float().abs().max()
    return bool((diff <= torch.maximum(2.0 ** -7 * ref.float().abs(),
                                       floor)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,hidden", [(64, 256), (48, 4100), (7, 8192),
                                         (33, 3)])
def test_norm_kernels_match_plain_on_card(rows, hidden):
    """Both norm kernels against their plain versions on the card: bf16
    within one bf16 ulp of the plain output (``_within_ulp_bf16``: the f32
    statistics differ in summation order and rsqrt's last bit only), fp32
    within 2e-6 of the
    plain output's largest magnitude; hidden sizes off the 16-byte vector
    (4100, 3) take the scalar path; rows of 8192 (Llama-70B) in one block's
    loop; fp16 runs too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import normalization as nm
    rng = np.random.default_rng(hidden)
    x = torch.from_numpy(rng.standard_normal((rows, hidden)).astype(
        np.float32) * 3 + 0.5).cuda()
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(hidden).astype(
        np.float32)).cuda()
    b = torch.from_numpy(0.1 * rng.standard_normal(hidden).astype(
        np.float32)).cuda()
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        xx = x.to(dt)
        nm.reset_launch_counts()
        got = [nm.fused_rms_norm(xx, w), nm.fused_layer_norm(xx, w, b)]
        ref = [nm.rms_norm_plain(xx, w, 1e-6),
               nm.layer_norm_plain(xx, w, b, 1e-5)]
        torch.cuda.synchronize()
        assert nm.LAUNCHES == {"rms_norm": 1, "layer_norm": 1}
        for g, r in zip(got, ref):
            assert g.dtype == dt and g.shape == xx.shape
            if dt is torch.float32:
                err = (g - r).abs().max().item()
                assert err <= 2e-6 * r.abs().max().item(), (rows, hidden, err)
            elif dt is torch.bfloat16:
                assert _within_ulp_bf16(g, r), (rows, hidden)
            else:
                assert torch.allclose(g.float(), r.float(), rtol=2e-3,
                                      atol=2e-3), (rows, hidden)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(4096, 0), (1000003, 0), (5000, 1)])
def test_adamw_kernel_bit_identical_to_plain_on_card(n, offset):
    """The AdamW kernel against its plain version over 3 steps from the
    same buffers: p, m and v bit-identical (no FMA contraction; the same
    f32 hyper-parameters), f32 and bf16 gradients, a ragged n, and buffers
    one element off the 16-byte vector alignment (the scalar path). The
    kernel updates in place: the returned tensors are the inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import fused_optimizer as fo
    rng = np.random.default_rng(n)
    base = [torch.from_numpy(a).cuda() for a in (
        rng.standard_normal(n + offset).astype(np.float32),
        (0.01 * rng.standard_normal(n + offset)).astype(np.float32),
        (1e-4 * rng.random(n + offset)).astype(np.float32))]
    grads = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
             .cuda() for _ in range(3)]
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    for gdt in (torch.float32, torch.bfloat16):
        kp, km, kv = (t.clone()[offset:] for t in base)
        pp, pm, pv = (t.clone()[offset:] for t in base)
        fo.reset_launch_counts()
        for step in (1, 2, 3):
            g = grads[step - 1].to(gdt)
            out = fo.fused_adamw_update(kp, g, km, kv, step, **kw)
            assert out[0] is kp and out[1] is km and out[2] is kv
            fo.fused_adamw_update_plain(pp, g, pm, pv, step, **kw)
        torch.cuda.synchronize()
        assert fo.LAUNCHES["adamw"] == 3
        for a, r in ((kp, pp), (km, pm), (kv, pv)):
            assert torch.equal(a, r), (n, offset, gdt,
                                       (a - r).abs().max().item())
    # lr and step as device tensors: the same bits, no host sync needed
    kp, km, kv = (t.clone()[offset:] for t in base)
    pp, pm, pv = (t.clone()[offset:] for t in base)
    lr = torch.tensor(1e-3, device="cuda")
    step = torch.tensor(1, device="cuda")
    fo.fused_adamw_update(kp, grads[0], km, kv, step, **{**kw, "lr": lr})
    fo.fused_adamw_update_plain(pp, grads[0], pm, pv, 1, **kw)
    assert torch.equal(kp, pp) and torch.equal(kv, pv)


def _sparse_case(rng, B, H, Hk, T, D, dt):
    nb = -(-T // 128)
    bm = rng.random((H, nb, nb)) < 0.5
    bm[0, nb - 1] = False                       # a q-block with no key
    bm[:, 0, 0] = True
    mk = lambda h: torch.from_numpy(                            # noqa: E731
        rng.standard_normal((B, T, h, D)).astype(np.float32)).cuda().to(dt)
    return bm, mk(H), mk(Hk), mk(Hk)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hk,T,D", [
    (2, 4, 4, 384, 64),
    (1, 4, 2, 300, 32),       # ragged T, GQA 4 -> 2
    (1, 2, 2, 256, 128),
])
def test_sparse_kernel_matches_plain_on_card(B, H, Hk, T, D):
    """The block-sparse kernel against its plain version on the card, on
    BTHD views (strided rows): bf16 (``_close_bf16``) and fp32 within 1e-5
    (the CUDA-core kernel, TF32 off for the plain products); a query block
    with no allowed key block gives zeros; a backward raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(T + D)
    for dt in (torch.float32, torch.bfloat16):
        bm, q, k, v = _sparse_case(rng, B, H, Hk, T, D, dt)
        fa.reset_launch_counts()
        got = fa.flash_attention_sparse(q, k, v, bm)
        ref = fa.flash_attention_sparse_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bm,
            sm_scale=D ** -0.5).transpose(1, 2)
        torch.cuda.synchronize()
        assert fa.SPARSE_LAUNCHES["flash_sparse_fwd"] == 1
        assert got.shape == q.shape and got.dtype == dt
        nb = bm.shape[1]
        assert not got[:, (nb - 1) * 128:, 0].any()
        if dt is torch.bfloat16:
            assert _close_bf16(got, ref), (B, H, Hk, T, D)
        else:
            assert (got - ref).abs().max().item() <= 1e-5, (B, H, Hk, T, D)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_attention_sparse(q, k, v, bm).sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("S,D", [(40, 32), (130, 64), (64, 32), (40, 16),
                                 (130, 48)])
@pytest.mark.parametrize("biases", ["none", "mask", "pair", "both"])
def test_evoformer_kernel_matches_plain_on_card(S, D, biases):
    """The Evoformer kernel against its plain version on the card: the four
    bias combinations, ragged S, D = 16, 32 and 64 natively and D = 48
    zero-padded to 64 by the wrapper, a row of MSA keys all at
    -inf (zeros out) and -1e9 mask biases; bf16 (``_close_bf16``) and fp32
    within 1e-5 (the CUDA-core kernel, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import evoformer as ev
    torch.backends.cuda.matmul.allow_tf32 = False
    B, N, H = 2, 3, 4
    rng = np.random.default_rng(S * D)
    arr = lambda *s: torch.from_numpy(                          # noqa: E731
        rng.standard_normal(s).astype(np.float32)).cuda()
    mask = torch.where(torch.from_numpy(rng.random((B, N, S)) < 0.2).cuda(),
                       -1e9, 0.0).float()
    mask[0, 1] = float("-inf")                  # every key of (0, 1) masked
    mb = mask if biases in ("mask", "both") else None
    pb = arr(B, H, S, S) if biases in ("pair", "both") else None
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (arr(B, N, S, H, D).to(dt) for _ in range(3))
        ev.reset_launch_counts()
        got = ev.evoformer_flash(q, k, v, mb, pb)
        ref = ev.evoformer_flash_plain(q, k, v, mb, pb)
        torch.cuda.synchronize()
        assert ev.LAUNCHES["evoformer_fwd"] == 1
        assert got.shape == q.shape and torch.isfinite(got.float()).all()
        if mb is not None:
            assert not got[0, 1].any()
        if dt is torch.bfloat16:
            assert _close_bf16(got, ref), (S, D, biases)
        else:
            assert (got - ref).abs().max().item() <= 1e-5, (S, D, biases)


@pytest.mark.cuda
def test_slice5_kernels_raise_on_unsupported_input():
    """CUDA tensors the kernels do not take raise; nothing falls back to
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import evoformer as ev
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_optimizer as fo
    fa.reset_launch_counts()
    ev.reset_launch_counts()
    fo.reset_launch_counts()
    h = torch.randn(1, 128, 2, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_sparse(h, h, h, np.ones((2, 1, 1), bool))
    with pytest.raises(ValueError, match="host"):
        fa.flash_attention_sparse(h.float(), h.float(), h.float(),
                                  torch.ones(2, 1, 1, device="cuda"))
    wide = torch.randn(1, 128, 2, 192, device="cuda", dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="head_dim 192"):
        fa.flash_attention_sparse(wide, wide, wide, np.ones((2, 1, 1), bool))
    e = torch.randn(1, 2, 16, 2, 128, device="cuda")
    with pytest.raises(NotImplementedError, match="head_dim"):
        ev.evoformer_flash(e, e, e)
    p = torch.zeros(64, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        fo.fused_adamw_update(p, p.half(), p.clone(), p.clone(), 1, lr=1e-3)
    assert fa.SPARSE_LAUNCHES["flash_sparse_fwd"] == 0
    assert ev.LAUNCHES["evoformer_fwd"] == 0 and fo.LAUNCHES["adamw"] == 0


# ------------------------------------------------ fault C1: widened kernels


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,KV", [
    (16, 4, 2),         # LlamaConfig.tiny's heads
    (32, 8, 2),
    (80, 8, 8),         # phi-2's head_dim
    (96, 8, 4),         # phi3's head_dim
    (64, 32, 1),        # a GQA group of 32: K2 over two 16-head blocks
])
def test_paged_kernels_c1_shapes_match_plain_on_card(D, H, KV):
    """K1 and K2 at the head dims and the GQA group that the kernels took
    only after fault C1, against the plain version: bf16 within 8e-3
    max-abs (1.6e-2 above D = 64, chip_smoke.py's D = 128 limit) and 2**-8
    of the plain output's norm, fp32 within 1e-4; a ragged chunk (C = 40)
    and an idle slot, which must be zeros. Each call launches its
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(D * H + KV)
    S, C, bs, nb, maxb = 4, 40, 16, 24, 8
    kp, vp = _pool(rng, nb, bs, KV, D)
    tables = np.zeros((S, maxb), np.int32)
    perm = rng.permutation(nb)
    for s in range(3):
        tables[s, :8] = perm[s * 8:(s + 1) * 8]
    start = np.array([0, 30, 88, 0], np.int32)
    lens = np.array([C, 30 + C, 88 + C, 0], np.int32)        # slot 3 idle
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    bf16_tol = 8e-3 if D <= 64 else 1.6e-2
    for dt, tol, rel_tol in ((torch.float32, 1e-4, 1.0),
                             (torch.bfloat16, bf16_tol, 2.0 ** -8)):
        args = [torch.from_numpy(a).cuda() for a in
                (q, kp, vp, tables, start, lens)]
        args[:3] = [a.to(dt) for a in args[:3]]
        for name, qq, st in (
                ("paged_prefill", args[0], args[4]),
                ("paged_decode", args[0][:, :1].contiguous(),
                 torch.clamp(args[5] - 1, min=0))):
            kw = dict(block_size=bs, sm_scale=D ** -0.5,
                      sliding_window=None, num_kv_heads=KV)
            port.reset_launch_counts()
            got = port.flash_paged_attention(
                qq, args[1], args[2], args[3], st, args[5], **kw)
            ref = port.paged_attention_plain(
                qq.cpu(), args[1].cpu(), args[2].cpu(), args[3].cpu(),
                st.cpu(), args[5].cpu(), **kw)
            torch.cuda.synchronize()
            assert port.LAUNCHES[name] == 1, port.LAUNCHES
            diff = got.float().cpu() - ref.float()
            err = diff.abs().max().item()
            rel = (diff.norm() / ref.float().norm()).item()
            assert err <= tol and rel <= rel_tol, (dt, name, err, rel)
            assert not got[3].any(), "idle slot must emit zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [
    ("fp16", 64), ("fp16", 128),          # fp16 at the GPT-2 head dims
    ("fp16", 16), ("bf16", 16), ("fp32", 16),   # GPT2Config.tiny's heads
    ("bf16", 32), ("fp16", 32), ("fp32", 32),
])
def test_flash_kernels_c1_match_plain_on_card(dtype, D):
    """The flash forward and backward in fp16 and at head dims 16 and 32
    (fault C1; the backward's route by head dim and dtype: the dq / dkv
    pair at 16 and 32 and in fp32, the wgmma kernel at 64 and 128)
    against their plain versions, with BTHD views, a ragged T, GQA 4
    -> 2 and the causal diagonal. Limits: bf16 as chip_smoke.py (1.6e-2
    max-abs, 2**-8 of the norm); fp16 4e-3 max-abs (about one fp16 ulp at
    outputs of 4-8; fp16 keeps three more bits than bf16) and 2**-8 of the
    norm; fp32 1e-5 (TF32 off for the plain products)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    dt, tol, rel_tol = {"fp16": (torch.float16, 4e-3, 2.0 ** -8),
                        "bf16": (torch.bfloat16, 1.6e-2, 2.0 ** -8),
                        "fp32": (torch.float32, 1e-5, 1.0)}[dtype]
    B, T, H, Hk = 2, 200, 4, 2
    rng = np.random.default_rng(D)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, T, H, D), (B, T, Hk, D), (B, T, Hk, D), (B, T, H, D))]
    kw = dict(causal=True, sm_scale=D ** -0.5)
    q, k, v, do = (torch.from_numpy(a).cuda().to(dt).transpose(1, 2)
                   for a in arrs)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ro, rlse = fa.flash_fwd_plain(q, k, v, **kw)
    got = [o, lse, *fa.flash_bwd(q, k, v, do, ro, rlse, **kw)]
    ref = [ro, rlse, *fa.flash_bwd_plain(q, k, v, do, ro, rlse, **kw)]
    torch.cuda.synchronize()
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want["flash_fwd"] = 1
    want.update(dict.fromkeys(fa.bwd_launch_names(D, dt), 1))
    assert fa.LAUNCHES == want
    for name, g, r in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
        assert g.dtype == r.dtype, (name, g.dtype, r.dtype)
        diff = g.float() - r.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / r.float().norm()).item()
        assert err <= tol and rel <= rel_tol, (dtype, D, name, err, rel)


# ------------------------------------------ K2 as split-context decoding


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D,bs,maxb,window", [
    (32, 4, 64, 64, 128, None),       # TinyLlama's heads (GQA 8), paged
    (32, 4, 64, 8192, 1, None),       # the linear layout
    (32, 4, 64, 64, 128, 700),        # a window edge inside a split
    (32, 1, 64, 64, 128, None),       # GQA 32: two head chunks
    (32, 32, 128, 8192, 1, 1000),     # Llama-2-7B's heads, linear, window
    (32, 4, 128, 64, 128, None),      # GQA 8 at D = 128
    (32, 1, 128, 64, 128, 700),       # GQA 32 at D = 128, window
])
def test_paged_decode_splits_match_plain_on_card(H, KV, D, bs, maxb,
                                                 window):
    """K2 over contexts of 1, 63, 64, 65, 2048 and 8192 keys in one call
    (ragged seq_lens, an idle slot, a sequence ending inside a split),
    split as ``decode_plan`` splits an 8192-key table, against the plain
    version: bf16 within 8e-3 max-abs (1.6e-2 at D = 128) and 2**-8 of the
    plain output's norm, fp32 within 1e-4. The idle slot is zeros, two
    calls give the same bits, and each call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(H * KV + D + (window or 0))
    lens = np.array([1, 63, 64, 65, 2048, 8192, 0, 3000], np.int32)
    S = len(lens)
    nb = S * maxb
    kp, vp = _pool(rng, nb, bs, KV, D)
    tables = rng.permutation(nb).astype(np.int32).reshape(S, maxb)
    start = np.maximum(lens - 1, 0).astype(np.int32)
    q = rng.standard_normal((S, 1, H, D)).astype(np.float32)
    _, splits, _ = port.decode_plan(S, KV, H // KV, maxb * bs,
                                    port.sm_count(torch.device("cuda")))
    assert splits > 1
    kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=window,
              num_kv_heads=KV)
    for dt, tol, rel_tol in ((torch.float32, 1e-4, 1.0),
                             (torch.bfloat16, 8e-3 if D <= 64 else 1.6e-2,
                              2.0 ** -8)):
        args = [torch.from_numpy(a).cuda() for a in
                (q, kp, vp, tables, start, lens)]
        args[:3] = [a.to(dt) for a in args[:3]]
        port.reset_launch_counts()
        got = port.paged_decode(*args, **kw)
        again = port.paged_decode(*args, **kw)
        torch.cuda.synchronize()
        assert port.LAUNCHES["paged_decode"] == 2, port.LAUNCHES
        assert torch.equal(got, again), dt
        ref = port.paged_attention_plain(*(a.cpu() for a in args), **kw)
        diff = got.float().cpu() - ref.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / ref.float().norm()).item()
        assert err <= tol and rel <= rel_tol, (dt, err, rel)
        assert not got[6].any(), "idle slot must emit zeros"


@pytest.mark.cuda
def test_kernels_run_on_a_second_card():
    """K2 split over its context and the fp6 GEMM's wgmma kernel (over 48
    KB of dynamic shared memory; a K split on a cooperative launch, one
    and two row tiles) on cuda:0, then cuda:1, in one process: the shared
    memory attribute and the occupancy belong to a device, so the second
    card must get its own. Each against its plain version, bf16 within
    the limits above."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from deepspeed_tpu_torch.ops.kernels import fp6_gemm as f6
    rng = np.random.default_rng(11)
    S, H, KV, D, bs, maxb = 4, 8, 2, 128, 64, 32
    lens = np.array([1, 700, 2048, 0], np.int32)
    kp, vp = _pool(rng, S * maxb, bs, KV, D)
    tables = rng.permutation(S * maxb).astype(np.int32).reshape(S, maxb)
    start = np.maximum(lens - 1, 0).astype(np.int32)
    q = rng.standard_normal((S, 1, H, D)).astype(np.float32)
    K, N = 2048, 1024
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((256, K)).astype(np.float32))
    kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=None,
              num_kv_heads=KV)
    for dev in ("cuda:0", "cuda:1"):
        with torch.cuda.device(dev):
            args = [torch.from_numpy(a).to(dev) for a in
                    (q, kp, vp, tables, start, lens)]
            args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
            _, splits, _ = port.decode_plan(S, KV, H // KV, maxb * bs,
                                            port.sm_count(args[0].device))
            assert splits > 1
            got = port.paged_decode(*args, **kw)
            ref = port.paged_attention_plain(*args, **kw)
            diff = got.float() - ref.float()
            assert diff.abs().max().item() <= 1.6e-2, dev
            assert (diff.norm() / ref.float().norm()).item() <= 2.0 ** -8
            assert not got[3].any(), dev
            fw = f6.fp6_gemm_pack(w.to(dev))
            for M in (64, 128, 256):
                xx = x[:M].to(dev).to(torch.bfloat16)
                plan = f6.fp6_plan(M, K, N // 4, port.sm_count(xx.device))
                assert plan.route != "mma" and plan.ks > 1, plan
                got = f6.fp6_matmul(xx, fw)
                assert _close_bf16(got, f6.fp6_matmul_plain(xx, fw)), \
                    (dev, M)
            torch.cuda.synchronize()


# ------------------------ the wgmma xent and flash forwards (Hopper)


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,C", [
    (1, 50257, 64), (1, 50304, 2048),
    (127, 50304, 64), (127, 50257, 768), (127, 50304, 4096),
    (4097, 50257, 64), (4097, 50304, 768), (4097, 50257, 2048),
    (4097, 50304, 4096), (4096, 50304, 2048),
    (300, 1, 64), (129, 257, 128),        # one ragged vocabulary tile, two
])
def test_xent_fwd_wgmma_matches_plain_on_card(N, V, C):
    """The wgmma + TMA xent forward against its plain version at the GPT-2
    vocabularies (V = 50257 leaves a ragged last 256-row tile, 50304 half
    a tile), ragged token counts (one token tile, a cluster with an empty
    peer, 4097) and C from 64 to 4096, with the ignore id, an id in the
    padded tile and one beyond it among the targets; two calls give the
    same bits. Limits as chip_smoke.py: lse and target logit 1e-3
    absolute, the logit sum 1e-5 of the plain output's norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    g = torch.Generator(device="cuda").manual_seed(N + V + C)
    h = torch.randn(N, C, generator=g, device="cuda").bfloat16()
    e = (torch.randn(V, C, generator=g, device="cuda")
         * (2.0 / C ** 0.5)).bfloat16()
    t = torch.randint(0, V, (N,), generator=g, device="cuda",
                      dtype=torch.int32)
    t[::5] = -100
    t[N // 2] = V + 3                       # inside the padded tile
    t[N - 1] = V + 1000                     # beyond it
    fx.reset_launch_counts()
    got = fx.xent_fwd(h, e, t)
    again = fx.xent_fwd(h, e, t)
    ref = fx.fused_xent_fwd_plain(h, e, t)
    torch.cuda.synchronize()
    assert fx.LAUNCHES["xent_fwd"] == 2
    for name, a, b, r in zip(("lse", "tgt", "lsum"), got, again, ref):
        assert torch.equal(a, b), name       # bit-identical call to call
        assert torch.isfinite(a).all(), name
        diff = a - r
        if name == "lsum":
            assert (diff.norm() / r.norm()).item() <= 1e-5, name
        else:
            assert diff.abs().max().item() <= 1e-3, (name,
                                                     diff.abs().max())
    assert got[1][N // 2] == 0 and got[1][N - 1] == 0


def _fwd_inputs(dt, B, Tq, Tk, H, Hk, D, fused):
    """q, k, v as [B, H, T, D] views of BTHD buffers: one fused qkv buffer
    when ``fused`` (as the GPT-2 block slices its projection), else three."""
    g = torch.Generator(device="cuda").manual_seed(B * Tq + Tk + D)
    if fused:
        qkv = torch.randn(B, Tq, (H + 2 * Hk) * D, generator=g,
                          device="cuda").to(dt)
        q, k, v = qkv.split([H * D, Hk * D, Hk * D], dim=-1)
        return [x.unflatten(-1, (-1, D)).transpose(1, 2) for x in (q, k, v)]
    return [torch.randn(B, T, h, D, generator=g, device="cuda").to(
        dt).transpose(1, 2) for T, h in ((Tq, H), (Tk, Hk), (Tk, Hk))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,Tq,Tk,H,Hk,causal,fused", [
    (2, 128, 384, 8, 2, True, False),     # Tq < Tk, causal offset, GQA 4
    (1, 300, 200, 4, 1, True, False),     # Tq > Tk: 100 rows see no key
    (2, 333, 333, 6, 2, True, True),      # strided views of a fused qkv
    (1, 200, 520, 4, 4, False, False),    # non-causal, ragged
])
def test_flash_fwd_wgmma_matches_plain_on_card(dtype, D, B, Tq, Tk, H, Hk,
                                               causal, fused):
    """The wgmma + TMA flash forward (head dims 64 and 128) against its
    plain version: o within the flash limits (bf16 1.6e-2, fp16 4e-3
    max-abs, both 2**-8 of the norm), lse within 1e-4 where finite, and
    rows with no live key exactly O = 0, lse = -inf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    dt, tol = {"bf16": (torch.bfloat16, 1.6e-2),
               "fp16": (torch.float16, 4e-3)}[dtype]
    q, k, v = _fwd_inputs(dt, B, Tq, Tk, H, Hk, D, fused)
    kw = dict(causal=causal, sm_scale=D ** -0.5)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ro, rlse = fa.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == 1
    assert o.dtype == dt and o.shape == q.shape
    diff = o.float() - ro.float()
    assert diff.abs().max().item() <= tol, diff.abs().max()
    assert (diff.norm() / ro.float().norm()).item() <= 2.0 ** -8
    live = torch.isfinite(rlse)
    assert torch.equal(torch.isfinite(lse), live)
    assert (lse[live] - rlse[live]).abs().max().item() <= 1e-4
    dead = ~live
    if dead.any():
        assert torch.all(lse[dead] == float("-inf"))
        assert torch.all(o[dead] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("sm_scale", [-0.125, 0.0])
def test_flash_fwd_wgmma_any_scale_matches_plain_on_card(sm_scale):
    """A scale that is not positive takes the softmax path that scales
    each score before the max (a positive one folds the scale into the
    exponent): both against the plain version, bf16 limits as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    q, k, v = _fwd_inputs(torch.bfloat16, 2, 200, 300, 4, 2, 64, False)
    kw = dict(causal=True, sm_scale=sm_scale)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ro, rlse = fa.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    diff = o.float() - ro.float()
    assert diff.abs().max().item() <= 1.6e-2
    assert (diff.norm() / ro.float().norm()).item() <= 2.0 ** -8
    assert (lse - rlse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_fwd_raises_on_a_stride_tma_cannot_take():
    """A q/k/v stride that is not a 16-byte multiple raises, naming it; the
    kernel is not launched and nothing else runs in its place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B, T, H, D = 2, 64, 4, 64
    buf = torch.randn(B, T, H * D + 4, device="cuda").bfloat16()
    q = buf[..., :H * D].unflatten(-1, (H, D)).transpose(1, 2)
    k, v = (torch.randn(B, H, T, D, device="cuda").bfloat16()
            for _ in range(2))
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="q's time stride is 260"):
        fa.flash_fwd(q, k, v, causal=True, sm_scale=D ** -0.5)
    assert fa.LAUNCHES["flash_fwd"] == 0
    # the backward reads dO by TMA too; and the dq / dkv pair refuses the
    # head dims of the wgmma backward instead of running in its place
    k2, v2 = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (k, v))
    qq = torch.randn(B, H, T, D, device="cuda").bfloat16()
    o, lse = fa.flash_fwd(qq, k2, v2, causal=True, sm_scale=D ** -0.5)
    with pytest.raises(ValueError, match="dO's time stride is 260"):
        fa.flash_bwd(qq, k2, v2, q, o, lse, causal=True, sm_scale=D ** -0.5)
    delta = fa.flash_bwd_delta_plain(o, qq)
    with pytest.raises(ValueError, match="wgmma"):
        fa.flash_bwd_dq(qq, k2, v2, qq, lse, delta, causal=True,
                        sm_scale=D ** -0.5)
    assert fa.LAUNCHES["flash_bwd"] == fa.LAUNCHES["flash_bwd_dq"] == 0


# ---------------------------------------------- K1 on wgmma + TMA (PR 10)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("group", [1, 8, 32])
@pytest.mark.parametrize("bs", [16, 64, 640])
@pytest.mark.parametrize("D", [64, 128])
def test_paged_prefill_wgmma_matches_plain_on_card(D, bs, group, window):
    """K1's wgmma kernel (K/V by TMA at block 64 and 640, by the cp.async
    gather at 16) at GQA groups 1, 8 and 32, against the plain version:
    bf16 within 8e-3 max-abs (1.6e-2 at D = 128) and 2**-8 of the plain
    output's norm. A ragged chunk (C = 200: a 72-row second query tile),
    start positions inside a block, ragged seq_lens with an idle slot, a
    window whose edge falls inside a tile; the idle slot is zeros, two
    calls give the same bits, each call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(D + bs + group + (window or 0))
    KV = 32 // group
    H = KV * group
    S, C = 4, 200
    start = np.array([0, 37, 0, 450], np.int32)
    lens = np.array([200, 237, 0, 650], np.int32)
    maxb = -(-700 // bs)
    nb = S * maxb
    kp, vp = _pool(rng, nb, bs, KV, D)
    tables = rng.permutation(nb).astype(np.int32).reshape(S, maxb)
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    assert port.prefill_route(C, D, torch.bfloat16, bs) == (
        "wgmma_tma" if bs % 64 == 0 else "wgmma_gather")
    kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=window,
              num_kv_heads=KV)
    args = [torch.from_numpy(a).cuda() for a in
            (q, kp, vp, tables, start, lens)]
    args[:3] = [a.bfloat16() for a in args[:3]]
    port.reset_launch_counts()
    got = port.paged_prefill(*args, **kw)
    again = port.paged_prefill(*args, **kw)
    torch.cuda.synchronize()
    assert port.LAUNCHES["paged_prefill"] == 2, port.LAUNCHES
    assert torch.equal(got, again)
    ref = port.paged_attention_plain(*(a.cpu() for a in args), **kw)
    diff = got.float().cpu() - ref.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.float().norm()).item()
    assert err <= (8e-3 if D <= 64 else 1.6e-2) and rel <= 2.0 ** -8, \
        (err, rel)
    assert not got[2].any(), "idle slot must emit zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,KV,D,bs", [
    (16, 256, 4, 64, 64),     # TinyLlama's second prefill chunk
    (64, 512, 32, 128, 640),  # Llama-2-7B's prefill step
])
def test_paged_prefill_wgmma_at_the_served_shapes_on_card(S, C, KV, D, bs):
    """The served shapes, every slot full (many items a persistent block,
    where a producer thread that skipped a buffer's waits could once fall
    two phases behind), against the plain version, bit-identical between
    two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(S + C)
    H, ctx = 32, 512
    maxb = -(-ctx // bs)
    nb = S * maxb
    kp, vp = _pool(rng, nb, bs, KV, D)
    tables = rng.permutation(nb).astype(np.int32).reshape(S, maxb)
    start = np.full(S, ctx - C, np.int32)
    lens = np.full(S, ctx, np.int32)
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=None,
              num_kv_heads=KV)
    args = [torch.from_numpy(a).cuda() for a in
            (q, kp, vp, tables, start, lens)]
    args[:3] = [a.bfloat16() for a in args[:3]]
    got = port.paged_prefill(*args, **kw)
    assert torch.equal(got, port.paged_prefill(*args, **kw))
    ref = port.paged_attention_plain(*args, **kw)
    diff = got.float() - ref.float()
    assert diff.abs().max().item() <= (8e-3 if D <= 64 else 1.6e-2)
    assert (diff.norm() / ref.float().norm()).item() <= 2.0 ** -8


# ---------------------------- Evoformer: two MSA rows a block (PR 10)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 7])
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("biases", ["none", "mask", "pair", "both"])
def test_evoformer_rows_a_block_match_plain_on_card(N, D, biases):
    """N a multiple of the rows a block and N with a tail (7 = 2 x 3 + 1),
    ragged S = 300, the four bias combinations, a fully masked MSA row
    (zeros out), against the plain version in bf16 (``_close_bf16``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import evoformer as ev
    assert ev.evo_plan(D, 1, N, 4, 300, 300).groups == -(-N // ev.EVO_ROWS)
    B, S, H = 1, 300, 4
    rng = np.random.default_rng(N * D + len(biases))
    arr = lambda *s: torch.from_numpy(                          # noqa: E731
        rng.standard_normal(s).astype(np.float32)).cuda()
    mask = torch.where(torch.from_numpy(rng.random((B, N, S)) < 0.2).cuda(),
                       -1e9, 0.0).float()
    mask[0, N - 1] = float("-inf")              # the last row: all masked
    mb = mask if biases in ("mask", "both") else None
    pb = arr(B, H, S, S) if biases in ("pair", "both") else None
    q, k, v = (arr(B, N, S, H, D).bfloat16() for _ in range(3))
    ev.reset_launch_counts()
    got = ev.evoformer_flash(q, k, v, mb, pb)
    ref = ev.evoformer_flash_plain(q, k, v, mb, pb)
    torch.cuda.synchronize()
    assert ev.LAUNCHES["evoformer_fwd"] == 1
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    if mb is not None:
        assert not got[0, N - 1].any()
    assert _close_bf16(got, ref), (N, D, biases)


# ------------------------------------------------ fault C2: widened kernels


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,C", [(200, 1000, 100), (130, 777, 192),
                                   (260, 2100, 2048)])
def test_xent_kernels_c2_fp16_and_odd_hidden_match_plain_on_card(N, V, C):
    """Fault C2: the fused-xent kernels in fp16 (the wgmma kernels' fp16
    instance) and at a hidden size that is no multiple of 64 (C = 100: the
    wrapper pads h and E with zero columns and slices dh and dE back), in
    fp32, bf16 and fp16 against their plain versions, launch counts
    rising. Limits as ``test_xent_kernels_match_plain_on_card`` (fp16 held
    to bf16's: its mantissa is longer); in fp16 also a loss scale of 2^16
    on h and E scaled by 2^-8: P' times the scale would overflow an fp16
    operand, but the kernels apply it in fp32 after the product, as the
    Pallas kernels do, so dh and dE stay finite and within the same
    limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(C)
    h = rng.standard_normal((N, C)).astype(np.float32)
    e = (rng.standard_normal((V, C)) * 2 / np.sqrt(C)).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    t[::7] = -100
    t[3] = V + 2
    kw = dict(ignore=-100, z=1e-4, eps=0.1)
    cases = [(torch.float32, 0.37, 1.0), (torch.bfloat16, 0.37, 1.0),
             (torch.float16, 0.37, 1.0), (torch.float16, 65536.0, 2.0 ** -8)]
    for dt, sc, mul in cases:
        hh, ee = (torch.from_numpy(a * mul).cuda().to(dt) for a in (h, e))
        tt = torch.from_numpy(t).cuda()
        scale = torch.tensor([sc], device="cuda")
        fx.reset_launch_counts()
        got = fx.xent_fwd(hh, ee, tt)
        ref = fx.fused_xent_fwd_plain(hh, ee, tt)
        lse = ref[0]
        got += (fx.xent_bwd_dh(scale, hh, ee, tt, lse, **kw),
                fx.xent_bwd_de(scale, hh, ee, tt, lse, **kw))
        ref += (fx.fused_xent_dh_plain(scale, hh, ee, tt, lse, **kw),
                fx.fused_xent_de_plain(scale, hh, ee, tt, lse, **kw))
        torch.cuda.synchronize()
        assert fx.LAUNCHES == {"xent_fwd": 1, "xent_bwd_dh": 1,
                               "xent_bwd_de": 1}, (dt, fx.LAUNCHES)
        for i, (name, g, r) in enumerate(zip(
                ("lse", "tgt", "lsum", "dh", "de"), got, ref)):
            assert g.dtype == r.dtype and g.shape == r.shape, (dt, name)
            assert torch.isfinite(g.float()).all(), (dt, sc, name)
            diff = g.float() - r.float()
            rel = (diff.norm() / r.float().norm()).item()
            err = diff.abs().max().item()
            if dt is torch.float32 or name == "lsum":
                assert rel <= 1e-5, (dt, name, rel)
            elif i < 3:
                assert err <= 1e-3, (dt, name, err)
            else:
                top = r.float().abs().max().item()
                assert rel <= 2.0 ** -8 and err <= 9e-3 * top, (
                    dt, sc, name, rel, err)


@pytest.mark.cuda
def test_fused_lm_xent_fp16_odd_hidden_trains_on_card():
    """Fault C2 end to end: ``fused_lm_xent`` in fp16 at C = 100, loss and
    both gradients through the kernels against the same function on the
    plain versions (the kernel wrappers' plain twins swapped in)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    rng = np.random.default_rng(11)
    h0 = torch.from_numpy(rng.standard_normal((2, 64, 100)).astype(
        np.float32)).cuda().half()
    e0 = torch.from_numpy((rng.standard_normal((500, 100)) * 0.2).astype(
        np.float32)).cuda().half()
    t = torch.from_numpy(rng.integers(0, 500, (2, 64))).cuda()

    def run():
        h, e = h0.clone().requires_grad_(True), e0.clone().requires_grad_(True)
        loss = fx.fused_lm_xent(h, e, t)
        loss.backward()
        return loss.float(), h.grad.float(), e.grad.float()

    fx.reset_launch_counts()
    got = run()
    assert all(fx.LAUNCHES.values()), fx.LAUNCHES
    saved = fx.xent_fwd, fx.xent_bwd_dh, fx.xent_bwd_de
    try:
        fx.xent_fwd = fx.fused_xent_fwd_plain
        fx.xent_bwd_dh = fx.fused_xent_dh_plain
        fx.xent_bwd_de = fx.fused_xent_de_plain
        ref = run()
    finally:
        fx.xent_fwd, fx.xent_bwd_dh, fx.xent_bwd_de = saved
    assert abs(got[0].item() - ref[0].item()) <= 1e-3 * abs(ref[0].item())
    for g, r in zip(got[1:], ref[1:]):
        assert torch.isfinite(g).all()
        assert ((g - r).norm() / r.norm()).item() <= 2.0 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 48, 64])
@pytest.mark.parametrize("biases", ["none", "both"])
def test_evoformer_kernel_c2_fp16_matches_plain_on_card(D, biases):
    """Fault C2: the Evoformer kernel in fp16 (its fp16 instance, the
    biases f32 as in bf16) against its plain version at a ragged S = 130
    and N = 3 (a ragged row group), D = 48 zero-padded: within 4e-3
    max-abs and 2**-8 of the plain output's norm (fp16's flash limits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import evoformer as ev
    B, N, S, H = 1, 3, 130, 4
    rng = np.random.default_rng(D)
    arr = lambda *s: torch.from_numpy(                          # noqa: E731
        rng.standard_normal(s).astype(np.float32)).cuda()
    mb = torch.where(torch.from_numpy(rng.random((B, N, S)) < 0.2).cuda(),
                     -1e9, 0.0).float() if biases == "both" else None
    pb = arr(B, H, S, S) if biases == "both" else None
    q, k, v = (arr(B, N, S, H, D).half() for _ in range(3))
    ev.reset_launch_counts()
    got = ev.evoformer_flash(q, k, v, mb, pb)
    ref = ev.evoformer_flash_plain(q, k, v, mb, pb)
    torch.cuda.synchronize()
    assert ev.LAUNCHES["evoformer_fwd"] == 1
    assert got.dtype == torch.float16 and got.shape == q.shape
    diff = (got.float() - ref.float())
    assert diff.abs().max().item() <= 4e-3, (D, biases)
    assert (diff.norm() / ref.float().norm()).item() <= 2.0 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_c2_misaligned_view_runs_on_card(dtype, D):
    """Fault C2: ``flash_attention`` on q/k/v views whose base address and
    time stride are no 16-byte multiples (a slice of a wider buffer, one
    element in): the forward hands the wgmma kernels dense copies, which
    the backward then reads too, and both match the plain versions on
    contiguous copies (limits of ``test_flash_kernels_match_plain_on_card``:
    bf16 1.6e-2, fp16 4e-3 max-abs, both 2**-8 of the norm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B, T, H = 2, 200, 4
    tol = 1.6e-2 if dtype is torch.bfloat16 else 4e-3
    g = torch.Generator(device="cuda").manual_seed(D)
    buf = torch.randn(B, T, 3 * H * D + 1, generator=g, device="cuda").to(
        dtype)
    q, k, v = (buf[..., 1 + i * H * D:1 + (i + 1) * H * D].unflatten(
        -1, (H, D)) for i in range(3))             # [B, T, H, D] views
    assert q.data_ptr() % 16 and q.stride(1) % 8
    do = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    fa.reset_launch_counts()
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fa.flash_attention(qq, kk, vv, causal=True)
    o.backward(do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == 1 and fa.LAUNCHES["flash_bwd"] == 1
    got = (o, qq.grad, kk.grad, vv.grad)
    qc, kc, vc, doc = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    ref_o, lse = fa.flash_fwd_plain(qc, kc, vc, causal=True,
                                    sm_scale=D ** -0.5)
    ref = (ref_o,) + tuple(fa.flash_bwd_plain(
        qc, kc, vc, doc, ref_o, lse, causal=True, sm_scale=D ** -0.5))
    for a, r in zip(got, ref):
        r = r.transpose(1, 2)
        diff = a.float() - r.float()
        assert diff.abs().max().item() <= tol, (dtype, D)
        assert (diff.norm() / r.float().norm()).item() <= 2.0 ** -8


# -------------------------------- the norm kernel's rows route, redesigned


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [64, 2048, 4096, 4100, 8192, 16384])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norm_plan_routes_match_plain_on_card(hidden, dtype, kind):
    """Both norms at the route ``norm_plan`` picks (the rows route's
    teams of 1-8 warps, 1-16 vectors a lane; 4100 in 16-bit types the
    scalar route) against their plain versions over 1000 rows (many rows a
    team: the grid-stride walk), x scaled and offset so that the centred
    variance matters: bf16 within one bf16 ulp (``_within_ulp_bf16``),
    fp32 within 2e-6 of the largest magnitude, fp16 within 2e-3 (the
    limits of ``test_norm_kernels_match_plain_on_card``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import normalization as nm
    rows = 1000
    g = torch.Generator(device="cuda").manual_seed(hidden)
    x = (torch.randn(rows, hidden, generator=g, device="cuda") * 3 + 0.5
         ).to(dtype)
    w = 1 + 0.1 * torch.randn(hidden, generator=g, device="cuda")
    b = 0.1 * torch.randn(hidden, generator=g, device="cuda")
    plan = nm.norm_plan(rows, hidden, dtype, kind == "ln")
    n = 16 // x.element_size()
    assert (plan.route == "rows") == (hidden % n == 0)
    nm.reset_launch_counts()
    if kind == "ln":
        got = nm.fused_layer_norm(x, w, b)
        ref = nm.layer_norm_plain(x, w, b, 1e-5)
    else:
        got = nm.fused_rms_norm(x, w)
        ref = nm.rms_norm_plain(x, w, 1e-6)
    torch.cuda.synchronize()
    assert sum(nm.LAUNCHES.values()) == 1
    assert got.dtype == dtype and got.shape == x.shape
    if dtype is torch.float32:
        err = (got - ref).abs().max().item()
        assert err <= 2e-6 * ref.abs().max().item(), (hidden, err)
    elif dtype is torch.bfloat16:
        assert _within_ulp_bf16(got, ref), hidden
    else:
        assert torch.allclose(got.float(), ref.float(), rtol=2e-3,
                              atol=2e-3), hidden
    # a misaligned x (a view one element in) is copied, not refused
    xv = torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].view(rows, hidden)
    assert xv.data_ptr() % 16
    again = (nm.fused_layer_norm(xv, w, b) if kind == "ln"
             else nm.fused_rms_norm(xv, w))
    assert torch.equal(again, got)


# ---------------------------- the group quantizer's vector route, redesigned


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("gs", [64, 128, 256, 100])
@pytest.mark.parametrize("symmetric", [True, False])
def test_quantize_plan_routes_match_plain_on_card(bits, gs, symmetric):
    """Both quantizers at the route ``quant_plan`` picks (groups of 100:
    the scalar route) in fp32, bf16 and fp16 (fault C2's fp16) against
    their plain version: codes, scales and zeros identical. The input is
    [333, 517] (a ragged tail group whose end is no 16-byte vector), an
    all-zero group, spans 40x and 1e-3x; also a view one element in (the
    wrapper's copy) and the Llama-2-7B gate_proj leaf [4096, 11008]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    g = torch.Generator(device="cuda").manual_seed(gs + bits)
    x = torch.randn(333, 517, generator=g, device="cuda")
    x.view(-1)[:256] = 0.0
    x.view(-1)[1000:3000] *= 40.0
    x.view(-1)[5000:7000] *= 1e-3
    leaf = torch.randn(4096, 11008, generator=g, device="cuda") / 64.0
    name = "quantize_sym" if symmetric else "quantize_asym"
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        plan = qz.quant_plan(gs, dt)
        assert (plan.route == "scalar") == (gs == 100)
        off = torch.cat([x.to(dt).reshape(-1)[:1], x.to(dt).reshape(-1)])[1:]
        for what, xx in (("ragged", x.to(dt)), ("offset", off),
                         ("leaf", leaf.to(dt))):
            qz.reset_launch_counts()
            got = qz.quantize_blockwise(xx, bits=bits, group_size=gs,
                                        symmetric=symmetric)
            ref = qz.quantize_blockwise_plain(xx, bits=bits, group_size=gs,
                                              symmetric=symmetric)
            torch.cuda.synchronize()
            assert qz.LAUNCHES[name] == 1
            assert torch.equal(got.values, ref.values), (dt, what)
            assert torch.equal(got.scale, ref.scale), (dt, what)
            if not symmetric:
                assert torch.equal(got.zero, ref.zero), (dt, what)


@pytest.mark.cuda
def test_tma_kernels_launch_first_on_a_fresh_thread():
    """A thread that has made no CUDA call yet (as PyTorch's autograd
    thread is when a backward reaches a kernel first) launches the TMA
    kernels: the flash forward and backward, the xent forward, each the
    thread's first CUDA work, match the same calls on the main thread
    (the entry points bind the thread's context before encoding a TMA
    map, which failed there before)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(2, 4, 200, 64, generator=g, device="cuda")
                   .bfloat16() for _ in range(4))
    h = torch.randn(300, 128, generator=g, device="cuda").bfloat16()
    e = torch.randn(1000, 128, generator=g, device="cuda").bfloat16()
    t = torch.randint(0, 1000, (300,), generator=g, device="cuda",
                      dtype=torch.int32)
    kw = dict(causal=True, sm_scale=0.125)
    torch.cuda.synchronize()

    def work():
        o, lse = fa.flash_fwd(q, k, v, **kw)
        return (o, *fa.flash_bwd(q, k, v, do, o, lse, **kw),
                *fx.xent_fwd(h, e, t))

    got = []
    th = threading.Thread(target=lambda: got.append(
        [x.clone() for x in work()]))
    th.start()
    th.join()
    assert got, "the fresh thread's launches raised"
    torch.cuda.synchronize()
    want = work()
    for a, b in zip(got[0], want):
        # dQ is added by bulk reduce-add: its last bits vary between calls
        assert torch.allclose(a.float(), b.float(), rtol=1e-2, atol=1e-2)


# ------------------------------------- fault C3 and the wgmma sparse kernel


def _close_sparse(got, ref):
    """A 16-bit block-sparse output against its plain version: bf16 by
    ``_close_bf16``; fp16 within the flash limits (4e-3 max-abs, 2**-8 of
    the plain output's norm)."""
    if got.dtype == torch.bfloat16:
        return _close_bf16(got, ref)
    diff = got.float() - ref.float()
    return diff.abs().max().item() <= 4e-3 and \
        (diff.norm() / ref.float().norm()).item() <= 2.0 ** -8


def _sparse_layout(kind, H, T, seed):
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    nb = -(-T // 128)
    if kind == "random":
        bm = np.random.default_rng(seed).random((H, nb, nb)) < 0.5
        bm[:, :, 0] = True
    else:
        cfg = sa.BSLongformerSparsityConfig(
            H, block=128, num_sliding_window_blocks=3,
            global_block_indices=[0]) if kind == "bslongformer" else \
            sa.BigBirdSparsityConfig(
                H, block=128, num_random_blocks=1,
                num_sliding_window_blocks=3, num_global_blocks=1,
                different_layout_per_head=True, seed=seed)
        bm = cfg.make_layout(nb * 128).astype(bool)
    bm[H - 1, nb - 1] = False                 # a query block with no key
    return bm


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind", ["bslongformer", "bigbird", "random"])
@pytest.mark.parametrize("T", [1000, 1024])
def test_sparse_wgmma_matches_plain_on_card(D, dtype, kind, T):
    """The wgmma block-sparse kernel (``sparse_route`` "wgmma") against
    its plain version on BTHD views: the three layouts, a ragged T (its
    last key tile masked, its last query tile part past Tq), GQA 4 -> 2,
    a query block with no allowed key block (zeros); the same bits from a
    second call; one launch a call, counted on the wgmma route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B, H, Hk = 2, 4, 2
    bm = _sparse_layout(kind, H, T, T + D)
    g = torch.Generator(device="cuda").manual_seed(D + T)
    q, k, v = (torch.randn(B, T, h, D, generator=g, device="cuda").to(dtype)
               for h in (H, Hk, Hk))
    assert fa.sparse_route(dtype, D, 128, 128) == "wgmma"
    fa.reset_launch_counts()
    got = fa.flash_attention_sparse(q, k, v, bm)
    again = fa.flash_attention_sparse(q, k, v, bm)
    torch.cuda.synchronize()
    assert fa.SPARSE_LAUNCHES["flash_sparse_fwd"] == 2
    assert fa.SPARSE_ROUTES == {"f32": 0, "mma": 0, "wgmma": 2}
    assert torch.equal(got, again)
    ref = fa.flash_attention_sparse_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bm,
        sm_scale=D ** -0.5).transpose(1, 2)
    nb = bm.shape[1]
    assert not got[:, (nb - 1) * 128:, H - 1].any()
    assert _close_sparse(got, ref), (D, dtype, kind, T)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 48, 80, 96, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_sparse_c3_head_dims_match_plain_on_card(D, dtype):
    """Fault C3: head dims the card refused before, natively (16, 32, 80,
    96 on the mma.sync kernel) or zero-padded (48 to 64 on the wgmma
    kernel, 100 to 128), in all three dtypes, against the plain version
    (fp32 within 1e-5, TF32 off for the plain products), at a ragged T
    with GQA 4 -> 2 and an empty query block; then 64-row blocks (the
    mma.sync route at every 16-bit head dim)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Hk, T = 2, 4, 2, 300
    rng = np.random.default_rng(D)
    for block in (128, 64):
        nb = -(-T // block)
        bm = rng.random((H, nb, nb)) < 0.5
        bm[:, :, 0] = True
        bm[1, nb - 1] = False
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, T, h, D)).astype(np.float32)).cuda().to(dtype)
            for h in (H, Hk, Hk))
        route = fa.sparse_route(dtype, D, block, block)
        fa.reset_launch_counts()
        got = fa.flash_attention_sparse(q, k, v, bm, block_q=block,
                                        block_k=block)
        torch.cuda.synchronize()
        assert fa.SPARSE_ROUTES[route] == 1 and \
            fa.SPARSE_LAUNCHES["flash_sparse_fwd"] == 1
        assert got.shape == q.shape and got.dtype == dtype
        ref = fa.flash_attention_sparse_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bm,
            sm_scale=D ** -0.5, block_q=block,
            block_k=block).transpose(1, 2)
        assert not got[:, (nb - 1) * block:, 1].any()
        if dtype == torch.float32:
            assert (got - ref).abs().max().item() <= 1e-5, (D, block)
        else:
            assert _close_sparse(got, ref), (D, dtype, block, route)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_sparse_c3_misaligned_view_runs_on_card(D, dtype):
    """Fault C3: q/k/v views one element into a wider buffer (a base and
    strides that neither 16-byte rows nor TMA can take), and a head_dim
    stride of 2: the wrapper hands each route a dense copy and the result
    matches the plain version on the same values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    B, T, H = 2, 256, 2
    g = torch.Generator(device="cuda").manual_seed(D)
    buf = torch.randn(B, T, 3 * H * D + 1, generator=g,
                      device="cuda").to(dtype)
    q, k, v = (buf[..., 1 + i * H * D:1 + (i + 1) * H * D].unflatten(
        -1, (H, D)) for i in range(3))
    wide = torch.randn(B, T, H, 2 * D, generator=g, device="cuda").to(dtype)
    bm = np.ones((H, 2, 2), bool)
    bm[0, 1, 0] = False
    for qq, kk, vv in ((q, k, v), (wide[..., ::2], k, wide[..., 1::2])):
        fa.reset_launch_counts()
        got = fa.flash_attention_sparse(qq, kk, vv, bm)
        torch.cuda.synchronize()
        assert fa.SPARSE_LAUNCHES["flash_sparse_fwd"] == 1
        ref = fa.flash_attention_sparse_plain(
            *(t.transpose(1, 2).contiguous() for t in (qq, kk, vv)), bm,
            sm_scale=D ** -0.5).transpose(1, 2)
        if dtype == torch.float32:
            assert (got - ref).abs().max().item() <= 1e-5, D
        else:
            assert _close_sparse(got, ref), (D, dtype)


# ------------- fault C4 (fp16), the int8 pool, ALiBi and the decode ring

#: kernel-vs-plain limits of the paged kernels: bf16 8e-3 (1.6e-2 above
#: D = 64) and fp16 4e-3, both with 2**-8 of the plain output's norm;
#: fp32 1e-5
PAGED_LIMITS = {torch.bfloat16: (8e-3, 1.6e-2, 2.0 ** -8),
                torch.float16: (4e-3, 4e-3, 2.0 ** -8),
                torch.float32: (1e-5, 1e-5, 1.0)}


def _paged_case(rng, *, S, C, H, KV, D, bs, maxb, lens, dtype, quant=False,
                alibi=False):
    """Seeded inputs of one paged call on the card: q [S, C, H, D] at the
    last C positions of each context (``lens``; 0 marks an idle slot),
    shuffled block tables, the pool (standard normal rows, as the tests
    above: the max-abs limits are about one output ulp at magnitudes up
    to 1-2) in ``dtype`` or, with ``quant``, int8 codes and [KV, slots]
    scales from ``quantize_rows``; ALiBi
    slopes of ``alibi_slopes(H)``. Returns (args, extras)."""
    from deepspeed_tpu_torch.inference.v2.kv_quant import quantize_rows
    from deepspeed_tpu_torch.models._lm_utils import alibi_slopes
    nb = S * maxb
    kp, vp = _pool(rng, nb, bs, KV, D)
    tables = rng.permutation(nb).astype(np.int32).reshape(S, maxb)
    lens = np.asarray(lens, np.int32)
    start = np.maximum(lens - C, 0).astype(np.int32)
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    ex = {}
    if quant:
        kq, ks = quantize_rows(torch.from_numpy(kp), KV)
        vq, vs = quantize_rows(torch.from_numpy(vp), KV)
        pool = [kq.cuda(), vq.cuda()]
        ex.update(k_scales=ks.contiguous().cuda(),
                  v_scales=vs.contiguous().cuda())
    else:
        pool = [torch.from_numpy(a).cuda().to(dtype) for a in (kp, vp)]
    if alibi:
        ex["alibi_slopes"] = alibi_slopes(H).cuda()
    args = [torch.from_numpy(q).cuda().to(dtype), *pool] + [
        torch.from_numpy(a).cuda() for a in (tables, start, lens)]
    return args, ex


def _check_paged(fn, args, ex, kw, D, what, launches=None, tol=None):
    """Run ``fn`` on the card twice (the same bits), against the plain
    version on the CPU within PAGED_LIMITS (or the max-abs ``tol``);
    ``launches``: the ROUTE_LAUNCHES keys that each call must add to."""
    port.reset_launch_counts()
    got = fn(*args, **kw, **ex)
    again = fn(*args, **kw, **ex)
    torch.cuda.synchronize()
    for key in launches or ():
        assert port.ROUTE_LAUNCHES[key] == 2, (what, key, port.ROUTE_LAUNCHES)
    assert torch.equal(got, again), what
    ref = port.paged_attention_plain(
        *(a.cpu() for a in args), **kw,
        **{k: v.cpu() if isinstance(v, torch.Tensor) else v
           for k, v in ex.items()})
    lo, hi, rel_tol = PAGED_LIMITS[args[0].dtype]
    tol = tol or (lo if D <= 64 else hi)
    diff = got.float().cpu() - ref.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.float().norm()).item()
    assert err <= tol and rel <= rel_tol, (what, err, rel)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 80, 96, 128])
@pytest.mark.parametrize("group", [1, 8, 32])
def test_paged_kernels_c4_fp16_match_plain_on_card(D, group):
    """Fault C4: fp16 q and pool, which the kernels refused, on every K1
    route the shapes reach at this head dim (mma.sync at C = 40; at D 64
    and 128 the wgmma kernel with K/V by TMA at block 64 and by the
    cp.async gather at block 16) and in K2 (split over its context), GQA
    1, 8 and 32, an idle slot; fp16 within 4e-3 and 2**-8 of the norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(D * 100 + group)
    KV = 2
    H = KV * group
    dt = torch.float16
    cases = [("paged_prefill", 40, 16, 8)]
    if D in port.WGMMA_PREFILL_HEAD_DIMS:
        cases += [("paged_prefill", 128, 64, 4),
                  ("paged_prefill", 128, 16, 16)]
    cases += [("paged_decode", 1, 64, 16)]
    for name, C, bs, maxb in cases:
        lens = [C, 0, maxb * bs - 3, maxb * bs // 2 + C]
        args, ex = _paged_case(rng, S=4, C=C, H=H, KV=KV, D=D, bs=bs,
                               maxb=maxb, lens=lens, dtype=dt)
        kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=None,
                  num_kv_heads=KV)
        route = ("decode_split" if name == "paged_decode" else
                 "prefill_" + port.prefill_route(C, D, dt, bs))
        got = _check_paged(getattr(port, name), args, ex, kw, D,
                           (name, D, group, C, bs), (route, "fp16"))
        assert not got[1].any(), "idle slot must emit zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("window", [None, 50])
def test_paged_kernels_int8_pool_match_plain_on_card(D, dtype, window):
    """An int8 pool with per-(token, KV head) scales in bf16, fp16 and
    fp32 compute: K1 (C = 40 and 128, both on the mma.sync kernel that
    widens the codes, or the fp32 kernel) and K2 (split, GQA 4), with and
    without a window, and ALiBi on K2; against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(D + (window or 0))
    H, KV = 16, 4
    for name, C, bs, maxb, alibi in (("paged_prefill", 40, 16, 8, False),
                                     ("paged_prefill", 128, 64, 4, False),
                                     ("paged_decode", 1, 64, 32, False),
                                     ("paged_decode", 1, 64, 32, True)):
        lens = [C, maxb * bs - 5, 0, 300 + C]
        args, ex = _paged_case(rng, S=4, C=C, H=H, KV=KV, D=D, bs=bs,
                               maxb=maxb, lens=lens, dtype=dtype, quant=True,
                               alibi=alibi)
        kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=window,
                  num_kv_heads=KV)
        if name == "paged_decode":
            route = "decode_f32" if dtype == torch.float32 else "decode_split"
        else:
            route = "prefill_" + port.prefill_route(C, D, dtype, bs, True)
            assert route in ("prefill_mma", "prefill_f32"), route
        got = _check_paged(getattr(port, name), args, ex, kw, D,
                           (name, D, dtype, window, C), (route, "int8"))
        assert not got[2].any(), "idle slot must emit zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_paged_kernels_alibi_match_plain_on_card(dtype):
    """ALiBi at Bloom-7B1's heads (32 of 128, no GQA) and at 12 heads of
    64 (a head count that is no power of two): K1 on each route the
    shapes reach (wgmma by TMA and by the gather, mma.sync at C = 40, or
    the fp32 kernel) and K2, with a window once; against the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(17)
    for H, KV, D in ((32, 32, 128), (12, 12, 64), (8, 8, 96)):
        for name, C, bs, maxb, window in (
                ("paged_prefill", 128, 64, 4, None),
                ("paged_prefill", 128, 16, 16, 100),
                ("paged_prefill", 40, 16, 8, None),
                ("paged_decode", 1, 64, 16, None),
                ("paged_decode", 1, 64, 16, 200)):
            lens = [C, maxb * bs - 1, 0, maxb * bs // 2]
            args, ex = _paged_case(rng, S=4, C=C, H=H, KV=KV, D=D, bs=bs,
                                   maxb=maxb, lens=lens, dtype=dtype,
                                   alibi=True)
            kw = dict(block_size=bs, sm_scale=D ** -0.5,
                      sliding_window=window, num_kv_heads=KV)
            _check_paged(getattr(port, name), args, ex, kw, D,
                         (name, H, D, C, bs, window), ("alibi",))


@pytest.mark.cuda
@pytest.mark.parametrize("ring_count", [1, 5, 32])
@pytest.mark.parametrize("dtype,quant", [
    (torch.bfloat16, True), (torch.float16, True), (torch.float32, True),
    (torch.bfloat16, False)])
def test_paged_decode_ring_matches_plain_on_card(ring_count, dtype, quant):
    """K2's ring round: the decode loop's own K/V as a [R, S, KV*D] view
    of its [R, L, 2, S, KV*D] carry in the compute dtype, rows below
    ``ring_count`` attended after the settled pool (int8 with scales, or
    bf16), an idle slot, and once with a window and ALiBi; the ring's
    split merges with the pool's in split order (the same bits twice)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(ring_count + 7 * quant)
    S, H, KV, D, bs, maxb, R, L = 4, 32, 4, 128, 64, 32, 32, 3
    for window, alibi in ((None, False), (40, True)):
        settled = [1, maxb * bs - 40, 0, 700]
        args, ex = _paged_case(rng, S=S, C=1, H=H, KV=KV, D=D, bs=bs,
                               maxb=maxb, lens=settled, dtype=dtype,
                               quant=quant, alibi=alibi)
        # the query sits ring_count - 1 past the settled tokens
        args[4] = (args[5] + ring_count - 1).to(torch.int32)
        carry = torch.from_numpy(rng.standard_normal(
            (R, L, 2, S, KV * D)).astype(np.float32)).cuda().to(dtype)
        ex.update(ring_k=carry[:, 1, 0], ring_v=carry[:, 1, 1],
                  ring_count=ring_count)
        kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=window,
                  num_kv_heads=KV)
        got = _check_paged(port.paged_decode, args, ex, kw, D,
                           (dtype, quant, ring_count, window), ("ring",))
        assert not got[2].any(), "idle slot must emit zeros"


def _prefix_hit_case(rng, *, C, H, KV, D, bs, dtype, quant):
    """The prefix cache's hit path as K1 and K2 see it: three slots whose
    tables share the blocks of a 1000-token preamble (one block id in
    three tables), each with private blocks after it, and an idle slot.
    K1 (C > 1): each slot's first chunk after a CoW tail, starting at
    position 1000 (40 rows into block 15) with 24, 200 and 117 of the C
    queries live. K2 (C = 1): a decode at the end of each context."""
    from deepspeed_tpu_torch.inference.v2.kv_quant import quantize_rows
    pre, ntok = 1000, np.array([24, 200, 117, 0])
    maxb = -(-(pre + 200) // bs)
    nshared = pre // bs + 1
    S = 4
    nb = nshared + S * (maxb - nshared) + 1
    ids = rng.permutation(nb)
    tables = np.zeros((S, maxb), np.int32)
    tables[:, :nshared] = ids[:nshared]
    for s in range(S):
        lo = nshared + s * (maxb - nshared)
        tables[s, nshared:] = ids[lo:lo + maxb - nshared]
    lens = np.where(ntok > 0, pre + ntok, 0).astype(np.int32)
    start = (np.full(S, pre, np.int32) if C > 1
             else np.maximum(lens - 1, 0).astype(np.int32))
    kp, vp = _pool(rng, nb, bs, KV, D)
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    ex = {}
    if quant:
        kq, ks = quantize_rows(torch.from_numpy(kp), KV)
        vq, vs = quantize_rows(torch.from_numpy(vp), KV)
        pool = [kq.cuda(), vq.cuda()]
        ex.update(k_scales=ks.contiguous().cuda(),
                  v_scales=vs.contiguous().cuda())
    else:
        pool = [torch.from_numpy(a).cuda().to(dtype) for a in (kp, vp)]
    args = [torch.from_numpy(q).cuda().to(dtype), *pool] + [
        torch.from_numpy(a).cuda() for a in (tables, start, lens)]
    return args, ex


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, False),
                                         (torch.float16, False),
                                         (torch.bfloat16, True)])
def test_paged_kernels_at_prefix_hit_shapes_on_card(D, dtype, quant):
    """K1 and K2 on the prefix cache's hit path against the plain
    version: an unaligned start (1000, block 64), fewer live queries than
    C = 256, blocks shared by three slots' tables, GQA 7 (28 heads on 4),
    in bf16, fp16 and over an int8 pool with scales (K1 then on mma.sync);
    the limits of the tests above, the same bits from a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(D + 7 * int(quant))
    KV, bs = 4, 64
    for name, C in (("paged_prefill", 256), ("paged_decode", 1)):
        args, ex = _prefix_hit_case(rng, C=C, H=7 * KV, KV=KV, D=D, bs=bs,
                                    dtype=dtype, quant=quant)
        kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=None,
                  num_kv_heads=KV)
        route = ("decode_split" if C == 1 else
                 "prefill_" + port.prefill_route(C, D, dtype, bs, quant))
        if quant and C > 1:
            assert route == "prefill_mma"
        got = _check_paged(getattr(port, name), args, ex, kw, D,
                           (name, D, dtype, quant), (route,))
        assert not got[3].any(), "idle slot must emit zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_prefix_block_moves_bit_exact_on_card(quant):
    """The KV block movers on a card pool (bf16, or int8 with scales):
    the CoW copy, pause's offload (pinned host, non-blocking) and
    restore, and a demotion's gather then promotion, both before the
    demotion is materialized (from the device gather) and after (from
    the pinned host copy): every moved block bit-identical, scales with
    rows, with no host wait between the moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.inference.v2 import (BlockedKVCache,
                                                  PrefixCache,
                                                  RaggedInferenceConfig,
                                                  StateManager)
    bs = 64
    cfg = RaggedInferenceConfig(
        block_size=bs, num_blocks=12, max_blocks_per_seq=4,
        kv_cache_dtype="int8" if quant else "auto", prefix_cache=True,
        prefix_cache_host_blocks=8)
    kv = BlockedKVCache(cfg, 3, 4, 128, torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    if quant:
        kv.data.copy_(torch.randint(-127, 128, kv.data.shape, generator=g,
                                    device="cuda", dtype=torch.int8))
        kv.scales.copy_(torch.rand(kv.scales.shape, generator=g,
                                   device="cuda"))
    else:
        kv.data.copy_(torch.randn(kv.data.shape, generator=g,
                                  device="cuda").to(torch.bfloat16))

    def block(b):
        rows = kv.data[:, :, b * bs:(b + 1) * bs].clone()
        sc = kv.scales[..., b * bs:(b + 1) * bs].clone() if quant else None
        return rows, sc

    def same(a, b):
        return torch.equal(a[0], b[0]) and (a[1] is None
                                            or torch.equal(a[1], b[1]))
    before = {b: block(b) for b in range(12)}
    kv.copy_block(3, 9)
    host = kv.offload([1, 9, 4])
    assert host[0].is_pinned()
    kv.data[:, :, bs:2 * bs].zero_()                   # reuse block 1
    kv.restore(host, [10, 11, 1])
    torch.cuda.synchronize()
    assert same(block(9), before[3])
    for b, src in ((10, 1), (11, 3), (1, 4)):
        assert same(block(b), before[src]), b
    # demote a cached two-block chain, then promote it back
    pc = PrefixCache(bs, host_blocks=8)
    kv.attach_prefix_cache(pc)
    sm = StateManager(cfg, kv)
    sm.prefix = pc
    for materialize in (False, True):
        seq = sm.put_tokens(0, list(range(1, 2 * bs + 2)))
        plan = sm.match_prefix(seq)
        if plan:
            kv.promote_blocks(plan.promotes)
        sm.ensure_blocks(seq, seq.in_flight)
        seq.seen_tokens += seq.in_flight
        seq.pending_tokens.clear()
        chain = {i: block(b) for i, b in enumerate(seq.kv_blocks[:2])}
        sm.register_prefix(seq)
        sm.flush(0)
        held = kv.reserve(cfg.num_blocks)
        for b in held:
            kv.data[:, :, b * bs:(b + 1) * bs].zero_()
        if materialize:
            kv.finalize_demotions()
        kv.free(held)
        seq = sm.put_tokens(1, list(range(1, 2 * bs + 2)))
        plan = sm.match_prefix(seq)
        assert plan.promoted_blocks == 2
        kv.promote_blocks(plan.promotes)
        torch.cuda.synchronize()
        for i, b in enumerate(seq.kv_blocks[:2]):
            assert same(block(b), chain[i]), (materialize, i)
        pc.check_invariants()
        pc.assert_exact_refs([seq])
        sm.flush(1)


@pytest.mark.cuda
@pytest.mark.parametrize("name,C", [("paged_prefill", 256),
                                    ("paged_decode", 1)])
def test_paged_kernels_at_gpt2_xl_shapes_on_card(name, C):
    """K1 and K2 at GPT-2 XL's heads (25 query heads on 25 KV heads of 64,
    no GQA: an odd KV-head count through ``decode_plan`` and
    ``prefill_route``), 16 slots at context 256 (K1: the 256-query prefill
    chunk, wgmma by TMA; K2: one query a slot), bf16 and fp16, against the
    plain version; limits as in chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(26)
    S, H, D, bs, ctx = 16, 25, 64, 64, 256
    maxb = ctx // bs
    kp, vp = _pool(rng, S * maxb, bs, H, D)
    tables = rng.permutation(S * maxb).reshape(S, maxb).astype(np.int32)
    lens = np.full(S, ctx, np.int32)
    start = lens - C
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    for dt, tol in ((torch.bfloat16, 8e-3), (torch.float16, 4e-3)):
        args = [torch.from_numpy(a).cuda() for a in
                (q, kp, vp, tables, start, lens)]
        args[:3] = [a.to(dt) for a in args[:3]]
        kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=None,
                  num_kv_heads=H)
        port.reset_launch_counts()
        got = getattr(port, name)(*args, **kw)
        assert port.LAUNCHES[name] == 1
        ref = port.paged_attention_plain(*[a.cpu() for a in args], **kw)
        diff = got.float().cpu() - ref.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / ref.float().norm()).item()
        assert err <= tol and rel <= 2.0 ** -8, (dt, err, rel)
        if C > 1:
            assert port.prefill_route(C, D, dt, bs) == "wgmma_tma"


@pytest.mark.cuda
def test_verify_feed_matches_self_fed_loop_on_card():
    """Speculative decoding's verify on the card: a GPT-2 (25 heads of
    64, vocabulary 50257, bf16, paged kernels) decodes 6 tokens a slot
    self-fed; the verify pass fed [its first input, its own first 5
    outputs] from the same state gives the same 6 tokens (the argmax over
    the odd vocabulary included), and a draft row that breaks at step 3
    gives the same tokens up to and including step 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.checkpoint import init_gpt2_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    cfg = GPT2Config(vocab_size=50257, max_seq_len=1024, num_layers=2,
                     num_heads=25, hidden_size=1600, dtype=torch.bfloat16)
    params = init_gpt2_params(cfg, seed=3, device="cuda",
                              dtype=torch.bfloat16)
    eng = InferenceEngineV2(cfg, params, RaggedInferenceConfig(
        max_seqs=4, chunk_size=128, block_size=64, num_blocks=32,
        max_blocks_per_seq=6, dtype="bfloat16", attention_impl="paged_flash",
        decode_loop_steps=0), device="cuda")
    rng = np.random.default_rng(4)
    uids = [0, 1, 2]
    first = eng.put(uids, [rng.integers(0, 50257, n).tolist()
                           for n in (100, 64, 130)], _greedy=True)
    n = 6
    tok0 = torch.zeros(4, dtype=torch.int32)
    start = torch.zeros(4, dtype=torch.int32)
    active = torch.zeros(4, dtype=torch.int32)
    tables = torch.zeros(4, 6, dtype=torch.int32)
    for i, u in enumerate(uids):
        s = eng.state.get(u)
        eng.state.ensure_blocks(s, n)
        tok0[i], start[i], active[i] = first[u], s.seen_tokens, 1
        tables[i, :len(s.kv_blocks)] = torch.tensor(s.kv_blocks)
    dev = [t.cuda() for t in (tok0, start, active, tables)]
    own, _, _ = eng.runner.decode_loop(eng.params, eng.kv_cache.pool, *dev,
                                       n)
    own = own.cpu()
    drafts = torch.cat([tok0[:, None], own[:, :n - 1]], dim=1)
    got, _, _ = eng.runner.decode_loop(eng.params, eng.kv_cache.pool, *dev,
                                       n, draft_toks=drafts.cuda())
    assert torch.equal(got.cpu()[:3], own[:3])
    broken = drafts.clone()
    broken[:, 3] = (broken[:, 3] + 1) % 50257
    got2, _, _ = eng.runner.decode_loop(eng.params, eng.kv_cache.pool,
                                        *dev, n, draft_toks=broken.cuda())
    assert torch.equal(got2.cpu()[:3, :3], own[:3, :3])


# ------------------------------------------- head dim 256 (GPT-J-6B's 16 x 256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("window", [None, 70])
def test_paged_kernels_d256_match_plain_on_card(dtype, group, window):
    """K1 and K2 at head dim 256, whose mma.sync instances keep Q in
    shared memory: K1 at C = 40 (a ragged query tile) and C = 128 (two
    tiles, mma.sync: the wgmma kernel is built for 64 and 128), K2 split
    over its context, GQA 1 and 2, with and without a window, an idle
    slot; within PAGED_LIMITS (bf16 1.6e-2, fp16 4e-3, fp32 1e-5 max-abs
    and 2**-8 of the norm) and the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    D, KV = 256, 2
    H = KV * group
    rng = np.random.default_rng(256 + group + (window or 0))
    for name, C, bs, maxb in (("paged_prefill", 40, 16, 8),
                              ("paged_prefill", 128, 64, 4),
                              ("paged_decode", 1, 64, 16)):
        lens = [C, 0, maxb * bs - 3, maxb * bs // 2 + C]
        args, ex = _paged_case(rng, S=4, C=C, H=H, KV=KV, D=D, bs=bs,
                               maxb=maxb, lens=lens, dtype=dtype)
        kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=window,
                  num_kv_heads=KV)
        if name == "paged_decode":
            route = "decode_f32" if dtype == torch.float32 else "decode_split"
        else:
            route = "prefill_" + port.prefill_route(C, D, dtype, bs)
            assert route in ("prefill_mma", "prefill_f32"), route
        got = _check_paged(getattr(port, name), args, ex, kw, D,
                           (name, dtype, group, window, C), (route,))
        assert not got[1].any(), "idle slot must emit zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_paged_kernels_d256_int8_alibi_ring_on_card(dtype):
    """Head dim 256 on what the other head dims take: an int8 pool (K1 on
    the mma.sync kernel that widens the codes, K2), ALiBi (K1 and K2, 12
    heads: no power of two), and K2's ring after an int8 and a plain
    pool; against the plain version within PAGED_LIMITS, but fp32 within
    2e-5: with ALiBi over hundreds of keys (slopes up to 0.5) the scores
    reach the hundreds, where one fp32 ulp is 1.5e-5 (a K1 case measured
    1.2e-5, 6e-7 of the norm, on an H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    D = 256
    tol = 2e-5 if dtype == torch.float32 else None
    rng = np.random.default_rng(2560)
    for name, C, bs, maxb, H, KV, quant, alibi in (
            ("paged_prefill", 40, 16, 8, 4, 2, True, False),
            ("paged_prefill", 128, 64, 4, 4, 2, True, True),
            ("paged_decode", 1, 64, 16, 8, 2, True, False),
            ("paged_prefill", 128, 64, 4, 12, 12, False, True),
            ("paged_decode", 1, 64, 16, 12, 12, False, True)):
        lens = [C, maxb * bs - 5, 0, 300 + C]
        args, ex = _paged_case(rng, S=4, C=C, H=H, KV=KV, D=D, bs=bs,
                               maxb=maxb, lens=lens, dtype=dtype,
                               quant=quant, alibi=alibi)
        kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=None,
                  num_kv_heads=KV)
        keys = (("int8",) if quant else ()) + (("alibi",) if alibi else ())
        got = _check_paged(getattr(port, name), args, ex, kw, D,
                           (name, dtype, quant, alibi, C), keys, tol)
        assert not got[2].any(), "idle slot must emit zeros"
    S, H, KV, bs, maxb, R, L = 4, 16, 16, 64, 8, 8, 2
    for quant in (True, False):
        args, ex = _paged_case(rng, S=S, C=1, H=H, KV=KV, D=D, bs=bs,
                               maxb=maxb, lens=[1, 300, 0, maxb * bs - 9],
                               dtype=dtype, quant=quant, alibi=True)
        args[4] = (args[5] + 4).to(torch.int32)       # 5 ring rows
        carry = torch.from_numpy(rng.standard_normal(
            (R, L, 2, S, KV * D)).astype(np.float32)).cuda().to(dtype)
        ex.update(ring_k=carry[:, 1, 0], ring_v=carry[:, 1, 1],
                  ring_count=5)
        kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=None,
                  num_kv_heads=KV)
        got = _check_paged(port.paged_decode, args, ex, kw, D,
                           ("ring", dtype, quant), ("ring",), tol)
        assert not got[2].any(), "idle slot must emit zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_paged_kernels_families_mqa_group_71_on_card(dtype):
    """Falcon-7B's multi-query heads (71 query heads on 1 KV head of 64):
    K2 splits the group into 5 chunks of 16 rows, the last with 7 live;
    K1 on the wgmma kernel (C = 128, by TMA and by the gather) and on
    mma.sync (C = 40); with ALiBi once (the plain version reshapes the
    slopes as [KV, g]); against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert port.decode_plan(4, 1, 71, 1024, 132)[0] == 5
    D, H, KV = 64, 71, 1
    rng = np.random.default_rng(71)
    for name, C, bs, maxb, alibi in (("paged_prefill", 128, 64, 4, False),
                                     ("paged_prefill", 128, 16, 16, True),
                                     ("paged_prefill", 40, 16, 8, False),
                                     ("paged_decode", 1, 64, 16, False),
                                     ("paged_decode", 1, 64, 16, True)):
        lens = [C, maxb * bs - 2, 0, maxb * bs // 2 + C]
        args, ex = _paged_case(rng, S=4, C=C, H=H, KV=KV, D=D, bs=bs,
                               maxb=maxb, lens=lens, dtype=dtype,
                               alibi=alibi)
        kw = dict(block_size=bs, sm_scale=D ** -0.5, sliding_window=None,
                  num_kv_heads=KV)
        got = _check_paged(getattr(port, name), args, ex, kw, D,
                           (name, dtype, C, bs, alibi),
                           ("alibi",) if alibi else ())
        assert not got[2].any(), "idle slot must emit zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("fam", ["opt", "bloom", "gpt_neox", "gptj", "falcon",
                                 "phi"])
def test_families_one_step_on_card(fam):
    """Each dense family of A5.4 served on the card from seeded weights
    (its ``tiny`` config; Falcon multi-query, BLOOM with ALiBi): in fp32
    with TF32 off the kernels' greedy tokens equal the dense path's, and
    a bf16 engine's prefill and decode steps launch K1 and K2 once a
    layer a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from deepspeed_tpu_torch.checkpoint import init_family_params
    from deepspeed_tpu_torch.checkpoint.jax_params import FAMILY_SHAPES
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    cls = {c.__name__: c for c in FAMILY_SHAPES}[{
        "opt": "OPTConfig", "bloom": "BloomConfig",
        "gpt_neox": "GPTNeoXConfig", "gptj": "GPTJConfig",
        "falcon": "FalconConfig", "phi": "PhiConfig"}[fam]]
    cfg = cls.tiny()
    params = init_family_params(cfg, seed=1, device="cuda",
                                dtype=torch.bfloat16)
    prompts = [list(range(3, 3 + n)) for n in (9, 30, 17)]

    def engine(dt, impl):
        return InferenceEngineV2(
            dataclasses.replace(cfg, dtype=getattr(torch, dt)), params,
            RaggedInferenceConfig(max_seqs=4, chunk_size=16, block_size=16,
                                  num_blocks=32, max_blocks_per_seq=4,
                                  dtype=dt, attention_impl=impl),
            device="cuda")

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = engine("float32", "dense").generate(prompts, max_new_tokens=6)
        got = engine("float32", "paged_flash").generate(prompts,
                                                        max_new_tokens=6)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got == want
    eng = engine("bfloat16", "paged_flash")
    port.reset_launch_counts()
    out = eng.generate(prompts, max_new_tokens=6)
    torch.cuda.synchronize()
    steps = eng.runner.step_counts
    assert [len(o) for o in out] == [6, 6, 6]
    assert port.LAUNCHES["paged_prefill"] == cfg.num_layers * steps["prefill"]
    assert port.LAUNCHES["paged_decode"] == cfg.num_layers * steps["decode"]
    assert port.ROUTE_LAUNCHES["alibi"] == (
        cfg.num_layers * (steps["prefill"] + steps["decode"])
        if fam == "bloom" else 0)


# ------------------------------------------------- the grouped expert GEMM

#: group sizes of the grouped GEMM's card cases: a decode step (a row an
#: expert, over more than 32 experts: two steps of the warp's scan), empty
#: experts among runs that fill no tile evenly, one live expert, a
#: prefill-sized run; then cases of the wgmma route: a live expert before
#: each empty, NaN-poisoned one and a single live expert of 700 rows
#: (128-row tiles), 33-80 rows an expert (64-row tiles)
GROUPED_SIZES = {
    "decode_60": (1,) * 52 + (2, 0, 0, 3, 1, 0, 4, 1),
    "ragged_empty": (0, 37, 0, 0, 129, 5, 0, 64),
    "one_live": (0, 0, 300, 0),
    "prefill_70": tuple(int(n) for n in
                        np.random.default_rng(7).integers(0, 300, 70)),
    "live_then_poisoned": (300, 0, 257, 0, 129, 0, 0, 511),
    "single_live_700": (0, 700, 0),
    "rows_64": (40, 0, 56, 60, 33, 50, 0, 80),
}
#: the cases whose plan takes the wgmma route at every dtype but fp32
GROUPED_WGMMA = ("one_live", "prefill_70", "live_then_poisoned",
                 "single_live_700", "rows_64")
#: against an fp32 reference: bf16 / fp16 within 2**-7 / 2**-10 of the
#: largest magnitude (one ulp of an output in the top binade: its
#: half-ulp rounding plus the fp32 sums' order), fp32 within 1e-5 of it
#: (summation order)
GROUPED_REL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
               torch.float32: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("K,N", [(64, 136), (200, 512), (200, 1408),
                                 (200, 128), (8, 24)])
@pytest.mark.parametrize("case", sorted(GROUPED_SIZES))
def test_grouped_gemm_matches_plain_on_card(case, K, N, dtype):
    """The grouped GEMM against an fp32 reference of the same inputs, at
    every row-tile height its plan picks (the cases' rows an expert run
    from 1 to 700) and both routes of 16-bit inputs, with N not a
    multiple of the column tile (136: one 256-column tile; 1408: six, the
    last half past N), both column tiles (128 at N 128 and 24), K not a
    multiple of the K step (200) and K, N below one TMA box (8, 24);
    bit-identical between calls; one launch a call, counted by route;
    experts with no rows never read (their weights are NaN here and
    would poison the output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    sizes = GROUPED_SIZES[case]
    R, E = sum(sizes), len(sizes)
    g = torch.Generator(device="cuda")
    g.manual_seed(R + K + N)
    x = torch.randn(R, K, generator=g, device="cuda").to(dtype)
    w = (torch.randn(E, K, N, generator=g, device="cuda")
         * K ** -0.5).to(dtype)
    for e, n in enumerate(sizes):
        if not n:
            w[e] = float("nan")
    off = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                       dtype=torch.int32, device="cuda")
    gg.reset_launch_counts()
    got = gg.ragged_dot(x, w, off)
    again = gg.ragged_dot(x, w, off)
    torch.cuda.synchronize()
    assert gg.LAUNCHES["grouped_gemm"] == 2
    wgmma = case in GROUPED_WGMMA and dtype != torch.float32
    assert (gg.grouped_plan(R, E, N, dtype).route == "wgmma") == wgmma
    assert gg.LAUNCHES["grouped_wgmma"] == (2 if wgmma else 0)
    ref = gg.ragged_dot_plain(x.float(), w.float(), off)
    err = (got.float() - ref).abs().max().item()
    assert err <= GROUPED_REL[dtype] * ref.abs().max().item(), (case, err)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_grouped_gemm_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    x = torch.zeros(4, 12, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(2, 12, 16, device="cuda", dtype=torch.bfloat16)
    off = torch.tensor([0, 2, 4], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        gg.ragged_dot(x, w, off)
    with pytest.raises(ValueError, match="int32"):
        gg.ragged_dot(x[:, :8].contiguous(), w[:, :8].contiguous(),
                      off.long())
    with pytest.raises(ValueError, match="on cpu"):
        gg.ragged_dot(x, w, off.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_grouped_moe_ffn_waits_for_nothing_on_card(k):
    """The MoE layer on CUDA tensors under
    ``torch.cuda.set_sync_debug_mode("error")``: no operation waits for
    the device (a bincount, nonzero or mask index would raise); its
    output is the plain grouped route's within bf16's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.nn.functional as F

    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    g = torch.Generator(device="cuda")
    g.manual_seed(k)
    S, M, E, H = 48, 64, 12, 96
    x = torch.randn(S, M, generator=g, device="cuda").to(torch.bfloat16)
    logits = torch.randn(S, E, generator=g, device="cuda")
    ws = [(torch.randn(E, a, b, generator=g, device="cuda") * a ** -0.5)
          .to(torch.bfloat16) for a, b in ((M, H), (M, H), (H, M))]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, l_aux = sharded_moe.grouped_moe_ffn(
            x, logits, k, ws, F.silu, torch.bfloat16,
            normalize_weights=k == 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    kernel = sharded_moe.ragged_dot
    sharded_moe.ragged_dot = gg.ragged_dot_plain
    try:
        ref, ref_aux = sharded_moe.grouped_moe_ffn(
            x, logits, k, ws, F.silu, torch.bfloat16,
            normalize_weights=k == 2)
    finally:
        sharded_moe.ragged_dot = kernel
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -6 * ref.float().abs().max().item(), err
    assert torch.equal(l_aux, ref_aux)


@pytest.mark.cuda
@pytest.mark.parametrize("fam", ["mixtral", "qwen2_moe"])
def test_moe_families_one_step_on_card(fam):
    """Each MoE family served on the card from seeded weights (its tiny
    config; Qwen2-MoE with a shared expert, top-4 over the full softmax):
    in fp32 with TF32 off the grouped kernel's greedy tokens equal the
    plain grouped route's, and a bf16 engine launches the grouped GEMM
    three times a layer a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from deepspeed_tpu_torch.checkpoint import init_family_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    over = {} if fam == "mixtral" else dict(
        num_experts=8, experts_top_k=4, shared_expert_size=96,
        qkv_bias=True, norm_topk_prob=False)
    cfg = MixtralConfig.tiny(**over)
    params = init_family_params(cfg, seed=1, device="cuda",
                                dtype=torch.float32)
    prompts = [list(range(3, 3 + n)) for n in (9, 30, 17)]

    def engine(dt):
        return InferenceEngineV2(
            dataclasses.replace(cfg, dtype=getattr(torch, dt)), params,
            RaggedInferenceConfig(max_seqs=4, chunk_size=16, block_size=16,
                                  num_blocks=32, max_blocks_per_seq=4,
                                  dtype=dt, attention_impl="paged_flash"),
            device="cuda")

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel = sharded_moe.ragged_dot
    try:
        got = engine("float32").generate(prompts, max_new_tokens=6)
        sharded_moe.ragged_dot = gg.ragged_dot_plain
        want = engine("float32").generate(prompts, max_new_tokens=6)
    finally:
        sharded_moe.ragged_dot = kernel
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got == want
    params = init_family_params(cfg, seed=1, device="cuda",
                                dtype=torch.bfloat16)
    eng = engine("bfloat16")
    gg.reset_launch_counts()
    out = eng.generate(prompts, max_new_tokens=6)
    torch.cuda.synchronize()
    steps = eng.runner.step_counts
    assert [len(o) for o in out] == [6, 6, 6]
    assert gg.LAUNCHES["grouped_gemm"] == 3 * cfg.num_layers * (
        steps["prefill"] + steps["decode"])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_fleet_disagg_handoff_and_counters_on_card(kv):
    """Two TinyLlama-width replicas (2 layers, seeded) on the one card as a
    prefill and a decode specialist: every handed-off block arrives
    bit-exact (scales too over an int8 pool), the streams equal one
    engine's, K1 / K2 launch, and each engine's token counter equals the
    tokens it committed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.checkpoint import init_llama_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.serving import ReplicaPool
    cfg = LlamaConfig.tinyllama_1b(num_layers=2, dtype=torch.bfloat16)
    params = init_llama_params(cfg, seed=5, device="cuda")

    def engine():
        return InferenceEngineV2(cfg, params, RaggedInferenceConfig(
            max_seqs=8, chunk_size=64, block_size=64, num_blocks=48,
            max_blocks_per_seq=4, dtype="bfloat16",
            attention_impl="paged_flash", kv_cache_dtype=kv,
            prefix_cache=True, serve_pipeline_depth=2), device="cuda")

    rng = np.random.default_rng(9)
    pre = rng.integers(1, cfg.vocab_size, 128).tolist()
    prompts = {u: pre + rng.integers(1, cfg.vocab_size, 40).tolist()
               for u in range(6)}

    def drive(pool):
        out = pool.put(list(prompts), [prompts[u] for u in prompts],
                       _greedy=True)
        toks = {u: [int(out[u])] for u in prompts}
        res = pool.decode_pipelined(list(toks), [t[0] for t in
                                                 toks.values()], 11)
        for u in toks:
            toks[u] += res[u]
            pool.flush(u)
        return toks

    want = drive(ReplicaPool([engine()], seed=0))
    pool = ReplicaPool([engine(), engine()], seed=0,
                       roles=["prefill", "decode"])
    dec = pool.replicas()[1].engine
    adopt, exact = dec.handoff_in, []

    def handoff_in(manifest, exposed_s=0.0):
        res = adopt(manifest, exposed_s=exposed_s)
        for rec in manifest["sequences"]:
            rows, scales = dec.kv_cache.gather_blocks(
                dec.state.get(int(rec["uid"])).kv_blocks)
            sent = rec["kv"] if isinstance(rec["kv"], tuple) \
                else (rec["kv"], None)
            exact.append(torch.equal(rows.cpu(), sent[0].cpu()) and (
                scales is None if sent[1] is None
                else torch.equal(scales.cpu(), sent[1].cpu())))
        return res
    dec.handoff_in = handoff_in
    port.reset_launch_counts()
    got = drive(pool)
    torch.cuda.synchronize()
    assert got == want
    assert len(exact) == len(prompts) and all(exact)
    assert port.LAUNCHES["paged_prefill"] > 0
    assert port.LAUNCHES["paged_decode"] > 0
    assert (port.ROUTE_LAUNCHES["int8"] > 0) == (kv == "int8")
    pre_m, dec_m = (r.engine.metrics for r in pool.replicas())
    assert pre_m.counter("serve_handoff_seqs").value == len(prompts)
    assert dec_m.counter("serve_handoff_seqs_in").value == len(prompts)
    # the prefill replica committed each first token, the decode replica
    # the rest; the fleet's counter is every token streamed
    assert pre_m.counter("serve_tokens_committed").value == len(prompts)
    assert dec_m.counter("serve_tokens_committed").value == \
        sum(len(t) for t in got.values()) - len(prompts)
    assert pool.fleet_snapshot()["counters"]["serve_tokens_committed"] \
        == sum(len(t) for t in got.values())
    for r in pool.replicas():
        assert r.engine.free_blocks == r.engine.config.num_blocks


#: B18's cases: rows an expert with empty experts and groups that are no
#: multiple of the wgrad kernel's 32-row stage or the forward's row tiles
B18_SIZES = {
    "ragged_empty": (0, 37, 0, 0, 129, 5, 0, 64),
    "one_row": (1, 0, 0, 0),
    "prefill_60": tuple(int(n) for n in
                        np.random.default_rng(9).integers(0, 300, 60)) +
    (0,),
    "all_empty_but_tail": (0, 0, 0, 33),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("K,N", [(64, 136), (200, 1408), (8, 24),
                                 (1408, 256)])
@pytest.mark.parametrize("case", sorted(B18_SIZES))
def test_grouped_gemm_backward_matches_plain_on_card(case, K, N, dtype):
    """B18: ``ragged_dot``'s data gradient (mma.sync over the weights read
    in place as their transpose) and weight gradient (``grouped_wgrad_kernel``)
    against fp32 references of the same inputs, through autograd, with
    empty experts (their dW exactly zero) and ragged groups, K and N not
    multiples of the tiles; bit-identical between calls; one launch each
    a call. Limits as the forward's (2**-7 / 2**-10 / 1e-5 of the largest
    magnitude)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    sizes = B18_SIZES[case]
    R, E = sum(sizes), len(sizes)
    g = torch.Generator(device="cuda")
    g.manual_seed(R + K + N)
    x = torch.randn(R, K, generator=g, device="cuda").to(dtype)
    w = (torch.randn(E, K, N, generator=g, device="cuda")
         * K ** -0.5).to(dtype)
    dy = torch.randn(R, N, generator=g, device="cuda").to(dtype)
    off = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                       dtype=torch.int32, device="cuda")
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    gg.reset_launch_counts()
    gg.ragged_dot(xl, wl, off).backward(dy)
    torch.cuda.synchronize()
    assert gg.LAUNCHES["grouped_dgrad"] == 1
    assert gg.LAUNCHES["grouped_wgrad"] == 1
    assert gg.LAUNCHES["grouped_gemm"] == 1
    ref_dx = gg.ragged_dot_plain(dy.float(), w.float().transpose(
        1, 2).contiguous(), off)
    ref_dw = gg.ragged_dot_wgrad_plain(x.float(), dy.float(), off)
    for got, ref in ((xl.grad, ref_dx), (wl.grad, ref_dw)):
        err = (got.float() - ref).abs().max().item()
        assert err <= GROUPED_REL[dtype] * max(ref.abs().max().item(),
                                               1e-30), (case, err)
    for e, n in enumerate(sizes):
        if not n:
            assert not wl.grad[e].any()
    assert torch.equal(gg.ragged_dot_wgrad(x, dy, off),
                       gg.ragged_dot_wgrad(x, dy, off))
    assert torch.equal(gg.ragged_dot_dgrad(dy, w, off),
                       gg.ragged_dot_dgrad(dy, w, off))


@pytest.mark.cuda
def test_grouped_backward_waits_for_nothing_on_card():
    """The grouped MoE layer's forward and backward (the offsets, the
    forward kernel, B18) read no device value on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.nn.functional as F
    from deepspeed_tpu_torch.moe import sharded_moe
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    S, M, I, E = 300, 64, 96, 6
    tok = torch.randn(S, M, generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    ws = [(torch.randn(*s, generator=g, device="cuda") * 0.1).to(
        torch.bfloat16).requires_grad_()
        for s in ((E, M, I), (E, M, I), (E, I, M))]
    logits = torch.randn(S, E, generator=g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, l_aux = sharded_moe.grouped_moe_ffn(tok, logits, 4, ws, F.silu,
                                               torch.bfloat16,
                                               normalize_weights=False)
        (y.float().sum() + l_aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t.grad.float()).all() for t in (tok, *ws))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("H,Hk,D,T", [(32, 8, 64, 512), (32, 4, 64, 512),
                                      (32, 8, 128, 384), (32, 4, 128, 384),
                                      (16, 4, 64, 300)])
def test_flash_backward_gqa_matches_plain_on_card(H, Hk, D, T, dtype):
    """The flash backward with GQA 4 and 8 at head dims 64 and 128 (the
    training shapes of TinyLlama and Mixtral, cut in length), through
    ``flash_attention``'s autograd in the BTHD layout with native KV heads,
    against ``flash_bwd_plain``: dQ, dK and dV within 2**-8 of the norm
    and a max-abs of the flash limits (1.6e-2 / 4e-3) or 2**-7 / 2**-10
    of the largest output, the larger (dK and dV sum a KV head's H / Hk
    query heads, so they grow with the group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    B = 2
    g = torch.Generator(device="cuda")
    g.manual_seed(H + Hk + D + T)
    q, k, v, do = (torch.randn(B, T, h, D, generator=g, device="cuda").to(
        dtype) for h in (H, Hk, Hk, H))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launch_counts()
    o = fa.flash_attention(*leaves, causal=True, layout="BTHD")
    o.backward(do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == 1
    for name in fa.bwd_launch_names(D, dtype):
        assert fa.LAUNCHES[name] == 1, fa.LAUNCHES
    kw = dict(causal=True, sm_scale=D ** -0.5)
    tq, tk, tv, tdo = (t.transpose(1, 2) for t in (q, k, v, do))
    ro, rlse = fa.flash_fwd_plain(tq, tk, tv, **kw)
    ref = fa.flash_bwd_plain(tq, tk, tv, tdo, ro, rlse, **kw)
    tol, rel_top = (1.6e-2, 2.0 ** -7) if dtype == torch.bfloat16 \
        else (4e-3, 2.0 ** -10)
    for name, got, r in zip(("dq", "dk", "dv"), leaves, ref):
        diff = got.grad.transpose(1, 2).float() - r.float()
        err = diff.abs().max().item()
        lim = max(tol, rel_top * r.float().abs().max().item())
        rel = (diff.norm() / r.float().norm()).item()
        assert err <= lim and rel <= 2.0 ** -8, (name, err, lim, rel)
