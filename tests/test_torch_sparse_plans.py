"""The wgmma block-sparse forward's launch geometry on the CPU: its deal of
work items (``flash_attention.sparse_plan``), its route choice
(``flash_attention.sparse_route``, with the head-dim padding of
``sparse_head_dim``), and a plain emulation of its order of work against
the JAX package's Pallas ``_fwd_sparse_kernel`` in interpret mode.

The plan and the route come from the mask and the shapes alone, so every
(batch, head, query tile) item, the balance of the persistent blocks and
the kernel each head dim reaches are checked here before a card runs
them. The emulation walks each block's items as
``sparse_fwd_wgmma_kernel`` does: 128 query rows an item (rows past Tq
zeros, as the TMA box fills them), the item's 128-key tiles from the CSR
row of its query block, the scores in fp32 scaled after the product, keys
at or past Tk masked, an online softmax a tile with the row sums taken
before P is cast to V's dtype, zeros for an item with no tile.
Tolerances: fp32 within 1e-5 (summation order only); bf16 within the
card's limits for the kernel against its plain version (8e-3 max-abs and
2**-8 of the reference's norm: the emulation and the Pallas kernel round
P to bf16 against running maxima taken over tiles of different widths)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels import flash_attention_sparse as jax_sparse
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

H100_SMS = 132
BF16_MAX_ABS, REL_NORM = 8e-3, 2.0 ** -8


def _mask(rng, H, Tq, Tk, block_q, block_k, dense=0.4):
    nq, nk = -(-Tq // block_q), -(-Tk // block_k)
    bm = rng.random((H, nq, nk)) < dense
    bm[:, :, 0] = True
    bm[H - 1, nq - 1] = False                    # a query block with no key
    return bm


def _check_plan(bm, block_q, block_k, Tq, Tk, B, sms):
    plan = fa.sparse_plan(bm, block_q, block_k, Tq, Tk, B, sms)
    H = bm.shape[0]
    nqt = -(-Tq // fa.SPARSE_ROWS)
    per = fa.sparse_item_tiles(bm, block_q, block_k, Tq, Tk)
    assert per.shape == (H, nqt)
    assert plan.items == B * H * nqt
    assert plan.grid == min(plan.items, sms) == len(plan.blocks)
    seen = set()
    for items in plan.blocks:
        assert items, "a block of the grid with no item"
        for b, h, qt, tiles in items:
            assert (b, h, qt) not in seen
            seen.add((b, h, qt))
            assert 0 <= b < B and 0 <= h < H and 0 <= qt < nqt
            assert tiles == per[h, qt]
        # heaviest first, a (batch, head)'s items in order within a weight
        keys = [(-t, (b * H + h) * nqt + qt) for b, h, qt, t in items]
        assert keys == sorted(keys)
    assert len(seen) == plan.items
    # each item to the least loaded block: the busiest block carries at
    # most the mean load plus the heaviest item
    cost = [sum(t + fa.SPARSE_ITEM_COST for *_, t in items)
            for items in plan.blocks]
    heaviest = int(per.max()) + fa.SPARSE_ITEM_COST
    assert max(cost) <= sum(cost) / len(cost) + heaviest
    return plan, cost


@pytest.mark.parametrize("B,H,Tq,Tk,block_q,block_k", [
    (1, 1, 128, 128, 128, 128),
    (2, 4, 384, 384, 128, 128),
    (1, 3, 300, 500, 128, 256),       # ragged, Tq != Tk, 256-key blocks
    (2, 2, 1000, 1000, 256, 128),     # two items a query block
    (4, 16, 4096, 4096, 128, 128),
])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_sparse_plan_deals_every_item_once(B, H, Tq, Tk, block_q, block_k,
                                           sms):
    rng = np.random.default_rng(Tq + Tk + sms)
    _check_plan(_mask(rng, H, Tq, Tk, block_q, block_k), block_q, block_k,
                Tq, Tk, B, sms)


def _phase20_layouts():
    H, T = 16, 4096
    return {
        "bslongformer": sa.BSLongformerSparsityConfig(
            H, block=128, num_sliding_window_blocks=3,
            global_block_indices=[0]).make_layout(T),
        "bigbird": sa.BigBirdSparsityConfig(
            H, block=128, num_random_blocks=1, num_sliding_window_blocks=3,
            num_global_blocks=1,
            different_layout_per_head=True).make_layout(T)}


@pytest.mark.parametrize("name", ["bslongformer", "bigbird"])
def test_sparse_plan_at_phase20_shapes(name):
    """chip_smoke.py phase 20 (BERT-large's 16 heads over B = 4 sequences
    of 4096 tokens): 2048 items on 132 blocks, the global rows' items (all
    32 tiles) dealt first, one to a block, and the busiest block within 3%
    of the mean load."""
    bm = _phase20_layouts()[name]
    plan, cost = _check_plan(bm, 128, 128, 4096, 4096, 4, H100_SMS)
    assert (plan.items, plan.grid) == (2048, 132)
    firsts = [items[0] for items in plan.blocks]
    heavy = [it for it in firsts if it[3] == 32]
    assert len(heavy) == 64 and all(it[2] == 0 for it in heavy)
    assert sum(t for items in plan.blocks for *_, t in items) \
        == 4 * int(bm.sum())
    assert max(cost) <= 1.03 * sum(cost) / len(cost), (max(cost), cost)


def test_sparse_plan_refuses_other_blocks():
    bm = np.ones((1, 2, 2), bool)
    for bq, bk in ((64, 128), (128, 192)):
        with pytest.raises(ValueError):
            fa.sparse_plan(bm, bq, bk, 128 * 2, 128 * 2, 1, 132)
    with pytest.raises(ValueError, match="shape"):
        fa.sparse_plan(bm, 128, 128, 128, 256, 1, 132)


def test_plan_tensors_are_the_plan():
    """The device form (block_ptr, items) decodes to the plan, block by
    block, and is cached per mask."""
    rng = np.random.default_rng(3)
    bm = _mask(rng, 3, 700, 700, 128, 128)
    args = (bm.tobytes(), bm.shape, 128, 128, 700, 700, 2, 5, "cpu")
    block_ptr, items, grid = fa._plan_tensors(*args)
    plan = fa.sparse_plan(bm, 128, 128, 700, 700, 2, 5)
    nqt = -(-700 // fa.SPARSE_ROWS)
    assert grid == plan.grid and block_ptr.tolist()[0] == 0
    for blk, want in enumerate(plan.blocks):
        lo, hi = block_ptr[blk].item(), block_ptr[blk + 1].item()
        got = [divmod(divmod(c, nqt)[0], 3) + (c % nqt,)
               for c in items[lo:hi].tolist()]
        assert got == [(b, h, qt) for b, h, qt, _ in want]
    assert fa._plan_tensors(*args)[1] is items


@pytest.mark.parametrize("D", list(range(1, 129, 7)) + [16, 32, 64, 80, 96,
                                                        128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("blocks", [(128, 128), (256, 128), (128, 256),
                                    (64, 128), (192, 64)])
def test_sparse_route_is_a_function_of_the_shapes(D, dtype, blocks):
    bq, bk = blocks
    route = fa.sparse_route(dtype, D, bq, bk)
    dk = fa.sparse_head_dim(D)
    assert dk in fa.SPARSE_HEAD_DIMS and dk >= D
    assert all(d < D for d in fa.SPARSE_HEAD_DIMS if d < dk)
    if dtype == torch.float32:
        assert route == "f32"
    elif dk in (64, 128) and bq % 128 == 0 and bk % 128 == 0:
        assert route == "wgmma"
        assert fa.sparse_plan(np.ones((1, 2, 2), bool), bq, bk, 2 * bq,
                              2 * bk, 1, H100_SMS).grid >= 1
    else:
        assert route == "mma"


def test_sparse_route_refusals_name_themselves():
    with pytest.raises(NotImplementedError, match="head_dim 192"):
        fa.sparse_route(torch.bfloat16, 192, 128, 128)
    with pytest.raises(NotImplementedError, match="head_dim 129"):
        fa.sparse_head_dim(129)
    with pytest.raises(NotImplementedError, match="block_q 100"):
        fa.sparse_route(torch.bfloat16, 64, 100, 128)
    with pytest.raises(ValueError, match="dtype"):
        fa.sparse_route(torch.float64, 64, 128, 128)


def _emulate_wgmma(q, k, v, bm, *, sm_scale, block_q, block_k, sms):
    """sparse_fwd_wgmma_kernel's order of work in plain PyTorch, on
    ``[B, H, T, D]`` tensors of any float dtype."""
    B, H, Tq, D = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    R, K = fa.SPARSE_ROWS, fa.SPARSE_KEYS
    plan = fa.sparse_plan(bm, block_q, block_k, Tq, Tk, B, sms)
    row_ptr, tiles = fa.sparse_tile_csr(bm, block_k, Tk, "cpu", tile=K)
    pad = lambda x, n: torch.nn.functional.pad(                # noqa: E731
        x, (0, 0, 0, n - x.shape[0]))
    o = torch.full_like(q, float("nan"))
    for items in plan.blocks:
        for b, h, qt, ntiles in items:
            hk = h // (H // Hk)
            q0 = qt * R
            qs = pad(q[b, h, q0:q0 + R], R).float()
            at = h * bm.shape[1] + q0 // block_q
            walk = tiles[row_ptr[at]:row_ptr[at + 1]].tolist()
            assert len(walk) == ntiles
            m = torch.full((R,), float("-inf"))
            l = torch.zeros(R)
            acc = torch.zeros(R, D)
            for t in walk:
                k0 = t * K
                kt = pad(k[b, hk, k0:k0 + K], K)
                vt = pad(v[b, hk, k0:k0 + K], K)
                s = qs @ kt.float().T * sm_scale
                s[:, torch.arange(k0, k0 + K) >= Tk] = float("-inf")
                m_new = torch.maximum(m, s.amax(dim=1))
                m_safe = torch.where(m_new == float("-inf"),
                                     torch.zeros_like(m_new), m_new)
                alpha = torch.exp(m - m_safe)
                p = torch.exp(s - m_safe[:, None])
                l = l * alpha + p.sum(dim=1)
                acc = acc * alpha[:, None] + p.to(v.dtype).float() \
                    @ vt.float()
                m = m_new
            out = acc / torch.where(l == 0, torch.ones_like(l), l)[:, None]
            n = min(R, Tq - q0)
            o[b, h, q0:q0 + n] = out[:n].to(q.dtype)
    return o


@pytest.mark.parametrize("B,H,Hk,Tq,Tk,D,block_q,block_k", [
    (2, 2, 2, 384, 384, 64, 128, 128),
    (1, 4, 2, 300, 300, 64, 128, 128),     # ragged T, GQA 4 -> 2
    (1, 2, 1, 200, 333, 128, 128, 128),    # Tq != Tk, ragged Tk
    (1, 2, 2, 512, 520, 64, 256, 256),     # two items a query block
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_wgmma_order_matches_the_pallas_kernel(
        B, H, Hk, Tq, Tk, D, block_q, block_k, dtype):
    """The emulation against the JAX package's flash_attention_sparse (its
    Pallas kernel in interpret mode) and against the port's plain version;
    the query block without an allowed key block gives zeros."""
    rng = np.random.default_rng(Tq * D + Tk)
    bm = _mask(rng, H, Tq, Tk, block_q, block_k)
    arr = lambda t, h: rng.standard_normal(                    # noqa: E731
        (B, h, t, D)).astype(np.float32)
    qn, kn, vn = arr(Tq, H), arr(Tk, Hk), arr(Tk, Hk)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.array(jax_sparse(
        *(jnp.asarray(a).astype(jdt) for a in (qn, kn, vn)),
        bm.astype(np.int32), block_q=block_q, block_k=block_k,
        layout="BHTD", interpret=True).astype(jnp.float32))
    q, k, v = (torch.from_numpy(a).to(dtype) for a in (qn, kn, vn))
    got = _emulate_wgmma(q, k, v, bm, sm_scale=D ** -0.5, block_q=block_q,
                         block_k=block_k, sms=5)
    plain = fa.flash_attention_sparse_plain(q, k, v, bm, sm_scale=D ** -0.5,
                                            block_q=block_q, block_k=block_k)
    nq = bm.shape[1]
    assert not got[:, H - 1, (nq - 1) * block_q:].any()
    for ref in (torch.from_numpy(want), plain.float()):
        diff = got.float() - ref
        if dtype == torch.float32:
            assert diff.abs().max().item() <= 1e-5
        else:
            assert diff.abs().max().item() <= BF16_MAX_ABS
            assert (diff.norm() / ref.norm()).item() <= REL_NORM
