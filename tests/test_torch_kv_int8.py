"""Port parity for the int8 and fp16 KV pool, ALiBi and the decode-loop
ring, against the JAX package on the CPU.

- ``kv_quant``: the port's codes and scales are the JAX package's bit for
  bit (both round half to even, both divide truly), zero rows included.
- ``alibi_slopes``: the JAX package's values exactly.
- ``paged_attention_plain`` (what the port's kernels compute, run by the
  wrappers on CPU tensors) against the JAX ``flash_paged_attention`` in
  Pallas interpret mode (``_paged_kernel`` for chunks and multi-block
  decode, ``_decode_grouped_kernel`` for the linear layout): an int8 pool
  with scales, ALiBi, the decode ring, int8 with a sliding window, and
  fp16. Inputs are made with numpy from a seed and handed to both. fp32
  within 1e-5 (summation order, and the order of the K scale's and
  sm_scale's products); fp16 within FP16_ATOL.
- The int8 engine (fp32 compute, dense attention) gives the JAX int8
  engine's greedy tokens: chunked prefill, decode loops of 0 and 4 steps
  (the loop attends its own tokens from the unquantized ring and
  quantizes them when it flushes), EOS and a sliding window; and the same
  tokens on ``paged_flash`` (the kernels' plain versions on the CPU).
- An fp16 engine's prefill logits against the JAX fp16 engine's.
- The int8 pool's bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.inference.v2 import kv_quant as jkq
from deepspeed_tpu.models import _lm_utils as jlm
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops.kernels.paged_attention import \
    flash_paged_attention as jax_flash_paged_attention
from deepspeed_tpu_torch.checkpoint import llama_params_from_numpy
from deepspeed_tpu_torch.inference.v2 import (BlockedKVCache,
                                              InferenceEngineV2,
                                              RaggedInferenceConfig)
from deepspeed_tpu_torch.inference.v2 import kv_quant as tkq
from deepspeed_tpu_torch.models import _lm_utils as tlm
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.ops.kernels import paged_attention as port

TOL = dict(atol=1e-5, rtol=1e-5)
#: fp16 plain version against the fp16 Pallas kernel: both round P to
#: fp16 before P.V from exponentials that may differ in their last bit,
#: and round the output to fp16; twice the largest reading (2.44e-4, one
#: fp16 ulp at 0.25-0.5; outputs reach 2.6)
FP16_ATOL = 5e-4


# ------------------------------------------------------------- kv_quant


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_rows_is_jax_bit_for_bit(scale):
    rng = np.random.default_rng(int(scale * 7) + 1)
    KV, D = 4, 32
    x = (rng.standard_normal((96, KV * D)) * scale).astype(np.float32)
    x[3] = 0.0                                   # a zero row: scale 1
    x[5, :D] = 0.0                               # one zero head
    # half-way codes: amax 127 gives s = 1, so r / s = k + 0.5 exactly
    x[7, :D] = np.arange(D) - 15.5
    x[7, 0] = 127.0
    x[8, D:2 * D] = np.linspace(-127.0, 127.0, D)
    jq, js = jkq.quantize_rows(jnp.asarray(x), KV)
    tq, ts = tkq.quantize_rows(torch.from_numpy(x), KV)
    assert tq.dtype == torch.int8 and ts.shape == (KV, 96)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 3] == 1.0 and not tq[3].any()
    # half to even on both sides: 0.5 -> 0, 1.5 -> 2, -0.5 -> -0
    assert tq[7, 15].item() == 0 and tq[7, 17].item() == 2
    np.testing.assert_array_equal(
        tkq.dequantize_rows(tq, ts, torch.float32).numpy(),
        np.asarray(jkq.dequantize_rows(jq, js, jnp.float32)))


def test_quantize_rows_of_bf16_rows_is_jax_bit_for_bit():
    """The rows a bf16 engine writes: bf16 K/V widened to f32 first."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 256)).astype(np.float32) * 4
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jq, js = jkq.quantize_rows(jnp.asarray(x, jnp.bfloat16), 2)
    tq, ts = tkq.quantize_rows(xb, 2)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("heads", [8, 12, 32])
def test_alibi_slopes_are_jax_exactly(heads):
    got = tlm.alibi_slopes(heads)
    assert got.dtype == torch.float32 and got.shape == (heads,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jlm.alibi_slopes(heads)))


# ------------------------------------------- the plain paged function


def _layout(rng, S, bs, maxb, lens, C):
    nb = S * maxb
    tables = rng.permutation(nb).astype(np.int32).reshape(S, maxb)
    lens = np.asarray(lens, np.int32)
    start = np.maximum(lens - C, 0).astype(np.int32)
    return nb, tables, start, lens


def _quant_pool(rng, slots, KV, D):
    """An int8 pool and its [KV, slots] scales, made by the JAX package's
    quantizer (the port's is the same bit for bit, above)."""
    k = rng.standard_normal((slots, KV * D)).astype(np.float32) * 3
    v = rng.standard_normal((slots, KV * D)).astype(np.float32) * 3
    kq, ks = jkq.quantize_rows(jnp.asarray(k), KV)
    vq, vs = jkq.quantize_rows(jnp.asarray(v), KV)
    return tuple(np.asarray(a) for a in (kq, vq, ks, vs))


def _run_both(q, kp, vp, tables, start, lens, *, bs, KV, window=None,
              scales=None, slopes=None, ring=None, ring_count=0,
              ring_layer=1):
    """(JAX interpret-mode output, port output) of one call. ``ring``: the
    decode loop's [R, L, 2, S, KV*D] carry (JAX takes it whole with the
    layer; the port takes that layer's K and V planes)."""
    jkw, tkw = {}, {}
    if scales is not None:
        ks, vs = scales
        jkw.update(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        tkw.update(k_scales=torch.from_numpy(ks.copy()),
                   v_scales=torch.from_numpy(vs.copy()))
    if slopes is not None:
        jkw["alibi_slopes"] = jnp.asarray(slopes)
        tkw["alibi_slopes"] = torch.from_numpy(slopes)
    if ring is not None:
        jkw.update(ring_full=jnp.asarray(ring), ring_layer=ring_layer,
                   ring_count=jnp.asarray(ring_count, jnp.int32))
        rt = torch.from_numpy(np.asarray(ring))
        tkw.update(ring_k=rt[:, ring_layer, 0], ring_v=rt[:, ring_layer, 1],
                   ring_count=ring_count)
    ref = jax_flash_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(start), jnp.asarray(lens),
        block_size=bs, sliding_window=window, num_kv_heads=KV,
        interpret=True, **jkw)
    got = port.flash_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(start),
        torch.from_numpy(lens), block_size=bs, sliding_window=window,
        num_kv_heads=KV, **tkw)
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("window", [None, 5])
def test_int8_prefill_matches_paged_kernel(window):
    """C = 6 chunks over a shuffled multi-block table of an int8 pool (GQA
    2, one idle slot; with a window once): ``_paged_kernel`` with
    per-layer scales."""
    rng = np.random.default_rng(11)
    S, C, H, KV, D, bs, maxb = 3, 6, 4, 2, 8, 4, 4
    nb, tables, start, lens = _layout(rng, S, bs, maxb, [6, 15, 0], C)
    kq, vq, ks, vs = _quant_pool(rng, (nb + 1) * bs, KV, D)
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    ref, got = _run_both(q, kq, vq, tables, start, lens, bs=bs, KV=KV,
                         window=window, scales=(ks, vs))
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[2].any()


@pytest.mark.parametrize("maxb", [1, 3])
def test_int8_decode_matches_both_kernels(maxb):
    """C = 1 over an int8 pool: the linear layout (MAXB = 1) runs
    ``_decode_grouped_kernel``, three blocks a sequence ``_paged_kernel``;
    an idle slot emits zeros."""
    rng = np.random.default_rng(12 + maxb)
    S, H, KV, D = 4, 8, 2, 16
    bs = 16 if maxb == 1 else 8
    nb, tables, start, lens = _layout(rng, S, bs, maxb,
                                      [5, maxb * bs, 0, 9], 1)
    kq, vq, ks, vs = _quant_pool(rng, (nb + 1) * bs, KV, D)
    q = rng.standard_normal((S, 1, H, D)).astype(np.float32)
    ref, got = _run_both(q, kq, vq, tables, start, lens, bs=bs, KV=KV,
                         scales=(ks, vs))
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[2].any()


@pytest.mark.parametrize("C,maxb", [(6, 4), (1, 1), (1, 3)])
@pytest.mark.parametrize("heads", [4, 6])
def test_alibi_matches_both_kernels(C, maxb, heads):
    """ALiBi slopes of ``alibi_slopes`` (4 heads, and 6: no power of two)
    on a chunk (``_paged_kernel``), linear decode (the grouped kernel)
    and multi-block decode, with a window on the chunk."""
    rng = np.random.default_rng(20 + C + maxb + heads)
    S, KV, D, bs = 3, 2, 8, 8
    H = heads
    nb, tables, start, lens = _layout(rng, S, bs, maxb,
                                      [C, maxb * bs - 1, 0], C)
    slots = (nb + 1) * bs
    kp = rng.standard_normal((slots, KV * D)).astype(np.float32)
    vp = rng.standard_normal((slots, KV * D)).astype(np.float32)
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    slopes = np.asarray(jlm.alibi_slopes(H))
    ref, got = _run_both(q, kp, vp, tables, start, lens, bs=bs, KV=KV,
                         window=4 if C > 1 else None, slopes=slopes)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("maxb,ring_count,window,alibi", [
    (1, 1, None, False), (1, 3, None, True), (3, 4, None, False),
    (3, 2, 5, True), (1, 4, 3, False)])
def test_ring_matches_both_kernels(quant, maxb, ring_count, window, alibi):
    """The decode-loop ring round: the settled pool (fp32, or int8 with
    scales) plus ``ring_count`` rows of the [R, L, 2, S, KV*D] carry in
    the compute dtype; the grouped kernel at MAXB = 1, ``_paged_kernel``'s
    ring round otherwise; windows that cut into the ring, ALiBi, and an
    idle slot whose ring rows hold garbage."""
    rng = np.random.default_rng(30 + maxb * 10 + ring_count + quant)
    S, H, KV, D, R, L = 3, 4, 2, 8, 4, 2
    bs = 16 if maxb == 1 else 8
    settled = [5, maxb * bs - R, 0]
    nb, tables, _, lens = _layout(rng, S, bs, maxb, settled, 1)
    start = (lens + ring_count - 1).astype(np.int32)
    slots = (nb + 1) * bs
    scales = None
    if quant:
        kp, vp, ks, vs = _quant_pool(rng, slots, KV, D)
        scales = (ks, vs)
    else:
        kp = rng.standard_normal((slots, KV * D)).astype(np.float32)
        vp = rng.standard_normal((slots, KV * D)).astype(np.float32)
    ring = rng.standard_normal((R, L, 2, S, KV * D)).astype(np.float32)
    q = rng.standard_normal((S, 1, H, D)).astype(np.float32)
    slopes = np.asarray(jlm.alibi_slopes(H)) if alibi else None
    ref, got = _run_both(q, kp, vp, tables, start, lens, bs=bs, KV=KV,
                         window=window, scales=scales, slopes=slopes,
                         ring=ring, ring_count=ring_count)
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[2].any()


@pytest.mark.parametrize("C,maxb", [(6, 4), (1, 1), (1, 3)])
def test_fp16_matches_both_kernels(C, maxb):
    """fp16 q and pool (fault C4's inputs) on a chunk, linear decode and
    multi-block decode: within FP16_ATOL."""
    rng = np.random.default_rng(40 + C + maxb)
    S, H, KV, D, bs = 3, 4, 2, 16, 8
    nb, tables, start, lens = _layout(rng, S, bs, maxb,
                                      [C, maxb * bs - 2, 0], C)
    slots = (nb + 1) * bs
    kp = rng.standard_normal((slots, KV * D)).astype(np.float16)
    vp = rng.standard_normal((slots, KV * D)).astype(np.float16)
    q = rng.standard_normal((S, C, H, D)).astype(np.float16)
    ref, got = _run_both(q, kp, vp, tables, start, lens, bs=bs, KV=KV)
    np.testing.assert_allclose(got, ref, atol=FP16_ATOL, rtol=0)
    assert not got[2].any()


def test_scales_and_int8_pool_go_together():
    """The JAX package's errors (``flash_paged_attention``): scales with a
    pool that is not int8, and an int8 pool without scales."""
    q = torch.zeros(1, 2, 2, 8)
    pool = torch.zeros(8, 16)
    tabs = torch.zeros(1, 2, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    sc = torch.ones(2, 8)
    with pytest.raises(ValueError, match="not int8"):
        port.flash_paged_attention(q, pool, pool, tabs, pos, pos,
                                   block_size=4, num_kv_heads=2,
                                   k_scales=sc, v_scales=sc)
    i8 = pool.to(torch.int8)
    with pytest.raises(ValueError, match="needs scales"):
        port.flash_paged_attention(q, i8, i8, tabs, pos, pos, block_size=4,
                                   num_kv_heads=2)
    with pytest.raises(ValueError, match="C == 1"):
        port.flash_paged_attention(q, pool, pool, tabs, pos, pos,
                                   block_size=4, num_kv_heads=2,
                                   ring_k=torch.zeros(1, 1, 16),
                                   ring_v=torch.zeros(1, 1, 16),
                                   ring_count=1)


def test_prefill_route_sends_int8_to_the_mma_kernel():
    for D in (64, 128):
        for bs in (16, 64):
            assert port.prefill_route(512, D, torch.bfloat16, bs,
                                      True) == "mma"
            assert port.prefill_route(512, D, torch.float16, bs,
                                      True) == "mma"
            assert port.prefill_route(512, D, torch.float16, bs) \
                .startswith("wgmma")
        assert port.prefill_route(512, D, torch.float32, 64, True) == "f32"


# ----------------------------------------------------------- the engines

PROMPT_LENS = (5, 11, 19)
NEW_TOKENS = 10
ENGINE_KW = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
                 max_blocks_per_seq=16, dtype="float32")


def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).tolist() for n in PROMPT_LENS]


class _Ref:
    """The tiny Llama in both packages (fp32 weights) and the JAX int8
    engines' greedy streams, built once per window."""

    def __init__(self, window):
        self.jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32,
                                            sliding_window=window)
        _, init_fn, _ = jllama.make_model(self.jcfg)
        self.jparams = init_fn(jax.random.PRNGKey(0), seq_len=16)
        self.tree = _numpy_tree(self.jparams)
        self.cfg = LlamaConfig.tiny(dtype=torch.float32,
                                    sliding_window=window)
        self.params = llama_params_from_numpy(self.tree, self.cfg,
                                              device="cpu",
                                              dtype=torch.float32)
        self.gen = {}

    def jax_gen(self, loop, eos=None):
        key = (loop, eos)
        if key not in self.gen:
            eng = JaxEngine(self.jcfg, self.jparams, JaxRagged(
                attention_impl="dense", kv_cache_dtype="int8",
                decode_loop_steps=loop, **ENGINE_KW))
            self.gen[key] = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS,
                                         eos_token_id=eos)
        return self.gen[key]


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(window=None):
        if window not in cache:
            cache[window] = _Ref(window)
        return cache[window]
    return get


def _engine(ref, **kw):
    return InferenceEngineV2(ref.cfg, ref.params, RaggedInferenceConfig(
        **{**ENGINE_KW, "kv_cache_dtype": "int8", **kw}), device="cpu")


@pytest.mark.parametrize("loop,window", [(0, None), (4, None), (4, 6),
                                         (0, 6)])
def test_int8_engine_tokens_identical_to_jax_int8_engine(refs, loop,
                                                         window):
    """Three prompts, one longer than two 8-token chunks, 10 new tokens:
    decode loops of 4 steps (two loop calls and a put() tail, the ring
    flushed into the int8 pool after each) or token at a time (loop 0),
    with and without a sliding window."""
    ref = refs(window)
    eng = _engine(ref, decode_loop_steps=loop, attention_impl="dense")
    assert eng.kv_cache.data.dtype == torch.int8
    got = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    assert got == ref.jax_gen(loop)
    assert eng.free_blocks == ENGINE_KW["num_blocks"]


@pytest.mark.parametrize("loop", [0, 4])
def test_int8_engine_on_the_kernels_path_identical(refs, loop):
    """``paged_flash`` over the int8 pool: the wrappers take the kernels'
    plain versions on CPU tensors (scales on the score and probability
    columns, the ring round in the loop), and the tokens are the JAX int8
    engine's, as on the card phase 23 holds the kernels to ``dense``."""
    ref = refs()
    eng = _engine(ref, decode_loop_steps=loop, attention_impl="paged_flash")
    assert eng.generate(_prompts(), max_new_tokens=NEW_TOKENS) \
        == ref.jax_gen(loop)


def test_int8_engine_with_eos_matches_jax(refs):
    """An eos id from the middle of one stream: the slot freezes inside
    the 4-step loop (its later ring rows are flushed past its consumed
    positions, as the JAX package's are) and no block leaks."""
    ref = refs()
    eos = ref.jax_gen(4)[1][5]
    eng = _engine(ref, decode_loop_steps=4, attention_impl="dense")
    got = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS,
                       eos_token_id=eos)
    assert got == ref.jax_gen(4, eos)
    assert got[1][-1] == eos and len(got[1]) <= 6
    assert eng.free_blocks == ENGINE_KW["num_blocks"]


def test_int8_loop_of_4_equals_loop_of_0(refs):
    """The JAX package's ``test_engine_int8_decode_loop_linear_layout`` on
    the port: the linear layout (one 32-token block a sequence), a
    4-step loop against token-at-a-time decoding over the int8 pool."""
    ref = refs()
    kw = dict(block_size=32, num_blocks=8, max_blocks_per_seq=1)
    prompts = [np.random.default_rng(5).integers(1, 512, 9).tolist()]
    got = _engine(ref, decode_loop_steps=4, **kw).generate(
        prompts, max_new_tokens=8)
    want = _engine(ref, decode_loop_steps=0, **kw).generate(
        prompts, max_new_tokens=8)
    assert got == want


def test_int8_loop_flush_writes_the_pool_as_appending_would(refs):
    """A 4-step loop's flush quantizes the ring's compute-dtype K/V once,
    into the rows the loop's positions own: at layer 0 (whose K/V depend
    on the token alone) the row of the loop's first token carries the
    codes and scales that a per-step write of the same token leaves, and
    the loop's other three positions are written."""
    ref = refs()
    prompt = _prompts()[2]
    loop = _engine(ref, decode_loop_steps=4, attention_impl="dense")
    step = _engine(ref, decode_loop_steps=0, attention_impl="dense")
    for eng in (loop, step):
        eng.put([0], [prompt], _greedy=True)
    loop.decode_batch([0], [7], 4)
    step.put([0], [[7]], _greedy=True)

    def rows(eng, n):
        blocks = eng.state.get(0).kv_blocks
        return [blocks[j // 4] * 4 + j % 4 for j in range(n)]
    n = len(prompt) + 1
    ra, rb = rows(loop, n + 3), rows(step, n)
    kv_a, kv_b = loop.kv_cache, step.kv_cache
    assert torch.equal(kv_a.data[0, :, ra[:n]], kv_b.data[0, :, rb])
    assert torch.equal(kv_a.scales[0, :, :, ra[:n]],
                       kv_b.scales[0, :, :, rb])
    assert kv_a.data[:, :, ra[n:]].any(dim=-1).all()


def test_fp16_engine_prefill_logits_match_jax_fp16_engine(refs):
    """An fp16 engine (fp16 compute and pool, fp32 weights cast at use as
    both packages do) on a 13-token prompt in 8-token chunks, dense and on
    the kernels' plain versions: its last logits within 8e-3 of the JAX
    fp16 engine's (about twice the largest reading, 3.24e-3: fp16 rounds
    at other places in the two frameworks; logits reach 2.6), and the
    pool is fp16."""
    ref = refs()
    prompt = np.random.default_rng(4).integers(1, 512, 13).tolist()
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float16)
    jeng = JaxEngine(jcfg, ref.jparams, JaxRagged(
        attention_impl="dense", **{**ENGINE_KW, "dtype": "float16"}))
    want = np.asarray(jeng.put([0], [prompt])[0], np.float32)
    cfg = LlamaConfig.tiny(dtype=torch.float16)
    for impl in ("dense", "paged_flash"):
        eng = InferenceEngineV2(cfg, ref.params, RaggedInferenceConfig(
            attention_impl=impl, **{**ENGINE_KW, "dtype": "float16"}),
            device="cpu")
        assert eng.kv_cache.data.dtype == torch.float16
        got = np.asarray(eng.put([0], [prompt])[0], np.float32)
        np.testing.assert_allclose(got, want, atol=8e-3, rtol=0)


def test_int8_pool_bytes_halve():
    """The JAX package's ``test_pool_memory_halves``: at head dim 128 the
    int8 data plane is exactly half the bf16 pool and the whole, scales
    included, under 0.6 of it."""
    cfg = RaggedInferenceConfig(**{**ENGINE_KW, "dtype": "bfloat16"})
    cfg8 = RaggedInferenceConfig(**{**ENGINE_KW, "dtype": "bfloat16",
                                    "kv_cache_dtype": "int8"})
    bf = BlockedKVCache(cfg, 2, 4, 128, torch.bfloat16, device="cpu")
    i8 = BlockedKVCache(cfg8, 2, 4, 128, torch.bfloat16, device="cpu")
    assert i8.data.dtype == torch.int8 and i8.data.shape == bf.data.shape
    assert i8.data.numel() * i8.data.element_size() * 2 \
        == bf.memory_bytes()
    assert i8.memory_bytes() < 0.6 * bf.memory_bytes()
    assert isinstance(i8.pool, tkq.KVPool) and bf.pool is bf.data
