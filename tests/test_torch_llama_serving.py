"""Port parity for the serving path: tiny Llama through the port's v2
ragged engine on the CPU against the JAX package's model and engine.

The JAX parameter tree (fp32) crosses over as numpy; both packages run
the same weights. Greedy token streams must be identical; logits agree
within 1e-4 (fp32, summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.checkpoint import llama_params_from_numpy
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceConfig)
from deepspeed_tpu_torch.models.llama import Llama, LlamaConfig

PROMPT_LENS = (5, 11, 19)
NEW_TOKENS = 10
ENGINE_KW = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
                 max_blocks_per_seq=16, dtype="float32", decode_loop_steps=4)


def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).tolist() for n in PROMPT_LENS]


class _Ref:
    """The JAX side, built once per (window) case."""

    def __init__(self, window):
        self.jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32,
                                            sliding_window=window)
        self.model, init_fn, _ = jllama.make_model(self.jcfg)
        self.jparams = init_fn(jax.random.PRNGKey(0), seq_len=16)
        self.tree = _numpy_tree(self.jparams)
        self.cfg = LlamaConfig.tiny(dtype=torch.float32,
                                    sliding_window=window)
        self.params = llama_params_from_numpy(self.tree, self.cfg,
                                              device="cpu",
                                              dtype=torch.float32)
        eng = JaxEngine(self.jcfg, self.jparams,
                        JaxRagged(attention_impl="dense", **ENGINE_KW))
        self.gen = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS)

    def logits(self, tokens):
        return np.asarray(self.model.apply(
            {"params": self.jparams}, jnp.asarray(tokens, jnp.int32)))


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(window=None):
        if window not in cache:
            cache[window] = _Ref(window)
        return cache[window]
    return get


def _engine(ref, **kw):
    return InferenceEngineV2(ref.cfg, ref.params,
                             RaggedInferenceConfig(**{**ENGINE_KW, **kw}),
                             device="cpu")


def test_bridge_round_trips_the_flax_tree(refs):
    ref = refs()
    model = Llama(ref.cfg, ref.params)

    def check(src, got, path=""):
        assert set(src) == set(got), path
        for k in src:
            if isinstance(src[k], dict):
                check(src[k], got[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(got[k].numpy(), src[k],
                                              err_msg=f"{path}/{k}")
    check(ref.tree, model.params())
    bad = _numpy_tree(ref.jparams)
    bad["layer_0"]["attn"]["q_proj"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        llama_params_from_numpy(bad, ref.cfg, device="cpu")


def test_full_forward_matches_jax(refs):
    ref = refs()
    toks = np.random.default_rng(3).integers(1, 512, (2, 17))
    got = Llama(ref.cfg, ref.params)(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, ref.logits(toks), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl", ["dense", "paged_flash"])
def test_engine_prefill_logits_match_jax_forward(refs, impl):
    """A 13-token prompt in 8-token SplitFuse chunks: the last chunk's
    logits equal the full forward's last position."""
    ref = refs()
    prompt = np.random.default_rng(4).integers(1, 512, 13).tolist()
    eng = _engine(ref, attention_impl=impl)
    out = eng.put([0], [prompt])
    np.testing.assert_allclose(out[0], ref.logits([prompt])[0, -1],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("window,impl", [(None, "dense"), (6, "dense"),
                                         (None, "paged_flash"),
                                         (6, "paged_flash")])
def test_generate_token_identical_to_jax_engine(refs, window, impl):
    """Three prompts of unequal length, one longer than two chunks, with
    the decode loop at 4 tokens per call and a put() tail. ``paged_flash``
    on CPU tensors runs the kernels' wrappers, which take their plain
    versions: the wiring (block tables, start positions, sequence lengths,
    K1 for chunks and K2 for decode) is the card's."""
    ref = refs(window)
    eng = _engine(ref, attention_impl=impl)
    got = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    assert got == ref.gen
    assert all(len(g) == NEW_TOKENS for g in got)
    # decode went through the loop: 2 calls x 4 steps + a 1-token tail
    assert eng.runner.step_counts["decode"] == 2 * 4 + 1


def test_generate_with_eos_matches_jax_engine(refs):
    """An eos id taken from the middle of one reference stream: every
    stream stops at its first eos, inside the decode loop or the put()
    tail, exactly as the JAX engine's do, and no KV block leaks."""
    ref = refs()
    eos = ref.gen[1][5]
    jeng = JaxEngine(ref.jcfg, ref.jparams,
                     JaxRagged(attention_impl="dense", **ENGINE_KW))
    want = jeng.generate(_prompts(), max_new_tokens=NEW_TOKENS,
                         eos_token_id=eos)
    eng = _engine(ref)
    got = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS,
                       eos_token_id=eos)
    assert got == want
    assert got[1][-1] == eos and len(got[1]) <= 6
    assert eng.free_blocks == ENGINE_KW["num_blocks"]


def test_put_and_flush_return_every_block(refs):
    ref = refs()
    eng = _engine(ref)
    total = eng.free_blocks
    prompts = _prompts(1)
    eng.put([0, 1, 2], prompts, _greedy=True)
    assert eng.free_blocks == total - sum(-(-n // 4) for n in PROMPT_LENS)
    assert eng.query(0)[0] == PROMPT_LENS[0]
    for u in (0, 1, 2):
        eng.flush(u)
    assert eng.free_blocks == total
    eng.generate(prompts, max_new_tokens=6)
    assert eng.free_blocks == total
    assert sorted(eng.kv_cache.allocator.free_list()) == list(range(total))


def test_config_refuses_unported_features():
    for kw in ({"tp_size": 2}, {"seq_size": 2}, {"ep_size": 2},
               {"prefix_cache": True}):
        with pytest.raises(NotImplementedError):
            RaggedInferenceConfig(**kw)
    with pytest.raises(ValueError):
        RaggedInferenceConfig(attention_impl="flash")


def test_config_accepts_the_pipelined_serve_loop():
    """``serve_pipeline_depth`` > 0 is ported (it left the refusals
    above) with the JAX package's default of 2; below 0 is refused as the
    JAX package refuses it."""
    assert RaggedInferenceConfig().serve_pipeline_depth == 2
    assert RaggedInferenceConfig(serve_pipeline_depth=2) \
        .serve_pipeline_depth == 2
    assert RaggedInferenceConfig(serve_pipeline_depth=0) \
        .serve_pipeline_depth == 0
    with pytest.raises(ValueError, match="serve_pipeline_depth"):
        RaggedInferenceConfig(serve_pipeline_depth=-1)


def test_config_accepts_the_int8_and_fp16_pools():
    """``kv_cache_dtype="int8"`` is ported (it left the refusals above);
    other names are refused as the JAX package refuses them."""
    assert RaggedInferenceConfig(kv_cache_dtype="int8").kv_cache_dtype \
        == "int8"
    assert RaggedInferenceConfig(dtype="float16").dtype == "float16"
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        RaggedInferenceConfig(kv_cache_dtype="fp8")
