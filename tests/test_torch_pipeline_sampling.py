"""Port parity for the pipelined serve loop and on-device sampled
decoding, against the JAX package on the CPU.

- ``utils/random.py`` against ``jax.random`` for 2048 (seed, position)
  pairs: keys, 32-bit words and uniforms bit for bit; gumbel noise within
  2 ulp counted at max(|g|, 1) (XLA's fp32 log is not correctly rounded
  near 1, the port's is).
- ``_select_tokens`` against the JAX sampler on the same logits and keys
  (token ids equal) over temperatures, top-k and top-p; ``_chosen_logprob``
  within 1e-5.
- The tiny Llama of the JAX package in fp32 (dense attention) served by
  both engines: ``put``, ``generate`` and ``decode_pipelined`` at
  pipeline depths 0 and 2 give the JAX engine's tokens; the EOS rollback
  of ``decode_pipelined`` with the EOS planted at each offset 0..2 leaves
  the JAX engine's ``free_blocks``, with one readback per committed step
  and none in plan or dispatch; sampled ``generate`` streams equal the
  JAX engine's through the decode loop and at both depths;
  ``logprobs_of`` within 1e-5 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.config import InferenceConfig as JaxSampling
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.inference.v2 import model_runner as jmr
from deepspeed_tpu.inference.v2.sampling import \
    SamplingParams as JaxSamplingParams
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.checkpoint import llama_params_from_numpy
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceConfig)
from deepspeed_tpu_torch.inference.v2 import model_runner as tmr
from deepspeed_tpu_torch.inference.v2.sampling import (SamplingParams,
                                                       derive_seed)
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.utils import random as trandom

PROMPT_LENS = (5, 11, 19)
NEW_TOKENS = 10
ENGINE_KW = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
                 max_blocks_per_seq=16, dtype="float32", decode_loop_steps=4)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def _key_pairs(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2 ** 31 - 1, n)
    pos = rng.integers(0, 1 << 20, n)
    seeds[:4] = (0, 1, 2 ** 31 - 1, 7)
    pos[:4] = (0, 1, 5, 2 ** 31 - 1)
    return seeds, pos


def _jax_keys(seeds, pos):
    return jmr._sample_keys(jnp.asarray(seeds, jnp.int32),
                            jnp.asarray(pos, jnp.int32))


def test_threefry_keys_and_bits_equal_jax_random():
    seeds, pos = _key_pairs()
    jk = _jax_keys(seeds, pos)
    tk = tmr._sample_keys(torch.tensor(seeds), torch.tensor(pos))
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64),
                                  tk.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.PRNGKey(12345)).astype(np.int64),
        trandom.PRNGKey(12345).numpy())
    jb = jax.vmap(lambda k: jax.random.bits(k, (300,), jnp.uint32))(jk)
    np.testing.assert_array_equal(np.asarray(jb).astype(np.int64),
                                  trandom.random_bits(tk, 300).numpy())
    tiny = float(jnp.finfo(jnp.float32).tiny)
    for lo in (0.0, tiny):
        ju = jax.vmap(lambda k: jax.random.uniform(
            k, (256,), jnp.float32, minval=lo))(jk)
        np.testing.assert_array_equal(
            np.asarray(ju).view(np.int32),
            trandom.uniform(tk, 256, minval=lo).numpy().view(np.int32))


def test_gumbel_within_two_ulp_of_jax():
    seeds, pos = _key_pairs(seed=1)
    jk = _jax_keys(seeds, pos)
    tk = tmr._sample_keys(torch.tensor(seeds), torch.tensor(pos))
    jg = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (256,), jnp.float32))(jk))
    tg = trandom.gumbel(tk, 256).numpy()
    assert tg.dtype == np.float32 and np.isfinite(tg).all()
    ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert (np.abs(tg - jg) / ulp).max() <= 2.0


@pytest.mark.parametrize("temp", [0.0, 0.7, 1.5])
@pytest.mark.parametrize("top_k", [0, 1, 50, 300])
@pytest.mark.parametrize("top_p", [0.5, 1.0])
def test_select_tokens_matches_jax(temp, top_k, top_p):
    """Same logits (a row with many exact ties among them), same keys:
    the same token ids. top_k 300 is clamped to the 256 candidates as
    the engines stage it."""
    rng = np.random.default_rng(int(temp * 10) + top_k + int(top_p * 7))
    S, V = 16, 1000
    logits = (rng.standard_normal((S, V)) * 3).astype(np.float32)
    logits[0] = np.round(logits[0])
    seeds, pos = _key_pairs(S, seed=top_k)
    temps = np.full(S, temp, np.float32)
    temps[1] = 0.0                                  # a greedy slot
    ks = np.full(S, min(top_k, 256), np.int32)
    ps = np.full(S, top_p, np.float32)
    want = jmr._select_tokens(jnp.asarray(logits), _jax_keys(seeds, pos),
                              jnp.asarray(temps), jnp.asarray(ks),
                              jnp.asarray(ps), cand=256)
    got = tmr._select_tokens(
        torch.from_numpy(logits),
        tmr._sample_keys(torch.tensor(seeds), torch.tensor(pos)),
        torch.from_numpy(temps), torch.from_numpy(ks), torch.from_numpy(ps),
        cand=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    assert got[1] == int(np.argmax(logits[1]))


def test_topk_ranks_ties_by_index_as_jax():
    rng = np.random.default_rng(5)
    logits = np.round(rng.standard_normal((4, 700)) * 2).astype(np.float32)
    logits[2, :] = 0.0
    logits[3, ::3] = -0.0
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 256)
    tv, ti = tmr._topk_by_index(torch.from_numpy(logits), 256)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_chosen_logprob_matches_jax():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((8, 512)) * 4).astype(np.float32)
    tok = rng.integers(0, 512, 8).astype(np.int32)
    want = jmr._chosen_logprob(jnp.asarray(logits), jnp.asarray(tok))
    got = tmr._chosen_logprob(torch.from_numpy(logits), torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------- engines


def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).tolist() for n in PROMPT_LENS]


class _Ref:
    """The tiny Llama in both packages (fp32), and the JAX engines."""

    def __init__(self):
        self.jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
        _, init_fn, _ = jllama.make_model(self.jcfg)
        self.jparams = init_fn(jax.random.PRNGKey(0), seq_len=16)
        self.cfg = LlamaConfig.tiny(dtype=torch.float32)
        self.params = llama_params_from_numpy(
            _numpy_tree(self.jparams), self.cfg, device="cpu",
            dtype=torch.float32)
        self._gen = {}

    def jax_engine(self, **kw):
        return JaxEngine(self.jcfg, self.jparams, JaxRagged(
            attention_impl="dense", **{**ENGINE_KW, **kw}))

    def engine(self, **kw):
        return InferenceEngineV2(self.cfg, self.params, RaggedInferenceConfig(
            **{**ENGINE_KW, **kw}), device="cpu")

    def jax_generate(self, sampled=False, seed=0, **kw):
        key = (sampled, seed, tuple(sorted(kw.items())))
        if key not in self._gen:
            samp = JaxSampling(greedy=False, **SAMPLED) if sampled else None
            self._gen[key] = self.jax_engine(**kw).generate(
                _prompts(), max_new_tokens=NEW_TOKENS, sampling=samp,
                seed=seed)
        return self._gen[key]


@pytest.fixture(scope="module")
def ref():
    return _Ref()


@pytest.mark.parametrize("depth", [0, 2])
def test_put_is_jax_at_each_depth(ref, depth):
    """Prompts longer than a chunk, so chunks of one sequence span
    in-flight steps at depth 2; the prompt tokens, then three rounds of
    one-token continuations, through put()."""
    eng = ref.engine(serve_pipeline_depth=depth)
    jeng = ref.jax_engine(serve_pipeline_depth=depth)
    uids, feed = [0, 1, 2], _prompts()
    for _ in range(4):
        got = eng.put(uids, feed, _greedy=True)
        want = jeng.put(uids, feed, _greedy=True)
        assert got == {u: int(t) for u, t in want.items()}
        feed = [[got[u]] for u in uids]
    assert eng.pipeline_stats["readbacks"] == eng.pipeline_stats["steps"]
    logits = eng.put([7], [_prompts(2)[2]])[7]
    np.testing.assert_allclose(logits, ref.jax_engine().put(
        [7], [_prompts(2)[2]])[7], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("depth,loop", [(0, 0), (2, 0), (0, 4), (2, 4)])
def test_generate_greedy_is_jax_at_each_depth(ref, depth, loop):
    eng = ref.engine(serve_pipeline_depth=depth, decode_loop_steps=loop)
    got = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    assert got == ref.jax_generate()
    assert eng.free_blocks == ENGINE_KW["num_blocks"]
    if depth and not loop:
        assert eng.pipeline_stats["fed_steps"] > 0


def test_depth_two_is_the_default_and_accepted():
    assert RaggedInferenceConfig().serve_pipeline_depth == 2
    assert RaggedInferenceConfig(serve_pipeline_depth=3) \
        .serve_pipeline_depth == 3
    with pytest.raises(ValueError, match="serve_pipeline_depth"):
        RaggedInferenceConfig(serve_pipeline_depth=-1)


def _pipelined(eng, eos, budgets, monkeypatch=None):
    """Prompts through put(), then decode_pipelined with per-uid budgets;
    the engine's state after."""
    uids = [0, 1, 2]
    first = eng.put(uids, _prompts(), _greedy=True)
    first = [int(first[u]) for u in uids]
    if monkeypatch is not None:
        _forbid_readbacks(eng, monkeypatch)
    out = eng.decode_pipelined(uids, first, budgets, eos_token_id=eos)
    seqs = {u: eng.state.get(u) for u in uids}
    state = {u: (s.seen_tokens, len(s.kv_blocks), s.in_flight,
                 s.spec_pending) for u, s in seqs.items()}
    return out, state, eng.free_blocks


def _forbid_readbacks(eng, monkeypatch):
    """Plan and dispatch run with every tensor-to-host call raising: a
    readback there would serialise the pipeline on a card."""
    def guard(fn):
        def run(*a, **k):
            with monkeypatch.context() as m:
                for name in ("cpu", "item", "tolist"):
                    m.setattr(torch.Tensor, name, _raise(name))
                return fn(*a, **k)
        return run
    monkeypatch.setattr(eng, "_plan_step", guard(eng._plan_step))
    monkeypatch.setattr(eng, "_dispatch_step", guard(eng._dispatch_step))


def _raise(name):
    def f(*a, **k):
        raise AssertionError(f"Tensor.{name} in plan or dispatch")
    return f


@pytest.mark.parametrize("offset", [0, 1, 2])
def test_decode_pipelined_eos_rollback_is_jax(ref, offset, monkeypatch):
    """An EOS taken from uid 1's greedy stream at ``offset`` of the
    pipelined decode (seen while up to two later steps are in flight),
    per-uid budgets: the tokens, the sequences' positions and blocks and
    the pool's free blocks are the JAX engine's at depth 2; one readback
    a committed step, none in plan or dispatch."""
    budgets = [7, 9, 8]
    plain, _, _ = _pipelined(ref.jax_engine(), None, budgets)
    eos = plain[1][offset]
    want, want_state, want_free = _pipelined(ref.jax_engine(), eos, budgets)
    eng = ref.engine(serve_pipeline_depth=2)
    got, state, free = _pipelined(eng, eos, budgets, monkeypatch)
    assert got == want
    assert got[1][-1] == eos and len(got[1]) <= offset + 1
    assert state == want_state and free == want_free
    st = eng.pipeline_stats
    assert st["readbacks"] == st["steps"] and st["fed_steps"] > 0
    # the pool is whole again once the sequences go
    for u in (0, 1, 2):
        eng.flush(u)
    assert eng.free_blocks == ENGINE_KW["num_blocks"]


@pytest.mark.parametrize("depth", [0, 2])
def test_decode_pipelined_without_eos_is_depth_zero(ref, depth):
    want, want_state, want_free = _pipelined(
        ref.engine(serve_pipeline_depth=0), None, [6, 3, 0])
    got, state, free = _pipelined(ref.engine(serve_pipeline_depth=depth),
                                  None, [6, 3, 0])
    assert got == want and state == want_state and free == want_free
    assert [len(got[u]) for u in (0, 1, 2)] == [6, 3, 0]


@pytest.mark.parametrize("depth,loop", [(0, 0), (2, 0), (0, 4), (2, 4)])
def test_sampled_generate_is_jax(ref, depth, loop):
    """temperature 0.8, top-k 50, top-p 0.95, per-uid seeds from one base
    seed: the JAX engine's streams through the decode loop (loop 4) and
    through the per-step paths at both depths, so the streams are the
    same across paths."""
    eng = ref.engine(serve_pipeline_depth=depth, decode_loop_steps=loop)
    got = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS,
                       sampling=SamplingParams(**SAMPLED), seed=11)
    assert got == ref.jax_generate(sampled=True, seed=11)
    assert got != ref.jax_generate()                # it did sample
    assert eng.free_blocks == ENGINE_KW["num_blocks"]


@pytest.mark.parametrize("depth,loop", [(0, 0), (2, 4)])
def test_temperature_zero_is_greedy(ref, depth, loop):
    eng = ref.engine(serve_pipeline_depth=depth, decode_loop_steps=loop)
    uids = [0, 1, 2]
    sp = {u: SamplingParams(temperature=0.0, logprobs=True) for u in uids}
    first = eng.put(uids, _prompts(), _greedy=True, sampling=sp)
    first = [int(first[u]) for u in uids]
    if loop:
        outs = eng.decode_batch(uids, first, NEW_TOKENS - 1)
    else:
        outs = eng.decode_pipelined(uids, first, NEW_TOKENS - 1)
    got = [[first[i]] + outs[u] for i, u in enumerate(uids)]
    assert got == ref.jax_generate()
    assert all(len(eng.logprobs_of(u)) == NEW_TOKENS for u in uids)


@pytest.mark.parametrize("path", ["pipelined", "loop"])
def test_logprobs_of_is_jax(ref, path):
    uids = [0, 1, 2]
    sp = {u: SamplingParams(seed=derive_seed(3, u), logprobs=True,
                            **SAMPLED) for u in uids}
    jsp = {u: JaxSamplingParams(seed=derive_seed(3, u), logprobs=True,
                                **SAMPLED) for u in uids}
    res = {}
    for name, eng, spm in (("jax", ref.jax_engine(), jsp),
                           ("port", ref.engine(), sp)):
        first = eng.put(uids, _prompts(), _greedy=True, sampling=spm)
        first = [int(first[u]) for u in uids]
        if path == "loop":
            toks = eng.decode_batch(uids, first, 8)
        else:
            toks = eng.decode_pipelined(uids, first, 8)
        res[name] = (first, {u: list(toks[u]) for u in uids},
                     {u: eng.logprobs_of(u) for u in uids})
    assert res["port"][:2] == res["jax"][:2]
    for u in uids:
        assert len(res["port"][2][u]) == 9
        np.testing.assert_allclose(res["port"][2][u], res["jax"][2][u],
                                   atol=1e-5, rtol=0)


def test_decode_batch_fallback_sampling_is_jax(ref):
    """``decode_batch(..., sampling=...)`` applies a per-call fallback to
    sequences without their own params (per-uid seeds derived from its
    seed), as the JAX engine applies its InferenceConfig."""
    uids = [0, 1, 2]
    got = {}
    for name, eng, fb in (
            ("jax", ref.jax_engine(),
             JaxSampling(greedy=False, seed=5, **SAMPLED)),
            ("port", ref.engine(), SamplingParams(seed=5, **SAMPLED))):
        first = eng.put(uids, _prompts(), _greedy=True)
        got[name] = eng.decode_batch(uids, [int(first[u]) for u in uids], 8,
                                     sampling=fb)
    assert got["port"] == {u: list(v) for u, v in got["jax"].items()}
