"""Port parity for prefix-cached serving and pool oversubscription: the
tiny Llama of the JAX package (fp32, dense attention) served by both
engines on the CPU.

- A shared-prefix workload whose cached chains outgrow a 10-block pool
  (6 preambles of 3 blocks, revisited): cache off, on, and on with the
  host tier, at pipeline depths 0 and 2 and through the decode loop.
  Greedy streams equal the JAX engine's of the same config (and the
  cache-off streams: the cache is token-invisible), and every counter of
  ``prefix_stats`` equals the JAX engine's; the refcount invariants hold
  after every request. The host-tier run on ``paged_flash`` takes K1's
  and K2's plain versions on the hit path (first chunks after a CoW tail
  start mid-block).
- The int8 pool (JAX ``test_int8_kv_prefix_parity``), wf8 weights
  (``test_llama_and_woq_prefix_parity``), the EOS rollback's decref over
  shared blocks, pause/resume with shared blocks, and the oversubscribed
  pool with and without the decode loop (pause to host memory, resume).
- The int8 decode loop's ring flush with an EOS inside a loop call, then
  the frozen slot flushed or aborted and its blocks handed to another
  request.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantization as jwoq
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.checkpoint import (llama_params_from_numpy,
                                            woq_params_from_numpy)
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceConfig)
from deepspeed_tpu_torch.inference.v2.sequence import SequenceStatus
from deepspeed_tpu_torch.models.llama import LlamaConfig

VOCAB = 512
HIER = dict(max_seqs=4, chunk_size=16, block_size=8, num_blocks=10,
            max_blocks_per_seq=8, dtype="float32", attention_impl="dense",
            decode_loop_steps=0, serve_pipeline_depth=2)
CONFIGS = {
    "off": dict(),
    "dev_d2": dict(prefix_cache=True),
    "dev_d0": dict(prefix_cache=True, serve_pipeline_depth=0),
    "host_d2": dict(prefix_cache=True, prefix_cache_host_blocks=64),
    "host_d0": dict(prefix_cache=True, prefix_cache_host_blocks=64,
                    serve_pipeline_depth=0),
    "host_loop": dict(prefix_cache=True, prefix_cache_host_blocks=64,
                      decode_loop_steps=4),
}
GEN = 6


class _Model:
    def __init__(self):
        self.jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32,
                                            max_seq_len=512)
        _, init_fn, _ = jllama.make_model(self.jcfg)
        self.jparams = init_fn(jax.random.PRNGKey(0), seq_len=16)
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.cfg = LlamaConfig.tiny(dtype=torch.float32, max_seq_len=512)
        self.params = llama_params_from_numpy(self.tree, self.cfg,
                                              device="cpu",
                                              dtype=torch.float32)
        self.runs = {}

    def jax_engine(self, params=None, **kw):
        return JaxEngine(self.jcfg, self.jparams if params is None
                         else params, JaxRagged(**kw))

    def engine(self, params=None, **kw):
        return InferenceEngineV2(self.cfg, self.params if params is None
                                 else params, RaggedInferenceConfig(**kw),
                                 device="cpu")


@pytest.fixture(scope="module")
def model():
    return _Model()


def _workload(groups=6, rounds=2, tail=5, pre=24, seed=0):
    rng = np.random.RandomState(seed)
    pres = [rng.randint(1, VOCAB, size=pre).tolist() for _ in range(groups)]
    return [(i, pres[i % groups] + rng.randint(1, VOCAB, size=tail).tolist())
            for i in range(rounds * groups)]


def _run(eng, reqs, loop):
    """Each request: admit (match, CoW, promotion), decode, flush; the
    cache's invariants after each."""
    out = {}
    for uid, p in reqs:
        if loop:
            out[uid] = eng.generate([p], max_new_tokens=GEN + 1)[0]
        else:
            first = eng.put([uid], [p], _greedy=True)
            toks = eng.decode_pipelined([uid], [first[uid]], GEN)
            out[uid] = [first[uid]] + toks[uid]
            eng.flush(uid)
        if eng._prefix is not None:
            eng._prefix.check_invariants()
            eng._prefix.assert_exact_refs(eng.state.sequences.values())
    assert eng.free_blocks == eng.config.num_blocks
    return out


def _jax_run(model, name):
    if name not in model.runs:
        kw = {**HIER, **CONFIGS[name]}
        eng = model.jax_engine(**kw)
        out = _run(eng, _workload(), kw["decode_loop_steps"] > 0)
        model.runs[name] = (out, eng.prefix_stats)
    return model.runs[name]


@pytest.mark.parametrize("name,impl", [(n, "dense") for n in CONFIGS]
                         + [("host_d2", "paged_flash")])
def test_streams_and_prefix_stats_equal_jax(model, name, impl):
    want, want_stats = _jax_run(model, name)
    kw = {**HIER, **CONFIGS[name], "attention_impl": impl}
    eng = model.engine(**kw)
    got = _run(eng, _workload(), kw["decode_loop_steps"] > 0)
    assert got == want
    assert got == _jax_run(model, "off")[0]       # the cache is invisible
    st = eng.prefix_stats
    assert st == want_stats
    if name.startswith("host"):
        # the tier worked: chains demoted, revisits promoted, nothing lost
        assert st["demoted"] > 0 and st["promoted"] > 0
        assert st["host_hit_blocks"] > 0 and st["evicted_pressure"] == 0
        assert st["prefill_chunks_skipped_frac"] > 0.3
    elif name.startswith("dev"):
        assert st["evicted_pressure"] > 0 and st["cow_copies"] > 0


def test_int8_pool_prefix_parity(model):
    """JAX ``test_int8_kv_prefix_parity``: 128-token blocks of int8 rows
    and scales; 130 shared tokens + 126 unique make block 0 a hit and
    block 1 a CoW copy of codes and scales."""
    kw = dict(max_seqs=4, chunk_size=8, block_size=128, num_blocks=8,
              max_blocks_per_seq=3, dtype="float32", kv_cache_dtype="int8",
              attention_impl="dense")
    rng = np.random.default_rng(76)
    shared = rng.integers(1, VOCAB, 130).tolist()
    prompts = [shared + rng.integers(1, VOCAB, 126).tolist()
               for _ in range(2)]
    jeng = model.jax_engine(prefix_cache=True, **kw)
    want = [jeng.generate([p], max_new_tokens=4)[0] for p in prompts]
    off = model.engine(**kw)
    eng = model.engine(prefix_cache=True, **kw)
    assert [off.generate([p], max_new_tokens=4)[0] for p in prompts] == want
    assert [eng.generate([p], max_new_tokens=4)[0] for p in prompts] == want
    st = eng.prefix_stats
    assert st["matched_blocks"] >= 1 and st["cow_copies"] >= 1
    assert st == jeng.prefix_stats


def test_wf8_prefix_parity(model):
    """JAX ``test_llama_and_woq_prefix_parity`` on the wf8 tree (the JAX
    package's quantization, bridged), with and without the cache."""
    qtree = jwoq.quantize_model_params(model.jparams, {"quantized_weights": {
        "enabled": True, "num_bits": 8, "group_size": 64,
        "modules": ["proj"]}})
    qparams = woq_params_from_numpy(jax.tree.map(np.asarray, qtree),
                                    model.cfg, device="cpu")
    kw = dict(max_seqs=2, chunk_size=8, block_size=4, num_blocks=64,
              max_blocks_per_seq=16, dtype="float32", decode_loop_steps=0,
              attention_impl="dense")
    rng = np.random.default_rng(77)
    shared = rng.integers(1, VOCAB, 10).tolist()
    prompts = [shared + rng.integers(1, VOCAB, 5).tolist()
               for _ in range(2)]
    jeng = model.jax_engine(qtree, prefix_cache=True, **kw)
    want = [jeng.generate([p], max_new_tokens=5)[0] for p in prompts]
    for cache in (False, True):
        eng = model.engine(qparams, prefix_cache=cache, **kw)
        assert [eng.generate([p], max_new_tokens=5)[0]
                for p in prompts] == want
    assert eng.prefix_stats["matched_blocks"] > 0
    assert eng.prefix_stats == jeng.prefix_stats


def test_eos_rollback_decrefs_shared_blocks(model):
    """A late EOS with steps in flight while the sequence's leading
    blocks are shared: the rollback decrefs them (JAX
    ``test_eos_rollback_decrefs_shared_blocks``). The EOS is the chain's
    token at index 2 and the stream ends at its first occurrence."""
    kw = dict(max_seqs=4, chunk_size=8, block_size=1, num_blocks=64,
              max_blocks_per_seq=32, dtype="float32", decode_loop_steps=0,
              attention_impl="dense", prefix_cache=True)
    prompt = np.random.default_rng(73).integers(1, VOCAB, 10).tolist()
    eng = model.engine(**kw)
    f = eng.put([0], [prompt], _greedy=True)
    chain = eng.decode_pipelined([0], [f[0]], 8)[0]
    eng.flush(0)
    eos = chain[2]
    k = chain.index(eos)
    cached0 = eng._prefix.cached_blocks
    assert cached0 > 0
    f = eng.put([1], [prompt], _greedy=True)
    assert eng.state.sequences[1].shared
    out = eng.decode_pipelined([1], [f[1]], 8, eos_token_id=eos)[1]
    assert out == chain[:k + 1]
    assert eng._prefix.cached_blocks >= cached0
    eng.flush(1)
    assert eng.kv_cache.allocator.free_blocks \
        + eng._prefix.cached_blocks == kw["num_blocks"]
    assert eng.free_blocks == kw["num_blocks"]
    jeng = model.jax_engine(**kw)
    jf = jeng.put([0], [prompt], _greedy=True)
    assert jeng.decode_pipelined([0], [jf[0]], 8)[0] == chain


def test_pause_resume_with_shared_blocks(model):
    """Pausing a sequence on cache-shared blocks offloads its KV and
    decrefs the shared run; resume restores into private blocks, and the
    tokens are the never-paused JAX engine's."""
    kw = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
              max_blocks_per_seq=16, dtype="float32", decode_loop_steps=0,
              attention_impl="dense")
    rng = np.random.default_rng(75)
    shared = rng.integers(1, VOCAB, 10).tolist()
    prompts = [shared + rng.integers(1, VOCAB, 5).tolist()
               for _ in range(2)]
    ref = model.jax_engine(**kw)
    r0 = ref.put([0], [prompts[0]], _greedy=True)
    r1 = ref.put([1], [prompts[1]], _greedy=True)
    rd = ref.decode_pipelined([1], [r1[1]], 4)[1]
    eng = model.engine(prefix_cache=True, **kw)
    g0 = eng.put([0], [prompts[0]], _greedy=True)
    g1 = eng.put([1], [prompts[1]], _greedy=True)
    assert (g0[0], g1[1]) == (r0[0], r1[1])
    seq = eng.state.sequences[1]
    shared_blocks = set(seq.shared)
    assert shared_blocks
    rows = eng.kv_cache.gather_blocks(seq.kv_blocks)[0].clone()
    eng.pause(1)
    assert seq.status is SequenceStatus.PAUSED
    assert not seq.shared and not seq.kv_blocks
    assert eng.query(1) == (seq.seen_tokens, 0)
    for b in shared_blocks:
        assert eng._prefix.entry_of(b) is not None
    eng._prefix.assert_exact_refs(eng.state.sequences.values())
    eng.resume(1)
    assert not seq.shared
    assert len(seq.kv_blocks) == -(-seq.seen_tokens // 4)
    assert torch.equal(eng.kv_cache.gather_blocks(seq.kv_blocks)[0], rows)
    assert eng.decode_pipelined([1], [g1[1]], 4)[1] == rd
    eng._prefix.assert_exact_refs(eng.state.sequences.values())


@pytest.mark.parametrize("loop,plen,gen", [(0, 9, 5), (4, 12, 6)])
def test_oversubscribed_pool_pauses_and_completes(model, loop, plen, gen):
    """Six prompts on an 8-block pool of 4-token blocks: the engine
    pauses holders to host memory and resumes them; the streams are the
    JAX engine's on a roomy pool and on the same small pool (JAX
    ``test_oversubscribed_pool_autopauses_and_completes`` and
    ``test_oversubscribed_pool_with_decode_loop_enabled``)."""
    rng = np.random.default_rng(7 if loop == 0 else 8)
    prompts = [rng.integers(1, VOCAB, plen).tolist() for _ in range(6)]
    kw = dict(max_seqs=4, chunk_size=8, block_size=4, max_blocks_per_seq=8,
              dtype="float32", attention_impl="dense",
              decode_loop_steps=loop)
    ref = model.jax_engine(num_blocks=64, **kw).generate(
        prompts, max_new_tokens=gen)
    small = model.jax_engine(num_blocks=8, **kw).generate(
        prompts, max_new_tokens=gen)
    assert small == ref
    eng = model.engine(num_blocks=8, **kw)
    paused = []
    orig = eng.pause
    eng.pause = lambda uid: (paused.append(uid), orig(uid))
    assert eng.generate(prompts, max_new_tokens=gen) == ref
    assert paused
    assert eng.free_blocks == 8


@pytest.mark.parametrize("release", ["flush", "abort"])
def test_int8_loop_eos_then_blocks_reused(model, release):
    """Over an int8 pool the decode loop's ring is flushed into the pool
    once a loop call ends, every row of a slot that froze at EOS inside
    the call too. Those rows lie in blocks the slot still owns; once it
    is flushed or aborted another request takes its blocks, and its
    stream is the JAX int8 engine's."""
    kw = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=12,
              max_blocks_per_seq=8, dtype="float32", kv_cache_dtype="int8",
              attention_impl="dense", decode_loop_steps=4)
    rng = np.random.default_rng(12)
    p0 = rng.integers(1, VOCAB, 9).tolist()
    p1 = rng.integers(1, VOCAB, 14).tolist()
    jeng = model.jax_engine(**kw)
    chain = jeng.generate([p0], max_new_tokens=9)[0]
    eos = chain[3]
    outs = {}
    for name, eng in (("jax", model.jax_engine(**kw)),
                      ("port", model.engine(**kw))):
        first = eng.put([0], [p0], _greedy=True)
        a = eng.decode_batch([0], [first[0]], 4, eos_token_id=eos)[0]
        getattr(eng, release)(0)
        b = eng.generate([p1, p0], max_new_tokens=9)
        outs[name] = (first[0], a, b)
        assert eng.free_blocks == 12
    assert outs["port"] == outs["jax"]
    assert eos in outs["port"][1]
