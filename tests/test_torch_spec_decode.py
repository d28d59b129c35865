"""Port parity for speculative decoding and fault C6, on the CPU.

- Fault C6: the port's ``RaggedInferenceConfig`` takes every field of the
  JAX dataclass at its JAX default, refuses each multi-device comm knob at
  any other value with a ``NotImplementedError`` naming A8, and has the
  same public fields.
- ``speculative.py`` against the JAX package's: ``accept_length`` and the
  n-gram proposer (its seeded noise too) on random histories.
- The verify feed: the runner's ``decode_loop(draft_toks=)`` against the
  JAX runner's, over an fp32 and an int8 pool.
- The JAX ``TestSpeculativeDecode`` cases on the port's GPT-2 (fp32,
  dense attention, prefix cache on): ngram and draft streams equal to
  spec off and to the JAX engine's, per-sequence ``spec_proposed`` /
  ``spec_accepted`` equal to the JAX engine's under the same noise (0.6,
  seed 0), exact prefix-cache refcounts after noisy rollbacks, budgets and
  EOS, a GPT-2 draft for a GPT-2 target and a tiny-Llama draft for a
  tiny-Llama target, the vocabulary refusal, a drain in the middle of the
  rounds then a replay equal to spec off, and ``build_hf_engine(
  draft_model_dir=)`` over two checkpoints written here.

No counterpart yet: ``test_spec_warm_path_zero_fresh_compiles`` (XLA's
compile cache has none in eager PyTorch; the program audit is A9),
``test_tp2_spec_and_temp0_parity`` (tp = 2 is A8) and
``test_spec_programs_audited_clean`` (A9). The JAX package's noise comes
from ``DSTPU_SPEC_NOISE`` (A9 on the port), so the port's engines here
get an ``NgramProposer(noise=...)`` built by the test.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.inference.v2 import speculative as jspec
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models.gpt2 import GPT2 as JaxGPT2
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu_torch.checkpoint import (gpt2_params_from_numpy,
                                            llama_params_from_numpy)
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceConfig,
                                              SamplingParams,
                                              build_hf_engine)
from deepspeed_tpu_torch.inference.v2 import speculative as tspec
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.models.llama import LlamaConfig

VOCAB = 96
UIDS = [0, 1, 2]
_rng = np.random.default_rng(3)
#: the JAX test's workloads: 3 prompts on a shared 10-token preamble (two
#: full shared blocks at block size 4 and a CoW tail), and periodic
#: prompts whose greedy continuations settle into short cycles
_SHARED = _rng.integers(1, VOCAB, 10).tolist()
PROMPTS = [_SHARED + _rng.integers(1, VOCAB, 5).tolist() for _ in range(3)]
_PAT = _rng.integers(1, VOCAB, 6).tolist()
REP_PROMPTS = [(_PAT * 4)[: 15 + i] for i in range(3)]

#: the multi-device comm knobs, each at a valid value other than its
#: default (the JAX config takes it; the port refuses it, A8)
A8_KNOBS = {"tp_quantized_comm": True, "tp_comm_overlap": "rs_ag",
            "tp_comm_chunks": 4, "ep_comm_overlap": "chunked",
            "ep_comm_chunks": 3, "ep_capacity_factor": 1.5}


class _Pair:
    """A GPT-2 in both packages: the JAX flax tree and the port's copy."""

    def __init__(self, layers, hidden, key):
        self.jcfg = JaxGPT2Config(vocab_size=VOCAB, max_seq_len=256,
                                  num_layers=layers, num_heads=2,
                                  hidden_size=hidden, dtype=jnp.float32)
        self.jparams = JaxGPT2(self.jcfg).init(
            jax.random.PRNGKey(key), jnp.zeros((1, 8), jnp.int32))["params"]
        self.cfg = GPT2Config(vocab_size=VOCAB, max_seq_len=256,
                              num_layers=layers, num_heads=2,
                              hidden_size=hidden, dtype=torch.float32)
        self.params = gpt2_params_from_numpy(
            jax.tree.map(np.asarray, self.jparams), self.cfg, device="cpu",
            dtype=torch.float32)


_PAIRS = {}


def _gpt2(layers=2, hidden=32, key=0):
    k = (layers, hidden, key)
    if k not in _PAIRS:
        _PAIRS[k] = _Pair(layers, hidden, key)
    return _PAIRS[k]


def _kw(depth=2, prefix=True, **kw):
    base = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=96,
                max_blocks_per_seq=24, dtype="float32",
                attention_impl="dense", decode_loop_steps=0,
                serve_pipeline_depth=depth, prefix_cache=prefix)
    base.update(kw)
    return base


def _port(pair, **kw):
    return InferenceEngineV2(pair.cfg, pair.params,
                             RaggedInferenceConfig(**_kw(**kw)),
                             device="cpu")


def _jax(pair, **kw):
    return JaxEngine(pair.jcfg, pair.jparams, JaxRagged(**_kw(**kw)))


def _stream(eng, prompts, n, sampling=None, uids=UIDS, eos=None):
    """put + pipelined decode: the full per-uid streams (first token and
    the ``n`` that follow)."""
    first = eng.put(uids, [list(p) for p in prompts], _greedy=True,
                    sampling=sampling)
    out = eng.decode_pipelined(uids, [first[u] for u in uids], n,
                               eos_token_id=eos)
    return {u: [int(first[u])] + [int(t) for t in out[u]] for u in uids}


def _counters(eng):
    return {u: (s.spec_proposed, s.spec_accepted)
            for u, s in eng.state.sequences.items()}


def _noisy(eng, noise=0.6):
    """The port engine's ngram proposer with the JAX test's noise."""
    eng._proposer = tspec.NgramProposer(
        n=eng.spec_ngram, noise=noise, noise_seed=0, vocab_size=VOCAB)
    return eng


_REFS = {}


def _ref(name, fn):
    if name not in _REFS:
        _REFS[name] = fn()
    return _REFS[name]


def _spec_off(prompts, n):
    key = ("off", tuple(map(tuple, prompts)), n)
    return _ref(key, lambda: _stream(_port(_gpt2()), prompts, n))


# --------------------------------------------------------------------- #
# fault C6
# --------------------------------------------------------------------- #


def test_c6_port_config_takes_every_jax_field():
    """Every public field of the JAX dataclass at its JAX default builds
    the port's config and reads back the same; the spec fields and the
    three sampling fields take other values too (sampling ones are never
    read); invalid values raise the JAX package's ValueError; the two
    classes have the same public fields."""
    jdef = JaxRagged()
    names = [f.name for f in dataclasses.fields(JaxRagged)
             if not f.name.startswith("_")]
    kw = {n: getattr(jdef, n) for n in names}
    cfg = RaggedInferenceConfig(**kw)
    for n, v in kw.items():
        assert getattr(cfg, n) == v, n
    tnames = [f.name for f in dataclasses.fields(RaggedInferenceConfig)
              if not f.name.startswith("_")]
    assert sorted(tnames) == sorted(names)
    for extra in ({"spec_decode": "ngram", "spec_k": 2, "spec_ngram": 5},
                  {"spec_decode": "draft"},
                  {"greedy": False, "temperature": 0.7, "top_k": 5}):
        c = RaggedInferenceConfig(**extra)
        assert all(getattr(c, k) == v for k, v in extra.items())
        JaxRagged(**extra)
    for bad in ({"spec_decode": "medusa"}, {"spec_k": 0}, {"spec_ngram": 0},
                {"tp_comm_overlap": "ring"}, {"tp_comm_chunks": 0},
                {"ep_comm_overlap": "on"}, {"ep_comm_chunks": 0},
                {"ep_capacity_factor": 0.0}):
        with pytest.raises(ValueError):
            JaxRagged(**bad)
        with pytest.raises(ValueError):
            RaggedInferenceConfig(**bad)


@pytest.mark.parametrize("knob", sorted(A8_KNOBS))
def test_c6_unported_knob_refused_naming_a8(knob):
    """A multi-device comm knob off its default: the JAX config takes it,
    the port refuses it naming the queue item (and the knob)."""
    JaxRagged(**{knob: A8_KNOBS[knob]})
    with pytest.raises(NotImplementedError, match=f"{knob}.*A8"):
        RaggedInferenceConfig(**{knob: A8_KNOBS[knob]})


# --------------------------------------------------------------------- #
# speculative.py
# --------------------------------------------------------------------- #


class _Seq:
    def __init__(self, uid, seen):
        self.uid, self.seen_tokens = uid, seen


@pytest.mark.parametrize("noise", [0.0, 0.6])
def test_ngram_proposer_and_accept_length_equal_jax(noise):
    rng = np.random.default_rng(11)
    for trial in range(60):
        n = int(rng.integers(1, 5))
        k = int(rng.integers(1, 7))
        hist = rng.integers(0, 6 if trial % 2 else VOCAB,
                            int(rng.integers(1, 40))).tolist()
        seq = _Seq(int(rng.integers(0, 50)), len(hist))
        jp = jspec.NgramProposer(n=n, noise=noise, noise_seed=trial,
                                 vocab_size=VOCAB)
        tp = tspec.NgramProposer(n=n, noise=noise, noise_seed=trial,
                                 vocab_size=VOCAB)
        assert tp.propose(seq, hist, k) == jp.propose(seq, hist, k)
        assert tp.propose_batch([seq], [hist], k) \
            == jp.propose_batch([seq], [hist], k)
        d = rng.integers(0, 3, k).tolist()
        e = rng.integers(0, 3, k + 1).tolist()
        assert tspec.accept_length(d, e) == jspec.accept_length(d, e)
    eng = _port(_gpt2(), spec_decode="ngram", spec_ngram=2)
    prop = tspec.build_proposer(eng)
    assert (prop.kind, prop.n, prop.noise, prop.vocab_size) \
        == ("ngram", 2, 0.0, VOCAB)
    with pytest.raises(ValueError, match="attach_draft"):
        tspec.build_proposer(_port(_gpt2(), spec_decode="draft"))


@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_verify_feed_equals_jax_decode_loop(pool):
    """``decode_loop(draft_toks=)``: step t consumes the given token. The
    port's tokens equal the JAX runner's on the same prefilled sequences,
    over an fp32 pool and over an int8 pool (the ring, flushed at the
    end); a self-fed loop agrees where the given tokens are its own."""
    pair = _gpt2()
    kv = {} if pool == "float32" else {"kv_cache_dtype": "int8"}
    n = 5
    drafts = np.array([[PROMPTS[i][-1]] + REP_PROMPTS[i][:n - 1]
                       for i in range(3)], np.int32)
    res = {}
    for name, eng in (("jax", _jax(pair, prefix=False, **kv)),
                      ("port", _port(pair, prefix=False, **kv))):
        eng.put(UIDS, [p[:-1] for p in PROMPTS], _greedy=True)
        S, maxb = 4, eng.config.max_blocks_per_seq
        tok0 = np.zeros(S, np.int32)
        start = np.zeros(S, np.int32)
        active = np.zeros(S, np.int32)
        tables = np.zeros((S, maxb), np.int32)
        dt = np.zeros((S, n), np.int32)
        for i, u in enumerate(UIDS):
            s = eng.state.get(u)
            eng.state.ensure_blocks(s, n)
            tok0[i], start[i], active[i] = drafts[i, 0], s.seen_tokens, 1
            tables[i, :len(s.kv_blocks)] = s.kv_blocks
            dt[i] = drafts[i]
        if name == "jax":
            a = jnp.asarray
            toks, _, eng._kv_data, _ = eng.runner.decode_loop(
                eng.params, eng._kv_data, a(tok0), a(start), a(active),
                a(tables), n, draft_toks=a(dt))
            res[name] = np.asarray(toks)
            continue
        t = torch.from_numpy
        toks, _, _ = eng.runner.decode_loop(
            eng.params, eng.kv_cache.pool, t(tok0), t(start), t(active),
            t(tables), n, draft_toks=t(dt))
        res[name] = toks.numpy()
        # a self-fed loop from the same state, fed its own tokens
        own = np.concatenate([drafts[:, :1], toks.numpy()[:3, :n - 1]], 1)
        dt2 = dt.copy()
        dt2[:3] = own
        again, _, _ = eng.runner.decode_loop(
            eng.params, eng.kv_cache.pool, t(tok0), t(start), t(active),
            t(tables), n, draft_toks=t(dt2))
        selfed, _, _ = eng.runner.decode_loop(
            eng.params, eng.kv_cache.pool, t(tok0), t(start), t(active),
            t(tables), n)
        assert np.array_equal(again.numpy()[:3], selfed.numpy()[:3])
    assert np.array_equal(res["port"][:3], res["jax"][:3])


# --------------------------------------------------------------------- #
# the JAX TestSpeculativeDecode cases on the port
# --------------------------------------------------------------------- #


def test_ngram_parity_counters_and_exact_release():
    pair = _gpt2()
    want = _spec_off(REP_PROMPTS, 12)
    jeng = _jax(pair, spec_decode="ngram", spec_k=4)
    assert _stream(jeng, REP_PROMPTS, 12) == want
    eng = _port(pair, spec_decode="ngram", spec_k=4)
    assert eng.spec_enabled
    got = _stream(eng, REP_PROMPTS, 12)
    assert got == want
    assert _counters(eng) == _counters(jeng)
    st = eng.spec_stats
    assert st["rounds"] > 0 and st["proposed"] > 0
    assert st["proposed"] == sum(p for p, _ in _counters(eng).values())
    assert st["accepted"] == sum(a for _, a in _counters(eng).values())
    assert eng.state.sequences[UIDS[0]].spec_proposed > 0
    eng._prefix.assert_exact_refs(eng.state.sequences.values())
    for u in UIDS:
        eng.flush(u)
    assert eng.kv_cache.free_blocks == eng.config.num_blocks
    eng._prefix.check_invariants()
    # the SLO report's speculation counters are the JAX engine's
    rep, jrep = eng.slo_report(), jeng.slo_report()
    assert rep["spec"] == jrep["spec"] and rep["spec"]["proposed"] > 0
    assert rep["spec_accept_rate"] == jrep["spec_accept_rate"]
    assert rep["spec"]["proposed"] == st["proposed"]


def test_budget_exact_and_eos_truncation():
    pair = _gpt2()
    ref = _port(pair)
    f0 = ref.put(UIDS, [list(p) for p in REP_PROMPTS], _greedy=True)
    budgets = [5, 9, 12]
    r0 = ref.decode_pipelined(UIDS, [f0[u] for u in UIDS], budgets)
    for name, eng in (("jax", _jax(pair, spec_decode="ngram", spec_k=4)),
                      ("port", _port(pair, spec_decode="ngram",
                                     spec_k=4))):
        f1 = eng.put(UIDS, [list(p) for p in REP_PROMPTS], _greedy=True)
        r1 = eng.decode_pipelined(UIDS, [f1[u] for u in UIDS], budgets)
        assert {u: [int(t) for t in r1[u]] for u in UIDS} == r0, name
        assert [len(r1[u]) for u in UIDS] == budgets
    eos = r0[UIDS[1]][2]
    want = _stream(_port(pair), REP_PROMPTS, 12, eos=eos)
    assert want[UIDS[1]][-1] == eos and eos not in want[UIDS[1]][1:-1]
    eng = _port(pair, spec_decode="ngram", spec_k=4)
    assert _stream(eng, REP_PROMPTS, 12, eos=eos) == want
    assert _stream(_jax(pair, spec_decode="ngram", spec_k=4), REP_PROMPTS,
                   12, eos=eos) == want
    # the EOS'd sequence holds KV for the tokens it committed, no more
    s = eng.state.get(UIDS[1])
    assert s.seen_tokens == len(REP_PROMPTS[1]) + len(want[UIDS[1]]) - 1
    assert len(s.kv_blocks) == -(-s.seen_tokens // 4)


@pytest.mark.parametrize("impl", ["dense", "paged_flash"])
def test_draft_model_same_params_full_acceptance(impl):
    """The target's own parameters as the draft: every draft is accepted
    (the draft's self feed and the target's given feed compute the same
    tokens); ``paged_flash`` runs the kernels' plain versions here."""
    pair = _gpt2()
    want = _spec_off(PROMPTS, 10)
    eng = _port(pair, spec_decode="draft", spec_k=3, attention_impl=impl)
    draft = eng.attach_draft(pair.cfg, pair.params)
    assert draft.device == eng.device and draft.spec_mode == "off"
    assert not draft.config.prefix_cache and draft.pipeline_depth == 0
    got = _stream(eng, PROMPTS, 10)
    assert got == want
    st = eng.spec_stats
    assert st["proposed"] > 0 and st["accepted"] == st["proposed"]
    for u in UIDS:
        eng.flush(u)
    assert eng.kv_cache.free_blocks == eng.config.num_blocks
    assert draft.kv_cache.free_blocks == draft.config.num_blocks
    assert not draft.state.sequences


def test_draft_vocab_mismatch_rejected():
    pair = _gpt2()
    bad = GPT2Config(vocab_size=64, max_seq_len=256, num_layers=1,
                     num_heads=2, hidden_size=16, dtype=torch.float32)
    eng = _port(pair, spec_decode="draft")
    with pytest.raises(ValueError, match="vocab"):
        eng.attach_draft(bad, None)


def test_draft_small_model_parity():
    """A one-layer GPT-2 drafting for the target: streams equal spec off
    and the JAX engine's with the same draft; per-sequence counters equal
    the JAX engine's."""
    pair, dpair = _gpt2(), _gpt2(layers=1, hidden=16, key=5)
    want = _spec_off(REP_PROMPTS, 14)
    jeng = _jax(pair, spec_decode="draft", spec_k=4)
    jeng.attach_draft(dpair.jcfg, dpair.jparams)
    assert _stream(jeng, REP_PROMPTS, 14) == want
    eng = _port(pair, spec_decode="draft", spec_k=4)
    eng.attach_draft(dpair.cfg, dpair.params)
    assert _stream(eng, REP_PROMPTS, 14) == want
    assert _counters(eng) == _counters(jeng)
    assert eng.spec_stats["accepted"] < eng.spec_stats["proposed"]
    for u in UIDS:
        eng.flush(u)
    assert eng.kv_cache.free_blocks == eng.config.num_blocks
    assert eng._draft_engine.kv_cache.free_blocks \
        == eng._draft_engine.config.num_blocks


def test_tiny_llama_draft_for_tiny_llama_target():
    """The dense Llama runner on both sides: a 1-layer tiny Llama drafts
    for a 2-layer one (vocabulary 512), greedy streams equal spec off and
    the JAX engine's; sampled and logprobs sequences bypass speculation."""
    trees = {}
    for layers, key in ((2, 0), (1, 7)):
        jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, max_seq_len=256,
                                       num_layers=layers)
        _, init_fn, _ = jllama.make_model(jcfg)
        jp = init_fn(jax.random.PRNGKey(key), seq_len=16)
        tcfg = LlamaConfig.tiny(dtype=torch.float32, max_seq_len=256,
                                num_layers=layers)
        trees[layers] = (jcfg, jp, tcfg, llama_params_from_numpy(
            jax.tree.map(np.asarray, jp), tcfg, device="cpu",
            dtype=torch.float32))
    (jcfg, jp, tcfg, tp), (djcfg, djp, dtcfg, dtp) = trees[2], trees[1]
    rng = np.random.default_rng(5)
    pat = rng.integers(1, 512, 5).tolist()
    prompts = [(pat * 5)[:12 + i] for i in range(3)]
    kw = _kw(block_size=8, max_blocks_per_seq=12)
    want = _stream(InferenceEngineV2(tcfg, tp, RaggedInferenceConfig(**kw),
                                     device="cpu"), prompts, 12)
    jeng = JaxEngine(jcfg, jp, JaxRagged(**kw, spec_decode="draft"))
    jeng.attach_draft(djcfg, djp)
    assert _stream(jeng, prompts, 12) == want
    eng = InferenceEngineV2(tcfg, tp, RaggedInferenceConfig(
        **kw, spec_decode="draft"), device="cpu")
    eng.attach_draft(dtcfg, dtp)
    assert _stream(eng, prompts, 12) == want
    assert _counters(eng) == _counters(jeng)
    assert eng.spec_stats["rounds"] > 0
    for u in UIDS:
        eng.flush(u)
    # a sampled and a logprobs request: decode_pipelined's own path
    sp = {0: SamplingParams(temperature=0.8, top_k=8, seed=3),
          1: SamplingParams(temperature=0.0, logprobs=True)}
    ref = _stream(InferenceEngineV2(tcfg, tp, RaggedInferenceConfig(**kw),
                                    device="cpu"), prompts, 6, sampling=sp)
    rounds = eng.spec_stats["rounds"]
    assert _stream(eng, prompts, 6, sampling=sp) == ref
    assert eng.spec_stats["rounds"] == rounds
    assert ref[1] == want[1][:7]


class _FlipAfter:
    """A preemption flag that turns on at its ``n``-th read."""

    def __init__(self, n):
        self.reads, self.n = 0, n

    @property
    def preempted(self):
        self.reads += 1
        return self.reads >= self.n


def _untimed(m):
    m = json.loads(json.dumps(m))
    for k in ("time", "path", "telemetry"):
        m.pop(k, None)
    return m


def test_spec_drain_mid_rounds_then_replay_parity():
    """A drain lands between verify rounds: the rounds stop, the manifest
    holds committed tokens only (rejected drafts never entered
    ``gen_log``), every block comes back, and the replay continues the
    spec-off stream token for token. The port's manifest equals the JAX
    engine's under the same flag."""
    pair = _gpt2()
    want = _spec_off(REP_PROMPTS, 12)
    res = {}
    for name, mk in (("jax", _jax), ("port", _port)):
        eng = mk(pair, spec_decode="ngram", spec_k=4)
        first = eng.put(UIDS, [list(p) for p in REP_PROMPTS], _greedy=True)
        eng.attach_preemption(_FlipAfter(3))
        part = eng.decode_pipelined(UIDS, [first[u] for u in UIDS], 12)
        assert 0 < sum(len(v) for v in part.values()) < 36
        eng.preemption = None
        m = eng.drain()
        assert m["pool"]["fully_recovered"]
        res[name] = (first, part, _untimed(m))
    assert res["port"][2] == res["jax"][2]
    first, part, m = res["port"]
    surv = _port(pair, spec_decode="ngram", spec_k=4)
    rep = surv.replay(m)
    gen = {r["uid"]: list(r["generated"]) for r in m["sequences"]}
    for u in UIDS:
        assert gen[u] == [int(first[u])] + [int(t) for t in part[u]]
    cont = surv.decode_pipelined(
        UIDS, [rep[u] for u in UIDS],
        [len(want[u]) - len(gen[u]) - 1 for u in UIDS])
    got = {u: gen[u] + [int(rep[u])] + [int(t) for t in cont[u]]
           for u in UIDS}
    assert got == want
    assert surv.spec_stats["rounds"] > 0


# --------------------------------------------------------------------- #
# build_hf_engine(draft_model_dir=)
# --------------------------------------------------------------------- #


def test_build_hf_engine_with_a_draft_checkpoint(tmp_path):
    """Two GPT-2 checkpoints written by ``transformers`` (a 2-layer target
    and a 1-layer draft of its vocabulary): both packages'
    ``build_hf_engine(draft_model_dir=)`` give the spec-off streams; the
    draft takes the dtype override; a draft architecture the factory
    does not serve is refused before any shard is read."""
    transformers = pytest.importorskip("transformers")
    from deepspeed_tpu.inference.v2.engine_factory import \
        build_hf_engine as jax_build_hf_engine
    dirs = {}
    for name, layers, seed in (("target", 2, 0), ("draft", 1, 1)):
        torch.manual_seed(seed)
        m = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=layers,
            n_head=2))
        d = tmp_path / name
        m.save_pretrained(d)
        dirs[name] = str(d)
    kw = _kw(spec_decode="draft", spec_k=3)
    off = build_hf_engine(dirs["target"], engine_config=RaggedInferenceConfig(
        **_kw()), dtype="float32", device="cpu")
    want = _stream(off, REP_PROMPTS, 10)
    eng = build_hf_engine(dirs["target"],
                          engine_config=RaggedInferenceConfig(**kw),
                          dtype="float32", draft_model_dir=dirs["draft"],
                          device="cpu")
    draft = eng._draft_engine
    assert draft is not None and draft.model_cfg.num_layers == 1
    assert draft.model_cfg.dtype == torch.float32
    assert _stream(eng, REP_PROMPTS, 10) == want
    assert eng.spec_stats["rounds"] > 0
    jeng = jax_build_hf_engine(dirs["target"], engine_config=JaxRagged(**kw),
                               dtype="float32",
                               draft_model_dir=dirs["draft"])
    assert _stream(jeng, REP_PROMPTS, 10) == want
    assert _counters(eng) == _counters(jeng)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "config.json").write_text(json.dumps(
        {"model_type": "bert"}))
    (bad / "model.safetensors").write_bytes(b"\xff" * 64)
    with pytest.raises(ValueError, match="not servable"):
        build_hf_engine(dirs["target"], draft_model_dir=str(bad),
                        device="cpu")


@pytest.fixture
def fresh_reference(monkeypatch):
    """The JAX engine as a fresh process builds it, whatever ran before in
    this process: each ``DSTPU_*`` serving or speculation knob found in the
    environment is removed for the test, and a fault injector found
    installed is taken out. Returns what it found (printed, and named in
    the test's assertion messages), so that a failure names the state
    another test left behind."""
    from deepspeed_tpu.resilience import fault_injection as fi
    found = {name: os.environ[name] for name in sorted(os.environ)
             if name.startswith("DSTPU_")}
    for name in found:
        monkeypatch.delenv(name)
    inj = fi._INJECTOR
    if inj is not None and inj is not fi._NOOP:
        found["fault_injector"] = repr(inj)
        monkeypatch.setattr(fi, "_INJECTOR", None)
    print(f"fresh_reference removed: {found}")
    return found


def test_noisy_proposer_rollback_refcounts_exact(monkeypatch,
                                                 fresh_reference):
    """Heavy rejection on a shared-prefix chain: every round retracts
    most of its span; shared blocks are decref'd exactly, never freed.
    The port's counters equal the JAX engine's under the same noise. The
    JAX engine is built without the ``DSTPU_*`` knobs or fault injector
    an earlier test may have left (``fresh_reference``): in one
    multi-worker run its noisy stream left spec off's, which no run of
    the file alone, after other files, or under load has repeated."""
    pair = _gpt2()
    want = _spec_off(PROMPTS, 10)
    monkeypatch.setenv("DSTPU_SPEC_NOISE", "0.6")
    jeng = _jax(pair, spec_decode="ngram", spec_k=4)
    assert _stream(jeng, PROMPTS, 10) == want, fresh_reference
    monkeypatch.delenv("DSTPU_SPEC_NOISE")
    eng = _noisy(_port(pair, spec_decode="ngram", spec_k=4))
    got = _stream(eng, PROMPTS, 10)
    assert got == want, fresh_reference
    assert _counters(eng) == _counters(jeng), fresh_reference
    assert any(p > a for p, a in _counters(eng).values())
    st = eng.state.prefix_stats
    assert st["trims"] > 0, "noisy speculation never rolled back"
    assert st["trims"] == jeng.state.prefix_stats["trims"]
    eng._prefix.assert_exact_refs(eng.state.sequences.values())
    for u in UIDS:
        eng.flush(u)
    assert eng.kv_cache.free_blocks == eng.config.num_blocks
    eng._prefix.check_invariants()
