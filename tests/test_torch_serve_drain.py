"""Port parity for serve-side resilience: drain/replay, the replay
journal, abort, deadlines, load shedding and dispatch retry, on the tiny
Llama of the JAX package (fp32, dense attention) on the CPU.

The oracle is the JAX engine's uninterrupted greedy stream (depth 0,
cache off). A drain at any point, then a replay of its manifest on a
fresh engine of either package, gives that stream token for token: a
manifest written by the JAX engine replays on the port and the port's on
the JAX engine, and the two engines' manifests and journals for the same
run are equal field for field but for time stamps (and the JAX drain's
telemetry report: telemetry is A6). Releases are exact:
every block back, refcounts zero, nothing freed twice (the allocator
detects a double free).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.inference.v2 import drain as jdrain
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.checkpoint import llama_params_from_numpy
from deepspeed_tpu_torch.inference.v2 import (EngineDrainingError,
                                              InferenceEngineV2,
                                              RaggedInferenceConfig,
                                              ServeDrainError,
                                              ServeStepError,
                                              load_manifest,
                                              load_replay_state,
                                              manifest_from_journal)
from deepspeed_tpu_torch.inference.v2.drain import write_manifest
from deepspeed_tpu_torch.models.llama import LlamaConfig

UIDS = (0, 1, 2)
N_TOK = 8
_rng = np.random.default_rng(55)
_SHARED = _rng.integers(1, 512, 10).tolist()
PROMPTS = tuple(_SHARED + _rng.integers(1, 512, 5).tolist() for _ in UIDS)
_CACHE = {}


def _model():
    if "m" not in _CACHE:
        jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
        _, init_fn, _ = jllama.make_model(jcfg)
        jparams = init_fn(jax.random.PRNGKey(0), seq_len=16)
        cfg = LlamaConfig.tiny(dtype=torch.float32)
        params = llama_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu",
                                         dtype=torch.float32)
        _CACHE["m"] = (jcfg, jparams, cfg, params)
    return _CACHE["m"]


def _kw(prefix=True, depth=2, **kw):
    base = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
                max_blocks_per_seq=16, dtype="float32",
                attention_impl="dense", decode_loop_steps=0,
                serve_pipeline_depth=depth, prefix_cache=prefix)
    base.update(kw)
    return base


def _engine(**kw):
    _, _, cfg, params = _model()
    return InferenceEngineV2(cfg, params, RaggedInferenceConfig(**_kw(**kw)),
                             device="cpu")


def _jax_engine(**kw):
    jcfg, jparams, _, _ = _model()
    return JaxEngine(jcfg, jparams, JaxRagged(**_kw(**kw)))


def _serve(eng, n=N_TOK, uids=UIDS, prompts=PROMPTS, rounds_of=2):
    """Admit each request, then decode the live ones in small pipelined
    rounds; sequences stay live on return (as the JAX test serves)."""
    toks = {}
    for u, p in zip(uids, prompts):
        r = eng.put([u], [list(p)], _greedy=True)
        if u in r:
            toks[u] = [int(r[u])]
    while True:
        live = [u for u in toks
                if len(toks[u]) < n and u not in eng.rejections
                and u in eng.state.sequences]
        if not live:
            return toks
        k = min(rounds_of, n - min(len(toks[u]) for u in live))
        outs = eng.decode_pipelined(live, [toks[u][-1] for u in live], k)
        got = False
        for u in live:
            if outs[u]:
                got = True
            toks[u].extend(outs[u][:n - len(toks[u])])
        if not got:
            return toks


@pytest.fixture(scope="module")
def oracle():
    want = _serve(_jax_engine(prefix=False, depth=0))
    assert _serve(_engine(prefix=False, depth=0)) == want
    return want


def _assert_released(eng, manifest):
    assert manifest["pool"]["fully_recovered"], manifest["pool"]
    assert eng.free_blocks == eng.config.num_blocks
    assert not eng.state.sequences
    if eng._prefix is not None:
        eng._prefix.check_invariants()
        assert eng._prefix.evictable_blocks == eng._prefix.cached_blocks


def _finish(eng, manifest, n=N_TOK):
    """Replay a manifest on ``eng`` and decode each sequence to ``n``
    tokens."""
    out = eng.replay(manifest)
    toks = {int(s["uid"]): list(s["generated"])
            for s in manifest["sequences"]}
    for u in list(toks):
        if u in out and len(toks[u]) < n:
            toks[u].append(int(out[u]))
    while True:
        short = [u for u in toks if len(toks[u]) < n]
        if not short:
            return toks
        outs = eng.decode_pipelined(short, [toks[u][-1] for u in short],
                                    [n - len(toks[u]) for u in short])
        for u in short:
            toks[u].extend(outs[u][:n - len(toks[u])])


def _untimed(m):
    """A manifest without its time stamps, and without the telemetry
    report the JAX engine's drain attaches (telemetry is A6)."""
    m = json.loads(json.dumps(m))
    m.pop("time", None)
    m.pop("path", None)
    m.pop("telemetry", None)
    for r in m.get("rejections", []):
        r.pop("time", None)
    return m


# --------------------------------------------------------------------- #
# drain / replay
# --------------------------------------------------------------------- #


def test_drain_replay_parity_and_release(oracle, tmp_path):
    eng = _engine()
    partial = _serve(eng, n=4)
    eng.request_drain()
    assert eng.draining
    # draining: a fresh admission is refused with a record; a live
    # sequence's continuation is not fed and not refused
    assert eng.put([9], [[1, 2, 3]]) == {}
    assert eng.rejections[9]["reason"] == "draining"
    assert eng.put([0], [[partial[0][-1]]]) == {}
    assert 0 not in eng.rejections
    with pytest.raises(EngineDrainingError):
        eng.replay({"sequences": []})
    path = str(tmp_path / "m.json")
    m = eng.drain(path)
    _assert_released(eng, m)
    m2 = load_manifest(path)
    assert [s["uid"] for s in m2["sequences"]] == list(UIDS)
    for s in m2["sequences"]:
        assert s["prompt"] == list(PROMPTS[s["uid"]])
        assert s["generated"] == partial[s["uid"]]
        assert s["scheduler"]["seen_tokens"] > 0
    eng2 = _engine()
    assert _finish(eng2, m2) == oracle
    # the replayed sequences keep their prompt/generated split: a later
    # drain is cumulative
    m3 = eng2.drain()
    for s in m3["sequences"]:
        assert s["prompt"] == list(PROMPTS[s["uid"]])
        assert s["generated"] == oracle[s["uid"]]
    _assert_released(eng2, m3)
    with pytest.raises(NotImplementedError, match="A6"):
        _engine().drain(ledger=object())


@pytest.mark.parametrize("prefix", [True, False])
def test_manifest_and_journal_equal_jax_field_for_field(prefix, tmp_path):
    """The same run on both engines: equal manifests (scheduler snapshot
    and pool verdict included) but for time stamps, and equal journals
    line for line."""
    ms, journals = [], []
    for name, make in (("jax", _jax_engine), ("port", _engine)):
        jpath = str(tmp_path / f"{name}.jsonl")
        eng = make(prefix=prefix, serve_journal=jpath)
        _serve(eng, n=4)
        eng.flush(1)
        ms.append(_untimed(eng.drain()))
        with open(jpath) as f:
            journals.append(f.read().splitlines())
    assert ms[0] == ms[1]
    assert journals[0] == journals[1] and len(journals[0]) > 4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manifest_replays_across_packages(oracle, writer, tmp_path):
    """A manifest one package drained to disk replays on the other with
    the uninterrupted stream."""
    path = str(tmp_path / "m.json")
    if writer == "jax":
        eng = _jax_engine()
        _serve(eng, n=3)
        eng.drain(path)
        reader = _engine()
        m = load_manifest(path)
    else:
        eng = _engine()
        _serve(eng, n=3)
        eng.drain(path)
        reader = _jax_engine()
        m = jdrain.load_manifest(path)
    assert _finish(reader, m) == oracle


def test_fused_decode_loop_replay_parity(oracle):
    eng = _engine(prefix=False, decode_loop_steps=4)
    r = eng.put(list(UIDS), [list(p) for p in PROMPTS], _greedy=True)
    outs = eng.decode_batch(list(UIDS), [int(r[u]) for u in UIDS], 4)
    m = eng.drain()
    _assert_released(eng, m)
    for s in m["sequences"]:
        assert s["generated"] == [int(r[s["uid"]])] + outs[s["uid"]]
    assert _finish(_engine(prefix=False), m) == oracle


def test_preemption_flag_unwinds_the_pipeline(oracle):
    """Any object with a boolean ``preempted``: once set mid-decode the
    loop stops planning, commits what is in flight and returns; the
    drain manifest then replays to the oracle."""
    class Flag:
        preempted = False
    eng = _engine()
    flag = Flag()
    eng.attach_preemption(flag)
    r = eng.put(list(UIDS), [list(p) for p in PROMPTS], _greedy=True)
    orig, n = eng._pre_commit, [0]

    def hook(fl):
        out = orig(fl)
        n[0] += 1
        if n[0] == 2:
            flag.preempted = True
        return out
    eng._pre_commit = hook
    outs = eng.decode_pipelined(list(UIDS), [int(r[u]) for u in UIDS],
                                N_TOK - 1)
    assert eng.draining and 0 < len(outs[0]) < N_TOK - 1
    with pytest.raises(ServeDrainError):
        eng._live_ring = []
        eng.drain()
    eng._live_ring = None
    m = eng.drain()
    _assert_released(eng, m)
    assert _finish(_engine(), m) == oracle


# --------------------------------------------------------------------- #
# abort
# --------------------------------------------------------------------- #


def test_abort_unknown_uid():
    assert _engine().abort(123) is False


def test_abort_idle_releases_immediately(oracle):
    eng = _engine(prefix=False)
    r = eng.put(list(UIDS), [list(p) for p in PROMPTS], _greedy=True)
    assert eng.abort(1) is True
    assert eng.abort(1) is False          # flushed: unknown now
    assert 1 not in eng.state.sequences
    live = sum(len(s.kv_blocks) for s in eng.state.sequences.values())
    assert eng.free_blocks == eng.config.num_blocks - live
    outs = eng.decode_pipelined([0, 2], [int(r[0]), int(r[2])], N_TOK - 1)
    for u in (0, 2):
        assert [int(r[u])] + outs[u] == oracle[u]


@pytest.mark.parametrize("prefix", [False, True])
def test_abort_mid_pipeline_defers_frees(oracle, prefix):
    """An abort from inside a commit with later steps in flight: its
    slots die, its flush waits for the last in-flight step's commit (a
    free any earlier is a double free the allocator would catch), and
    the others' streams are untouched."""
    eng = _engine(prefix=prefix, depth=2)
    r = eng.put(list(UIDS), [list(p) for p in PROMPTS], _greedy=True)
    orig, n, deferred = eng._pre_commit, [0], []

    def hook(fl):
        out = orig(fl)
        n[0] += 1
        if n[0] == 3:
            assert eng.abort(1) is True
            deferred.append(any(eng.state.get(1) is s for f in
                                eng._live_ring for s in f.aborts))
        return out
    eng._pre_commit = hook
    outs = eng.decode_pipelined(list(UIDS), [int(r[u]) for u in UIDS],
                                N_TOK - 1)
    eng._pre_commit = orig
    assert deferred == [True]
    assert 1 not in eng.state.sequences
    live = sum(len(s.kv_blocks) for s in eng.state.sequences.values())
    assert eng.free_blocks == eng.config.num_blocks - live
    for u in (0, 2):
        assert [int(r[u])] + outs[u] == oracle[u]
    got = [int(r[1])] + outs[1]
    assert got == oracle[1][:len(got)]
    if prefix:
        eng._prefix.check_invariants()
        eng._prefix.assert_exact_refs(eng.state.sequences.values())


def test_abort_racing_eos_rollback_no_double_free():
    """A late EOS kills a sequence's later in-flight slots and queues a
    rollback; an abort arriving as that rollback's carrier commits must
    not free blocks the rollback then trims again. The EOS is the first
    token of the greedy chain whose first occurrence is at index 2 or
    later, so the stream ends mid-ring (the JAX test's EOS, chain[2],
    also occurs at chain[0] there)."""
    eng = _engine(prefix=False, depth=3, block_size=1, num_blocks=64,
                  max_blocks_per_seq=32)
    prompt = np.random.default_rng(9).integers(1, 512, 10).tolist()
    f = eng.put([0], [prompt], _greedy=True)
    chain = eng.decode_pipelined([0], [int(f[0])], 8)[0]
    eng.flush(0)
    k = next(i for i in range(2, len(chain)) if chain[i] not in chain[:i])
    eos = chain[k]
    f = eng.put([1], [prompt], _greedy=True)
    orig, state = eng._pre_commit, {"done": False}

    def hook(fl):
        out = orig(fl)
        if fl.rollbacks and not state["done"]:
            state["done"] = True
            eng.abort(1)
        return out
    eng._pre_commit = hook
    out = eng.decode_pipelined([1], [int(f[1])], 8, eos_token_id=eos)
    eng._pre_commit = orig
    assert state["done"], "EOS rollback never queued"
    assert out[1] == chain[:k + 1]
    assert 1 not in eng.state.sequences
    assert eng.free_blocks == eng.config.num_blocks


def test_abort_shared_prefix_refcounts_exact():
    eng = _engine()
    _serve(eng, n=3)
    assert eng.state.sequences[1].shared
    assert eng.abort(1) is True
    eng._prefix.check_invariants()
    eng._prefix.assert_exact_refs(eng.state.sequences.values())
    for u in (0, 2):
        eng.flush(u)
    eng._prefix.check_invariants()
    assert eng._prefix.evictable_blocks == eng._prefix.cached_blocks
    assert eng.free_blocks == eng.config.num_blocks


# --------------------------------------------------------------------- #
# the journal
# --------------------------------------------------------------------- #


def test_journal_crash_replay_parity(oracle, tmp_path):
    jpath = str(tmp_path / "serve.jsonl")
    eng = _engine(serve_journal=jpath)
    partial = _serve(eng, n=4)
    del eng                                # a hard crash: no drain
    m = manifest_from_journal(jpath)
    assert m["source"] == "journal"
    assert {int(s["uid"]): s["generated"] for s in m["sequences"]} \
        == partial
    assert _finish(_engine(), m) == oracle
    assert _finish(_jax_engine(), jdrain.manifest_from_journal(jpath)) \
        == oracle


def test_journal_finish_drops_sequence(tmp_path):
    jpath = str(tmp_path / "serve.jsonl")
    eng = _engine(serve_journal=jpath)
    _serve(eng, n=2)
    eng.flush(1)
    m = manifest_from_journal(jpath)
    assert sorted(int(s["uid"]) for s in m["sequences"]) == [0, 2]


def test_journal_torn_tail_tolerated(tmp_path):
    jpath = str(tmp_path / "serve.jsonl")
    eng = _engine(serve_journal=jpath)
    partial = _serve(eng, n=3)
    with open(jpath, "a") as f:
        f.write('{"e": "tokens", "t": {"0": [7')     # killed mid-write
    m = manifest_from_journal(jpath)
    assert {int(s["uid"]): s["generated"] for s in m["sequences"]} \
        == partial


def test_drain_leaves_journal_intact_as_fallback(oracle, tmp_path):
    jpath = str(tmp_path / "serve.jsonl")
    eng = _engine(serve_journal=jpath)
    partial = _serve(eng, n=4)
    assert len(eng.drain()["sequences"]) == 3
    m2 = manifest_from_journal(jpath)
    assert {int(s["uid"]): s["generated"] for s in m2["sequences"]} \
        == partial
    assert _finish(_engine(), m2) == oracle


def test_load_replay_state_prefers_manifest(tmp_path):
    mpath, jpath = str(tmp_path / "m.json"), str(tmp_path / "j.jsonl")
    write_manifest({"version": 1, "source": "drain", "sequences": []},
                   mpath)
    with open(jpath, "w") as f:
        f.write(json.dumps({"e": "admit", "uid": 3, "prompt": [1, 2]})
                + "\n")
    assert load_replay_state(mpath, jpath)["source"] == "drain"
    assert load_replay_state(None, jpath)["source"] == "journal"
    assert load_replay_state(str(tmp_path / "no.json"), None) is None
    with open(mpath, "w") as f:
        json.dump({"version": 2, "sequences": []}, f)
    with pytest.raises(ServeDrainError, match="version"):
        load_manifest(mpath)


# --------------------------------------------------------------------- #
# deadlines, shedding, retry
# --------------------------------------------------------------------- #


def test_deadline_expiry_aborts_with_rejection(oracle):
    eng = _engine(prefix=False, request_deadline_s=60)
    r = eng.put(list(UIDS), [list(p) for p in PROMPTS], _greedy=True)
    for u in UIDS:
        assert eng.state.sequences[u].deadline_at is not None
    eng.state.sequences[1].deadline_at = time.monotonic() - 1
    outs = eng.decode_pipelined(list(UIDS), [int(r[u]) for u in UIDS],
                                N_TOK - 1)
    rej = eng.rejections[1]
    assert rej["reason"] == "deadline_exceeded" and rej["deadline_s"] == 60
    assert 1 not in eng.state.sequences
    for u in (0, 2):
        assert [int(r[u])] + outs[u] == oracle[u]
    # a request that owes nothing is not reaped by an expired deadline
    eng.state.sequences[0].deadline_at = time.monotonic() - 1
    more = eng.decode_pipelined([2], [outs[2][-1]], 2)
    assert 0 not in eng.rejections and 0 in eng.state.sequences
    assert len(more[2]) == 2


def test_per_request_deadline_and_arrival():
    eng = _engine(prefix=False)
    now = time.monotonic()
    eng.put([0, 1], [list(PROMPTS[0]), list(PROMPTS[1])], _greedy=True,
            arrivals={0: now - 1, 1: now}, deadlines={0: 5, 1: 50})
    s0, s1 = eng.state.sequences[0], eng.state.sequences[1]
    assert s0.deadline_s == 5 and s0.deadline_at == pytest.approx(now + 4)
    assert s1.deadline_at == pytest.approx(now + 50)


def test_prompt_larger_than_the_pool_is_shed_at_the_door():
    """A prompt that needs more blocks than the whole pool: a
    ``kv_pool_exhausted`` rejection in place of the OutOfBlocksError the
    port raised before; the engine keeps serving. With ``serve_shed``
    off the scheduler starves and raises."""
    eng = _engine(prefix=False, num_blocks=2, max_blocks_per_seq=8)
    assert eng.put([0], [[1] * 16]) == {}
    assert eng.rejections[0]["reason"] == "kv_pool_exhausted"
    assert eng.rejections[0]["needed_blocks"] == 5
    assert 0 not in eng.state.sequences and eng.free_blocks == 2
    assert 1 in eng.put([1], [[1, 2, 3, 4, 5]])
    hard = _engine(prefix=False, num_blocks=2, max_blocks_per_seq=8,
                   serve_shed=False)
    with pytest.raises(RuntimeError, match="starved"):
        hard.put([0], [[1] * 12])


def test_decode_outgrows_pool_sheds_gracefully():
    eng = _engine(prefix=False, num_blocks=4, max_seqs=2)
    prompt = np.random.default_rng(3).integers(1, 512, 13).tolist()
    r = eng.put([0], [prompt], _greedy=True)
    outs = eng.decode_pipelined([0], [int(r[0])], 8)
    assert len(outs[0]) < 8
    assert eng.rejections[0]["reason"] == "kv_pool_exhausted"
    assert 0 not in eng.state.sequences and eng.free_blocks == 4
    assert 1 in eng.put([1], [[5, 6, 7]], _greedy=True)
    jeng = _jax_engine(prefix=False, num_blocks=4, max_seqs=2)
    jr = jeng.put([0], [prompt], _greedy=True)
    assert jeng.decode_pipelined([0], [int(jr[0])], 8) == outs


def test_decode_outgrows_pool_hard_mode_raises():
    eng = _engine(prefix=False, num_blocks=4, max_seqs=2, serve_shed=False)
    prompt = np.random.default_rng(3).integers(1, 512, 13).tolist()
    r = eng.put([0], [prompt], _greedy=True)
    with pytest.raises(RuntimeError, match="starved"):
        eng.decode_pipelined([0], [int(r[0])], 8)


def test_transient_dispatch_failure_retries(oracle):
    """A dispatch that raises OSError once is retried with the same
    planned step; the stream is the oracle's."""
    eng = _engine(prefix=False, serve_retry_backoff_s=0.0)
    orig, fails = eng._dispatch_step, [1]

    def flaky(plan):
        if fails[0]:
            fails[0] -= 1
            raise OSError("transient")
        return orig(plan)
    eng._dispatch_step = flaky
    assert _serve(eng) == oracle
    assert eng.pipeline_stats["retries"] == 1


def test_persistent_dispatch_failure_surfaces_then_drains(oracle):
    eng = _engine(prefix=False, serve_retry_backoff_s=0.0,
                  serve_step_retries=2)
    eng.put([0], [list(PROMPTS[0])], _greedy=True)
    orig = eng._dispatch_step

    def broken(plan):
        raise OSError("gone")
    eng._dispatch_step = broken
    with pytest.raises(ServeStepError):
        eng.put([1], [list(PROMPTS[1])], _greedy=True)
    assert eng.pipeline_stats["retries"] == 3
    eng._dispatch_step = orig
    m = eng.drain()
    _assert_released(eng, m)
    toks = _finish(_engine(prefix=False), m)
    for u in toks:
        assert toks[u] == oracle[u][:len(toks[u])]
