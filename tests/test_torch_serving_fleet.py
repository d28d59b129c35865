"""Port parity for the serving fleet, on the CPU: the router, admission
control, the replica pool with elastic membership, and disaggregated
prefill -> decode serving with its KV handoff.

- The JAX package's router cases (``TestRouterPolicy``,
  ``TestMergeSourceScheme``), the loadgen-driven pool cases
  (``TestPoolSmoke``, ``TestRollupExactness``, ``TestElasticMembership``,
  and the slow ``TestFleetSlow`` with its fault drill), admission cases
  (``TestControlLaw``) and disaggregated-serving cases
  (``TestDisaggParity``, the fault cases with the slow subprocess drill,
  ``TestKillSwitchAndRoles``) run here on the port: compiled from their
  files with the imports pointed at the port and the engines built by
  the port (the tiny Llama, or the loadgen's tiny GPT-2, fp32, dense
  attention), the drills' workers on the CPU.
- For the same seed and inputs the port's router picks the replica the
  JAX router picks, and its admission controller makes the same level
  transitions with the same ``retry_after_s``.
- A two-replica JAX pool and port pool give the same uid -> replica map
  and the same streams, through an elastic drain-and-absorb too, and so
  does the disaggregated pool over an fp32 and an int8 pool.
- Handoff manifests are equal field for field but for time stamps, and
  their KV equals the JAX manifest's within 1e-5 once laid out alike.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.serving import ReplicaPool as JaxPool
from deepspeed_tpu.serving.admission import \
    AdmissionController as JaxAdmission
from deepspeed_tpu.serving.router import Router as JaxRouter
from deepspeed_tpu_torch.serving import (ReplicaPool, build_admission,
                                         build_replica_engines)
from deepspeed_tpu_torch.serving.admission import AdmissionController
from deepspeed_tpu_torch.resilience import faultdrill
from deepspeed_tpu_torch.serving.router import Router
from deepspeed_tpu_torch.telemetry import loadgen
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry
from torch_port_cases import jax_engine, port_cases, port_engine

#: the JAX disaggregated-serving tests' engine configuration
DISAGG = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=96,
              max_blocks_per_seq=24, dtype="float32",
              attention_impl="dense", decode_loop_steps=0,
              serve_pipeline_depth=2, prefix_cache=True)


def _engine(**kw):
    return port_engine(DISAGG, **kw)


def _tiny_engine(**kw):
    """The loadgen's tiny GPT-2 engine, on the CPU."""
    return loadgen._tiny_engine(device="cpu", **kw)


@pytest.fixture(autouse=True)
def _drills_on_the_cpu(monkeypatch):
    """The fault drills' workers build their engines on the CPU."""
    monkeypatch.setitem(faultdrill._DEVICE, "name", "cpu")


(TestRouterPolicy, TestMergeSourceScheme, TestPoolSmoke,
 TestRollupExactness, TestElasticMembership, TestFleetSlow,
 smoke_pool) = port_cases(
    "tests/unit/test_serving_fleet.py",
    ("TestRouterPolicy", "TestMergeSourceScheme", "TestPoolSmoke",
     "TestRollupExactness", "TestElasticMembership", "TestFleetSlow",
     "smoke_pool"),
    ("serving", "telemetry.registry", "telemetry.loadgen",
     "resilience.faultdrill"),
    overrides={"_tiny_engine": _tiny_engine})
(TestControlLaw,) = port_cases(
    "tests/unit/test_admission.py", ("TestControlLaw",),
    ("serving.admission", "telemetry.registry"))
(TestDisaggParity, TestDisaggFaults, TestKillSwitchAndRoles,
 greedy_oracle) = port_cases(
    "tests/unit/test_serving_disagg.py",
    ("TestDisaggParity", "TestDisaggFaults", "TestKillSwitchAndRoles",
     "greedy_oracle"),
    ("serving", "inference.v2", "resilience.fault_injection",
     "resilience.faultdrill"),
    overrides={"_engine": _engine})


# ------------------------------------------------------------------ #
# router and admission: the same decisions as the JAX package's
# ------------------------------------------------------------------ #


class _Fake:
    def __init__(self, rid, dev, host, queue, headroom, available):
        self.replica_id = rid
        self._dev, self._host = dev, host
        self._queue, self._headroom = queue, headroom
        self.available = available

    def prefix_overlap(self, tokens):
        return self._dev + self._host

    def prefix_overlap_tiered(self, tokens):
        return self._dev, self._host

    def queue_frac(self):
        return self._queue

    def slo_headroom(self, slo):
        return self._headroom


@pytest.mark.parametrize("policy", ["prefix_aware", "round_robin",
                                    "random"])
def test_router_picks_as_jax(policy):
    rng = np.random.default_rng(11)
    jr = JaxRouter(policy=policy, seed=5, slo_ttft_s=0.2)
    tr = Router(policy=policy, seed=5, slo_ttft_s=0.2)
    for _ in range(200):
        reps = [_Fake(f"r{i}", int(rng.integers(0, 3)) * 16,
                      int(rng.integers(0, 2)) * 16,
                      float(rng.choice([0.0, 0.25, 0.5, 1.0])),
                      float(rng.uniform(-1, 1)), bool(rng.uniform() > 0.1))
                for i in range(4)]
        if not any(r.available for r in reps):
            reps[0].available = True
        prompt = rng.integers(1, 96, 32).tolist()
        jx, tx = {}, {}
        assert tr.select(reps, prompt, explain=tx).replica_id == \
            jr.select(reps, prompt, explain=jx).replica_id
        assert tx == jx
    assert tr.describe() == jr.describe()


class _FakeEngine:
    """The attributes the controller reads and actuates."""

    def __init__(self, registry_cls):
        self.config = type("C", (), {"max_seqs": 8, "chunk_size": 16,
                                     "prefill_chunk_cap": 16})()
        self.state = type("S", (), {"promote_defer_ticks": 1})()
        self.spec_mode, self.spec_k = "ngram", 4
        self.metrics = registry_cls("adm")
        self.rejections = {}

    def _reject(self, uid, reason, **fields):
        self.rejections[uid] = {"uid": uid, "reason": reason,
                                "retry_after_s": fields.pop(
                                    "retry_after_s", None), **fields}


def test_admission_transitions_and_retry_as_jax():
    from deepspeed_tpu.telemetry.registry import \
        MetricsRegistry as JaxRegistry
    kw = dict(window_s=1.0, qw_slo_s=0.1, tick_s=0.1, hysteresis_s=0.5)
    je, te = _FakeEngine(JaxRegistry), _FakeEngine(MetricsRegistry)
    jc, tc = JaxAdmission(je, **kw), AdmissionController(te, **kw)
    rng = np.random.default_rng(2)
    now = 0.0
    trail = []
    for step in range(120):
        # overload for a while, then health: the ladder climbs and falls
        v = float(rng.uniform(0.2, 0.6)) if 20 <= step < 60 \
            else float(rng.uniform(0.001, 0.02))
        for eng in (je, te):
            for _ in range(4):
                eng.metrics.histogram("serve_queue_wait_s").observe(v)
        now += 0.11
        jc.poll(now=now)
        tc.poll(now=now)
        assert tc.state() == jc.state(), step
        assert tc.retry_after_s() == jc.retry_after_s()
        assert tc.door(live=step % 10) == jc.door(live=step % 10)
        assert (te.spec_mode, te.spec_k, te.config.prefill_chunk_cap,
                te.state.promote_defer_ticks) == (
            je.spec_mode, je.spec_k, je.config.prefill_chunk_cap,
            je.state.promote_defer_ticks)
        trail.append(tc.level)
        if step % 7 == 0:
            assert tc.reject(step) == {**jc.reject(step)}
    assert max(trail) >= 2 and trail[-1] < max(trail)
    assert tc.transitions == jc.transitions > 0


def test_admission_rejection_carries_retry_after_on_the_engine():
    eng = _engine()
    eng._reject(5, "deadline_exceeded", deadline_s=0.1)
    rec = eng.rejections[5]
    assert rec["retry_after_s"] is None and rec["deadline_s"] == 0.1
    ctrl = build_admission(eng, tick_s=0.1)
    assert ctrl is not None
    rec = ctrl.reject(7)
    assert rec["reason"] == "admission_overload"
    assert rec["retry_after_s"] > 0
    assert rec["retry_after_s"] == round(ctrl.retry_after_s(), 4)
    assert eng.metrics.counter(
        "serve_requests_rejected_admission").value == 1
    assert eng.slo_report()["requests"]["rejected_admission"] == 1


def test_admission_off_builds_none(monkeypatch):
    monkeypatch.setenv("DSTPU_ADMISSION", "0")
    assert build_admission(_engine()) is None


# ------------------------------------------------------------------ #
# the pool: the JAX pool's placements and streams
# ------------------------------------------------------------------ #

GEN = 6
_rng = np.random.default_rng(21)
_SHARED = [_rng.integers(1, 96, 16).tolist() for _ in range(2)]
PROMPTS = {u: _SHARED[u % 2] + _rng.integers(1, 96, 6).tolist()
           for u in range(6)}


def _drive(pool, prompts, gen=GEN, drain_at=None, one_by_one=True):
    """Admit (one request a put, so that placements see the caches the
    previous ones filled), then decode in rounds of 2; ``drain_at``
    drains replica r0 before that round. Returns (streams, owners after
    admission, final owners)."""
    toks, placed = {}, {}
    batches = [[u] for u in prompts] if one_by_one else [list(prompts)]
    for b in batches:
        out = pool.put(b, [prompts[u] for u in b], _greedy=True)
        for u in b:
            toks[u] = [int(out[u])]
            placed[u] = pool.owner_of(u).replica_id
    rounds = 0
    while True:
        live = [u for u in toks if len(toks[u]) < gen
                and u in pool.state.sequences]
        if not live:
            break
        if rounds == drain_at:
            pool.replica("r0").engine.request_drain()
        outs = pool.decode_pipelined(live, [toks[u][-1] for u in live], 2)
        for u in live:
            toks[u].extend(outs[u][:gen - len(toks[u])])
        rounds += 1
    owners = {u: pool.owner_of(u).replica_id for u in toks
              if pool.owner_of(u) is not None}
    for u in toks:
        pool.flush(u)
    return toks, placed, owners


def _pools(n=2, roles=None, **kw):
    jp = JaxPool([jax_engine(DISAGG, **kw) for _ in range(n)],
                 policy="prefix_aware", seed=0, roles=roles)
    tp = ReplicaPool(build_replica_engines(
        lambda i, dev: port_engine(DISAGG, **kw), n, devices=["cpu"]),
        policy="prefix_aware", seed=0, roles=roles)
    return jp, tp


@pytest.fixture(scope="module")
def oracle():
    return _drive(ReplicaPool([_engine()], seed=0), PROMPTS)[0]


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    """One two-replica pool of each package driven through the same
    calls, replica r0 drained before the second decode round: the
    placements at admission are the routers' decisions, the streams and
    owners the absorb's outcome."""
    from deepspeed_tpu_torch.resilience import RestartLedger
    jp, tp = _pools()
    tp._ledger = RestartLedger(
        str(tmp_path_factory.mktemp("fleet") / "ledger.json"))
    return _drive(jp, PROMPTS, drain_at=1), _drive(tp, PROMPTS,
                                                   drain_at=1), tp


def test_pool_routes_and_streams_as_jax(oracle, elastic_runs):
    (jt, jplaced, _), (tt, tplaced, _), tp = elastic_runs
    assert tt == jt == oracle
    assert tplaced == jplaced
    # each preamble group landed on one replica, and both replicas hit
    for g in (0, 1):
        assert len({tplaced[u] for u in PROMPTS if u % 2 == g}) == 1
    assert set(tplaced.values()) == {"r0", "r1"}
    live = [r for r in tp.replicas() if r.state != "dead"]
    snap = tp.fleet_snapshot()
    for name, h in snap["histograms"].items():
        assert h["count"] == sum(
            r.engine.metrics.snapshot()["histograms"].get(
                name, {"count": 0})["count"] for r in live), name


def test_elastic_absorb_as_jax(oracle, elastic_runs):
    (jt, _, jowners), (tt, _, towners), tp = elastic_runs
    assert tt == jt == oracle
    assert towners == jowners and set(towners.values()) == {"r1"}
    man = tp.replica("r0").manifest
    assert man["pool"]["fully_recovered"]
    assert man["telemetry"]["requests"]["drained"] == len(man["sequences"])
    events = [e["event"] for e in tp._ledger.events]
    assert events == ["fleet_drain", "fleet_replay"]


def _jax_layout(kv, L, bs):
    """A port handoff payload (block-major: rows [n, L, 2, bs, KV*D],
    scales [n, L, 2, KV, bs]) in the JAX layout (rows [L, 2, n*bs, KV*D],
    scales [L, 2, KV, n*bs])."""
    if isinstance(kv, tuple):
        rows, scales = kv
        n = rows.shape[0]
        return (rows.permute(1, 2, 0, 3, 4).reshape(L, 2, n * bs, -1),
                scales.permute(1, 2, 3, 0, 4).reshape(L, 2, -1, n * bs))
    n = kv.shape[0]
    return kv.permute(1, 2, 0, 3, 4).reshape(L, 2, n * bs, -1)


def _record(engine, name, into):
    """Wrap ``engine.<name>`` to append its manifest argument / result."""
    fn = getattr(engine, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        into.append(out if name == "handoff_out" else (a[0], out))
        return out
    setattr(engine, name, wrapped)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_disagg_pool_and_handoff_as_jax(oracle, kv):
    """Prefill -> decode pools of both packages: the same streams and
    owners; handoff manifests equal field for field but for time stamps,
    their KV within 1e-5 of the JAX payload once laid out alike; every
    block handed off arrives bit-exact (gathered again at the
    destination)."""
    kw = {} if kv == "float32" else {"kv_cache_dtype": "int8"}
    want = oracle if kv == "float32" else _drive(
        ReplicaPool([_engine(**kw)], seed=0), PROMPTS)[0]
    jp, tp = _pools(roles=["prefill", "decode"], **kw)
    jouts, touts, tins = [], [], []
    _record(jp.replicas()[0].engine, "handoff_out", jouts)
    _record(tp.replicas()[0].engine, "handoff_out", touts)
    dec = tp.replicas()[1].engine
    adopted = []
    fn = dec.handoff_in

    def adopt(manifest, exposed_s=0.0):
        res = fn(manifest, exposed_s=exposed_s)
        for rec in manifest["sequences"]:
            seq = dec.state.get(int(rec["uid"]))
            adopted.append((rec["kv"], dec.kv_cache.gather_blocks(
                seq.kv_blocks)))
        return res
    dec.handoff_in = adopt
    jt, jplaced, jowners = _drive(jp, PROMPTS, one_by_one=False)
    tt, tplaced, towners = _drive(tp, PROMPTS, one_by_one=False)
    assert tt == jt == want
    assert towners == jowners and set(towners.values()) == {"r1"}
    pre_m, dec_m = (r.engine.metrics for r in tp.replicas())
    jpre_m = jp.replicas()[0].engine.metrics
    for c in ("serve_handoff_seqs", "serve_handoff_blocks",
              "serve_handoff_bytes"):
        assert pre_m.counter(c).value == jpre_m.counter(c).value > 0, c
    assert dec_m.counter("serve_handoff_seqs_in").value == len(PROMPTS)
    assert dec_m.histogram("serve_handoff_exposed_s").count == 1
    # the manifests, field for field
    assert len(touts) == len(jouts) == 1
    tm, jm = touts[0], jouts[0]
    assert set(tm) == set(jm)
    assert {k: tm[k] for k in tm if k not in ("time", "sequences")} == \
        {k: jm[k] for k in jm if k not in ("time", "sequences")}
    L = tp.replicas()[0].engine.runner.num_layers
    assert len(tm["sequences"]) == len(jm["sequences"]) == len(PROMPTS)
    for jr, tr in zip(jm["sequences"], tm["sequences"]):
        assert set(tr) == set(jr)
        for k in tr:
            if k not in ("kv", "stamps"):
                assert tr[k] == jr[k], k
        assert len(tr["stamps"]) == len(jr["stamps"]) == 4
        got = _jax_layout(tr["kv"], L, DISAGG["block_size"])
        ref = jr["kv"]
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert str(g.dtype).split(".")[-1] == str(r.dtype)
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(r, np.float32),
                                       rtol=0, atol=1e-5)
    # bit-exact at the destination, scales with the rows
    assert len(adopted) == len(PROMPTS)
    for sent, (rows, scales) in adopted:
        sent = sent if isinstance(sent, tuple) else (sent, None)
        assert torch.equal(rows, sent[0])
        assert (scales is None) == (sent[1] is None)
        assert scales is None or torch.equal(scales, sent[1])
    for r in tp.replicas():
        assert r.engine.free_blocks == r.engine.config.num_blocks


def test_replica_builder_and_multi_card_refusals():
    engines = build_replica_engines(lambda i, dev: (i, dev), 3,
                                    devices=["cpu", "cpu"])
    assert [(i, d.type) for i, d in engines] == [(0, "cpu"), (1, "cpu"),
                                                 (2, "cpu")]
    with pytest.raises(NotImplementedError, match="A8"):
        build_replica_engines(lambda i, d: None, 2, devices=["cpu"],
                              devices_per_replica=[2, 1])
    with pytest.raises(NotImplementedError, match="A8"):
        ReplicaPool([_engine()], role_mesh={"prefill": 2})
