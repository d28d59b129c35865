"""Port parity for the open-loop load generator, on the CPU.

- The JAX package's loadgen cases (``TestArrivalDeterminism``,
  ``TestOpenLoop``, ``TestAdmissionHooks``) and admission cases
  (``TestRejectionBackCompat``, ``TestRetryDiscipline``, and the slow
  ``TestSpikeGate``) run here on the port: compiled from their files
  with the imports pointed at the port and ``_tiny_engine`` building the
  port's engine on the CPU. The cases that count XLA compiles
  (``test_warm_loadgen_pass_is_compile_free``, the compile half of
  ``test_spike_on_vs_off_parity_and_compiles``) hold the port's warm-path
  invariant instead: a warm pass allocates no staging set
  (``StagingTripwire``).
- The same (process, mix, n, seed) gives the JAX package's schedule and
  requests bit for bit, for every arrival process and mix preset.
- At a sustainable rate the JAX tiny engine under the JAX loadgen and the
  port's under the port's loadgen, on the same weights, give identical
  streams for each uid, equal outcome counts and the same report keys
  (timing fields aside).
- The CLI (``python -m deepspeed_tpu_torch.telemetry.loadgen``) runs on
  ``--device cpu``; without a card its default raises; ``--seq`` /
  ``--ep`` and ``--mix moe_decode_heavy`` name their queue items.
"""

import functools
import json

import jax
import numpy as np
import pytest

from deepspeed_tpu.telemetry import loadgen as jlg
from deepspeed_tpu_torch.checkpoint import gpt2_params_from_numpy
from deepspeed_tpu_torch.telemetry import loadgen as tlg
from torch_port_cases import StagingTripwire, port_cases

_cpu_tiny = functools.partial(tlg._tiny_engine, device="cpu")
_TRIPWIRE = ("from deepspeed_tpu.analysis import RecompileTripwire",
             "from torch_port_cases import StagingTripwire as "
             "RecompileTripwire")


@pytest.fixture(autouse=True, scope="module")
def _tiny_engines_on_the_cpu():
    """The JAX cases import ``_tiny_engine`` inside their bodies: the
    port's builds on the card unless asked, so point it at the CPU. Its
    ops are a few hundred elements: one intra-op thread runs them faster
    than a pool that the test workers' pools contend with, and the
    open-loop cases read the wall clock."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tlg, "_tiny_engine", _cpu_tiny)
            yield
    finally:
        torch.set_num_threads(threads)


(TestArrivalDeterminism, TestOpenLoop, TestAdmissionHooks,
 eng) = port_cases(
    "tests/unit/test_loadgen.py",
    ("TestArrivalDeterminism", "TestOpenLoop", "TestAdmissionHooks", "eng"),
    ("telemetry.loadgen",), overrides={"_tiny_engine": _cpu_tiny},
    subs=(_TRIPWIRE,))
(TestRejectionBackCompat, TestRetryDiscipline, TestSpikeGate,
 tiny_engine) = port_cases(
    "tests/unit/test_admission.py",
    ("TestRejectionBackCompat", "TestRetryDiscipline", "TestSpikeGate",
     "tiny_engine"),
    ("serving.admission", "telemetry.registry", "telemetry.loadgen"),
    subs=(_TRIPWIRE,))


def test_warm_pass_tripwire_sees_a_fresh_shape(eng):
    """The tripwire counts: a step shape the warm engine has not run
    (a chunk size it never planned) allocates one staging set."""
    with StagingTripwire() as tw:
        eng._staging_bufs(eng.config.max_seqs, 3)
    assert tw.fresh_compiles == 1
    del eng._staging[(eng.config.max_seqs, 3)]


# ------------------------------------------------------------------ #
# schedules and requests: the JAX package's, bit for bit
# ------------------------------------------------------------------ #

def _procs(pkg):
    return {
        "poisson": pkg.PoissonArrivals(37.5, seed=4),
        "uniform": pkg.UniformArrivals(12.0),
        "spike": pkg.SpikeArrivals(5.0, 3.5, 0.7, 1.3, seed=9),
        "trace": pkg.TraceArrivals(
            list(np.random.default_rng(2).uniform(0, 9, 300)),
            time_scale=0.75),
    }


def _mixes(pkg):
    pool = [list(range(1, 1 + n)) for n in (5, 9, 13)]
    return {
        "default": pkg.WorkloadMix(),
        "shared_deadlines": pkg.WorkloadMix(
            prompt_lens=(8, 16, 40), prompt_probs=(0.2, 0.5, 0.3),
            gen_lens=(4, 9), gen_probs=(0.6, 0.4), shared_prefix_frac=0.5,
            shared_prefix_len=6, deadline_frac=0.4, deadline_s=2.5,
            vocab_size=96),
        "groups_batch": pkg.WorkloadMix(
            prompt_lens=(24,), prompt_probs=(1.0,), gen_lens=(6,),
            gen_probs=(1.0,), shared_prefix_frac=0.8, shared_prefix_len=16,
            prefix_group_count=3, batch_frac=0.3, vocab_size=96),
        "working_set": pkg.WorkloadMix(
            prompt_lens=(40, 56), prompt_probs=(0.5, 0.5), gen_lens=(8,),
            gen_probs=(1.0,), shared_prefix_len=32,
            prefix_working_set_blocks=20, vocab_size=96),
        "pool": pkg.WorkloadMix(prompt_pool=pool, gen_lens=(3, 5),
                                gen_probs=(0.5, 0.5)),
        "prefill_heavy": pkg.WorkloadMix.prefill_heavy(
            vocab_size=96, deadline_frac=1.0, deadline_s=4.0),
        "long_context": pkg.WorkloadMix.long_context(
            pool_span_tokens=512, vocab_size=96, batch_frac=0.5),
        "moe_decode_heavy": pkg.WorkloadMix.moe_decode_heavy(vocab_size=96),
    }


@pytest.mark.parametrize("proc", ["poisson", "uniform", "spike", "trace"])
def test_schedules_equal_jax(proc):
    for n in (1, 17, 250):
        a = _procs(jlg)[proc].schedule(n)
        b = _procs(tlg)[proc].schedule(n)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert _procs(tlg)[proc].describe() == _procs(jlg)[proc].describe()


def _fields(reqs):
    return [(r.uid, r.arrival_s, r.prompt, r.gen_len, r.deadline_s,
             r.group, r.klass) for r in reqs]


@pytest.mark.parametrize("mix", ["default", "shared_deadlines",
                                 "groups_batch", "working_set", "pool",
                                 "prefill_heavy", "long_context",
                                 "moe_decode_heavy"])
@pytest.mark.parametrize("proc", ["poisson", "spike"])
def test_requests_equal_jax(mix, proc):
    for n, seed, base in ((64, 0, 0), (40, 13, 1_000_000)):
        want = jlg.build_requests(_procs(jlg)[proc], _mixes(jlg)[mix], n,
                                  seed=seed, uid_base=base)
        got = tlg.build_requests(_procs(tlg)[proc], _mixes(tlg)[mix], n,
                                 seed=seed, uid_base=base)
        assert _fields(got) == _fields(want)
    assert _mixes(tlg)[mix].describe() == _mixes(jlg)[mix].describe()


def test_mix_refusals_equal_jax():
    for pkg in (jlg, tlg):
        with pytest.raises(ValueError, match="shared_prefix_len"):
            pkg.build_requests(pkg.UniformArrivals(1.0), pkg.WorkloadMix(
                prefix_working_set_blocks=4), 3)
        with pytest.raises(ValueError, match="exceed"):
            pkg.build_requests(pkg.UniformArrivals(1.0), pkg.WorkloadMix(
                prompt_lens=(8,), prompt_probs=(1.0,), shared_prefix_len=8,
                prefix_working_set_blocks=4), 3)
        with pytest.raises(ValueError):
            pkg.PoissonArrivals(0.0)
        with pytest.raises(ValueError):
            pkg.SpikeArrivals(1.0, 2.0, -1.0, 1.0)
        with pytest.raises(ValueError, match="sweep_capacity"):
            pkg.sweep_capacity(None, [1.0], 1, pkg.WorkloadMix(),
                               process="trace")


# ------------------------------------------------------------------ #
# the driver on both packages' engines, same weights
# ------------------------------------------------------------------ #

#: report fields that carry wall-clock readings (not compared)
_TIMED = {"rates_rps", "latency", "open_loop", "decode", "duration_s",
          "output_tokens_per_sec", "goodput_frac"}


@pytest.fixture(scope="module")
def engine_pair():
    """The JAX CLI engine and the port's on the JAX engine's weights,
    each warmed by one pass."""
    jeng, jmcfg = jlg._tiny_engine()
    tree = jax.tree.map(np.asarray, jeng.params)
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    import torch
    tcfg = GPT2Config(vocab_size=96, max_seq_len=256, num_layers=2,
                      num_heads=2, hidden_size=32, dtype=torch.float32)
    teng, tmcfg = _cpu_tiny(params=gpt2_params_from_numpy(
        tree, tcfg, device="cpu"))
    assert tmcfg == tcfg and tmcfg.vocab_size == jmcfg.vocab_size
    for pkg, e in ((jlg, jeng), (tlg, teng)):
        pkg.run_open_loop(e, pkg.build_requests(
            pkg.PoissonArrivals(200.0, seed=99), _pair_mix(pkg), 2,
            seed=99, uid_base=99_000_000), decode_burst=4)
    return jeng, teng


def _pair_mix(pkg, **kw):
    return pkg.WorkloadMix(prompt_lens=(12, 20), prompt_probs=(0.5, 0.5),
                           gen_lens=(4, 7), gen_probs=(0.5, 0.5),
                           shared_prefix_frac=0.5, shared_prefix_len=8,
                           vocab_size=96, **kw)


def test_open_loop_streams_and_outcomes_equal_jax(engine_pair):
    jeng, teng = engine_pair
    reports = []
    for pkg, e in ((jlg, jeng), (tlg, teng)):
        reqs = pkg.build_requests(pkg.PoissonArrivals(30.0, seed=21),
                                  _pair_mix(pkg), 10, seed=21,
                                  uid_base=21_000)
        res = pkg.run_open_loop(e, reqs, decode_burst=4)
        reports.append((res.report, res.streams))
    (jrep, jst), (trep, tst) = reports
    assert tst == jst and len(tst) == 10
    assert all(len(s) in (4, 7) for s in tst.values())
    assert trep["requests"] == jrep["requests"]
    assert trep["requests"]["completed"] == 10
    assert trep["requests"]["balance_ok"]
    assert set(trep) == set(jrep)
    assert {k: v for k, v in trep.items() if k not in _TIMED} == \
        {k: v for k, v in jrep.items() if k not in _TIMED}
    for k in ("rates_rps", "latency", "open_loop", "decode"):
        assert set(trep[k]) == set(jrep[k]), k
    for name, h in trep["latency"].items():
        assert h["count"] == jrep["latency"][name]["count"], name
    assert trep["latency_source"] == "registry_stamps"
    for e in (jeng, teng):
        assert not e.state.sequences


def test_sweep_curve_shape_equals_jax(engine_pair):
    """One sustainable rate through both packages' ``sweep_capacity``:
    the same curve keys and outcome counts, and the knee at that rate."""
    jeng, teng = engine_pair
    outs = [pkg.sweep_capacity(e, [20.0], 6, _pair_mix(
        pkg, deadline_frac=1.0, deadline_s=30.0), seed=3, decode_burst=4)
        for pkg, e in ((jlg, jeng), (tlg, teng))]
    (j, t) = outs
    assert set(t) == set(j)
    assert {k: t[k] for k in t if k != "curve" and "knee" not in k} == \
        {k: j[k] for k in j if k != "curve" and "knee" not in k}
    (jr,), (tr,) = j["curve"], t["curve"]
    assert set(tr) == set(jr)
    for k in ("offered_rps", "offered_realized_rps", "goodput_frac",
              "shed", "deadline_expired", "shed_late",
              "rejected_admission"):
        assert tr[k] == jr[k], k
    assert t["knee_rps"] == j["knee_rps"] == 20.0


# ------------------------------------------------------------------ #
# the CLI
# ------------------------------------------------------------------ #

def test_cli_runs_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "rep.json"
    assert tlg.main(["--device", "cpu", "--rate", "8", "--requests", "8",
                     "--out", str(out)]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep == json.loads(out.read_text())
    assert rep["requests"]["balance_ok"] is True
    assert rep["requests"]["completed"] == 8
    assert rep["arrival"] == {"process": "poisson", "rate_rps": 8.0,
                              "seed": 0}
    assert rep["slo_cumulative"]["goodput_frac"] == 1.0


def test_cli_sweep_and_fleet_on_the_cpu(capsys):
    assert tlg.main(["--device", "cpu", "--rate", "20,40", "--requests",
                     "4", "--gen-len", "4", "--replicas", "2", "--roles",
                     "prefill,decode"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["offered_rps"] for r in rep["curve"]] == [20.0, 40.0]
    assert rep["fleet"]["replicas"] == 2
    assert rep["disagg"]["handoffs"]["adopted"] == 8


def test_cli_refusals(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tlg.main(["--rate", "8", "--requests", "2"])
    for argv in (["--seq", "2"], ["--ep", "2"]):
        with pytest.raises(NotImplementedError, match="A8"):
            tlg.main(["--device", "cpu", *argv])
    with pytest.raises(NotImplementedError, match="A9"):
        tlg.main(["--device", "cpu", "--mix", "moe_decode_heavy"])
    with pytest.raises(NotImplementedError, match="A8"):
        tlg._tiny_moe_engine(ep=2, device="cpu")


def test_tiny_moe_engines_serve_on_the_cpu():
    """The MoE harness engine and its dense-matched reference (the
    engines ``--mix moe_decode_heavy`` drives) serve a decode-heavy pass."""
    for dense in (False, True):
        e, mcfg = tlg._tiny_moe_engine(dense_match=dense, device="cpu")
        assert mcfg.intermediate_size == (64 if dense else 32)
        reqs = tlg.build_requests(
            tlg.UniformArrivals(200.0),
            tlg.WorkloadMix.moe_decode_heavy(vocab_size=96), 3, seed=1)
        rep = tlg.run_open_loop(e, reqs, decode_burst=8).report
        assert rep["requests"]["completed"] == 3
        assert rep["requests"]["balance_ok"]
