"""Port parity for serve-side resilience, on the CPU: fault injection,
the step watchdog, preemption and the restart ledger.

- The JAX package's ``TestFaultInjector``, ``TestStepWatchdog`` and
  ``TestRestartLedger`` cases (``tests/unit/test_resilience.py``) run on
  the port's modules, but for the two that need what is not ported: the
  watchdog naming the last collective (collectives are A8; the port's
  diagnosis names none, checked here) and the training engine's watchdog
  (``tests/test_torch_train_resilience.py``). The fault-site tuples are
  the JAX ones.
- The JAX serve kill-point model (``TestKillPointModel``,
  ``tests/unit/test_serve_drain.py``) runs on port engines (the tiny
  Llama, fp32): an injected fault at a serve site, then drain and replay,
  gives the uninterrupted stream with every block back; each serve site
  fires on the port engine at every pipeline depth the test uses.
- A real SIGTERM through ``PreemptionHandler`` mid-decode unwinds the
  pipeline; drain and replay give the uninterrupted stream.
- ``drain(ledger=)`` writes the JAX engine's ledger lines, and the drain
  manifest's ``trace`` fields and telemetry report equal the JAX
  engine's but for time stamps and latencies.
"""

import json
import os
import signal
import time

import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import drain as jdrain
from deepspeed_tpu.resilience import fault_injection as jfi
from deepspeed_tpu.resilience.ledger import RestartLedger as JaxLedger
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              load_manifest)
from deepspeed_tpu_torch.resilience import (DISAGG_FAULT_SITE, FAULT_SITES,
                                            SERVE_FAULT_SITES,
                                            TRAIN_FAULT_SITES,
                                            FaultInjector, InjectedFault,
                                            PreemptionHandler,
                                            RestartLedger, StepWatchdog,
                                            set_fault_injector)
from torch_port_cases import jax_engine, port_cases, port_engine, \
    tiny_llama

#: the JAX serve-drain tests' engine configuration
BASE = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
            max_blocks_per_seq=16, dtype="float32", attention_impl="dense",
            decode_loop_steps=0, serve_pipeline_depth=2, prefix_cache=True)


def _port_engine_cls(mcfg, params, cfg):
    """The JAX test file's ``InferenceEngineV2(mcfg, params, cfg)`` on
    the port, on the CPU."""
    return InferenceEngineV2(mcfg, params, cfg, device="cpu")


(TestFaultInjector, TestStepWatchdog, TestRestartLedger,
 _clean_injector) = port_cases(
    "tests/unit/test_resilience.py",
    ("TestFaultInjector", "TestStepWatchdog", "TestRestartLedger",
     "_clean_injector"),
    ("resilience",))
# the collective a stall names is A8 (port version below); the training
# engine's watchdog is held in test_torch_train_resilience.py
del TestStepWatchdog.test_stall_diagnosis_names_last_collective
del TestStepWatchdog.test_engine_wires_watchdog_from_config
(TestKillPointModel, oracle, _serve, _cfg, _assert_released,
 _replay_and_finish) = port_cases(
    "tests/unit/test_serve_drain.py",
    ("TestKillPointModel", "oracle", "_serve", "_cfg", "_assert_released",
     "_replay_and_finish"),
    ("inference.v2", "resilience"),
    overrides={"_gpt2": lambda: tiny_llama()[2:],
               "InferenceEngineV2": _port_engine_cls})
# the grid of every site x depth x cache rides the JAX slow tier; the
# parametrized sweep below covers every site here
del TestKillPointModel.test_kill_grid


def test_site_tuples_equal_jax():
    assert FAULT_SITES == jfi.FAULT_SITES
    assert SERVE_FAULT_SITES == jfi.SERVE_FAULT_SITES
    assert TRAIN_FAULT_SITES == jfi.TRAIN_FAULT_SITES
    assert DISAGG_FAULT_SITE == jfi.DISAGG_FAULT_SITE


def test_stall_diagnosis_names_no_collective(tmp_path, monkeypatch):
    """The JAX stall case, on the port: the phase is named, the
    collective is not (A8), and the flight rings are dumped."""
    monkeypatch.setenv("DSTPU_FLIGHT_DIR", str(tmp_path))
    seen = []
    wd = StepWatchdog(check_interval_s=3600, min_median_samples=2,
                      min_stall_s=0.01, stall_factor=2.0,
                      on_stall=seen.append)
    try:
        for i in range(3):
            wd.step_start(i)
            wd.step_end(i)
        wd.step_start(3)
        wd.phase("commit")
        time.sleep(0.05)
        diag = wd.check_once()
        assert diag is not None and diag["step"] == 3
        assert diag["last_phase"] == "commit"
        assert diag["last_collective"] is None
        assert wd.check_once() is None
        assert seen == [diag]
        assert wd.abort_exit_code == 99
    finally:
        wd.stop()


def test_engine_watchdog_brackets_steps():
    eng = port_engine(BASE)
    phases = []
    wd = StepWatchdog(check_interval_s=3600)
    orig = wd.phase

    def note(name):
        phases.append(name)
        orig(name)
    wd.phase = note
    eng.attach_watchdog(wd)
    try:
        r = eng.put([0], [list(range(1, 15))], _greedy=True)
        eng.decode_pipelined([0], [r[0]], 4)
        assert len(wd._durations) > 0 and wd._step is None
        assert {"plan", "dispatch", "commit"} <= set(phases)
    finally:
        wd.stop()


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("site", SERVE_FAULT_SITES)
def test_every_serve_site_fires_then_replays(oracle, site, depth):
    """Each serve fault site fires on the port engine (the cache is on,
    so ``during_cow_copy`` is reached); drain and replay give the
    uninterrupted stream with every block back."""
    eng = _port_engine_cls(*tiny_llama()[2:], _cfg(True, depth))
    inj = FaultInjector(site=site, mode="raise", skip=1)
    set_fault_injector(inj)
    try:
        with pytest.raises(InjectedFault):
            _serve(eng)
    finally:
        set_fault_injector(None)
    assert inj._fired == 1
    m = eng.drain()
    _assert_released(eng, m)
    assert m["sequences"]
    _, toks = _replay_and_finish(m, _cfg(True, depth))
    assert toks == {u: oracle[u] for u in toks}


def test_sigterm_preemption_drain_and_replay(oracle, tmp_path):
    """A real SIGTERM mid-decode: the handler sets the flag, the serve
    loop unwinds, the drain releases everything and its manifest replays
    to the uninterrupted stream; the ledger records the drain."""
    eng = port_engine(BASE)
    handler = PreemptionHandler()
    # installed (the test runs on the main thread), or the signal below
    # would end the process
    assert handler._installed
    eng.attach_preemption(handler)
    orig, n = eng._dispatch_step, [0]

    def dispatch(plan):
        n[0] += 1
        if n[0] == 6:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(plan)
    eng._dispatch_step = dispatch
    try:
        _serve(eng)
        assert handler.preempted
        assert handler.signal_received == signal.SIGTERM
    finally:
        handler.uninstall()
    led = RestartLedger(str(tmp_path / "ledger.json"))
    m = eng.drain(str(tmp_path / "m.json"), ledger=led)
    assert m["pool"]["fully_recovered"] and m["sequences"]
    assert m["telemetry"]["requests"]["drained"] == len(m["sequences"])
    eng2 = port_engine(BASE)
    out = eng2.replay(load_manifest(m["path"]))
    toks = {int(s["uid"]): list(s["generated"]) for s in m["sequences"]}
    for u in toks:
        toks[u].append(int(out[u]))
    while True:
        short = [u for u in toks if len(toks[u]) < 8]
        if not short:
            break
        outs = eng2.decode_pipelined(short, [toks[u][-1] for u in short],
                                     [8 - len(toks[u]) for u in short])
        for u in short:
            toks[u].extend(outs[u])
    assert toks == {u: oracle[u] for u in toks}
    assert json.loads(open(tmp_path / "ledger.json").read())["events"][0][
        "event"] == "serve_drain"


def _untimed_telemetry(tel):
    tel = dict(tel)
    for k in ("ttft_s", "tpot_s", "queue_wait_s"):
        tel[k] = {"count": tel[k]["count"]}
    return tel


def test_drain_ledger_trace_and_telemetry_equal_jax(tmp_path):
    """The same traced run drained by both engines: the same ledger
    records, the same manifest ``trace`` fields, the same telemetry
    report but for latencies; the port's manifest replays on the JAX
    engine with the traces intact."""
    recs = {}
    for name, make, ledger_cls in (("jax", jax_engine, JaxLedger),
                                   ("port", port_engine, RestartLedger)):
        eng = make(BASE)
        rng = np.random.default_rng(9)
        prompts = [rng.integers(1, 96, 12).tolist() for _ in range(3)]
        traces = {u: f"fleet/{u}#{u + 1}" for u in range(3)}
        first = eng.put([0, 1, 2], prompts, _greedy=True, traces=traces)
        eng.decode_pipelined([0, 1, 2], [first[u] for u in range(3)], 3)
        eng.flush(2)
        led = ledger_cls(str(tmp_path / f"{name}.json"))
        m = eng.drain(str(tmp_path / f"{name}_m.json"), ledger=led)
        recs[name] = (m, led.events)
    (jm, jev), (tm, tev) = recs["jax"], recs["port"]
    assert [s["trace"] for s in tm["sequences"]] == \
        [s["trace"] for s in jm["sequences"]] == ["fleet/0#1", "fleet/1#2"]
    assert _untimed_telemetry(tm["telemetry"]) == \
        _untimed_telemetry(jm["telemetry"])
    strip = ("time", "manifest")
    assert [{k: v for k, v in e.items() if k not in strip} for e in tev] \
        == [{k: v for k, v in e.items() if k not in strip} for e in jev]
    assert tev[0]["manifest"].endswith("port_m.json")
    # the port's manifest on the JAX engine: traces ride the replay
    jeng = jax_engine(BASE)
    jeng.replay(jdrain.load_manifest(str(tmp_path / "port_m.json")))
    assert [jeng.state.get(u).trace_id for u in (0, 1)] == \
        ["fleet/0#1", "fleet/1#2"]


def test_flight_dump_on_injected_fault(tmp_path, monkeypatch):
    """The injector dumps every live flight ring before it fires: the
    dump holds the port engine's phases."""
    monkeypatch.setenv("DSTPU_FLIGHT_DIR", str(tmp_path))
    eng = port_engine(BASE)
    set_fault_injector(FaultInjector(site="mid_commit", mode="raise",
                                     skip=2))
    try:
        with pytest.raises(InjectedFault):
            _serve(eng)
    finally:
        set_fault_injector(None)
    dumps = [f for f in os.listdir(tmp_path)
             if f.startswith("flight_fault_mid_commit")]
    assert dumps
    ev = json.loads(open(tmp_path / dumps[0]).read())["traceEvents"]
    assert {"plan", "dispatch", "commit"} <= {e["name"] for e in ev}
