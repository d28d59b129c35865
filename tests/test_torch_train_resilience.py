"""Port parity for the training engine's resilience, on the CPU: the
self-healing checkpoints, the async writer, the step fault site, the
watchdog and preemption wired from the config, and the elastic agent.

- The JAX package's cases (``tests/unit/test_resilience.py``
  ``TestSelfHealingCheckpoints``, ``TestEngineFaultSites``,
  ``TestPreemption``, ``TestElasticPreemptionEndToEnd``,
  ``TestStepWatchdog.test_engine_wires_watchdog_from_config``;
  ``tests/unit/test_elasticity.py`` ``TestBatchSolver``,
  ``TestImmutableConfig``, ``TestElasticAgent``) run on the port's
  modules, their engines the port's GPT-2 tiny (fp32) on the CPU; the
  SIGTERM end-to-end's worker is the port's.
- The async save (``tests/unit/test_checkpoint.py``
  ``test_async_checkpoint_engine``) and the in-place race: the engine's
  optimizer writes the params and moments in place, so a step run
  straight after an async save must not reach the file being written.
- ``compute_elastic_config`` equals the JAX package's on the JAX tests'
  inputs; an elastic config sizes the engine's batch on one card, and a
  world above 1 names A8."""

import json
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu.elasticity import compute_elastic_config as jax_elastic
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.checkpoint import (STATE_FILE, load_checkpoint,
                                            validate_checkpoint_dir)
from deepspeed_tpu_torch.checkpoint import engine_checkpoint as ec
from deepspeed_tpu_torch.elasticity import (ElasticityIncompatibleWorldSize,
                                            compute_elastic_config)
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from torch_port_cases import ROOT, port_cases

TINY = tgpt2.GPT2Config.tiny(dtype=torch.float32, attention_impl="xla")


def _make_model(_cfg=None):
    """The JAX cases' ``make_model(GPT2Config.tiny(...))`` on the port:
    GPT-2 tiny in fp32, ``init_fn(key, batch_size, seq_len)`` drawing
    seed 0 on the CPU."""
    model, init_fn, loss_fn = tgpt2.make_model(TINY)
    return model, (lambda *a, **k: init_fn(seed=0, device="cpu")), loss_fn


def _port_initialize(**kw):
    return initialize(device="cpu", **kw)


def _engine(lr=1e-2, **extra):
    _, init_fn, loss_fn = _make_model()
    engine, _, _, _ = initialize(
        loss_fn=loss_fn, params=init_fn(), device="cpu", config={
            "train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": lr}},
            "steps_per_print": 1000,
            "checkpoint": {"retry_backoff_s": 0.01}, **extra})
    return engine


def _batch(engine, seed=0):
    rng = np.random.RandomState(seed)
    B = engine.config.train_batch_size
    return {"tokens": torch.from_numpy(rng.randint(0, 512, size=(B, 18)))}


def _params_snapshot(engine):
    return [p.detach().clone().numpy() for p in engine.state.params]


def _opt_snapshot(engine):
    o = engine.state.opt_state
    return [np.asarray(o.count)] + [t.detach().clone().numpy()
                                    for t in o.mu + o.nu]


#: the JAX end-to-end worker on the port: GPT-2 tiny on the CPU under
#: preemption, resuming from WK_SAVE_DIR, SIGTERM to itself before step
#: WK_SELF_SIGTERM_STEP
WORKER_SCRIPT = r"""
import json, os, signal, sys
import numpy as np, torch
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, make_model

save_dir = os.environ["WK_SAVE_DIR"]
progress = os.environ["WK_PROGRESS_FILE"]
stop_at = int(os.environ.get("WK_STEPS", "6"))
sigterm_step = int(os.environ.get("WK_SELF_SIGTERM_STEP", "-1"))

cfg = GPT2Config.tiny(dtype=torch.float32, attention_impl="xla")
_, init_fn, loss_fn = make_model(cfg)
engine, _, _, _ = initialize(
    loss_fn=loss_fn, params=init_fn(seed=0, device="cpu"), device="cpu",
    config={
        "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
        "steps_per_print": 1000,
        "resilience": {"preemption": {"enabled": True,
                                      "save_dir": save_dir}},
    })
engine.load_checkpoint(save_dir)
while engine.global_steps < stop_at:
    rng = np.random.RandomState(engine.global_steps)
    batch = {"tokens": torch.from_numpy(
        rng.randint(0, 512, size=(engine.config.train_batch_size, 18)))}
    if engine.global_steps + 1 == sigterm_step:
        os.kill(os.getpid(), signal.SIGTERM)   # delivered before this step
    engine.train_batch(batch)                  # step boundary handles it
    with open(progress, "w") as f:
        json.dump({"global_steps": engine.global_steps}, f)
sys.exit(0)
"""

_OVERRIDES = {"_engine": _engine, "_batch": _batch, "make_model": _make_model,
              "_params_snapshot": _params_snapshot,
              "_opt_snapshot": _opt_snapshot,
              "_port_initialize": _port_initialize,
              "WORKER_SCRIPT": WORKER_SCRIPT}
_SUBS = (("dstpu.initialize(", "_port_initialize("),)

(TestSelfHealingCheckpoints, TestEngineFaultSites, TestPreemption,
 TestElasticPreemptionEndToEnd, TestStepWatchdog,
 _clean_injector) = port_cases(
    "tests/unit/test_resilience.py",
    ("TestSelfHealingCheckpoints", "TestEngineFaultSites", "TestPreemption",
     "TestElasticPreemptionEndToEnd", "TestStepWatchdog", "_clean_injector"),
    ("checkpoint", "resilience", "elasticity"), overrides=_OVERRIDES,
    subs=_SUBS)
# the rest of TestStepWatchdog runs in test_torch_serve_resilience.py
for _name in [n for n in vars(TestStepWatchdog) if n.startswith("test_")]:
    if _name != "test_engine_wires_watchdog_from_config":
        delattr(TestStepWatchdog, _name)

(TestBatchSolver, TestImmutableConfig, TestElasticAgent) = port_cases(
    "tests/unit/test_elasticity.py",
    ("TestBatchSolver", "TestImmutableConfig", "TestElasticAgent"),
    ("elasticity",))


# ------------------------------------------------------------- async

def _async_engine():
    return _engine(checkpoint={"async_save": True,
                               "retry_backoff_s": 0.01})


def test_async_checkpoint_engine(tmp_path):
    """The JAX case: an async save, training goes on, and a load from
    another engine flushes the write and restores the saved state (its
    eval loss)."""
    engine = _async_engine()
    engine.train_batch(_batch(engine))
    ref_loss = float(engine.eval_batch(_batch(engine, 5)))
    engine.save_checkpoint(str(tmp_path / "ck"))
    engine.train_batch(_batch(engine, 1))          # training continues

    e2 = _engine()
    e2.load_checkpoint(str(tmp_path / "ck"))       # flushes async write
    assert float(e2.eval_batch(_batch(e2, 5))) == \
        pytest.approx(ref_loss, rel=1e-5)


def test_async_save_is_not_raced_by_the_next_step(tmp_path, monkeypatch):
    """The writer thread is held until a step has run after the save: the
    file still holds the state at the save, leaf for leaf (the step wrote
    the live params and moments in place)."""
    import threading
    engine = _async_engine()
    engine.train_batch(_batch(engine))
    want = {p: v.copy() for p, v in
            ((p, ec._to_host(v, d)) for p, v, d in ec.state_leaves(engine))}
    gate = threading.Event()
    real = ec.save_state_tree

    def held(*a, **kw):
        assert gate.wait(30)
        return real(*a, **kw)

    monkeypatch.setattr("deepspeed_tpu_torch.checkpoint.checkpoint_engine."
                        "save_state_tree", held)
    engine.save_checkpoint(str(tmp_path))
    engine.train_batch(_batch(engine, 1))
    moved = [p for p, v, d in ec.state_leaves(engine)
             if not np.array_equal(ec._to_host(v, d), want[p])]
    assert len(moved) > len(want) // 2           # the step wrote in place
    gate.set()
    engine._ckpt_engine.commit()
    ok, reason = validate_checkpoint_dir(str(tmp_path / "global_step1"))
    assert ok, reason
    meta = json.loads((tmp_path / "global_step1" / "meta.json").read_text())
    with np.load(tmp_path / "global_step1" / STATE_FILE) as z:
        for i, p in enumerate(meta["paths"]):
            np.testing.assert_array_equal(z[f"leaf_{i:05d}"], want[p],
                                          err_msg=p)
    assert (tmp_path / "latest").read_text() == "global_step1"


def test_async_write_failure_raises_at_commit(tmp_path, monkeypatch):
    """A failed background write is not swallowed: it raises at the next
    ``commit`` (and so at the next ``save`` or ``load``)."""
    engine = _async_engine()
    engine.train_batch(_batch(engine))

    def dead(*a, **kw):
        raise OSError("disk on fire")

    monkeypatch.setattr(np, "savez", dead)
    engine.save_checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        load_checkpoint(_engine(), str(tmp_path))
    assert not (tmp_path / "latest").exists()


# ------------------------------------------------------------ elastic

ELASTIC_CASES = [  # (elasticity block, world size) from the JAX tests
    (dict(max_train_batch_size=2000, micro_batch_sizes=[2, 4, 6],
          min_gpus=1, max_gpus=10000, version=0.1), 0),
    (dict(max_train_batch_size=2000, micro_batch_sizes=[2, 4, 6],
          min_gpus=1, max_gpus=10000, version=0.1), 1),
    (dict(max_train_batch_size=2000, micro_batch_sizes=[2, 4, 6],
          min_gpus=1, max_gpus=10000, version=0.1), 8),
    (dict(max_train_batch_size=1024, micro_batch_sizes=[2, 4],
          min_gpus=8, max_gpus=64, version=0.2, num_gpus_per_node=8), 16),
    (dict(max_train_batch_size=2000, micro_batch_sizes=[2],
          min_gpus=1, max_gpus=8, version=0.1), 0),
]


@pytest.mark.parametrize("block,world", ELASTIC_CASES)
def test_compute_elastic_config_equals_jax(block, world):
    cfg = {"elasticity": dict(block, enabled=True)}
    want = jax_elastic(cfg, world_size=world, return_microbatch=True)
    assert compute_elastic_config(cfg, world_size=world,
                                  return_microbatch=True) == want


def test_elastic_config_sizes_the_batch_on_one_card():
    """``elasticity.enabled`` with ``train_batch_size: "auto"``: the batch
    is the JAX computation's at a world of 1 (micro x gas), and the engine
    trains on it; a fixed batch that disagrees raises."""
    from deepspeed_tpu_torch.config.config import ConfigError
    block = dict(max_train_batch_size=8, micro_batch_sizes=[2, 4],
                 min_gpus=1, max_gpus=8, version=0.1, enabled=True)
    engine = _engine(elasticity=block, train_batch_size="auto",
                     train_micro_batch_size_per_gpu="auto")
    tb, _, mb = jax_elastic({"elasticity": block}, world_size=1,
                            return_microbatch=True)
    c = engine.config
    assert (c.train_batch_size, c.train_micro_batch_size_per_gpu,
            c.gradient_accumulation_steps) == (tb, mb, tb // mb)
    assert np.isfinite(float(engine.train_batch(_batch(engine))))
    with pytest.raises(ConfigError):
        _engine(elasticity=block, train_batch_size=7,
                train_micro_batch_size_per_gpu="auto")
    with pytest.raises(ElasticityIncompatibleWorldSize):
        compute_elastic_config({"elasticity": dict(block, min_gpus=2)},
                               world_size=1)


def test_elastic_world_above_one_names_a8(monkeypatch):
    """The agent's DSTPU_ELASTIC_WORLD_SIZE sizes a mesh in the JAX
    engine; the port trains on one card and refuses a larger world."""
    monkeypatch.setenv("DSTPU_ELASTIC_WORLD_SIZE", "4")
    with pytest.raises(NotImplementedError, match="A8"):
        _engine()
    monkeypatch.setenv("DSTPU_ELASTIC_WORLD_SIZE", "1")
    assert _engine().global_steps == 0


def test_one_membership_change_exit():
    """One ``MEMBERSHIP_CHANGE_EXIT`` (the watchdog's), equal to the JAX
    agent's."""
    from deepspeed_tpu.elasticity.elastic_agent import \
        MEMBERSHIP_CHANGE_EXIT as JAX_EXIT
    from deepspeed_tpu_torch.elasticity import elastic_agent
    from deepspeed_tpu_torch.resilience import watchdog
    assert elastic_agent.MEMBERSHIP_CHANGE_EXIT is \
        watchdog.MEMBERSHIP_CHANGE_EXIT == JAX_EXIT == 99
    src = (ROOT / "deepspeed_tpu_torch").rglob("*.py")
    assert sum("MEMBERSHIP_CHANGE_EXIT = " in p.read_text()
               for p in src) == 1


def test_watchdog_writes_heartbeat_and_stops_with_the_engine(tmp_path):
    """The config's heartbeat file is written by the engine's dog, and the
    dog's thread stops when the engine is collected."""
    import gc
    hb = tmp_path / "hb.json"
    engine = _engine(resilience={"watchdog": {
        "enabled": True, "check_interval_s": 0.01,
        "heartbeat_file": str(hb)}})
    engine.train_batch(_batch(engine))
    dog = engine._watchdog
    for _ in range(500):
        if hb.exists() and json.loads(hb.read_text())[
                "steps_recorded"] == 1:
            break
        dog._stop.wait(0.01)
    assert json.loads(hb.read_text())["in_step"] is None
    del engine
    gc.collect()
    dog._thread.join(5)
    assert not dog._thread.is_alive()


def test_step_abort_on_a_failed_step():
    """A step that raises leaves the dog idle (no stale in-flight step)."""
    engine = _engine(resilience={"watchdog": {"enabled": True,
                                              "check_interval_s": 3600}})
    try:
        with pytest.raises(Exception):
            engine.train_batch({"tokens": torch.zeros(2, 18,
                                                      dtype=torch.float32)})
        assert engine._watchdog._step is None
        assert len(engine._watchdog._durations) == 0
    finally:
        engine._watchdog.stop()


def test_agent_pins_the_elastic_config_for_the_worker(tmp_path):
    """The worker sees the elastic config the agent pinned (the JAX
    agent's environment), and the ledger records the launch and the
    success."""
    from deepspeed_tpu_torch.elasticity import run_elastic
    block = {"max_train_batch_size": 8, "micro_batch_sizes": [2],
             "version": 0.1}
    out = tmp_path / "seen.json"
    rc = run_elastic(
        [sys.executable, "-c",
         "import os; open(os.environ['OUT'], 'w').write("
         "os.environ['DSTPU_ELASTICITY_CONFIG'])"],
        block, ledger_path=str(tmp_path / "l.json"), env={"OUT": str(out)})
    assert rc == 0
    assert json.loads(out.read_text()) == dict(block, enabled=True)
    events = json.loads((tmp_path / "l.json").read_text())["events"]
    assert [e["event"] for e in events] == ["launch", "success"]
