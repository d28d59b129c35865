"""Port parity for the optimizers beyond Adam/AdamW
(``deepspeed_tpu_torch/ops/optimizers.py``) and their checkpoints.

- **Updates**: each optimizer name 5 updates against the JAX package's
  transformation (``build_optimizer`` over optax 0.2.6, and its own 1-bit
  math) on seeded numpy parameters and gradients with a WarmupLR schedule:
  params and every state slot within 1e-6 of their largest magnitude
  (fp32: the same ops, some fused or ordered differently). The 1-bit
  names cross their ``freeze_step`` (2), ZeroOneAdam refreshes its
  variance at count 4.
- **The JAX unit cases** of ``tests/unit/test_optimizers.py`` and
  ``test_onebit.py::TestOnebitOptimizers`` on the port's optimizers.
- **C7**: an Adam name ignores ``moment_dtype`` (fp32 moments), as the JAX
  package's Adam branch does.
- **Engines**: for each state layout the JAX engine builds (Lamb, Lion,
  Adagrad, SGD plain and with momentum + Nesterov + decay, the three 1-bit
  names, Adam with ``moment_dtype`` and L2 decay), GPT-2 tiny at one
  layer, fp32, no clipping, two batches in turn, 5 steps on both
  engines: losses within 1e-6 relative; the
  JAX engine's step-2 tag into a port engine built from other weights
  (every leaf equal by path) and the port's step-2 tag into the JAX
  engine, each then 3 steps on the JAX trajectory; the two files' meta
  (paths, shapes, dtypes) equal. Each JAX engine is built once for the
  module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.optimizers import build_optimizer as jax_opt
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.checkpoint import engine_checkpoint as ec
from deepspeed_tpu_torch.checkpoint import gpt2_params_from_numpy
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import lr_schedules
from torch_port_cases import seeded_tree

SCHED = dict(warmup_min_lr=0.0, warmup_max_lr=1e-2, warmup_num_steps=3)
SHAPES = {"b": (16,), "w": (8, 16)}

#: name -> optimizer params for the update parity
UPDATES = {
    "Lamb": {"weight_decay": 0.01},
    "FusedLamb": {},
    "Lion": {"weight_decay": 0.1},
    "FusedLion": {"betas": [0.95, 0.98]},
    "Adagrad": {},
    "SGD": {},
    "SGD_wd": {"weight_decay": 0.01},
    "SGD_momentum": {"momentum": 0.9},
    "MuSGD_nesterov_wd": {"momentum": 0.9, "nesterov": True,
                          "weight_decay": 0.01},
    "OneBitAdam": {"freeze_step": 2, "weight_decay": 0.01},
    "ZeroOneAdam": {"freeze_step": 2, "var_update_scaler": 2},
    "OneBitLamb": {"freeze_step": 2, "weight_decay": 0.01},
    "Adam_moment_dtype_l2": {"moment_dtype": "bfloat16",
                             "adam_w_mode": False, "weight_decay": 0.01},
}


def _opt_name(case):
    return case.split("_")[0]


def _jax_slots(state):
    """Every array leaf of an optax state by its path under ``state``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat
            if np.ndim(v) > 0}


def _close(got, want, what):
    """Within 1e-6 of the largest magnitude (fp32 rounding of the same
    ops in another order; small entries carry the largest one's error)."""
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("case", list(UPDATES))
def test_updates_match_the_jax_transformation(case):
    name, params = _opt_name(case), {"lr": 1e-2, **UPDATES[case]}
    rng = np.random.default_rng(3)
    init = {k: rng.standard_normal(v).astype(np.float32)
            for k, v in SHAPES.items()}
    jtx = jax_opt(name, params, learning_rate=jax_sched.build_schedule(
        "WarmupLR", SCHED, base_lr=1e-2))
    tx = topt.build_optimizer(name, params,
                              learning_rate=lr_schedules.build_schedule(
                                  "WarmupLR", SCHED, base_lr=1e-2))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = [torch.tensor(init[k]) for k in SHAPES]
    jstate, tstate = jtx.init(jp), tx.init(tp)
    jupdate = jax.jit(jtx.update)
    for _ in range(5):
        g = {k: rng.standard_normal(v).astype(np.float32)
             for k, v in SHAPES.items()}
        ju, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()},
                             jstate, jp)
        jp = {k: jp[k] + ju[k] for k in jp}
        tstate = tx.update([torch.tensor(g[k]) for k in SHAPES], tstate, tp)
    assert tstate.count == 5
    for i, k in enumerate(SHAPES):
        _close(tp[i].numpy(), np.asarray(jp[k]), k)
    # every slot of the port's state against the JAX leaf of that name
    want = _jax_slots(jstate)
    got = {}
    for field in tstate._fields[1:]:
        for i, k in enumerate(SHAPES):
            if getattr(tstate, field):
                got[field, k] = getattr(tstate, field)[i]
    assert len(got) == len(want)
    for (field, k), t in got.items():
        (path,) = [p for p in want if f"'{field}'" in p or
                   f".{field}" in p if p.endswith(f"['{k}']")]
        assert t.dtype == torch.float32, (field, k)
        _close(t.numpy(), want[path], path)


# ------------------------------------------- the JAX unit cases, ported


PARAMS = {"w": np.ones((4, 4), np.float32), "b": np.zeros(4, np.float32)}
GRADS = {"w": np.full((4, 4), 0.5, np.float32),
         "b": np.full(4, 0.1, np.float32)}


def _step(tx, params, grads):
    p = [torch.tensor(params[k]) for k in params]
    tx.update([torch.tensor(grads[k]) for k in params], tx.init(p), p)
    return dict(zip(params, p))


@pytest.mark.parametrize("name", ["Adam", "AdamW", "FusedAdam", "Lamb",
                                  "Lion", "Adagrad", "SGD", "OneBitAdam"])
def test_all_types_step(name):
    tx = topt.build_optimizer(name, {"lr": 1e-2, "weight_decay": 0.01})
    new = _step(tx, PARAMS, GRADS)
    assert not np.allclose(new["w"].numpy(), PARAMS["w"])


def test_adam_l2_mode_and_fusedadam_decay():
    """FusedAdam's decoupled decay and Adam's L2 mode both move a
    zero-gradient parameter."""
    for name, extra in (("FusedAdam", {}), ("Adam", {"adam_w_mode": False})):
        tx = topt.build_optimizer(name, {"lr": 1e-1, "weight_decay": 0.5,
                                         **extra})
        new = _step(tx, {"w": np.ones(4, np.float32)},
                    {"w": np.zeros(4, np.float32)})
        assert float(new["w"][0]) < 1.0, name
    with pytest.raises(ValueError):
        topt.build_optimizer("NotAnOptimizer", {})


def test_schedule_as_lr():
    tx = topt.build_optimizer("SGD", {},
                              learning_rate=lambda s: 0.1 / (1.0 + s))
    new = _step(tx, PARAMS, GRADS)
    np.testing.assert_allclose(new["w"].numpy(), PARAMS["w"] - 0.1 * 0.5,
                               rtol=1e-6)


def test_onebit_frozen_variance_and_zeroone_refresh():
    """``nu`` moves during warm-up and freezes after ``freeze_step``;
    ZeroOneAdam refreshes it at the counts ``var_update_scaler`` divides;
    OneBitLamb's updates stay finite."""
    def nus(name, params, n):
        tx = topt.build_optimizer(name, {"lr": 1e-2, **params})
        p = [torch.ones(4)]
        st, out = tx.init(p), []
        for i in range(n):
            st = tx.update([torch.full((4,), float(i + 1))], st, p)
            out.append(st.nu[0].clone())
        return out, p
    a, _ = nus("OneBitAdam", {"freeze_step": 3}, 6)
    assert not torch.allclose(a[0], a[2])
    assert torch.equal(a[3], a[4]) and torch.equal(a[4], a[5])
    z, _ = nus("ZeroOneAdam", {"freeze_step": 2, "var_update_scaler": 4}, 9)
    assert torch.equal(z[1], z[2]) and not torch.allclose(z[2], z[3])
    assert torch.equal(z[4], z[5]) and not torch.allclose(z[6], z[7])
    _, p = nus("OneBitLamb", {"freeze_step": 2}, 4)
    assert torch.isfinite(p[0]).all()


def test_adam_ignores_moment_dtype_as_jax_does():
    """C7: ``{"type": "Adam", "params": {"moment_dtype": "bfloat16",
    "adam_w_mode": false, "weight_decay": 0.01}}`` builds the JAX
    package's ``chain(add_decayed_weights, adam)``: fp32 moments, the
    Adam state at ``opt_state/1/0``; an AdamW name keeps the compact
    moments."""
    tx = topt.build_optimizer("Adam", UPDATES["Adam_moment_dtype_l2"])
    assert type(tx) is topt.Adam and not tx.decoupled
    st = tx.init([torch.zeros(3)])
    assert st.mu[0].dtype == st.nu[0].dtype == torch.float32
    assert tx.layout()[0] == ("opt_state/1/0/count", "count")
    jst = jax_opt("Adam", UPDATES["Adam_moment_dtype_l2"]).init(
        {"w": jnp.zeros(3)})
    assert jst[1][0].mu["w"].dtype == jnp.float32
    compact = topt.build_optimizer("AdamW", {"moment_dtype": "bfloat16"})
    assert isinstance(compact, topt.CompactAdamW)


# ------------------------------------------------------------- engines


LAYOUTS = {
    "lamb": {"type": "Lamb", "params": {"weight_decay": 0.01}},
    "lion": {"type": "Lion", "params": {"lr": 1e-4, "weight_decay": 0.1}},
    "adagrad": {"type": "Adagrad", "params": {"lr": 1e-2}},
    "sgd": {"type": "SGD", "params": {"lr": 1e-1}},
    "sgd_momentum_nesterov_wd": {"type": "SGD", "params": {
        "lr": 1e-1, "momentum": 0.9, "nesterov": True,
        "weight_decay": 0.01}},
    "onebitadam": {"type": "OneBitAdam", "params": {"freeze_step": 2}},
    "zerooneadam": {"type": "ZeroOneAdam", "params": {
        "freeze_step": 2, "var_update_scaler": 2}},
    "onebitlamb": {"type": "OneBitLamb", "params": {
        "freeze_step": 2, "weight_decay": 0.01}},
    "adam_moment_dtype_l2": {"type": "Adam", "params": {
        "moment_dtype": "bfloat16", "adam_w_mode": False,
        "weight_decay": 0.01}},
}
#: one leaf a tensor's path: "opt_state/<chain>/<slot>/<param path>"
WANT_PATHS = {
    "lamb": ["opt_state/0/count", "opt_state/0/mu/", "opt_state/0/nu/",
             "opt_state/3/count"],
    "lion": ["opt_state/0/count", "opt_state/0/mu/", "opt_state/2/count"],
    "adagrad": ["opt_state/0/sum_of_squares/", "opt_state/1/count"],
    "sgd": ["opt_state/1/count"],
    "sgd_momentum_nesterov_wd": ["opt_state/1/0/trace/",
                                 "opt_state/1/1/count"],
    "onebitadam": ["opt_state/count", "opt_state/mu/", "opt_state/nu/"],
    "zerooneadam": ["opt_state/count", "opt_state/mu/", "opt_state/nu/"],
    "onebitlamb": ["opt_state/count", "opt_state/mu/", "opt_state/nu/"],
    "adam_moment_dtype_l2": ["opt_state/1/0/count", "opt_state/1/0/mu/",
                             "opt_state/1/0/nu/", "opt_state/1/1/count"],
}
ENGINE_REL = 1e-6


def _cfgs():
    j = jgpt2.GPT2Config(vocab_size=512, max_seq_len=64, num_layers=1,
                         num_heads=4, hidden_size=64, dtype=jnp.float32,
                         attention_impl="xla")
    t = tgpt2.GPT2Config(vocab_size=512, max_seq_len=64, num_layers=1,
                         num_heads=4, hidden_size=64, dtype=torch.float32,
                         attention_impl="xla")
    return j, t


def _ds(opt):
    opt = {"type": opt["type"], "params": {"lr": 1e-3, **opt["params"]}}
    return {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 1, "seed": 5, "optimizer": opt,
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0.0, "warmup_max_lr": opt["params"]["lr"],
                "warmup_num_steps": 3}},
            # no clipping: the JAX engine's jitted global norm runs ~5e-6
            # (relative) below the exact one here, and the clip factor
            # would carry that into every update
            "gradient_clipping": 0.0, "steps_per_print": 1000}


_TREES = {}


def _tree(seed):
    if seed not in _TREES:
        j, _ = _cfgs()
        init = jgpt2.make_model(j)[1]
        _TREES[seed] = seeded_tree(lambda: init(jax.random.PRNGKey(0), 2,
                                                17), seed=seed)
    return _TREES[seed]


def _jax_engine(ds):
    j, _ = _cfgs()
    topo = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    eng, *_ = dstpu.initialize(
        loss_fn=jgpt2.make_model(j)[2],
        params=jax.tree.map(jnp.asarray, _tree(0)), config=ds,
        topology=topo)
    return eng


def _port_engine(ds, seed=0):
    _, t = _cfgs()
    eng, *_ = initialize(
        loss_fn=tgpt2.make_model(t)[2], config=ds, device="cpu",
        params=gpt2_params_from_numpy(_tree(seed), t, device="cpu"))
    return eng


def _path(p):
    return "/".join(str(getattr(k, "key", getattr(k, "idx",
                    getattr(k, "name", k)))) for k in p)


def _jax_state(eng):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        eng.state._replace(comm_state=()))
    return {_path(p): np.asarray(jax.device_get(v)) for p, v in flat}


def _meta(d):
    import json
    import os
    tag = open(os.path.join(d, "latest")).read().strip()
    with open(os.path.join(d, tag, "meta.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """Per layout: both engines 5 steps with a save at step 2; the JAX
    engine's saved state; then the cross loads (the port's tag into the
    JAX engine after its 5 steps, the JAX tag into a port engine from
    other weights), each followed by steps 3-5."""
    rng = np.random.default_rng(11)
    # two batches in turn: a 1-bit optimizer freezes the variance after
    # step 2, and an embedding row first used after that would divide by
    # its zero variance (both engines: the loss climbs ~60x)
    two = [rng.integers(0, 512, (2, 17)).astype(np.int32) for _ in range(2)]
    batches = [two[i % 2] for i in range(5)]
    out = {}
    for name, opt in LAYOUTS.items():
        ds = _ds(opt)
        d = tmp_path_factory.mktemp(name)
        jeng, teng = _jax_engine(ds), _port_engine(ds)
        jl, tl = [], []
        for i, b in enumerate(batches):
            if i == 2:
                jeng.save_checkpoint(str(d / "jax"))
                saved = _jax_state(jeng)
                teng.save_checkpoint(str(d / "port"))
            jl.append(float(jeng.train_batch({"tokens": jnp.asarray(b)})))
            tl.append(float(teng.train_batch({"tokens": torch.from_numpy(b)})))
        jeng.load_checkpoint(str(d / "port"))
        jax_resumed = [float(jeng.train_batch({"tokens": jnp.asarray(b)}))
                       for b in batches[2:]]
        peng = _port_engine(ds, seed=1)
        peng.load_checkpoint(str(d / "jax"))
        loaded = {p: ec._to_host(v, dt)
                  for p, v, dt in ec.state_leaves(peng)}
        port_resumed = [float(peng.train_batch(
            {"tokens": torch.from_numpy(b)})) for b in batches[2:]]
        out[name] = dict(jax=jl, port=tl, saved=saved, loaded=loaded,
                         jax_resumed=jax_resumed, port_resumed=port_resumed,
                         jmeta=_meta(str(d / "jax")),
                         tmeta=_meta(str(d / "port")),
                         count=peng.state.opt_state.count)
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_engine_trajectory_matches_jax(engine_runs, name):
    r = engine_runs[name]
    assert all(np.isfinite(r["port"]))
    np.testing.assert_allclose(r["port"], r["jax"], rtol=ENGINE_REL)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_checkpoint_layout_equals_jax(engine_runs, name):
    """The port's file is laid out as the JAX engine's (paths in order,
    shapes, dtypes), with the optimizer leaves of the layout table."""
    r = engine_runs[name]
    for k in ("paths", "shapes", "dtypes", "n_leaves", "global_steps"):
        assert r["tmeta"][k] == r["jmeta"][k], k
    paths = r["tmeta"]["paths"]
    opt = [p for p in paths if p.startswith("opt_state/")]
    n_params = sum(p.startswith("params/") for p in paths)
    for w in WANT_PATHS[name]:
        assert sum(p == w if w.endswith("count") else p.startswith(w)
                   for p in opt) == (1 if w.endswith("count") else n_params)
    assert len(opt) == sum(1 if w.endswith("count") else n_params
                           for w in WANT_PATHS[name])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_checkpoints_resume_in_the_other_engine(engine_runs, name):
    """JAX tag -> port (every leaf equal by path, then 3 steps on the JAX
    trajectory) and port tag -> JAX (3 steps on it)."""
    r = engine_runs[name]
    assert set(r["loaded"]) == set(r["saved"])
    for p, want in r["saved"].items():
        np.testing.assert_array_equal(r["loaded"][p], want, err_msg=p)
    assert r["count"] == 5
    np.testing.assert_allclose(r["port_resumed"], r["jax"][2:],
                               rtol=ENGINE_REL)
    np.testing.assert_allclose(r["jax_resumed"], r["jax"][2:],
                               rtol=ENGINE_REL)
