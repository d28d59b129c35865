"""Port parity for resumable training: the port's engine saves and loads
checkpoints in the JAX package's on-disk format
(``deepspeed_tpu_torch/checkpoint/engine_checkpoint.py``).

- **Layout**: for each optimizer structure the JAX engine builds (AdamW
  with a schedule and with a constant lr, Adam with L2 decay, the compact
  AdamW, fp16 with its loss-scale values) the port's ``meta`` paths,
  shapes, dtypes, leaf count and key set equal the JAX engine's after the
  same 2 steps (checksums and ``treedef`` are not compared).
- **Both directions**: the tiny Llama (2 layers, width 64), the tiny
  Mixtral (2 layers, 4 experts, second-expert noise drawn from the
  engine's key, so a wrongly restored key changes the trajectory) and
  GPT-2 tiny, fp32: the JAX engine saves at step 2 and the port loads it
  into an engine built from other weights, every leaf equal to the JAX
  state by name; the port saves at step 2 and a fresh JAX engine loads
  it. Either way 3 resumed steps match the JAX engine's uninterrupted
  steps 3-5 within 1e-6 relative (Llama, Mixtral) or 1e-5 (GPT-2), with
  the counters equal.
- **Load options**: ``load_module_only``, ``load_optimizer_states=False``
  and ``load_lr_scheduler_states=False`` give the JAX engine's next 3
  losses and ``get_lr()``.
- **bf16** (compact AdamW): the port writes its moments as the JAX package
  does (``'|V2'`` in the npz, ``"bfloat16"`` in the meta) and reads both
  files back bit for bit; the JAX engine cannot load its own file (a
  reference caveat, pinned).
- ``zero_to_fp32`` and ``ds_to_universal`` against the JAX package's.

Weights are seeded numpy draws over the flax initializers' trees; the JAX
engines are pinned to one device and built once for the module where they
can be shared."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.checkpoint import zero_to_fp32 as jz2f
from deepspeed_tpu.checkpoint.ds_to_universal import \
    load_universal_named as jax_load_universal
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.checkpoint import (STATE_FILE,
                                            export_fp32_params,
                                            extract_fp32_params,
                                            family_params_from_numpy,
                                            gpt2_params_from_numpy,
                                            llama_params_from_numpy,
                                            zero_to_fp32)
from deepspeed_tpu_torch.checkpoint import engine_checkpoint as ec
from deepspeed_tpu_torch.checkpoint.ds_to_universal import (
    convert, load_universal_named)
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models import mixtral as tmixtral
from torch_port_cases import port_cases, seeded_tree

TOL = {"llama": 1e-6, "mixtral": 1e-6, "gpt2": 1e-5}
SCHED = {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0,
                                        "warmup_max_lr": 1e-3,
                                        "warmup_num_steps": 4}}
META_KEYS = {"checksums", "client_state", "config", "dtypes",
             "format_version", "global_samples", "global_steps", "n_leaves",
             "paths", "shapes", "skipped_steps", "treedef"}


def _ds(**kw):
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2, "seed": 5,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "scheduler": SCHED, "gradient_clipping": 1.0,
          "steps_per_print": 1000}
    ds.update(kw)
    return ds


def _cfgs(fam):
    """(JAX model config, port model config, JAX init thunk) of a family."""
    if fam == "llama":
        j = jllama.LlamaConfig.tiny(dtype=jnp.float32, attention_impl="xla")
        t = tllama.LlamaConfig.tiny(dtype=torch.float32)
        init = jllama.make_model(j)[1]
        return j, t, lambda: init(jax.random.PRNGKey(0), seq_len=16)
    if fam == "mixtral":
        j = jmixtral.MixtralConfig.tiny(dtype=jnp.float32, num_layers=2,
                                        attention_impl="xla")
        t = tmixtral.MixtralConfig.tiny(dtype=torch.float32, num_layers=2,
                                        attention_impl="xla")
        init = jmixtral.make_model(j)[1]
        return j, t, lambda: init(jax.random.PRNGKey(0), seq_len=16)
    j = jgpt2.GPT2Config.tiny(dtype=jnp.float32, attention_impl="xla")
    t = tgpt2.GPT2Config.tiny(dtype=torch.float32, attention_impl="xla")
    init = jgpt2.make_model(j)[1]
    return j, t, lambda: init(jax.random.PRNGKey(0), 2, 17)


_TREES = {}


def _tree(fam, seed):
    if (fam, seed) not in _TREES:
        _TREES[fam, seed] = seeded_tree(_cfgs(fam)[2], seed=seed)
    return _TREES[fam, seed]


def jax_engine(fam, seed=0, ds=None):
    j, _, _ = _cfgs(fam)
    mod = {"llama": jllama, "mixtral": jmixtral, "gpt2": jgpt2}[fam]
    topo = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    eng, *_ = dstpu.initialize(
        loss_fn=mod.make_model(j)[2],
        params=jax.tree.map(jnp.asarray, _tree(fam, seed)),
        config=ds or _ds(), topology=topo)
    return eng


def port_engine(fam, seed=0, ds=None):
    _, t, _ = _cfgs(fam)
    tree = _tree(fam, seed)
    if fam == "llama":
        params = llama_params_from_numpy(tree, t, device="cpu",
                                         dtype=torch.float32)
        loss = tllama.make_model(t)[2]
    elif fam == "mixtral":
        params = family_params_from_numpy(tree, t, device="cpu",
                                          dtype=torch.float32)
        loss = tmixtral.make_model(t)[2]
    else:
        params = gpt2_params_from_numpy(tree, t, device="cpu")
        loss = tgpt2.make_model(t)[2]
    eng, *_ = initialize(loss_fn=loss, params=params, config=ds or _ds(),
                         device="cpu")
    return eng


def _batches(n=5):
    rng = np.random.default_rng(11)
    return [rng.integers(0, 512, (4, 17)).astype(np.int32)
            for _ in range(n)]


def _jstep(eng, b):
    return float(eng.train_batch({"tokens": jnp.asarray(b)}))


def _tstep(eng, b):
    return float(eng.train_batch({"tokens": torch.from_numpy(b)}))


def _jax_state(eng):
    """The JAX engine's saved leaves by path, as numpy."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        eng.state._replace(comm_state=()))
    return {ec_path(p): np.asarray(jax.device_get(v)) for p, v in flat}


def ec_path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx",
                    getattr(k, "name", k)))) for k in path)


def _port_state(eng):
    """The port engine's leaves by JAX path, as the file holds them."""
    return {p: ec._to_host(v, d) for p, v, d in ec.state_leaves(eng)}


def _meta(d):
    tag = open(os.path.join(d, "latest")).read().strip()
    with open(os.path.join(d, tag, "meta.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each family's JAX reference: 2 steps, a save, 3 more steps (the
    uninterrupted trajectory), with the state and lr at the save."""
    out = {}
    batches = _batches()
    for fam in TOL:
        d = str(tmp_path_factory.mktemp(f"jax_{fam}"))
        eng = jax_engine(fam)
        first = [_jstep(eng, b) for b in batches[:2]]
        eng.save_checkpoint(d)
        saved = _jax_state(eng)
        lr, samples = eng.get_lr()[0], eng.global_samples
        rest = [_jstep(eng, b) for b in batches[2:]]
        out[fam] = dict(dir=d, first=first, rest=rest, state=saved, lr=lr,
                        samples=samples, engine=eng)
    return batches, out


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    """Each family on the port: 2 steps and a save."""
    batches, _ = jax_runs
    out = {}
    for fam in TOL:
        d = str(tmp_path_factory.mktemp(f"port_{fam}"))
        eng = port_engine(fam)
        first = [_tstep(eng, b) for b in batches[:2]]
        eng.save_checkpoint(d)
        out[fam] = dict(dir=d, first=first, state=_port_state(eng),
                        lr=eng.get_lr()[0])
    return out


def _same_layout(got, want):
    assert set(got) == set(want) == META_KEYS
    for k in ("paths", "shapes", "dtypes", "n_leaves", "format_version",
              "global_steps", "global_samples", "skipped_steps"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("fam", list(TOL))
def test_layout_equals_jax(jax_runs, port_runs, fam):
    """AdamW with WarmupLR on each family: the port's file is laid out as
    the JAX engine's (92 leaves for GPT-2 in the JAX order, every level's
    keys sorted as strings)."""
    _, jr = jax_runs
    _same_layout(_meta(port_runs[fam]["dir"]), _meta(jr[fam]["dir"]))
    np.testing.assert_allclose(port_runs[fam]["first"], jr[fam]["first"],
                               rtol=TOL[fam])


@pytest.mark.parametrize("fam", list(TOL))
def test_jax_checkpoint_resumes_on_the_port(jax_runs, fam):
    """The JAX engine's step-2 tag into a port engine built from other
    weights: every leaf equal to the JAX state by path (params, both
    moments, the counts, the loss-scale state, the key), the counters and
    the lr equal, then 3 steps on the JAX engine's trajectory."""
    batches, jr = jax_runs
    r = jr[fam]
    eng = port_engine(fam, seed=1)
    path, client = eng.load_checkpoint(r["dir"])
    assert path.endswith("global_step2") and client == {}
    got = _port_state(eng)
    assert set(got) == set(r["state"])
    for p, want in r["state"].items():
        np.testing.assert_array_equal(got[p], want, err_msg=p)
    assert (eng.global_steps, eng.global_samples) == (2, r["samples"])
    assert eng.get_lr()[0] == pytest.approx(r["lr"], rel=1e-6)
    got = [_tstep(eng, b) for b in batches[2:]]
    np.testing.assert_allclose(got, r["rest"], rtol=TOL[fam])
    assert eng.global_steps == 5 and eng.state.opt_state.count == 5


@pytest.mark.parametrize("fam", list(TOL))
def test_port_checkpoint_resumes_in_jax(jax_runs, port_runs, fam):
    """The port's step-2 tag into the JAX reference engine, 3 steps past
    it (the load replaces its whole state; reusing it spares a compile):
    3 steps on the uninterrupted JAX trajectory, the counters equal."""
    batches, jr = jax_runs
    eng = jr[fam]["engine"]
    path, _ = eng.load_checkpoint(port_runs[fam]["dir"])
    assert path.endswith("global_step2")
    assert (eng.global_steps, eng.global_samples) == (2, jr[fam]["samples"])
    assert eng.get_lr()[0] == pytest.approx(jr[fam]["lr"], rel=1e-6)
    got = [_jstep(eng, b) for b in batches[2:]]
    np.testing.assert_allclose(got, jr[fam]["rest"], rtol=TOL[fam])


LAYOUTS = {
    # Adam with L2 decay: chain(add_decayed_weights, adam) -> opt_state/1/
    "adam_l2": _ds(optimizer={"type": "Adam", "params": {
        "lr": 1e-3, "weight_decay": 0.01, "adam_w_mode": False}}),
    # a constant lr (the JAX engine still hands optax a schedule) under
    # fp16, from a scale that overflows: the loss-scale values move
    "adamw_const_fp16": {**{k: v for k, v in _ds().items()
                            if k != "scheduler"},
                         "fp16": {"enabled": True, "initial_scale_power": 24,
                                  "loss_scale_window": 2, "hysteresis": 1}},
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_optimizer_layouts_equal_jax(jax_runs, tmp_path, name):
    """Adam with L2 decay and the fp16 AdamW on GPT-2 tiny after the same
    2 steps: meta equal to the JAX engine's, and every scalar leaf (the
    step, the counts, the loss-scale state) equal in value."""
    batches, _ = jax_runs
    ds = LAYOUTS[name]
    jeng, teng = jax_engine("gpt2", ds=ds), port_engine("gpt2", ds=ds)
    for b in batches[:2]:
        _jstep(jeng, b)
        _tstep(teng, b)
    jeng.save_checkpoint(str(tmp_path / "jax"))
    teng.save_checkpoint(str(tmp_path / "port"))
    jm, tm = _meta(str(tmp_path / "jax")), _meta(str(tmp_path / "port"))
    _same_layout(tm, jm)
    jz = np.load(tmp_path / "jax" / "global_step2" / STATE_FILE)
    tz = np.load(tmp_path / "port" / "global_step2" / STATE_FILE)
    for i, (p, shape) in enumerate(zip(jm["paths"], jm["shapes"])):
        if not shape or p == "rng":
            np.testing.assert_array_equal(tz[f"leaf_{i:05d}"],
                                          jz[f"leaf_{i:05d}"], err_msg=p)
    if name == "adamw_const_fp16":
        assert teng.get_loss_scale() == jeng.get_loss_scale() < 2.0 ** 24


def test_adam_without_decay_layout_equals_jax():
    """Plain Adam (L2 mode, no decay) is ``optax.adam``: the Adam state at
    ``opt_state/0``, the schedule's count at ``opt_state/1``; checked on
    the engines' initial state, against the JAX tree's paths."""
    ds = _ds(optimizer={"type": "Adam", "params": {"lr": 1e-3,
                                                   "adam_w_mode": False}})
    want = _jax_state(jax_engine("gpt2", ds=ds))
    got = _port_state(port_engine("gpt2", ds=ds))
    assert list(got) == list(want)
    for p in got:
        assert got[p].shape == want[p].shape and \
            got[p].dtype == want[p].dtype, p


LOAD_OPTIONS = ("load_module_only", "load_optimizer_states",
                "load_lr_scheduler_states")


@pytest.fixture(scope="module")
def load_option_runs(jax_runs):
    """One JAX and one port engine built from other weights train a step
    of their own (so the state a load keeps is not the initial one), then
    in turn load the JAX engine's GPT-2 tag under each option and train 3
    steps: ``get_lr()`` and ``global_steps`` after the load, the 3 losses
    and ``get_lr()`` after them, per option and engine."""
    batches, jr = jax_runs
    out = {}
    engs = jax_engine("gpt2", seed=1), port_engine("gpt2", seed=1)
    for eng, step in zip(engs, (_jstep, _tstep)):
        step(eng, batches[4])
        for opt in LOAD_OPTIONS:
            eng.load_checkpoint(jr["gpt2"]["dir"],
                                **{opt: opt == "load_module_only"})
            out.setdefault(opt, []).append(
                [eng.get_lr()[0], eng.global_steps] +
                [step(eng, b) for b in batches[2:]] + [eng.get_lr()[0]])
    return out


@pytest.mark.parametrize("opt", LOAD_OPTIONS)
def test_load_options_follow_jax(load_option_runs, opt):
    """``load_module_only`` and ``load_optimizer_states=False`` take the
    saved params and step and keep the engine's optimizer, loss-scale
    state and key; ``load_lr_scheduler_states=False`` sets the step (the
    lr ``get_lr`` reports) to 0 and keeps the saved optimizer count (the
    lr applied): the port's figures equal the JAX engine's."""
    want, got = load_option_runs[opt]
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.fixture(scope="module")
def compact_runs(jax_runs, tmp_path_factory):
    """GPT-2 tiny with the compact AdamW (bf16 moments) on both engines:
    2 steps and a save each."""
    batches, _ = jax_runs
    ds = _ds(optimizer={"type": "AdamW", "params": {
        "lr": 1e-3, "weight_decay": 0.01, "moment_dtype": "bfloat16"}})
    d = tmp_path_factory.mktemp("compact")
    jeng, teng = jax_engine("gpt2", ds=ds), port_engine("gpt2", ds=ds)
    for b in batches[:2]:
        _jstep(jeng, b)
        _tstep(teng, b)
    jeng.save_checkpoint(str(d / "jax"))
    teng.save_checkpoint(str(d / "port"))
    return jeng, teng, d, ds


def test_bf16_moments_are_written_as_jax_writes_them(compact_runs):
    """The compact AdamW's file: one Adam state without a chain index
    (``opt_state/{count,mu,nu}``, 91 leaves), the moments as raw 2-byte
    void in the npz and ``"bfloat16"`` in the meta, as the JAX engine
    writes them."""
    _, _, d, _ = compact_runs
    jm, tm = _meta(str(d / "jax")), _meta(str(d / "port"))
    _same_layout(tm, jm)
    assert "opt_state/count" in tm["paths"]
    assert tm["dtypes"].count("bfloat16") == 2 * sum(
        p.startswith("params/") for p in tm["paths"])
    tz = np.load(d / "port" / "global_step2" / STATE_FILE)
    jz = np.load(d / "jax" / "global_step2" / STATE_FILE)
    for i, dt in enumerate(tm["dtypes"]):
        k = f"leaf_{i:05d}"
        assert tz[k].dtype.str == jz[k].dtype.str, tm["paths"][i]
        if dt == "bfloat16":
            assert tz[k].dtype.str == "|V2"


def test_bf16_checkpoints_load_bit_exact(compact_runs):
    """The port reads both files back bit for bit (the JAX engine's state
    by path, and its own), through ``meta["dtypes"]``."""
    jeng, teng, d, ds = compact_runs
    want = {p: v.view(np.uint16) if v.dtype.itemsize == 2 and
            v.dtype.kind not in "iu" else v
            for p, v in _jax_state(jeng).items()}
    eng = port_engine("gpt2", seed=1, ds=ds)
    eng.load_checkpoint(str(d / "jax"))
    for p, v in _port_state(eng).items():
        if v.dtype.kind == "V":
            v = v.view(np.uint16)
        np.testing.assert_array_equal(v, want[p], err_msg=p)
    own = _port_state(teng)
    eng.load_checkpoint(str(d / "port"))
    for p, v in _port_state(eng).items():
        assert (v.dtype.str, v.shape, v.tobytes()) == \
            (own[p].dtype.str, own[p].shape, own[p].tobytes()), p


def test_jax_engine_cannot_load_its_own_bf16_checkpoint(compact_runs):
    """Reference caveat (ROADMAP §C): the JAX loader hands the npz's raw
    2-byte void leaves to ``jnp.asarray``, which refuses them, so the JAX
    engine cannot resume any tag holding a bf16 leaf."""
    jeng, _, d, _ = compact_runs
    with pytest.raises(TypeError):
        jeng.load_checkpoint(str(d / "jax"))


def test_zero_to_fp32_equals_jax(port_runs, tmp_path):
    """``extract_fp32_params`` of a port-written tag (a save dir with
    ``latest``, or the tag itself) equals the JAX package's on the same
    file and the live engine's export; the CLI writes the same npz."""
    d = port_runs["gpt2"]["dir"]
    got = extract_fp32_params(d)
    want = jz2f.extract_fp32_params(os.path.join(d, "global_step2"))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    live = {k[len("params/"):]: v for k, v in port_runs["gpt2"]["state"]
            .items() if k.startswith("params/")}
    assert list(live) == list(got)
    out = tmp_path / "fp32.npz"
    assert zero_to_fp32.main([d, str(out)]) == 0
    with np.load(out) as z:
        assert sorted(z.files) == sorted(got)
        for k in got:
            np.testing.assert_array_equal(z[k], got[k])


def test_zero_to_fp32_widens_bf16_leaves(compact_runs):
    """bf16 master params (compact moments here share the file) are
    widened exactly from their stored bits."""
    _, teng, d, _ = compact_runs
    got = extract_fp32_params(str(d / "port"))
    for k, v in export_fp32_params(teng).items():
        np.testing.assert_array_equal(got[k], v)


(TestDsToUniversal,) = port_cases(
    "tests/unit/test_checkpoint.py", ("TestDsToUniversal",),
    ("checkpoint",))


def test_ds_to_universal_equals_jax(tmp_path):
    """A stage-2 reference checkpoint through both converters: the
    universal dirs read back to equal arrays (by either reader)."""
    from deepspeed_tpu.checkpoint.ds_to_universal import convert as jconvert
    src = str(tmp_path / "ref")
    os.makedirs(src)
    TestDsToUniversal()._write_reference_ckpt(src, world=2, stage=2)
    convert(src, str(tmp_path / "port"))
    jconvert(src, str(tmp_path / "jax"))
    got = load_universal_named(str(tmp_path / "port"))
    want = jax_load_universal(str(tmp_path / "jax"))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
