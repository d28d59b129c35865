"""Port parity for the single-GPU training path: the chunked LM-head loss,
GPT-2 loss and grads, the LR schedules, the config, and the engine's
``train_batch`` trajectory, each against the JAX package on the CPU.

Inputs and weights are made with numpy / a flax init from a seed and
handed to both. The JAX engine is pinned to one device (the test session
gives JAX 8 virtual CPU devices, over which ``initialize`` would build a
data=8 mesh). Tolerances: fp32 1e-5 relative (summation order); bf16 and
the grad norm as stated in their tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.config.config import Config as JaxConfig
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models._lm_utils import chunked_lm_xent as jax_xent
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import make_model as jax_make_model
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.checkpoint import (gpt2_param_shapes,
                                            gpt2_params_from_numpy,
                                            init_gpt2_params)
from deepspeed_tpu_torch.config.config import Config, ConfigError
from deepspeed_tpu_torch.models._lm_utils import chunked_lm_xent, lm_head_xent
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, make_model
from deepspeed_tpu_torch.ops.optimizers import build_optimizer
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.utils.tree import flatten, unflatten

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _flax_params(cfg, seed=0):
    _, init_fn, _ = jax_make_model(cfg)
    return init_fn(jax.random.PRNGKey(seed), 2, 32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_grad_by_path(grads):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}


# ---------------------------------------------------------------- the loss


@pytest.mark.parametrize("head_layout", ["vc", "cv"])
def test_chunked_xent_loss_and_grads(head_layout):
    """Loss and grads w.r.t. hidden and head, with ignore_index, an
    out-of-range target, and T = 12 over 5 chunks (decremented to 4)."""
    rng = np.random.default_rng(0)
    B, T, C, V = 2, 12, 16, 40
    h = rng.standard_normal((B, T, C)).astype(np.float32)
    e = rng.standard_normal((V, C) if head_layout == "vc" else (C, V)
                            ).astype(np.float32)
    t = rng.integers(0, V, (B, T)).astype(np.int32)
    t[0, 3] = -100                      # ignore_index
    t[1, 5] = V + 7                     # out of range: dropped
    kw = dict(num_chunks=5, ignore_index=-100, head_layout=head_layout)
    jl, (jdh, jde) = jax.value_and_grad(
        lambda h_, e_: jax_xent(h_, e_, jnp.asarray(t), **kw),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(e))
    for remat in (True, False):
        th = torch.tensor(h, requires_grad=True)
        te = torch.tensor(e, requires_grad=True)
        tl = chunked_lm_xent(th, te, torch.from_numpy(t), remat=remat, **kw)
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(te.grad.numpy(), np.asarray(jde),
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- GPT-2


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_gpt2_tiny_loss_and_grads(impl):
    """The tiny GPT-2 in fp32 from the flax params carried across: loss
    and every parameter's grad. ``flash`` runs the Pallas kernels in
    interpret mode on the JAX side and the plain versions on the port's."""
    jcfg = JaxGPT2Config.tiny(dtype=jnp.float32, attention_impl=impl)
    tcfg = GPT2Config.tiny(dtype=torch.float32, attention_impl=impl)
    jp = _flax_params(jcfg)
    _, _, jloss = jax_make_model(jcfg)
    _, _, tloss = make_model(tcfg)
    toks = np.random.default_rng(1).integers(0, 512, (2, 33)).astype(
        np.int32)
    jl, jg = jax.value_and_grad(jloss)(jp, {"tokens": jnp.asarray(toks)},
                                       None)
    flat = flatten(gpt2_params_from_numpy(_np_tree(jp), tcfg, device="cpu"))
    for v in flat.values():
        v.requires_grad_(True)
    tl = tloss(unflatten(flat), {"tokens": torch.from_numpy(toks)})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jgf = _jax_grad_by_path(jg)
    assert set(jgf) == set(flat)
    for name, v in flat.items():
        np.testing.assert_allclose(v.grad.numpy(), jgf[name], atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_make_causal_lm_matches_and_copies_the_module_params():
    """``make_causal_lm``'s full-logits NLL over the tiny GPT-2 module
    (fp32) against the JAX package's on the same flax params, within
    1e-5; its ``init_fn`` copies a module's own parameters into the
    nested dict."""
    from deepspeed_tpu.models._lm_utils import \
        make_causal_lm as jax_make_causal_lm
    from deepspeed_tpu.models.gpt2 import GPT2 as JaxGPT2
    from deepspeed_tpu_torch.models._lm_utils import make_causal_lm
    from deepspeed_tpu_torch.models.gpt2 import GPT2
    jcfg = JaxGPT2Config.tiny(dtype=jnp.float32, attention_impl="xla")
    tcfg = GPT2Config.tiny(dtype=torch.float32, attention_impl="xla")
    jp = _flax_params(jcfg)
    _, _, jloss = jax_make_causal_lm(JaxGPT2(jcfg), jcfg)
    _, _, tloss = make_causal_lm(GPT2(tcfg), tcfg)
    toks = np.random.default_rng(4).integers(0, 512, (2, 33)).astype(
        np.int32)
    jl = jloss(jp, {"tokens": jnp.asarray(toks)}, None)
    tl = tloss(gpt2_params_from_numpy(_np_tree(jp), tcfg, device="cpu"),
               {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    lin = torch.nn.Linear(3, 2)
    _, init_fn, _ = make_causal_lm(lin, tcfg)
    p = init_fn()
    assert set(p) == {"weight", "bias"}
    assert torch.equal(p["weight"], lin.weight) and \
        p["weight"].data_ptr() != lin.weight.data_ptr()


def test_param_bridge_and_seeded_init_follow_the_flax_tree():
    cfg = JaxGPT2Config.tiny()
    jp = _np_tree(_flax_params(cfg))
    tcfg = GPT2Config.tiny()
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert shapes == gpt2_param_shapes(tcfg)
    seeded = init_gpt2_params(tcfg, seed=0, device="cpu")
    again = init_gpt2_params(tcfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten(seeded).items()} == \
        {k: tuple(v.shape) for k, v in flatten(
            gpt2_params_from_numpy(jp, tcfg, device="cpu")).items()}
    assert all(torch.equal(a, b) for a, b in zip(flatten(seeded).values(),
                                                 flatten(again).values()))
    bad = dict(jp)
    bad["extra"] = {"kernel": np.zeros(1)}
    with pytest.raises(KeyError):
        gpt2_params_from_numpy(bad, tcfg, device="cpu")


def test_param_dtypes_follow_flax_with_bf16_params():
    """With ``param_dtype=bf16`` flax keeps every LayerNorm scale and bias
    in fp32 (its ``nn.LayerNorm`` takes no ``param_dtype``); the seeded
    init and the bridge give the same dtype per path."""
    jp = _flax_params(JaxGPT2Config.tiny(param_dtype=jnp.bfloat16))
    want = {".".join(str(k.key) for k in path): str(np.asarray(v).dtype)
            for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert want["h_0.ln_1.scale"] == "float32"
    assert want["h_0.attn.c_attn.kernel"] == "bfloat16"
    tcfg = GPT2Config.tiny(param_dtype=torch.bfloat16)
    for tree in (init_gpt2_params(tcfg, seed=0, device="cpu"),
                 gpt2_params_from_numpy(_np_tree(jp), tcfg, device="cpu")):
        got = {k: str(v.dtype)[6:] for k, v in flatten(tree).items()}
        assert got == want


def test_gpt2_refuses_what_the_slice_does_not_serve(monkeypatch):
    """``flash_sharded`` raises at ``make_model``; the fused loss raises
    under a process group of more than one rank, for either head layout
    (the shard_map wrappers, ROADMAP A8). Dropout is served
    (``tests/test_torch_dropout.py``)."""
    for kw in (dict(attention_impl="flash_sharded"),):
        with pytest.raises(NotImplementedError):
            make_model(GPT2Config.tiny(**kw))
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    cfg = GPT2Config.tiny(xent_impl="fused")
    for layout, head in (("vc", torch.zeros(8, 4)),
                         ("cv", torch.zeros(4, 8))):
        with pytest.raises(NotImplementedError, match="A8"):
            lm_head_xent(torch.zeros(1, 2, 4), head,
                         torch.zeros(1, 2, dtype=torch.long), cfg,
                         head_layout=layout)
    with pytest.raises(ValueError):
        make_model(GPT2Config.tiny(remat=True, remat_policy="everything"))
    with pytest.raises(ValueError):
        make_model(GPT2Config.tiny(remat=True, remat_policy="save:qkv,h"))


def test_gpt2_remat_full_matches_no_remat():
    cfg = GPT2Config.tiny(dtype=torch.float32)
    params = init_gpt2_params(cfg, seed=2, device="cpu")
    toks = torch.randint(0, 512, (2, 17), generator=torch.Generator()
                         .manual_seed(0))
    grads = []
    for remat in (False, True):
        _, _, loss_fn = make_model(GPT2Config.tiny(dtype=torch.float32,
                                                   remat=remat))
        flat = {k: v.clone().requires_grad_() for k, v in
                flatten(params).items()}
        loss_fn(unflatten(flat), {"tokens": toks}).backward()
        grads.append([v.grad for v in flat.values()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


REMAT_POLICIES = ["full", "dots", "no_mlp", "no_gelu", "qkv_out",
                  "save:qkv,attn_out,mlp_pre_act"]


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_gpt2_remat_policy_matches_no_remat_and_jax(policy, monkeypatch):
    """Each policy's loss and grads (tiny GPT-2, fp32, the flash path's
    plain versions) against no remat within 1e-6 and against the JAX
    model under the same policy (Pallas flash in interpret mode) within
    1e-5. The flash forward runs once per layer in the forward and once
    more in the backward exactly when the policy does not keep the
    attention's output (its lse is recomputed)."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    calls = []
    inner = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    jcfg = JaxGPT2Config.tiny(dtype=jnp.float32, attention_impl="flash",
                              remat=True, remat_policy=policy)
    jp = _flax_params(jcfg)
    _, _, jloss = jax_make_model(jcfg)
    toks = np.random.default_rng(3).integers(0, 512, (2, 33)).astype(
        np.int32)
    jl, jg = jax.value_and_grad(jloss)(jp, {"tokens": jnp.asarray(toks)},
                                       None)
    jgf = _jax_grad_by_path(jg)
    grads = {}
    for remat in (False, True):
        cfg = GPT2Config.tiny(dtype=torch.float32, attention_impl="flash",
                              remat=remat, remat_policy=policy)
        _, _, tloss = make_model(cfg)
        flat = flatten(gpt2_params_from_numpy(_np_tree(jp), cfg,
                                              device="cpu"))
        for v in flat.values():
            v.requires_grad_(True)
        calls.clear()
        tl = tloss(unflatten(flat), {"tokens": torch.from_numpy(toks)})
        forward_calls = len(calls)
        tl.backward()
        grads[remat] = {k: v.grad for k, v in flat.items()}
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    recompute = policy in ("full", "dots", "qkv_out") or \
        policy.startswith("save:")
    assert forward_calls == 2 and \
        len(calls) == forward_calls + (2 if recompute else 0)
    for name, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][name], atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(g.numpy(), jgf[name], atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("policy,kept", [
    ("qkv_out", {"qkv", "attn_out"}),
    ("dots", {"qkv", "attn_out", "mlp_pre_act", "mlp_out"}),
    ("save:mlp_act", {"mlp_act"}),
    ("full", set()),
])
def test_remat_segments_keep_what_the_jax_policy_saves(policy, kept):
    """Under a save-only policy every segment is checkpointed and reads
    only the block's input and the kept activations."""
    from deepspeed_tpu_torch.models.gpt2 import remat_segments
    segs = remat_segments(policy)
    assert {t for t, _, _ in segs} == kept | {"out"}
    assert all(rec for _, _, rec in segs)
    assert set().union(*(set(i) for _, i, _ in segs)) <= kept | {"x"}


# ---------------------------------------------------------------- schedules


SCHEDULES = {
    "WarmupLR": dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3,
                     warmup_num_steps=10),
    "WarmupLR_linear": dict(warmup_min_lr=0.0, warmup_max_lr=1e-3,
                            warmup_num_steps=10, warmup_type="linear"),
    "WarmupDecayLR": dict(total_num_steps=30, warmup_max_lr=1e-3,
                          warmup_num_steps=10),
    "WarmupCosineLR": dict(total_num_steps=30, warmup_num_steps=10),
    "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                     cycle_first_step_size=5, decay_step_size=3,
                     decay_lr_rate=0.5),
    "LRRangeTest": dict(lr_range_test_step_size=4,
                        lr_range_test_staircase=True),
    "Constant": dict(lr=3e-4),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match(name):
    """Every schedule over 40 steps; the JAX schedules compute in fp32,
    the port's in Python floats, hence 1e-5 relative."""
    kind = name.split("_")[0]
    params = SCHEDULES[name]
    ref = jax_sched.build_schedule(kind, params, base_lr=1e-3)
    got = lr_schedules.build_schedule(kind, params, base_lr=1e-3)
    for step in range(40):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-5,
                                   atol=1e-12, err_msg=f"step {step}")


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("sizes", [
    dict(train_batch_size=8, train_micro_batch_size_per_gpu=2),
    dict(train_batch_size=8, gradient_accumulation_steps=4),
    dict(train_micro_batch_size_per_gpu=3, gradient_accumulation_steps=2),
    dict(train_batch_size=6),
    dict(train_micro_batch_size_per_gpu=2, train_batch_size="auto",
         gradient_accumulation_steps="auto"),
])
def test_batch_size_resolution_matches(sizes):
    ref = JaxConfig.load(dict(sizes))
    ref.resolve_batch_sizes(1)
    got = Config.load(dict(sizes))
    got.resolve_batch_sizes(1)
    for k in ("train_batch_size", "train_micro_batch_size_per_gpu",
              "gradient_accumulation_steps"):
        assert getattr(got, k) == getattr(ref, k), k
    bad = Config.load(dict(train_batch_size=7,
                           train_micro_batch_size_per_gpu=2))
    with pytest.raises(ConfigError):
        bad.resolve_batch_sizes(1)


@pytest.mark.parametrize("extra", [
    {"zero_optimization": {"stage": 2, "offload_optimizer": {"device":
                                                             "cpu"}}},
    {"zero_optimization": {"stage": 3, "zero_quantized_weights": True}},
    {"hybrid_engine": {"enabled": True}},
    {"pipeline": {"stages": 2}},
    {"memory_breakdown": True},
    {"curriculum_learning": {"enabled": True}},
    {"compression_training": {"weight_quantization": {}}},
    {"tensorboard": {"enabled": True}},
    {"mesh": {"data": 2}},
    {"dump_state": True},
    {"flops_profiler": {"enabled": True}},
])
def test_config_refuses_unported_features(extra):
    cfg = {"train_batch_size": 2, **extra}
    with pytest.raises(NotImplementedError):
        c = Config.load(cfg)
        build_optimizer(c.optimizer.type, c.optimizer.params)


def test_config_accepts_what_one_card_serves():
    cfg = Config.load({"train_batch_size": 2, "bf16": {"enabled": True},
                       "zero_optimization": {"stage": 3,
                                             "overlap_comm": True},
                       "tensorboard": {"enabled": False},
                       "wall_clock_breakdown": False, "mesh": {"data": 1},
                       "compile": False})
    assert cfg.precision_dtype == "bfloat16"
    assert cfg.zero_optimization.stage == 3
    with pytest.raises(ConfigError):
        Config.load({"fp16": {"enabled": True},
                     "bf16": {"enabled": True}}).precision_dtype


# ---------------------------------------------------------------- engine


def _ds(prec):
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR",
                        "params": {"warmup_min_lr": 0.0,
                                   "warmup_max_lr": 1e-3,
                                   "warmup_num_steps": 4}},
          "gradient_clipping": 1.0, "steps_per_print": 1000}
    if prec == "bf16":
        ds["bf16"] = {"enabled": True}
    if prec == "fp16":
        # a scale that overflows at first: the trajectory halves it
        ds["fp16"] = {"enabled": True, "initial_scale_power": 24,
                      "loss_scale_window": 2, "hysteresis": 2}
    return ds


def _run_both(prec, steps, ds=None, batch=4, param_dtype=None, **cfg_kw):
    """``steps`` train_batch calls on both engines from the same flax
    params and batches; per-step (loss, grad norm, loss scale, lr).
    ``param_dtype`` is a (jax, torch) pair; ``cfg_kw`` go to both
    ``GPT2Config.tiny``s."""
    jd, td = DTYPES.get(prec, (jnp.float32, torch.float32))
    jpd, tpd = param_dtype or (jnp.float32, torch.float32)
    jcfg = JaxGPT2Config.tiny(dtype=jd, attention_impl="xla",
                              param_dtype=jpd, **cfg_kw)
    tcfg = GPT2Config.tiny(dtype=td, attention_impl="xla", param_dtype=tpd,
                           **cfg_kw)
    jp = _flax_params(jcfg)
    _, _, jloss = jax_make_model(jcfg)
    _, _, tloss = make_model(tcfg)
    topo = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    ds = ds or _ds(prec)
    jeng, *_ = dstpu.initialize(loss_fn=jloss, params=jp, config=ds,
                                topology=topo)
    teng, *_ = initialize(
        loss_fn=tloss, config=ds, device="cpu",
        params=gpt2_params_from_numpy(_np_tree(jp), tcfg, device="cpu"))
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, 512, (batch, 33)).astype(np.int32)
        jl = float(jeng.train_batch({"tokens": jnp.asarray(toks)}))
        tl = float(teng.train_batch({"tokens": torch.from_numpy(toks)}))
        out.append(((jl, tl),
                    (jeng.get_global_grad_norm(),
                     teng.get_global_grad_norm()),
                    (jeng.get_loss_scale(), teng.get_loss_scale()),
                    (jeng.get_lr()[0], teng.get_lr()[0])))
    return out, jeng, teng


def test_engine_fp32_trajectory_matches():
    """5 steps of the tiny GPT-2 in fp32 (AdamW with weight decay,
    WarmupLR, clip 1.0, gas 2): losses within 1e-5 relative. The JAX
    engine's grad norm comes from a jitted ``jnp.vdot`` that XLA:CPU
    evaluates about 5.5e-5 (relative) below the float64 norm of the same
    gradients, so the grad norms are held to 1e-4 here; the port's norm is
    held to 1e-6 of the float64 norm in the next test."""
    out, _, teng = _run_both("fp32", 5)
    for (jl, tl), (jg, tg), (js, ts), (jlr, tlr) in out:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=1e-4)
        np.testing.assert_allclose(tlr, jlr, rtol=1e-6)
        assert js == ts == 1.0
    assert teng.global_steps == 5 and teng.global_samples == 20


def test_wall_clock_breakdown_times_train_batch(monkeypatch):
    """``wall_clock_breakdown`` (ported with ``utils/timer.py``): the
    ``train_batch`` timer and the throughput timer report every
    ``steps_per_print`` steps, and the losses equal the run with the
    timers off, bit for bit (the JAX engine's trajectory is held above)."""
    from deepspeed_tpu_torch.utils import timer as tm
    logged = []
    monkeypatch.setattr(tm, "log_dist",
                        lambda msg, ranks=None: logged.append(msg))
    tcfg = GPT2Config.tiny(dtype=torch.float32, attention_impl="xla")
    _, _, tloss = make_model(tcfg)
    engines = []
    for timers in (True, False):
        ds = {**_ds("fp32"), "steps_per_print": 2,
              "wall_clock_breakdown": timers}
        eng, *_ = initialize(loss_fn=tloss, config=ds, device="cpu",
                             params=init_gpt2_params(tcfg, seed=3,
                                                     device="cpu"))
        engines.append(eng)
    on, off = engines
    assert isinstance(on.timers, tm.SynchronizedWallClockTimer)
    assert isinstance(off.timers, tm.NoopTimer)
    rng = np.random.default_rng(7)
    for _ in range(4):
        toks = torch.from_numpy(rng.integers(0, 512, (4, 33)))
        assert float(on.train_batch({"tokens": toks})) == \
            float(off.train_batch({"tokens": toks}))
    assert on.timers.has_timer(tm.TRAIN_BATCH_TIMER)
    assert on.tput_timer.global_step_count == 4
    times = [m for m in logged if m.startswith("time (ms) | ")]
    assert len(times) == 2 and all(
        m.startswith("time (ms) | train_batch: ") and
        float(m.rsplit(" ", 1)[1]) > 0.0 for m in times)
    # both engines' throughput timers report at steps 2 and 4
    assert sum("RunningAvgSamplesPerSec" in m for m in logged) == 4


def test_engine_grad_norm_is_the_exact_global_norm():
    """The port's step-1 grad norm against the float64 norm of the JAX
    package's own gradients of the same two micro-batches (mean)."""
    jcfg = JaxGPT2Config.tiny(dtype=jnp.float32, attention_impl="xla")
    tcfg = GPT2Config.tiny(dtype=torch.float32, attention_impl="xla")
    jp = _flax_params(jcfg)
    _, _, jloss = jax_make_model(jcfg)
    _, _, tloss = make_model(tcfg)
    toks = np.random.default_rng(7).integers(0, 512, (4, 33)).astype(
        np.int32)
    gs = [jax.grad(jloss)(jp, {"tokens": jnp.asarray(toks[i:i + 2])}, None)
          for i in (0, 2)]
    mean = jax.tree_util.tree_map(
        lambda a, b: (np.asarray(a, np.float64) + np.asarray(b, np.float64))
        / 2, *gs)
    ref = np.sqrt(sum((x ** 2).sum() for x in jax.tree_util.tree_leaves(
        mean)))
    teng, *_ = initialize(
        loss_fn=tloss, config=_ds("fp32"), device="cpu",
        params=gpt2_params_from_numpy(_np_tree(jp), tcfg, device="cpu"))
    teng.train_batch({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(teng.get_global_grad_norm(), ref, rtol=1e-6)


def test_engine_bf16_trajectory_matches():
    """bf16 compute with fp32 master params: the two frameworks round at
    different places (fused vs separate ops, bf16 vs fp32 accumulation of
    the tied embedding's two gradients), so the limits are 5e-4 relative
    for the loss and 5e-3 for the grad norm (readings up to 1.8e-4 and
    9e-4 over 8 steps)."""
    out, _, _ = _run_both("bf16", 5)
    for (jl, tl), (jg, tg), _, (jlr, tlr) in out:
        np.testing.assert_allclose(tl, jl, rtol=5e-4)
        np.testing.assert_allclose(tg, jg, rtol=5e-3)
        np.testing.assert_allclose(tlr, jlr, rtol=1e-6)


def test_engine_fp16_loss_scale_trajectory_is_identical():
    """fp16 params (the model computes in fp32, as the JAX one does with
    dtype=float32) under a dynamic scale of 2**24: overflows consume the
    hysteresis, halve the scale and skip the update without advancing the
    step; the scale, the skipped steps and the lr must be identical and
    the losses within 1e-5."""
    out, jeng, teng = _run_both("fp16", 8)
    for (jl, tl), _, (js, ts), (jlr, tlr) in out:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert ts == js
        assert tlr == pytest.approx(jlr, rel=1e-6)
    assert teng.skipped_steps == jeng.skipped_steps > 0
    assert teng.state.step == int(jeng.state.step)
    assert [s for _, _, (s, _), _ in out][-1] < 2.0 ** 24


def test_engine_fused_xent_fp32_trajectory_matches():
    """5 steps of ``GPT2Config.tiny(xent_impl="fused")`` in fp32 (AdamW,
    WarmupLR, clip 1.0, gas 2): the port's plain path against the JAX
    engine running the Pallas kernels in interpret mode; losses within
    1e-5 relative, grad norms within 1e-4 (the JAX engine's jitted norm,
    as in ``test_engine_fp32_trajectory_matches``)."""
    out, _, _ = _run_both("fp32", 5, xent_impl="fused")
    for (jl, tl), (jg, tg), _, (jlr, tlr) in out:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=1e-4)
        np.testing.assert_allclose(tlr, jlr, rtol=1e-6)


def test_engine_bench_gpt1p3b_config_in_miniature_matches():
    """The bench's ``gpt1p3b`` training configuration on the tiny model:
    bf16 params (fp32 LayerNorms), bf16 compute, fused xent, remat
    ``qkv_out``, AdamW with bf16 moments, bf16 gradient accumulation, micro
    batch 2, gas 1, clip 1.0, no scheduler; 5 steps against the JAX engine.
    Both round to bf16 at different places (see the bf16 trajectory test),
    so losses within 5e-4 relative and grad norms within 5e-3; the
    LayerNorm master weights stay fp32 on both sides."""
    ds = {"train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 1, "bf16": {"enabled": True},
          "data_types": {"grad_accum_dtype": "bfloat16"},
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 3e-4, "weight_decay": 0.01,
                                   "moment_dtype": "bfloat16"}},
          "gradient_clipping": 1.0, "steps_per_print": 1000}
    kw = dict(param_dtype=(jnp.bfloat16, torch.bfloat16), remat=True,
              remat_policy="qkv_out", xent_impl="fused")
    out, jeng, teng = _run_both("bf16", 5, ds=ds, batch=2, **kw)
    for (jl, tl), (jg, tg), _, (jlr, tlr) in out:
        np.testing.assert_allclose(tl, jl, rtol=5e-4)
        np.testing.assert_allclose(tg, jg, rtol=5e-3)
        assert tlr == 3e-4 and jlr == pytest.approx(3e-4, rel=1e-6)
    assert teng.params["h_0"]["ln_1"]["scale"].dtype == torch.float32
    assert teng.params["h_0"]["mlp"]["c_fc"]["kernel"].dtype == \
        torch.bfloat16
    assert jeng.state.params["h_0"]["ln_1"]["scale"].dtype == jnp.float32


def test_compact_adamw_matches_adamw_compact():
    """``moment_dtype="bfloat16"`` AdamW against the JAX package's
    ``adamw_compact`` over 5 steps with a WarmupLR schedule, on a bf16 and
    an fp32 leaf from numpy-seeded values: the same fp32 arithmetic on the
    same stored values, so the bf16 moments and params agree to one bf16
    ulp (2^-8 relative) and the fp32 leaf within 1e-6."""
    from deepspeed_tpu.ops.optimizers import build_optimizer as jax_opt
    rng = np.random.default_rng(5)
    shapes = {"w": (8, 16), "ln": (16,)}
    init = {k: rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}
    jdt = {"w": jnp.bfloat16, "ln": jnp.float32}
    tdt = {"w": torch.bfloat16, "ln": torch.float32}
    params = {"lr": 1e-2, "weight_decay": 0.01, "moment_dtype": "bfloat16"}
    sched = dict(warmup_min_lr=0.0, warmup_max_lr=1e-2, warmup_num_steps=3)
    jtx = jax_opt("AdamW", params, learning_rate=jax_sched.build_schedule(
        "WarmupLR", sched, base_lr=1e-2))
    topt = build_optimizer("AdamW", params, learning_rate=lr_schedules
                           .build_schedule("WarmupLR", sched, base_lr=1e-2))
    jp = {k: jnp.asarray(v, jdt[k]) for k, v in init.items()}
    tp = [torch.tensor(init[k]).to(tdt[k]) for k in shapes]
    jstate, tstate = jtx.init(jp), topt.init(tp)
    for _ in range(5):
        g = {k: rng.standard_normal(v).astype(np.float32)
             for k, v in shapes.items()}
        ju, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = {k: jp[k] + ju[k].astype(jp[k].dtype) for k in jp}
        tstate = topt.update([torch.tensor(g[k]) for k in shapes], tstate,
                             tp)
    assert tstate.count == 5 and all(m.dtype == torch.bfloat16
                                     for m in tstate.mu + tstate.nu)
    for i, k in enumerate(shapes):
        tol = 2.0 ** -8 if k == "w" else 1e-6
        for got, want in ((tp[i], jp[k]), (tstate.mu[i], jstate.mu[k]),
                          (tstate.nu[i], jstate.nu[k])):
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                       atol=tol * np.abs(want).max())


def test_initialize_validates_and_evaluates():
    cfg = GPT2Config.tiny(dtype=torch.float32)
    _, init_fn, loss_fn = make_model(cfg)
    eng, opt, loader, sched = initialize(
        loss_fn=loss_fn, params=init_fn(seed=0, device="cpu"),
        config=_ds("fp32"), device="cpu")
    assert loader is None and opt is eng.optimizer and sched(0) == 0.0
    with pytest.raises(ConfigError):
        eng.train_batch({"tokens": torch.zeros(3, 9, dtype=torch.long)})
    toks = torch.randint(0, 512, (4, 17))
    before = float(eng.eval_batch({"tokens": toks}))
    for _ in range(3):
        eng.train_batch({"tokens": toks})
    assert float(eng.eval_batch({"tokens": toks})) < before
    with pytest.raises(ValueError):
        initialize(params={}, config=_ds("fp32"), device="cpu")
    with pytest.raises(ValueError):
        initialize(loss_fn=loss_fn, config=_ds("fp32"), device="cpu")
