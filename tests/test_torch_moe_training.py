"""Port parity for training the MoE families: the capacity gating, the MoE
layer on both routes, ``ragged_dot``'s backward, the per-layer gating keys,
one step's loss and gradients of Mixtral (top-2 with second-expert
sampling) and Qwen2-MoE (top-4 on the grouped GEMM, a shared expert, qkv
bias), their 5-step engine trajectories (``train_batch`` and the
``forward`` / ``backward`` / ``step`` trio), and the refusals. The
single-group cases of ``tests/unit/test_moe.py`` also run on the port
(``torch_port_cases.port_cases``).

Weights are seeded numpy draws over the flax trees
(``torch_port_cases.seeded_tree``; the standalone layer's from its flax
``init``) and cross through numpy.
Tolerances: gating and one step's loss and gradients 1e-5 relative in
fp32; ``ragged_dot``'s gradients 1e-5; trajectories 1e-6 relative; keys
and dispatch masks bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu.moe.sharded_moe as jsm
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.moe.layer import MoE as JMoE
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.checkpoint import (family_params_from_numpy,
                                            moe_params_from_numpy)
from deepspeed_tpu_torch.models import mixtral as tmixtral
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from deepspeed_tpu_torch.ops.kernels import grouped_gemm
from deepspeed_tpu_torch.utils import random as trandom
from deepspeed_tpu_torch.utils.tree import flatten, unflatten
from torch_port_cases import port_cases, seeded_tree


def _grads_by_path(grads):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}


def _close(got, want, tol=1e-5, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=tol,
        atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=msg)


# ------------------------------------------------------------- gating

def _logits(S=24, E=6, seed=0):
    return np.random.default_rng(seed).standard_normal((S, E)).astype(
        np.float32)


GATES = [
    ("top1", dict(capacity_factor=1.0)),
    ("top1", dict(capacity_factor=1.0, drop_tokens=False)),
    ("top1", dict(capacity_factor=0.5, min_capacity=6)),
    ("top1", dict(capacity_factor=1.0, noisy_gate_policy="RSample")),
    ("top1", dict(capacity_factor=2.0, noisy_gate_policy="Jitter")),
    ("top2", dict(capacity_factor=1.0)),
    ("top2", dict(capacity_factor=1.0, normalize_weights=False)),
    ("top2", dict(capacity_factor=1.0, drop_tokens=False)),
    ("top2", dict(capacity_factor=0.5, top2_2nd_expert_sampling=False)),
    ("topk", dict(k=3, capacity_factor=1.0)),
    ("topk", dict(k=3, capacity_factor=1.0, normalize_weights=False)),
    ("topk", dict(k=4, drop_tokens=False)),
    ("gate", dict(k=2, capacity_factor=1.0, noisy_gate_policy="RSample")),
]


@pytest.mark.parametrize("fn,kw", GATES,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(GATES)])
def test_gating_matches_jax(fn, kw):
    """``(l_aux, combine, dispatch)`` of each gating function, with and
    without drops, noise (RSample, Jitter, second-expert sampling, from
    the same key), both weight normalisations and ``min_capacity``;
    combine within 1e-5, dispatch bit for bit, and the gradient of
    ``sum(combine * r) + l_aux`` with respect to the logits within 3e-5
    of its largest element."""
    lg = _logits()
    r = np.random.default_rng(1).standard_normal(lg.shape).astype(np.float32)
    kw = dict(kw)
    if fn != "topk" and (fn == "top2" or kw.get("noisy_gate_policy")):
        kw["rng"] = jax.random.PRNGKey(7)
    jf = {"top1": jsm.top1gating, "top2": jsm.top2gating,
          "topk": jsm.topkgating, "gate": jsm.gate}[fn]
    tf = {"top1": tsm.top1gating, "top2": tsm.top2gating,
          "topk": tsm.topkgating, "gate": tsm.gate}[fn]

    def jobj(x):
        l_aux, comb, disp = jf(x, **kw)
        return (comb.sum(axis=1) * r[:, :1]).sum() + l_aux, (l_aux, comb,
                                                             disp)

    (_, (jl, jc, jd)), jg = jax.jit(jax.value_and_grad(jobj, has_aux=True))(
        jnp.asarray(lg))
    x = torch.tensor(lg, requires_grad=True)
    tkw = dict(kw)
    if "rng" in tkw:
        tkw["rng"] = trandom.as_key(tkw["rng"])
    tl, tc, td = tf(x, **tkw)
    ((tc.sum(dim=1) * torch.from_numpy(r[:, :1])).sum() + tl).backward()
    _close(tl.detach(), jl)
    _close(tc.detach(), jc)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the softmax derivative and the top-2 renormalisation, in a
    # different fp32 summation order: 3e-5 of the largest
    _close(x.grad, jg, tol=3e-5)


def test_gumbel_noise_uses_jax_uniform_bits():
    """``_gumbel``'s uniforms are ``jax.random.uniform``'s bits; the noise
    agrees to fp32 rounding of the two logarithms."""
    key = jax.random.PRNGKey(11)
    want = np.asarray(jsm._gumbel(key, (16, 8)))
    got = tsm._gumbel(trandom.as_key(key), (16, 8)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    u = np.asarray(jax.random.uniform(key, (16 * 8,), minval=1e-9,
                                      maxval=1.0 - 1e-9))
    np.testing.assert_array_equal(
        trandom.uniform(trandom.as_key(key), 16 * 8, minval=1e-9,
                        maxval=1.0 - 1e-9).numpy(), u)


# ------------------------------------------------------- ragged_dot VJP

@pytest.mark.parametrize("sizes", [[3, 0, 5, 1], [0, 0, 9, 0], [4, 4, 4, 4]])
def test_ragged_dot_backward_matches_jax_vjp(sizes):
    """dX and dW of ``ragged_dot`` (the plain versions of the grouped GEMM
    over the transposed weights and of ``grouped_wgrad_kernel``) against
    the VJP of ``jax.lax.ragged_dot`` in fp32, experts without rows among
    them (their dW is zero)."""
    rng = np.random.default_rng(sum(sizes))
    R, E, K, N = sum(sizes), len(sizes), 16, 24
    x = rng.standard_normal((R, K)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    dy = rng.standard_normal((R, N)).astype(np.float32)
    gs = jnp.asarray(sizes, jnp.int32)
    jy, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, gs),
                      jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    off = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                       dtype=torch.int32)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ty = grouped_gemm.ragged_dot(tx, tw, off)
    ty.backward(torch.from_numpy(dy))
    _close(ty.detach(), jy)
    _close(tx.grad, jdx)
    _close(tw.grad, jdw)
    for e, n in enumerate(sizes):
        if n == 0:
            assert not tw.grad[e].any()
    _close(grouped_gemm.ragged_dot_wgrad_plain(
        torch.from_numpy(x), torch.from_numpy(dy), off), jdw)


# ------------------------------------------------------------ the layer

LAYERS = [  # MoE kwargs, train
    (dict(k=1, capacity_factor=1.0, noisy_gate_policy="RSample"), True),
    (dict(k=2, drop_tokens=False, gated=True), True),
    (dict(k=3, capacity_factor=1.0, use_residual=True), True),
    (dict(k=2, drop_tokens=False, gated=True,
          top2_2nd_expert_sampling=False), True),
    (dict(k=4, drop_tokens=False, gated=True, normalize_weights=False),
     True),
    (dict(k=1, drop_tokens=False), True),
]


@pytest.mark.parametrize("kw,train", LAYERS,
                         ids=[str(i) for i in range(len(LAYERS))])
def test_moe_layer_matches_jax(kw, train):
    """The MoE layer on JAX-initialised weights: output, l_aux and the
    gradients of ``sum(out * r) + l_aux`` with respect to every parameter
    and the input, on the capacity route (drops, RSample, top-2 sampling
    without drops, top-k, PR-MoE) and the grouped route (auto-chosen at
    k = 2 without sampling, at k = 4 and at k = 1)."""
    act = {"gated": (jax.nn.silu, torch.nn.functional.silu)}
    gated = kw.get("gated", False)
    jact, tact = act["gated"] if gated else (jax.nn.gelu, tlayer.gelu)
    base = dict(d_model=16, num_experts=4, hidden=32)
    jmod = JMoE(**base, **kw, activation=jact)
    tmod = tlayer.MoE(**base, **kw, activation=tact)
    x = np.random.default_rng(3).standard_normal((2, 6, 16)).astype(
        np.float32)
    r = np.random.default_rng(4).standard_normal((2, 6, 16)).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    variables = jmod.init({"params": jax.random.PRNGKey(0), "gating": key},
                          jnp.asarray(x))

    def jobj(p, xx):
        out, l_aux = jmod.apply({"params": p}, xx, train=train,
                                rngs={"gating": key})
        return (out * r).sum() + l_aux, (out, l_aux)

    (_, (jo, jl)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jobj, argnums=(0, 1), has_aux=True))(variables["params"],
                                             jnp.asarray(x))
    params = moe_params_from_numpy(jax.tree.map(np.asarray,
                                                variables["params"]),
                                   tmod, device="cpu")
    flat = flatten(params)
    for v in flat.values():
        v.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    to, tl = tmod.forward(unflatten(flat), tx, train, trandom.as_key(key))
    ((to * torch.from_numpy(r)).sum() + tl).backward()
    _close(to.detach(), jo)
    _close(tl.detach(), jl)
    _close(tx.grad, jgx)
    jg = _grads_by_path(jgp)
    assert set(jg) == set(flat)
    for name, v in flat.items():
        _close(v.grad, jg[name], msg=name)


@pytest.mark.parametrize("gated", [False, True])
def test_experts_match_jax(gated):
    """The standalone stacked experts ``[E, T, M] -> [E, T, M]`` on the
    JAX-initialised weights, within 1e-5."""
    from deepspeed_tpu.moe.layer import Experts as JExperts
    x = np.random.default_rng(8).standard_normal((3, 5, 8)).astype(
        np.float32)
    jmod = JExperts(num_experts=3, hidden=24, d_model=8, gated=gated)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    got = tlayer.Experts(num_experts=3, hidden=24, d_model=8,
                         gated=gated).apply(
        jax.tree.map(np.asarray, variables), x)
    _close(got, want)


def test_moe_layer_refusals():
    """The grouped route's two ``ValueError``s; expert parallelism and
    experts-TP raise ``NotImplementedError`` naming A8."""
    x = torch.zeros(1, 4, 16)
    mk = dict(d_model=16, num_experts=4, k=2, hidden=32, gated=True)
    p = tlayer.MoE(**mk, drop_tokens=False).init(0, x, train=False)["params"]
    with pytest.raises(ValueError, match="deterministically"):
        tlayer.MoE(**mk, drop_tokens=False, use_grouped_gemm=True).forward(
            p, x, True, trandom.PRNGKey(0))
    with pytest.raises(ValueError, match="dropless"):
        tlayer.MoE(**mk, top2_2nd_expert_sampling=False,
                   use_grouped_gemm=True).forward(p, x, True)
    for extra in (dict(ep_mesh=object()), dict(expert_tensor_parallel=True)):
        with pytest.raises(NotImplementedError, match="A8"):
            tlayer.MoE(**mk, **extra).forward(p, x, True, trandom.PRNGKey(0))


# ---------------------------------------------- the JAX package's cases

_SUBS = (("\nimport jax\n", "\nimport jax\nimport torch\n"),
         ("activation=jax.nn.silu", "activation=torch.nn.functional.silu"),
         ("    g = jax.grad(loss)(variables)\n"
          "    leaves = jax.tree_util.tree_leaves(g)\n",
          "    leaves = _torch_grads(loss, variables)\n"))
_CASES = ("test_capacity_formula", "test_top1_shapes_and_onehot",
          "test_top1_capacity_drop", "test_top1_no_drop",
          "test_top2_two_experts_per_token", "test_top2_norm_topk_prob_off",
          "test_topk_matches_k", "test_rts_gumbel_changes_selection",
          "test_moe_layer_forward",
          "test_grouped_gemm_matches_dropless_capacity",
          "test_grouped_gemm_matches_dropless_capacity_k1",
          "test_grouped_gemm_rejects_stochastic_gating",
          "test_grouped_gemm_grad_flows", "test_moe_residual")


def _torch_grads(loss, variables):
    leaves = [t.requires_grad_(True) for t in flatten(
        variables["params"]).values()]
    loss(variables).backward()
    return [t.grad for t in leaves]


for _name, _fn in zip(_CASES, port_cases(
        "tests/unit/test_moe.py", _CASES, ["moe"], subs=_SUBS,
        overrides={"_torch_grads": _torch_grads})):
    globals()[f"{_name}_on_the_port"] = _fn


# --------------------------------------------------------- the models

def _mixtral_cfgs(**kw):
    base = dict(num_layers=2, attention_impl="xla")
    base.update(kw)
    return (jmixtral.MixtralConfig.tiny(dtype=jnp.float32, **base),
            tmixtral.MixtralConfig.tiny(dtype=torch.float32, **base))


QWEN = dict(num_experts=6, experts_top_k=4, shared_expert_size=48,
            qkv_bias=True, norm_topk_prob=False, router_aux_loss_coef=0.001)


@pytest.fixture(scope="module")
def moe_weights():
    """Seeded Mixtral-tiny and Qwen2-MoE-tiny weights over the flax
    trees."""
    out = {}
    for name, kw in (("mixtral", {}), ("qwen", QWEN)):
        jcfg, _ = _mixtral_cfgs(**kw)
        _, init_fn, _ = jmixtral.make_model(jcfg)
        out[name] = seeded_tree(
            lambda: init_fn(jax.random.PRNGKey(0), seq_len=16))
    return out


def _tokens(seed, B=2, T=17):
    return np.random.default_rng(seed).integers(0, 512, (B, T)).astype(
        np.int32)


@pytest.mark.parametrize("remat", [False, True])
def test_gating_keys_are_bit_equal_to_jax(moe_weights, remat, monkeypatch):
    """The keys each Mixtral layer draws its second-expert noise from:
    JAX's (captured at run time by wrapping its ``_gumbel`` in a
    ``jax.debug.callback`` while ``model.apply`` runs) and the port's (its ``_gumbel`` wrapped likewise), bit for bit,
    with remat on and off; the noise itself agrees."""
    jcfg, tcfg = _mixtral_cfgs(remat=remat)
    jkeys, tkeys = [], []
    jorig, torig = jsm._gumbel, tsm._gumbel

    def jgumbel(rng, shape):
        jax.debug.callback(lambda k: jkeys.append(np.asarray(k)), rng,
                           ordered=True)
        return jorig(rng, shape)

    def tgumbel(rng, shape):
        tkeys.append(rng.numpy())
        return torig(rng, shape)

    monkeypatch.setattr(jsm, "_gumbel", jgumbel)
    monkeypatch.setattr(tsm, "_gumbel", tgumbel)
    toks = _tokens(5)
    key = jax.random.PRNGKey(21)
    model, _, _ = jmixtral.make_model(jcfg)
    out = jax.jit(lambda p, t, k: model.apply(
        {"params": p}, t, rngs={"gating": k}, mutable=["losses"]))(
        jax.tree.map(jnp.asarray, moe_weights["mixtral"]), jnp.asarray(toks),
        key)
    jax.block_until_ready(out)
    tmodel, _, _ = tmixtral.make_model(tcfg)
    params = family_params_from_numpy(moe_weights["mixtral"], tcfg,
                                      device="cpu", dtype=torch.float32)
    tmodel(params, torch.from_numpy(toks), trandom.as_key(key))
    assert len(jkeys) == len(tkeys) == tcfg.num_layers
    for li, (j, t) in enumerate(zip(jkeys, tkeys)):
        np.testing.assert_array_equal(t, j.astype(np.int64))
        np.testing.assert_array_equal(t, trandom.make_rng(
            trandom.as_key(key), (f"layer_{li}", "moe")).numpy())


@pytest.mark.parametrize("name,remat", [("mixtral", False),
                                        ("mixtral", True), ("qwen", True)])
def test_moe_model_loss_and_grads_match_jax(moe_weights, name, remat):
    """One step's loss (NLL + coef x the layers' l_aux) and every
    parameter's gradient: Mixtral with second-expert sampling (the
    capacity route) and Qwen2-MoE (top-4 on the grouped GEMM, shared
    expert, qkv bias), fp32."""
    jcfg, tcfg = _mixtral_cfgs(remat=remat,
                               **(QWEN if name == "qwen" else {}))
    toks = _tokens(6)
    key = jax.random.PRNGKey(13)
    _, _, jloss = jmixtral.make_model(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, moe_weights[name]),
        {"tokens": jnp.asarray(toks)}, key)
    flat = flatten(family_params_from_numpy(moe_weights[name], tcfg,
                                            device="cpu",
                                            dtype=torch.float32))
    for v in flat.values():
        v.requires_grad_(True)
    _, _, tloss = tmixtral.make_model(tcfg)
    tl = tloss(unflatten(flat), {"tokens": torch.from_numpy(toks)},
               trandom.as_key(key))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jgf = _grads_by_path(jg)
    assert set(jgf) == set(flat)
    for n, v in flat.items():
        _close(v.grad, jgf[n], msg=n)


def _ds():
    return {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2, "seed": 5,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0,
                                     "warmup_max_lr": 1e-3,
                                     "warmup_num_steps": 4}},
            "gradient_clipping": 1.0, "steps_per_print": 1000}


STEPS = 5


@pytest.fixture(scope="module")
def jax_trajectories(moe_weights):
    """Each family's 5 JAX-engine losses (fp32, gas 2) and the batches;
    one engine a family."""
    out = {}
    topo = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    batches = [_tokens(20 + i, B=4) for i in range(STEPS)]
    for name in ("mixtral", "qwen"):
        jcfg, _ = _mixtral_cfgs(**(QWEN if name == "qwen" else {}))
        _, _, jloss = jmixtral.make_model(jcfg)
        jeng, *_ = dstpu.initialize(
            loss_fn=jloss, params=jax.tree.map(jnp.asarray,
                                               moe_weights[name]),
            config=_ds(), topology=topo)
        out[name] = [float(jeng.train_batch({"tokens": jnp.asarray(b)}))
                     for b in batches]
    return batches, out


@pytest.mark.parametrize("name", ["mixtral", "qwen"])
@pytest.mark.parametrize("api", ["train_batch", "trio"])
def test_moe_trajectory_matches_the_jax_engine(moe_weights, jax_trajectories,
                                               name, api):
    """5 steps through ``train_batch`` or the trio (remat on there):
    Mixtral draws its second-expert noise from the engine's keys each
    micro-batch; the losses within 1e-6 relative of the JAX engine's."""
    batches, want = jax_trajectories
    _, tcfg = _mixtral_cfgs(remat=(api == "trio"),
                            **(QWEN if name == "qwen" else {}))
    _, _, tloss = tmixtral.make_model(tcfg)
    eng, *_ = initialize(loss_fn=tloss, config=_ds(), device="cpu",
                         params=family_params_from_numpy(
                             moe_weights[name], tcfg, device="cpu",
                             dtype=torch.float32))
    got = []
    for b in batches:
        t = torch.from_numpy(b)
        if api == "train_batch":
            got.append(float(eng.train_batch({"tokens": t})))
            continue
        for i in range(2):
            eng.forward({"tokens": t[2 * i:2 * i + 2]})
            eng.backward()
        got.append(float(eng.step()))
    np.testing.assert_allclose(got, want[name], rtol=1e-6)
