"""Port parity for training the Llama family: the threefry key derivations
the JAX training path uses (``split``, flax's ``make_rng``), one step's
loss and gradients of the tiny Llama (GQA, tied and untied heads, the
chunked and fused LM-head losses, remat on and off, flash and plain
attention), the 5-step trajectories of ``Engine.train_batch`` and of the
``forward`` / ``backward`` / ``step`` trio against the JAX engine, and
the refusals.

Weights are seeded numpy draws over the flax initializer's tree
(``torch_port_cases.seeded_tree``) and cross to the port as numpy. The JAX engine is pinned to one device and built once for the
module. Tolerances: one step's loss and gradients 1e-5 relative in fp32
(summation order); trajectories 1e-6 relative (ROADMAP A7's parity
rule)."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.parallel import topology as jtopology
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.checkpoint import llama_params_from_numpy
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.utils import random as trandom
from deepspeed_tpu_torch.utils.tree import flatten, unflatten
from torch_port_cases import seeded_tree

V = 512


def _jax_grad_by_path(grads):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}


@pytest.fixture
def one_device():
    """A one-device JAX topology while the test runs (the fused JAX loss
    reads it; the session has 8 virtual CPU devices), then the old one."""
    old = jtopology._TOPOLOGY
    jtopology.set_topology(build_mesh(MeshConfig(data=1),
                                      devices=jax.devices()[:1]))
    yield
    jtopology._TOPOLOGY = old


def _tokens(seed, B=2, T=17):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(
        np.int32)


@pytest.fixture(scope="module")
def weights():
    """Seeded weights of the flax tree of the tiny Llama, tied and
    untied."""
    out = {}
    for tie in (False, True):
        cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, tie_embeddings=tie)
        _, init_fn, _ = jllama.make_model(cfg)
        out[tie] = seeded_tree(
            lambda: init_fn(jax.random.PRNGKey(0), seq_len=16))
    return out


def test_split_and_make_rng_are_bit_equal_to_jax():
    """``split`` against ``jax.random.split`` over several seeds and
    counts, ``make_rng`` against flax's derivation of a module's key
    (the SHA-1 of its path and counter folded in) for the paths the MoE
    layers use."""
    from flax.core.scope import LazyRng
    for seed in (0, 1, 42, 2 ** 31 - 1):
        for n in (1, 2, 3, 9):
            got = trandom.split(trandom.PRNGKey(seed), n).numpy()
            want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
            np.testing.assert_array_equal(got, want.astype(np.int64))
        root = jax.random.PRNGKey(seed)
        for path in (("layer_0", "moe"), ("layer_11", "moe"), ()):
            for counter in (1, 2):
                want = np.asarray(LazyRng.create(
                    root, *path, counter).as_jax_rng())
                got = trandom.make_rng(trandom.PRNGKey(seed), path,
                                       counter).numpy()
                np.testing.assert_array_equal(got, want.astype(np.int64))
    # the hash is flax's: the first four bytes of the SHA-1, big-endian
    h = hashlib.sha1(b"layer_0moe\x01").digest()
    assert trandom._static_hash(("layer_0", "moe", 1)) == \
        int.from_bytes(h[:4], "big")
    assert trandom.as_key(jax.random.PRNGKey(5)).tolist() == [0, 5]


CASES = [  # (tied, xent, remat, port attention)
    (False, "chunked", False, "xla"),
    (False, "fused", True, "xla"),
    (True, "chunked", True, "xla"),
    (True, "fused", False, "xla"),
    (False, "chunked", True, "flash"),
]


@pytest.mark.parametrize("tie,xent,remat,impl", CASES)
def test_llama_loss_and_grads_match_jax(weights, one_device, tie, xent,
                                        remat, impl):
    """One step's loss and every parameter's gradient of the tiny Llama
    (GQA 2) in fp32 against ``jax.value_and_grad`` of the JAX loss
    (``attention_impl="xla"``: flash on the JAX side would run the Pallas
    kernels in interpret mode; the port's ``"flash"`` runs the kernels'
    plain versions on CPU tensors)."""
    kw = dict(tie_embeddings=tie, xent_impl=xent, remat=remat)
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, attention_impl="xla",
                                   **kw)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, attention_impl=impl,
                                   **kw)
    toks = _tokens(1)
    _, _, jloss = jllama.make_model(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, weights[tie]),
        {"tokens": jnp.asarray(toks)}, None)
    flat = flatten(llama_params_from_numpy(weights[tie], tcfg, device="cpu",
                                           dtype=torch.float32))
    for v in flat.values():
        v.requires_grad_(True)
    _, _, tloss = tllama.make_model(tcfg)
    tl = tloss(unflatten(flat), {"tokens": torch.from_numpy(toks)})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jgf = _jax_grad_by_path(jg)
    assert set(jgf) == set(flat)
    for name, v in flat.items():
        np.testing.assert_allclose(v.grad.numpy(), jgf[name], rtol=1e-5,
                                   atol=1e-5 * np.abs(jgf[name]).max(),
                                   err_msg=name)


def test_llama_forward_logits_and_the_serving_oracle(weights):
    """The trainable forward's logits equal the JAX model's, and the
    no-grad serving oracle (``Llama(cfg, params)``) still gives them."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, attention_impl="xla")
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    toks = _tokens(2, T=12)
    want = np.asarray(jllama.Llama(jcfg).apply(
        {"params": weights[False]}, jnp.asarray(toks)))
    params = llama_params_from_numpy(weights[False], tcfg, device="cpu",
                                     dtype=torch.float32)
    model, _, _ = tllama.make_model(tcfg)
    got = model(params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    oracle = tllama.Llama(tcfg, params)(torch.from_numpy(toks))
    np.testing.assert_allclose(oracle.numpy(), want, rtol=1e-5, atol=1e-5)


def _ds():
    return {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0,
                                     "warmup_max_lr": 1e-3,
                                     "warmup_num_steps": 4}},
            "gradient_clipping": 1.0, "steps_per_print": 1000}


STEPS = 5


@pytest.fixture(scope="module")
def jax_trajectory(weights):
    """The JAX engine's 5 losses and grad norms on the untied tiny Llama
    (fp32, gas 2, chunked xent), and the batches."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, attention_impl="xla")
    _, _, jloss = jllama.make_model(jcfg)
    topo = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, *_ = dstpu.initialize(
        loss_fn=jloss, params=jax.tree.map(jnp.asarray, weights[False]),
        config=_ds(), topology=topo)
    batches = [_tokens(10 + i, B=4) for i in range(STEPS)]
    losses = [float(jeng.train_batch({"tokens": jnp.asarray(b)}))
              for b in batches]
    return batches, losses


def _port_engine(weights, **cfg_kw):
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    _, _, tloss = tllama.make_model(tcfg)
    eng, *_ = initialize(loss_fn=tloss, config=_ds(), device="cpu",
                         params=llama_params_from_numpy(
                             weights[False], tcfg, device="cpu",
                             dtype=torch.float32))
    return eng


@pytest.mark.parametrize("api", ["train_batch", "trio"])
def test_llama_trajectory_matches_the_jax_engine(weights, jax_trajectory,
                                                 api):
    """5 steps of the tiny Llama (AdamW with weight decay, WarmupLR, clip
    1.0, gas 2) through ``train_batch`` or ``forward`` / ``backward`` /
    ``step`` (remat on for the trio): the losses within 1e-6 relative of
    the JAX engine's."""
    batches, want = jax_trajectory
    eng = _port_engine(weights, remat=(api == "trio"))
    got = []
    for b in batches:
        t = torch.from_numpy(b)
        if api == "train_batch":
            got.append(float(eng.train_batch({"tokens": t})))
            continue
        for i in range(2):
            eng.forward({"tokens": t[2 * i:2 * i + 2]})
            eng.backward()
            assert eng.is_gradient_accumulation_boundary() == (i == 1)
            if i == 0:
                assert eng.step() is None
        got.append(float(eng.step()))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert eng.global_steps == STEPS and eng.state.step == STEPS


def test_engine_keys_follow_the_jax_engine(weights):
    """Each micro-batch's key is the JAX engine's: ``split(key, gas + 1)``
    a step from ``PRNGKey(seed)``, the first carried to the next step."""
    seen = []
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, num_layers=1)
    _, _, tloss = tllama.make_model(tcfg)

    def loss_fn(params, batch, key):
        seen.append(key.tolist())
        return tloss(params, batch, key)

    ds = dict(_ds(), seed=3)
    eng, *_ = initialize(loss_fn=loss_fn, config=ds, device="cpu",
                         params=tllama.make_model(tcfg)[1](seed=0,
                                                           device="cpu"))
    for i in range(2):
        eng.train_batch({"tokens": torch.from_numpy(_tokens(i, B=4))})
    key = jax.random.PRNGKey(3)
    want = []
    for _ in range(2):
        ks = jax.random.split(key, 3)
        key = ks[0]
        want += np.asarray(ks[1:]).astype(np.int64).tolist()
    assert seen == want


def test_llama_refusals():
    """A sliding window shorter than the sequence on the flash path and an
    unknown attention_impl raise, as in JAX."""
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, sliding_window=4,
                                  attention_impl="flash", num_layers=1)
    _, init_fn, loss_fn = tllama.make_model(cfg)
    params = init_fn(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="sliding window"):
        loss_fn(params, {"tokens": torch.zeros(1, 9, dtype=torch.long)})
    # a window the sequence fits in runs, and "xla" masks it
    loss_fn(params, {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    xla = tllama.make_model(tllama.LlamaConfig.tiny(
        dtype=torch.float32, sliding_window=4, attention_impl="xla",
        num_layers=1))[2]
    assert torch.isfinite(xla(params, {"tokens": torch.zeros(
        1, 9, dtype=torch.long)}))
    with pytest.raises(ValueError, match="attention_impl"):
        tllama.make_model(tllama.LlamaConfig.tiny(attention_impl="ring"))
