"""Port parity for GPT-2 dropout and progressive layer drop, against the
JAX package on the CPU.

- **The dropout kernel's plain version** (``ops/kernels/dropout.py``,
  which the CUDA kernel is held to bit for bit on the card) against flax's
  ``nn.Dropout`` under the same key: bf16, fp16 and fp32, rates 0.1 and
  0.5, an odd length; the output and its VJP bit for bit.
- **GPT-2 tiny with dropout 0.1**, remat off and on under ``full`` and
  ``qkv_out``: every site's key and mask, forward and recompute, bit-equal
  to flax's (captured inside the JAX model through
  ``jax.debug.callback``); the loss within 1e-6 relative and every
  gradient within 1e-6 of the largest gradient of the JAX model's (fp32
  rounding in another order).
- ``eval_batch`` applies dropout under ``PRNGKey(0)``, as the JAX engine
  does; serving ignores it.
- **PLD**: theta, ``layer_keep_prob`` and ``stochastic_depth_block`` bit
  for bit against ``deepspeed_tpu/runtime/progressive_layer_drop.py``.

The JAX weights are seeded numpy draws (``seeded_tree``); the JAX model is
jitted once per remat mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn
import flax.linen.stochastic as flax_stochastic
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.checkpoint import gpt2_params_from_numpy
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.kernels import dropout as kdropout
from deepspeed_tpu_torch.runtime import progressive_layer_drop as pld
from deepspeed_tpu_torch.utils import random as trandom
from deepspeed_tpu_torch.utils.tree import flatten, unflatten
from torch_port_cases import seeded_tree

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16)}


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_dropout_equals_flax(dtype, rate):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 37)).astype(np.float32)
    dy = rng.standard_normal((3, 37)).astype(np.float32)
    key = jax.random.PRNGKey(42)
    drop = nn.Dropout(rate)

    def f(x_):
        return drop.apply({}, x_, deterministic=False,
                          rngs={"dropout": key})

    want, vjp = jax.vjp(f, jnp.asarray(x, jd))
    (want_dx,) = vjp(jnp.asarray(dy, jd))
    # the key flax's Dropout draws at the root scope: make_rng, counter 1
    tkey = trandom.make_rng(trandom.as_key(np.asarray(key)), ())
    tx = torch.tensor(x).to(td).requires_grad_()
    got = kdropout.dropout(tx, tkey, rate)
    (got_dx,) = torch.autograd.grad(got, tx, torch.tensor(dy).to(td))
    for g, w in ((got, want), (got_dx, want_dx)):
        g = g.detach()
        g = g.view(torch.int16) if g.element_size() == 2 else \
            g.view(torch.int32)
        np.testing.assert_array_equal(g.numpy().view(_bits(w).dtype),
                                      _bits(w))
    kp, div = kdropout.keep_and_divisor(rate, td)
    assert kp == float(np.float32(1 - rate))
    assert div == float(jnp.asarray(1 - rate, jd).astype(jnp.float32))


def test_dropout_edges():
    x = torch.ones(5)
    key = trandom.PRNGKey(0)
    assert kdropout.dropout(x, key, 0.0) is x
    assert torch.equal(kdropout.dropout(x, key, 1.0), torch.zeros(5))
    with pytest.raises(ValueError):
        kdropout.dropout(x, key, 1.5)
    with pytest.raises(ValueError):
        kdropout.dropout(x, key.to(torch.int32), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        kdropout.dropout_fwd(x, key, 0.1)


# ------------------------------------------------------------ GPT-2


REMAT = {"off": dict(remat=False), "full": dict(remat=True),
         "qkv_out": dict(remat=True, remat_policy="qkv_out")}
SITES = [(f"h_{i}", s, "Dropout_0") for i in range(2) for s in ("attn", "mlp")]


@pytest.fixture(scope="module")
def gpt2_tree():
    j = jgpt2.GPT2Config.tiny(dtype=jnp.float32, attention_impl="xla")
    init = jgpt2.make_model(j)[1]
    return seeded_tree(lambda: init(jax.random.PRNGKey(0), 2, 17), seed=4)


def _jax_masks(loss_fn, params, batch, key):
    """Loss, grads and every (key, mask) flax's Dropouts draw, forward and
    recompute, through jax.debug.callback inside the jitted gradient."""
    seen = []
    inner = flax_stochastic.random.bernoulli

    def bernoulli(k, p, shape):
        mask = inner(k, p, shape)
        jax.debug.callback(lambda kk, mm: seen.append(
            (tuple(np.asarray(kk).tolist()), np.asarray(mm).ravel())),
            k, mask)
        return mask

    flax_stochastic.random.bernoulli = bernoulli
    try:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch,
                                                           key)
        jax.effects_barrier()
    finally:
        flax_stochastic.random.bernoulli = inner
    return float(loss), grads, seen


@pytest.mark.parametrize("remat", list(REMAT))
def test_gpt2_dropout_masks_loss_and_grads(gpt2_tree, remat, monkeypatch):
    kw = dict(dropout=0.1, attention_impl="xla", **REMAT[remat])
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, **kw)
    tcfg = tgpt2.GPT2Config.tiny(dtype=torch.float32, **kw)
    toks = np.random.default_rng(1).integers(0, 512, (2, 17)).astype(
        np.int32)
    key = jax.random.PRNGKey(9)
    jl, jg, jseen = _jax_masks(
        jgpt2.make_model(jcfg)[2], jax.tree.map(jnp.asarray, gpt2_tree),
        {"tokens": jnp.asarray(toks)}, key)

    seen = []
    inner = kdropout.dropout

    def dropout(x, k, rate):
        keep = trandom.bernoulli(k, 1 - rate, x.numel())
        seen.append((tuple(k.tolist()), keep.numpy()))
        return inner(x, k, rate)

    monkeypatch.setattr(kdropout, "dropout", dropout)
    flat = flatten(gpt2_params_from_numpy(gpt2_tree, tcfg, device="cpu"))
    for v in flat.values():
        v.requires_grad_(True)
    tl = tgpt2.make_model(tcfg)[2](unflatten(flat),
                                   {"tokens": torch.from_numpy(toks)},
                                   trandom.as_key(np.asarray(key)))
    tl.backward()

    # the keys are flax's make_rng at each site's scope path
    tkey = trandom.as_key(np.asarray(key))
    site_keys = {tuple(trandom.make_rng(tkey, s).tolist()) for s in SITES}
    n = len(SITES) * (1 if remat == "off" else 2)
    assert len(jseen) == len(seen) == n
    assert {k for k, _ in jseen} == {k for k, _ in seen} == site_keys
    for (jk, jm), (tk, tm) in zip(sorted(jseen, key=lambda e: e[0]),
                                  sorted(seen, key=lambda e: e[0])):
        assert jk == tk
        np.testing.assert_array_equal(tm, jm.astype(bool))
    np.testing.assert_allclose(tl.item(), jl, rtol=1e-6)
    jgf = {".".join(str(k.key) for k in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert set(jgf) == set(flat)
    # within 1e-6 of the largest gradient (fp32 rounding of the same
    # products summed in another order; one leaf's small entries carry
    # the error of the products that feed them, ~2e-6 of that leaf's max)
    top = max(np.abs(g).max() for g in jgf.values())
    for name, v in flat.items():
        np.testing.assert_allclose(v.grad.numpy(), jgf[name], rtol=1e-6,
                                   atol=1e-6 * top, err_msg=name)


def test_eval_applies_dropout_and_serving_ignores_it(gpt2_tree, monkeypatch):
    """``eval_batch`` is the loss under ``PRNGKey(0)`` with dropout on (the
    JAX engine passes its key whatever the mode); a ragged engine serves a
    dropout config's weights without a dropout call."""
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32, dropout=0.1,
                                attention_impl="xla")
    params = gpt2_params_from_numpy(gpt2_tree, cfg, device="cpu")
    _, _, loss_fn = tgpt2.make_model(cfg)
    eng, *_ = initialize(loss_fn=loss_fn, params=params, device="cpu",
                         config={"train_batch_size": 2})
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (2, 17)))}
    got = eng.eval_batch(batch)
    assert torch.equal(got, loss_fn(params, batch, trandom.PRNGKey(0)))
    assert not torch.equal(got, eng.eval_batch(batch, rng=trandom.PRNGKey(1)))
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    rc = dict(max_seqs=2, chunk_size=8, block_size=4, num_blocks=32,
              max_blocks_per_seq=8, dtype="float32", attention_impl="dense")
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    plain = InferenceEngineV2(
        tgpt2.GPT2Config.tiny(dtype=torch.float32), params,
        RaggedInferenceConfig(**rc), device="cpu").generate(
            prompts, max_new_tokens=4)

    def no_dropout(*a, **k):
        raise AssertionError("serving applied dropout")
    monkeypatch.setattr(kdropout, "dropout", no_dropout)
    served = InferenceEngineV2(cfg, params, RaggedInferenceConfig(**rc),
                               device="cpu").generate(prompts,
                                                      max_new_tokens=4)
    assert served == plain


# --------------------------------------------------------------- PLD


def test_pld_theta_matches_jax():
    a, b = pld.ProgressiveLayerDrop(0.5, 0.01), jpld.ProgressiveLayerDrop(
        0.5, 0.01)
    for step in (0, 1, 100, 10**6):
        assert a.update_state(step) == b.update_state(step)
        assert a.get_state() == b.get_state()
    assert a.get_theta() == pytest.approx(0.5)


@pytest.mark.parametrize("theta", [0.5, 0.9, 1 / 3])
def test_pld_keep_prob_and_block_match_jax(theta):
    """``layer_keep_prob`` bit for bit (fp32) at every layer of 12, and
    ``stochastic_depth_block`` over 64 keys and three layers: the same
    blocks kept and the same outputs, bit for bit; ``deterministic``
    keeps every block."""
    for i in range(12):
        got = pld.layer_keep_prob(theta, i, 12)
        want = np.asarray(jpld.layer_keep_prob(theta, i, 12))
        assert got.dtype == torch.float32
        assert got.numpy().view(np.uint32) == want.view(np.uint32), i
    h = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 64)
    for layer in (0, 5, 11):
        want = np.asarray(jax.vmap(lambda k: jpld.stochastic_depth_block(
            lambda x: x * 2, jnp.asarray(h), k, theta, layer, 12))(keys))
        got = np.stack([pld.stochastic_depth_block(
            lambda x: x * 2, torch.tensor(h), trandom.as_key(np.asarray(k)),
            theta, layer, 12).numpy() for k in keys])
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    det = pld.stochastic_depth_block(lambda x: x * 2, torch.ones(2, 4),
                                     trandom.PRNGKey(0), theta, 11, 12,
                                     deterministic=True)
    assert torch.equal(det, torch.full((2, 4), 3.0))
