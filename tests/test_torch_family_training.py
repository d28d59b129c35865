"""Port parity for the dense families' training entry points (OPT, BLOOM,
GPT-NeoX, GPT-J, Falcon, Phi): each ``make_model``'s loss (``make_causal_lm``:
next-token NLL over full fp32 logits, plain attention, no kernel, as in
JAX) and every parameter's gradient against ``jax.value_and_grad`` of the
JAX family's loss, with remat on and off; and the registry's training
entry points against the JAX registry's.

Weights are seeded numpy draws over each flax tree (biases and norms not
trivial; ``torch_port_cases.seeded_tree``), carried across with
``family_params_from_numpy``.
Tolerance: 1e-5 relative in fp32 (the gradients: 1e-5 of each leaf's
largest element). Without rotary embedding (OPT, BLOOM) the key
projection's bias shifts every score of a row alike, so its gradient is
zero in exact arithmetic: there both packages' are held below 1e-4 of the
model's largest gradient element instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bloom as jbloom
from deepspeed_tpu.models import falcon as jfalcon
from deepspeed_tpu.models import gpt_neox as jneox
from deepspeed_tpu.models import opt as jopt
from deepspeed_tpu.models import phi as jphi
from deepspeed_tpu.models import registry as jreg
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.checkpoint import family_params_from_numpy
from deepspeed_tpu_torch.models import bloom as tbloom
from deepspeed_tpu_torch.models import falcon as tfalcon
from deepspeed_tpu_torch.models import gpt_neox as tneox
from deepspeed_tpu_torch.models import opt as topt
from deepspeed_tpu_torch.models import phi as tphi
from deepspeed_tpu_torch.models import registry as treg
from deepspeed_tpu_torch.utils.tree import flatten, unflatten
from torch_port_cases import seeded_tree

#: variant -> (JAX make, JAX config, port make, port config, overrides)
VARIANTS = {
    "opt": (jopt.make_model, jopt.OPTConfig, topt.make_model,
            topt.OPTConfig, {"max_seq_len": 30}),
    "opt_350m": (jopt.make_model, jopt.OPTConfig, topt.make_model,
                 topt.OPTConfig, {"max_seq_len": 30,
                                  "do_layer_norm_before": False,
                                  "word_embed_proj_dim": 24}),
    "bloom": (jbloom.make_model, jbloom.BloomConfig, tbloom.make_model,
              tbloom.BloomConfig, {}),
    "gpt_neox": (jneox.make_model_neox, jneox.GPTNeoXConfig,
                 tneox.make_model_neox, tneox.GPTNeoXConfig, {}),
    "gptj": (jneox.make_model_gptj, jneox.GPTJConfig, tneox.make_model_gptj,
             tneox.GPTJConfig, {}),
    "falcon": (jfalcon.make_model, jfalcon.FalconConfig, tfalcon.make_model,
               tfalcon.FalconConfig, {}),
    "falcon_alibi_new_arch": (jfalcon.make_model, jfalcon.FalconConfig,
                              tfalcon.make_model, tfalcon.FalconConfig,
                              {"alibi": True, "num_kv_heads": 2,
                               "new_decoder_architecture": True}),
    "phi": (jphi.make_model, jphi.PhiConfig, tphi.make_model,
            tphi.PhiConfig, {}),
}


def _grads_by_path(grads):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}


@pytest.mark.parametrize("name,remat", [
    (n, i % 2 == 1) for i, n in enumerate(VARIANTS)])
def test_family_loss_and_grads_match_jax(name, remat):
    jmake, jcfg_cls, tmake, tcfg_cls, over = VARIANTS[name]
    jcfg = jcfg_cls.tiny(dtype=jnp.float32, remat=remat, **over)
    tcfg = tcfg_cls.tiny(dtype=torch.float32, remat=remat, **over)
    _, init_fn, jloss = jmake(jcfg)
    tree = seeded_tree(lambda: init_fn(jax.random.PRNGKey(0), seq_len=8))
    params = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(3).integers(0, 512, (2, 13)).astype(
        np.int32)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        params, {"tokens": jnp.asarray(toks)}, jax.random.PRNGKey(0))
    flat = flatten(family_params_from_numpy(tree, tcfg, device="cpu"))
    for v in flat.values():
        v.requires_grad_(True)
    _, _, tloss = tmake(tcfg)
    tl = tloss(unflatten(flat), {"tokens": torch.from_numpy(toks)})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jgf = _grads_by_path(jg)
    assert set(jgf) == set(flat)
    top = max(float(np.abs(g).max()) for g in jgf.values())
    for n, v in flat.items():
        if n.endswith("k_proj.bias") and name.startswith(("opt", "bloom")):
            assert max(float(v.grad.abs().max()),
                       float(np.abs(jgf[n]).max())) < 1e-4 * top, n
            continue
        np.testing.assert_allclose(v.grad.numpy(), jgf[n], rtol=1e-5,
                                   atol=1e-5 * np.abs(jgf[n]).max(),
                                   err_msg=n)


def test_every_ported_family_has_the_jax_training_entry_point():
    """Each architecture both registries carry has a ``make_model`` in the
    port's entry (the JAX registry's ``make_model`` field); one step of
    each dense family trains on the CPU through the engine."""
    for arch, entry in treg.ARCHITECTURES.items():
        jentry = jreg.ARCHITECTURES[arch]
        assert jentry.make_model is not None, arch
        assert callable(entry.make_model), arch
        assert entry.make_model.__name__ == jentry.make_model.__name__, arch
    ds = {"train_batch_size": 2, "optimizer": {"type": "AdamW",
                                               "params": {"lr": 1e-2}}}
    toks = torch.randint(0, 512, (2, 9))
    for arch in ("opt", "bloom", "gpt_neox", "gptj", "falcon", "phi"):
        cfg = treg.get_arch(arch).config_cls.tiny(dtype=torch.float32,
                                                  num_layers=1)
        _, init_fn, loss_fn = treg.get_arch(arch).make_model(cfg)
        eng, *_ = initialize(loss_fn=loss_fn, config=ds, device="cpu",
                             params=init_fn(seed=0, device="cpu"))
        first = float(eng.train_batch({"tokens": toks}))
        last = float(eng.train_batch({"tokens": toks}))
        assert np.isfinite(first) and last < first, arch
