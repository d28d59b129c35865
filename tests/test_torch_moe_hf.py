"""Port parity for the HF path of the MoE families (Mixtral, Qwen2-MoE) on
the CPU: checkpoints written in the test by ``transformers`` (no
download), the JAX tests' shapes (``tests/unit/test_hf_loader.py``
``TestMoEParity``).

- The registry: ``config_from_hf`` on the published ``config.json`` of
  Mixtral-8x7B and Qwen1.5-MoE-A2.7B gives the JAX package's fields; a
  Qwen2-MoE config with dense layers interleaved raises the JAX
  ``ValueError`` in both.
- Both packages' ``load_hf_model`` trees are equal bit for bit (fp32
  shards; the per-expert weights stacked into ``[E, in, out]``); a
  checkpoint missing an expert raises.
- ``build_hf_engine``'s greedy tokens (fp32) equal ``transformers``'
  greedy continuation and the JAX factory's: the three JAX serving tests
  (Mixtral; Qwen2-MoE; both ``norm_topk_prob`` modes), at pipeline depth
  0 as the JAX tests serve and at depth 2 through the decode loop.
- Qwen2-MoE under ``quantization_mode="wf8"``: every leaf the JAX
  factory's bit for bit (the shared expert's projections quantized, the
  expert stacks and router dense: the factory's module list) and the
  same tokens.
"""

import json

import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint import hf_loader as jhf
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.inference.v2.engine_factory import \
    build_hf_engine as jax_build_hf_engine
from deepspeed_tpu.models import registry as jreg
from deepspeed_tpu_torch.checkpoint import hf_loader as thf
from deepspeed_tpu_torch.inference.v2 import (RaggedInferenceConfig,
                                              build_hf_engine)
from deepspeed_tpu_torch.models import registry as treg
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from deepspeed_tpu_torch.ops.kernels import QuantizedTensor

transformers = pytest.importorskip("transformers")

#: the JAX serving tests' engine (TestMoEParity._serve)
JAX_TEST_KW = dict(max_seqs=2, chunk_size=8, block_size=4, num_blocks=64,
                   max_blocks_per_seq=16, dtype="float32")
PROMPT = [int(t) for t in np.random.RandomState(8).randint(1, 90, 8)]
NEW_TOKENS = 4


def _hf_model(name):
    """The JAX tests' tiny models (``TestMoEParity``), seeded."""
    t = transformers
    torch.manual_seed(sorted(_MODELS).index(name))
    common = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
                  num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=2, max_position_embeddings=64,
                  tie_word_embeddings=False)
    if name == "mixtral":
        return t.MixtralForCausalLM(t.MixtralConfig(
            num_local_experts=4, num_experts_per_tok=2, **common)).eval()
    return t.Qwen2MoeForCausalLM(t.Qwen2MoeConfig(
        moe_intermediate_size=24, shared_expert_intermediate_size=40,
        num_experts=4, num_experts_per_tok=2, decoder_sparse_step=1,
        norm_topk_prob=name == "qwen2_moe_norm", **common)).eval()


_MODELS = ("mixtral", "qwen2_moe", "qwen2_moe_norm")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """name -> (checkpoint directory, the transformers model), written
    once."""
    made = {}

    def get(name):
        if name not in made:
            m = _hf_model(name)
            d = tmp_path_factory.mktemp(name)
            m.save_pretrained(d)
            made[name] = (str(d), m)
        return made[name]
    return get


def _walk(j, t, path=()):
    """Both trees have the same paths; yields (path, JAX leaf, port
    leaf)."""
    assert set(j) == set(t), (path, sorted(j), sorted(t))
    for k in j:
        if isinstance(j[k], dict):
            yield from _walk(j[k], t[k], path + (k,))
        else:
            yield path + (k,), j[k], t[k]


def _greedy(m, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        with torch.no_grad():
            logits = m(torch.tensor([toks])).logits
        toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


@pytest.mark.parametrize("name", _MODELS)
def test_hf_tree_equals_jax_loader(ckpt, name):
    d, _ = ckpt(name)
    jarch, jcfg, jtree = jhf.load_hf_model(d)
    arch, cfg, tree = thf.load_hf_model(d, device="cpu")
    assert arch == jarch and isinstance(cfg, MixtralConfig)
    assert cfg.norm_topk_prob == jcfg.norm_topk_prob
    n = 0
    for path, a, b in _walk(jtree, tree):
        assert b.dtype == torch.float32, path
        assert np.array_equal(np.asarray(a), b.numpy()), path
        n += 1
    stacks = tree["layer_1"]["moe"]
    assert tuple(stacks["wi_gate"].shape) == (4, 32, cfg.intermediate_size)
    assert tuple(stacks["wo"].shape) == (4, cfg.intermediate_size, 32)
    assert n > 20


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("name", _MODELS)
def test_build_hf_engine_equals_transformers_and_jax(ckpt, name, depth):
    """The JAX serving tests through the port's factory (depth 0, their
    engine), and at depth 2 through the decode loop over the plain paged
    path: transformers' greedy tokens, and the JAX factory's."""
    d, m = ckpt(name)
    kw = dict(JAX_TEST_KW)
    if depth:
        kw.update(serve_pipeline_depth=2, decode_loop_steps=2,
                  attention_impl="paged_flash")
    else:
        kw.update(serve_pipeline_depth=0)
    eng = build_hf_engine(d, engine_config=RaggedInferenceConfig(**kw),
                          dtype="float32", device="cpu")
    got = eng.generate([PROMPT], max_new_tokens=NEW_TOKENS)[0]
    assert got == _greedy(m, PROMPT, NEW_TOKENS)
    want = jax_build_hf_engine(d, engine_config=JaxRagged(**JAX_TEST_KW),
                               dtype="float32").generate(
        [PROMPT], max_new_tokens=NEW_TOKENS)[0]
    assert got == want
    assert eng.free_blocks == eng.config.num_blocks


def test_qwen2_moe_wf8_tree_is_jax_bit_for_bit(ckpt):
    d, m = ckpt("qwen2_moe")
    jeng = jax_build_hf_engine(d, engine_config=JaxRagged(**JAX_TEST_KW),
                               dtype="float32", quantization_mode="wf8")
    eng = build_hf_engine(d, engine_config=RaggedInferenceConfig(
        **JAX_TEST_KW), dtype="float32", quantization_mode="wf8",
        device="cpu")
    quantized = set()
    for path, w, g in _walk(jeng.params, eng.params):
        if isinstance(g, QuantizedTensor):
            quantized.add(path[1])
            for f in ("values", "scale"):
                assert np.array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(w, f))), (path, f)
            assert (tuple(g.shape), g.group_size, g.bits) \
                == (tuple(w.shape), w.group_size, w.bits)
        else:
            assert not hasattr(w, "_fields"), path
            assert np.array_equal(g.numpy(), np.asarray(w)), path
    assert quantized == {"attn", "shared_gate_proj", "shared_up_proj",
                         "shared_down_proj"}
    got = eng.generate([PROMPT], max_new_tokens=NEW_TOKENS)
    assert got == jeng.generate([PROMPT], max_new_tokens=NEW_TOKENS)


def test_missing_expert_raises(ckpt, tmp_path):
    """An expert stack that never fills (the checkpoint lacks an
    expert's tensors) raises, naming the layer and the stack."""
    d, _ = ckpt("mixtral")
    state = thf.load_hf_state_dict(d)
    del state["model.layers.1.block_sparse_moe.experts.2.w3.weight"]
    with open(f"{d}/config.json") as f:
        hf_cfg = json.load(f)
    with pytest.raises(ValueError, match="layer 1 wi_up"):
        thf.convert_hf_state("mixtral", state, hf_cfg=hf_cfg)


#: the published config.json fields the registry reads
#: (mistralai/Mixtral-8x7B-v0.1, Qwen/Qwen1.5-MoE-A2.7B)
PUBLISHED = {
    "mixtral": {"vocab_size": 32000, "max_position_embeddings": 32768,
                "hidden_size": 4096, "intermediate_size": 14336,
                "num_hidden_layers": 32, "num_attention_heads": 32,
                "num_key_value_heads": 8, "num_local_experts": 8,
                "num_experts_per_tok": 2, "rope_theta": 1e6,
                "rms_norm_eps": 1e-5, "router_aux_loss_coef": 0.02,
                "sliding_window": None, "tie_word_embeddings": False},
    "qwen2_moe": {"vocab_size": 151936, "max_position_embeddings": 8192,
                  "hidden_size": 2048, "intermediate_size": 5632,
                  "moe_intermediate_size": 1408,
                  "shared_expert_intermediate_size": 5632,
                  "num_hidden_layers": 24, "num_attention_heads": 16,
                  "num_key_value_heads": 16, "num_experts": 60,
                  "num_experts_per_tok": 4, "norm_topk_prob": False,
                  "decoder_sparse_step": 1, "mlp_only_layers": [],
                  "rope_theta": 1e6, "rms_norm_eps": 1e-6,
                  "router_aux_loss_coef": 0.001,
                  "tie_word_embeddings": False},
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_registry_entry_equals_jax(name):
    d = {"model_type": name, **PUBLISHED[name]}
    jarch, jcfg = jreg.config_from_hf(d)
    arch, cfg = treg.config_from_hf(d)
    assert arch == jarch == name and isinstance(cfg, MixtralConfig)
    fields = set(cfg.__dataclass_fields__) - {"dtype"}
    assert fields <= set(jcfg.__dataclass_fields__)
    for f in sorted(fields):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    if name == "qwen2_moe":
        assert (cfg.intermediate_size, cfg.shared_expert_size,
                cfg.num_experts, cfg.experts_top_k, cfg.qkv_bias,
                cfg.norm_topk_prob) == (1408, 5632, 60, 4, True, False)


@pytest.mark.parametrize("dense", [{"decoder_sparse_step": 2},
                                   {"mlp_only_layers": [0]}])
def test_interleaved_dense_qwen2_moe_raises(dense):
    d = {"model_type": "qwen2_moe", **PUBLISHED["qwen2_moe"], **dense}
    for reg in (jreg, treg):
        with pytest.raises(ValueError, match="dense layers interleaved"):
            reg.config_from_hf(d)
