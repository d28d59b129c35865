"""Port parity for ``build_hf_engine``: HuggingFace checkpoint directories
written in the test (no download) served by both packages on the CPU.

- llama (untied and tied), mistral (a window shorter than the prompts),
  qwen2 and phi3 written by ``transformers``; qwen v1 (not in
  ``transformers``) written by hand in its fused layout as a
  ``pytorch_model.bin``. Both packages' ``build_hf_engine`` on the same
  directory give identical greedy tokens in fp32 at pipeline depth 0.
- Parameter trees: bf16 shards load as bf16 and equal the JAX loader's
  widened fp32 in value; fp32 shards bit for bit; a ``.bin`` checkpoint
  loads the same tree as its safetensors twin.
- ``quantization_mode`` wf8 / wf4: the quantized trees are the JAX
  factory's bit for bit.
- The registry: ``config_from_hf`` gives the JAX package's fields for
  every Llama-family entry (internlm's ``bias=True`` refused as JAX
  refuses it); unported architectures raise ``NotImplementedError``
  naming their queue item before any shard is read; unknown and
  unservable ones raise JAX's ``ValueError``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint import hf_loader as jhf
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.inference.v2.engine_factory import \
    build_hf_engine as jax_build_hf_engine
from deepspeed_tpu.models import registry as jreg
from deepspeed_tpu_torch.checkpoint import hf_loader as thf
from deepspeed_tpu_torch.checkpoint import woq_params_from_numpy
from deepspeed_tpu_torch.inference.v2 import (RaggedInferenceConfig,
                                              build_hf_engine)
from deepspeed_tpu_torch.models import registry as treg
from deepspeed_tpu_torch.ops.kernels import QuantizedTensor

transformers = pytest.importorskip("transformers")

V, HID, INTER, LAYERS, HEADS, KVH = 128, 64, 128, 2, 4, 2
PROMPT_LENS = (5, 11, 19)
NEW_TOKENS = 8
ENGINE_KW = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
                 max_blocks_per_seq=16, dtype="float32", decode_loop_steps=4,
                 serve_pipeline_depth=0)
LLAMA_FAMILY = ("llama", "llama_tied", "mistral", "qwen2", "phi3", "qwen")


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, V, n).tolist() for n in PROMPT_LENS]


def _hf_model(arch):
    common = dict(vocab_size=V, hidden_size=HID, intermediate_size=INTER,
                  num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                  num_key_value_heads=KVH, max_position_embeddings=64,
                  tie_word_embeddings=arch == "llama_tied")
    torch.manual_seed(LLAMA_FAMILY.index(arch))
    if arch in ("llama", "llama_tied"):
        return transformers.LlamaForCausalLM(transformers.LlamaConfig(
            **common))
    if arch == "mistral":
        return transformers.MistralForCausalLM(transformers.MistralConfig(
            sliding_window=6, **common))
    if arch == "qwen2":
        return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            **common))
    if arch == "phi3":
        return transformers.Phi3ForCausalLM(transformers.Phi3Config(
            pad_token_id=0, **common))
    raise KeyError(arch)


def _write_qwen_v1(path, dtype, safetensors=False):
    """A random qwen v1 checkpoint in its own fused layout (c_attn qkv
    with bias, w2 the gate, w1 the up projection, c_proj), the config's
    intermediate_size counting both SwiGLU branches."""
    g = torch.Generator().manual_seed(5)

    def w(*shape, std=0.1):
        return (torch.randn(*shape, generator=g) * std).to(dtype)
    sd = {"transformer.wte.weight": w(V, HID, std=1.0),
          "transformer.ln_f.weight": 1.0 + w(HID),
          "lm_head.weight": w(V, HID)}
    for i in range(LAYERS):
        pre = f"transformer.h.{i}"
        sd.update({f"{pre}.ln_1.weight": 1.0 + w(HID),
                   f"{pre}.ln_2.weight": 1.0 + w(HID),
                   f"{pre}.attn.c_attn.weight": w(3 * HID, HID),
                   f"{pre}.attn.c_attn.bias": w(3 * HID),
                   f"{pre}.attn.c_proj.weight": w(HID, HID),
                   f"{pre}.mlp.w1.weight": w(INTER, HID),
                   f"{pre}.mlp.w2.weight": w(INTER, HID),
                   f"{pre}.mlp.c_proj.weight": w(HID, INTER)})
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "config.json", "w") as f:
        json.dump({"model_type": "qwen", "vocab_size": V,
                   "hidden_size": HID, "num_hidden_layers": LAYERS,
                   "num_attention_heads": HEADS,
                   "intermediate_size": 2 * INTER, "seq_length": 64,
                   "rotary_emb_base": 10000.0,
                   "layer_norm_epsilon": 1e-6}, f)
    if safetensors:
        from safetensors.torch import save_file
        save_file({k: v.contiguous() for k, v in sd.items()},
                  str(path / "model.safetensors"))
    else:
        torch.save(sd, path / "pytorch_model.bin")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(arch, shard dtype, format) -> a checkpoint directory, written
    once."""
    made = {}

    def get(arch, dtype=torch.float32, safetensors=True):
        key = (arch, dtype, safetensors)
        if key not in made:
            d = tmp_path_factory.mktemp(
                f"{arch}_{str(dtype)[6:]}_{'st' if safetensors else 'bin'}")
            if arch == "qwen":
                _write_qwen_v1(d, dtype, safetensors)
            else:
                _hf_model(arch).to(dtype).save_pretrained(
                    d, safe_serialization=safetensors)
            made[key] = d
        return str(made[key])
    return get


def _leaves(tree, path=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", LLAMA_FAMILY)
def test_loaded_tree_equals_jax(ckpt, arch, dtype):
    d = ckpt(arch, dtype)
    jarch, _, jparams = jhf.load_hf_model(d)
    tarch, cfg, params = thf.load_hf_model(d, device="cpu")
    assert tarch == jarch == arch.split("_")[0]
    want, got = dict(_leaves(jparams)), dict(_leaves(params))
    assert sorted(got) == sorted(want)
    assert ("lm_head/kernel" in got) == (arch != "llama_tied")
    for path, g in got.items():
        assert g.dtype == dtype, path
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        if dtype == torch.float32:
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          w.view(np.int32), err_msg=path)
        else:
            np.testing.assert_array_equal(g.float().numpy(), w,
                                          err_msg=path)


def test_bin_checkpoint_loads_as_its_safetensors_twin(ckpt):
    """A ``.bin`` checkpoint gives its safetensors twin's tree; so does
    the state-dict path (``load_hf_state_dict`` + ``convert_hf_state``,
    strict, with phi3's split), which refuses an unmapped tensor."""
    d_st = ckpt("llama", torch.bfloat16, safetensors=True)
    d_bin = ckpt("llama", torch.bfloat16, safetensors=False)
    _, _, a = thf.load_hf_model(d_st, device="cpu")
    _, _, b = thf.load_hf_model(d_bin, device="cpu")
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    d_phi = ckpt("phi3", torch.bfloat16)
    hf_cfg = json.load(open(f"{d_phi}/config.json"))
    state = thf.load_hf_state_dict(d_phi)
    conv = dict(_leaves(thf.convert_hf_state("phi3", state, hf_cfg=hf_cfg)))
    loaded = dict(_leaves(thf.load_hf_model(d_phi, device="cpu")[2]))
    assert sorted(conv) == sorted(loaded)
    for k in conv:
        assert torch.equal(conv[k], loaded[k]), k
    with pytest.raises(ValueError, match="no mapping"):
        thf.convert_hf_state("llama", {"model.extra.weight": state[
            "model.norm.weight"]})
    qs = thf.load_hf_model(ckpt("qwen", torch.float32, True), device="cpu")
    qb = thf.load_hf_model(ckpt("qwen", torch.float32, False), device="cpu")
    for (p, x), (_, y) in zip(_leaves(qs[2]), _leaves(qb[2])):
        assert torch.equal(x, y), p


def _engines(d, **kw):
    jeng = jax_build_hf_engine(d, dtype="float32", engine_config=JaxRagged(
        attention_impl="dense", **ENGINE_KW), **kw)
    eng = build_hf_engine(d, dtype="float32", engine_config=(
        RaggedInferenceConfig(**ENGINE_KW)), device="cpu", **kw)
    return jeng, eng


@pytest.mark.parametrize("arch,dtype", [(a, torch.float32)
                                        for a in LLAMA_FAMILY]
                         + [("llama", torch.bfloat16)])
def test_build_hf_engine_greedy_tokens_are_jax(ckpt, arch, dtype):
    jeng, eng = _engines(ckpt(arch, dtype, safetensors=arch != "qwen"))
    want = jeng.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    got = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    assert got == want
    assert eng.model_cfg.dtype == torch.float32
    assert eng.free_blocks == ENGINE_KW["num_blocks"]
    if arch == "mistral":
        assert eng.model_cfg.sliding_window == 6 < max(PROMPT_LENS)


@pytest.mark.parametrize("mode", ["wf8", "wf4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_woq_trees_are_jax_bit_for_bit(ckpt, mode, dtype):
    """qwen2 (biased q/k/v: 1-D leaves stay dense) through both
    factories' quantization_mode: every projection quantized, the codes,
    scales and metadata the JAX factory's; the engines' tokens equal."""
    jeng, eng = _engines(ckpt("qwen2", dtype), quantization_mode=mode)
    want = woq_params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                 eng.model_cfg, device="cpu")
    got = eng.params
    n_q = 0
    for (path, w), (path2, g) in zip(_leaves(want), _leaves(got)):
        assert path == path2 and type(w) is type(g), path
        if isinstance(g, QuantizedTensor):
            n_q += 1
            assert g.bits == {"wf8": 8, "wf4": 4}[mode]
            for f in ("values", "scale"):
                assert torch.equal(getattr(g, f), getattr(w, f)), (path, f)
            assert (g.zero, g.shape, g.group_size) == (w.zero, w.shape,
                                                       w.group_size)
        else:
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.float().numpy(), err_msg=path)
    assert n_q == 7 * LAYERS
    assert eng.generate(_prompts(), max_new_tokens=NEW_TOKENS) \
        == jeng.generate(_prompts(), max_new_tokens=NEW_TOKENS)


_HF_DICT = {"vocab_size": 1000, "max_position_embeddings": 2048,
            "num_hidden_layers": 3, "num_attention_heads": 8,
            "num_key_value_heads": 2, "hidden_size": 256,
            "intermediate_size": 688, "rope_theta": 5e5,
            "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
            "sliding_window": 128, "seq_length": 4096,
            "rotary_emb_base": 2e4, "layer_norm_epsilon": 1e-5}
_FIELDS = ("vocab_size", "max_seq_len", "num_layers", "num_heads",
           "num_kv_heads", "hidden_size", "intermediate_size", "rope_theta",
           "rms_eps", "sliding_window", "qkv_bias", "tie_embeddings")


@pytest.mark.parametrize("arch", ["llama", "mistral", "qwen", "qwen2",
                                  "phi3", "internlm", "internlm2"])
def test_config_from_hf_gives_jax_fields(arch):
    d = {"model_type": arch, **_HF_DICT}
    jname, jcfg = jreg.config_from_hf(d)
    tname, tcfg = treg.config_from_hf(d)
    assert tname == jname == arch
    assert {f: getattr(tcfg, f) for f in _FIELDS} \
        == {f: getattr(jcfg, f) for f in _FIELDS}
    assert tcfg.head_dim == jcfg.head_dim


def test_internlm_bias_is_refused_as_jax(tmp_path):
    d = {"model_type": "internlm", "bias": True, **_HF_DICT}
    for reg in (jreg, treg):
        with pytest.raises(ValueError, match="bias=True"):
            reg.config_from_hf(d)


@pytest.mark.parametrize("arch", ["internlm", "internlm2", "bert",
                                  "not_a_model"])
def test_unservable_archs_raise_jax_value_error(tmp_path, arch):
    """Not in JAX's build_hf_engine list: both factories raise ValueError
    before a shard is read (the directory holds none). internlm and
    internlm2 have no HF name map in either loader either; bert's config
    is not ported (A9)."""
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": arch, **_HF_DICT}))
    with pytest.raises(ValueError, match="not servable"):
        jax_build_hf_engine(str(tmp_path))
    with pytest.raises(ValueError, match="not servable"):
        build_hf_engine(str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError if arch == "bert"
                       else ValueError):
        thf.load_hf_model(str(tmp_path), device="cpu")


@pytest.mark.parametrize("arch", ["gpt2", "bloom", "mixtral", "opt", "phi",
                                  "gpt_neox", "gptj", "qwen2_moe"])
def test_unported_archs_raise_before_reading_shards(tmp_path, arch):
    """Architectures the JAX package serves whose runners wait for queue
    item A5.4: NotImplementedError naming it, though the shard is corrupt
    (it is never opened)."""
    (tmp_path / "config.json").write_text(json.dumps({"model_type": arch}))
    (tmp_path / "model.safetensors").write_bytes(b"\xff" * 64)
    with pytest.raises(NotImplementedError, match="A5.4"):
        build_hf_engine(str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="A5.4"):
        treg.get_arch(arch)


def test_registry_refusals():
    for arch in ("bert", "distilbert", "gpt_neo", "unet2dconditionmodel",
                 "autoencoderkl"):
        with pytest.raises(NotImplementedError, match="A9"):
            treg.get_arch(arch)
        jreg.get_arch(arch)                     # known to the JAX registry
    for reg in (jreg, treg):
        with pytest.raises(ValueError, match="unknown architecture"):
            reg.get_arch("not_a_model")
        with pytest.raises(ValueError, match="model_type"):
            reg.config_from_hf({})
    assert set(treg.ARCHITECTURES) | set(treg.NOT_PORTED) \
        == set(jreg.ARCHITECTURES)


def test_factory_refusals(ckpt):
    d = ckpt("llama")
    with pytest.raises(NotImplementedError, match="A5.2"):
        build_hf_engine(d, draft_model_dir=d, device="cpu")
    with pytest.raises(NotImplementedError, match="tp_size"):
        build_hf_engine(d, tp_size=2, device="cpu")
    with pytest.raises(ValueError, match="quantization_mode"):
        build_hf_engine(d, quantization_mode="wf6", device="cpu")
    eng = build_hf_engine(d, device="cpu")      # the defaults: bf16, depth 2
    assert eng.model_cfg.dtype == torch.bfloat16
    assert eng.pipeline_depth == 2
