"""Port parity for the HF path of the dense families of A5.4 (OPT, BLOOM,
GPT-NeoX, GPT-J, Phi; Falcon has no HF name map), on the CPU: checkpoints
written in the test by ``transformers`` (no download).

- The registry: ``config_from_hf`` on the published ``config.json`` of
  gpt-j-6b, bloom-7b1, gpt-neox-20b, opt-6.7b, opt-350m, phi-2 and
  falcon-7b gives the JAX package's fields.
- Both packages' ``load_hf_model`` trees are equal bit for bit (fp32
  shards; BLOOM's and NeoX's fused ``query_key_value`` split head by head;
  the tied heads dropped; ``attention.bias`` / ``masked_bias`` /
  ``rotary_emb.inv_freq`` buffers ignored).
- ``build_hf_engine``'s greedy tokens (fp32, the decode loop, pipeline
  depth 2) equal the JAX factory's and ``transformers``' own greedy
  continuation.
- BLOOM under ``quantization_mode="wf8"``: the quantized leaves are the
  JAX factory's bit for bit and the tokens agree.
- Falcon through ``build_hf_engine``: the JAX factory's ``ValueError``.
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
from deepspeed_tpu_torch.ops.kernels import QuantizedTensor

transformers = pytest.importorskip("transformers")

ENGINE_KW = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
                 max_blocks_per_seq=16, dtype="float32", decode_loop_steps=4,
                 serve_pipeline_depth=2, attention_impl="paged_flash")
PROMPTS = [np.random.default_rng(8).integers(1, 90, n).tolist()
           for n in (8, 13)]
NEW_TOKENS = 6


def _hf_model(fam):
    """A tiny random model of ``fam`` (the JAX tests' shapes; BLOOM at 6
    heads, no power of two), its weights moved off their init so that
    the logits are not flat."""
    torch.manual_seed(sorted(_FAMS).index(fam))
    t = transformers
    if fam == "opt":
        m = t.OPTForCausalLM(t.OPTConfig(
            vocab_size=96, hidden_size=48, ffn_dim=96, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            word_embed_proj_dim=48))
    elif fam == "opt_350m":
        m = t.OPTForCausalLM(t.OPTConfig(
            vocab_size=96, hidden_size=48, ffn_dim=96, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            word_embed_proj_dim=24, do_layer_norm_before=False))
    elif fam == "bloom":
        m = t.BloomForCausalLM(t.BloomConfig(
            vocab_size=96, hidden_size=48, n_layer=2, n_head=6,
            tie_word_embeddings=True))
    elif fam.startswith("gpt_neox"):
        m = t.GPTNeoXForCausalLM(t.GPTNeoXConfig(
            vocab_size=96, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64, rotary_pct=0.25,
            use_parallel_residual=fam == "gpt_neox",
            tie_word_embeddings=False))
    elif fam == "gptj":
        m = t.GPTJForCausalLM(t.GPTJConfig(
            vocab_size=96, n_embd=32, n_layer=2, n_head=4, n_positions=64,
            rotary_dim=8, tie_word_embeddings=False))
    elif fam == "phi":
        m = t.PhiForCausalLM(t.PhiConfig(
            vocab_size=96, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64, partial_rotary_factor=0.5))
    else:
        raise KeyError(fam)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return m.eval()


_FAMS = ("opt", "opt_350m", "bloom", "gpt_neox", "gpt_neox_sequential",
         "gptj", "phi")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """fam -> (checkpoint directory, the transformers model), written
    once."""
    made = {}

    def get(fam):
        if fam not in made:
            m = _hf_model(fam)
            d = tmp_path_factory.mktemp(fam)
            m.save_pretrained(d)
            made[fam] = (str(d), m)
        return made[fam]
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


@pytest.mark.parametrize("fam", _FAMS)
def test_hf_tree_equals_jax_loader(ckpt, fam):
    d, _ = ckpt(fam)
    jarch, jcfg, jtree = jhf.load_hf_model(d)
    arch, cfg, tree = thf.load_hf_model(d, device="cpu")
    assert arch == jarch and type(cfg).__name__ == type(jcfg).__name__
    n = 0
    for path, a, b in _walk(jtree, tree):
        assert b.dtype == torch.float32, path
        assert np.array_equal(np.asarray(a), b.numpy()), path
        n += 1
    assert n > 10


@pytest.mark.parametrize("fam", _FAMS)
def test_build_hf_engine_equals_jax_and_transformers(ckpt, fam):
    """fp32, the plain paged path, the decode loop in calls of 4, depth
    2: the port's tokens are the JAX factory's and transformers' greedy
    continuation."""
    d, m = ckpt(fam)
    eng = build_hf_engine(d, engine_config=RaggedInferenceConfig(
        **ENGINE_KW), dtype="float32", device="cpu")
    got = eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
    jkw = {**ENGINE_KW, "attention_impl": "dense"}
    want = jax_build_hf_engine(d, engine_config=JaxRagged(**jkw),
                               dtype="float32").generate(
        PROMPTS, max_new_tokens=NEW_TOKENS)
    assert got == want
    for p, g in zip(PROMPTS, got):
        toks = list(p)
        for _ in range(NEW_TOKENS):
            with torch.no_grad():
                logits = m(torch.tensor([toks])).logits
            toks.append(int(logits[0, -1].argmax()))
        assert g == toks[len(p):]
    assert eng.free_blocks == eng.config.num_blocks


def test_bloom_wf8_tree_is_jax_bit_for_bit(ckpt):
    """BLOOM through both factories' ``quantization_mode="wf8"`` (the
    JAX module lists: q/k/v_proj quantized, the rest dense): every leaf
    the JAX factory's bit for bit, and the same tokens."""
    d, _ = ckpt("bloom")
    kw = {**ENGINE_KW, "attention_impl": "dense"}
    jeng = jax_build_hf_engine(d, engine_config=JaxRagged(**kw),
                               dtype="float32", quantization_mode="wf8")
    eng = build_hf_engine(d, engine_config=RaggedInferenceConfig(**kw),
                          dtype="float32", quantization_mode="wf8",
                          device="cpu")
    n_q = 0
    for path, w, g in _walk(jeng.params, eng.params):
        if isinstance(g, QuantizedTensor):
            n_q += 1
            assert g.bits == w.bits == 8, path
            for f in ("values", "scale"):
                assert np.array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(w, f))), (path, f)
            assert (tuple(g.shape), g.group_size) == (tuple(w.shape),
                                                      w.group_size)
        else:
            assert not hasattr(w, "_fields"), path
            assert np.array_equal(g.numpy(), np.asarray(w)), path
    assert n_q == 3 * 2                     # q/k/v_proj of two layers
    assert eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS) \
        == jeng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)


def test_falcon_is_not_servable_through_build_hf_engine(tmp_path):
    """Falcon has no HF name map in either loader: both factories raise
    ValueError before a shard is read; InferenceEngineV2 serves its
    config (tests/test_torch_family_runners.py)."""
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "falcon", **_PUBLISHED["falcon"]}))
    (tmp_path / "model.safetensors").write_bytes(b"\xff" * 64)
    with pytest.raises(ValueError, match="not servable"):
        jax_build_hf_engine(str(tmp_path))
    with pytest.raises(ValueError, match="not servable"):
        build_hf_engine(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="no HF name map"):
        thf.load_hf_model(str(tmp_path), device="cpu")


#: the published config.json fields the registry reads (EleutherAI/gpt-j-6b,
#: bigscience/bloom-7b1, EleutherAI/gpt-neox-20b, facebook/opt-6.7b,
#: facebook/opt-350m, microsoft/phi-2, tiiuae/falcon-7b)
_PUBLISHED = {
    "gptj": {"vocab_size": 50400, "n_positions": 2048, "n_layer": 28,
             "n_embd": 4096, "n_head": 16, "rotary_dim": 64, "n_inner": None,
             "layer_norm_epsilon": 1e-5, "tie_word_embeddings": False},
    "bloom": {"vocab_size": 250880, "n_layer": 30, "n_head": 32,
              "hidden_size": 4096, "layer_norm_epsilon": 1e-5},
    "gpt_neox": {"vocab_size": 50432, "max_position_embeddings": 2048,
                 "num_hidden_layers": 44, "num_attention_heads": 64,
                 "hidden_size": 6144, "intermediate_size": 24576,
                 "rotary_pct": 0.25, "rotary_emb_base": 10000,
                 "layer_norm_eps": 1e-5, "use_parallel_residual": True,
                 "tie_word_embeddings": False},
    "opt": {"vocab_size": 50272, "max_position_embeddings": 2048,
            "num_hidden_layers": 32, "num_attention_heads": 32,
            "hidden_size": 4096, "ffn_dim": 16384,
            "do_layer_norm_before": True, "word_embed_proj_dim": 4096},
    "opt_350m": {"vocab_size": 50272, "max_position_embeddings": 2048,
                 "num_hidden_layers": 24, "num_attention_heads": 16,
                 "hidden_size": 1024, "ffn_dim": 4096,
                 "do_layer_norm_before": False, "word_embed_proj_dim": 512},
    "phi": {"vocab_size": 51200, "max_position_embeddings": 2048,
            "num_hidden_layers": 32, "num_attention_heads": 32,
            "hidden_size": 2560, "intermediate_size": 10240,
            "partial_rotary_factor": 0.4, "rope_theta": 10000.0},
    "falcon": {"vocab_size": 65024, "num_hidden_layers": 32,
               "num_attention_heads": 71, "hidden_size": 4544,
               "multi_query": True, "parallel_attn": True, "alibi": False,
               "new_decoder_architecture": False},
}
#: (heads, KV heads, head dim) of each published config
_HEADS = {"gptj": (16, 16, 256), "bloom": (32, 32, 128),
          "gpt_neox": (64, 64, 96), "opt": (32, 32, 128),
          "opt_350m": (16, 16, 64), "phi": (32, 32, 80),
          "falcon": (71, 1, 64)}


@pytest.mark.parametrize("name", sorted(_PUBLISHED))
def test_registry_entry_equals_jax(name):
    d = {"model_type": name.split("_350m")[0], **_PUBLISHED[name]}
    jarch, jcfg = jreg.config_from_hf(d)
    arch, cfg = treg.config_from_hf(d)
    assert arch == jarch == d["model_type"]
    fields = set(cfg.__dataclass_fields__) - {"dtype", "param_dtype"}
    assert fields <= set(jcfg.__dataclass_fields__)
    for f in sorted(fields):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
    assert (cfg.num_heads, kv, cfg.head_dim) == _HEADS[name]
