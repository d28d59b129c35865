"""Port parity for the GPT-2 ragged runner, on the CPU: the JAX package's
GPT-2 (fp32) served by both engines.

- ``_gpt2_ragged_step``'s last-token logits against the JAX runner's, a
  prefill chunk and a decode step, over dense attention and over
  ``paged_flash`` (the kernels' plain versions on the CPU).
- ``put`` / ``decode_pipelined`` and ``generate`` streams equal to the JAX
  engine's at pipeline depths 0 and 2, greedy and sampled, through the
  decode loop too, and over an int8 KV pool.
- Weight-only-quantized trees (int8, and the fused fp6 layout, which the
  GPT-2 runner dequantizes at its use: ``supports_fused_woq`` False)
  served token-identically to the JAX engine's on its own quantized tree.
- The HF path: ``config_from_hf`` for gpt2, a checkpoint written by
  ``transformers`` loaded to the JAX loader's tree bit for bit, and both
  packages' ``build_hf_engine`` on it giving the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint import hf_loader as jhf
from deepspeed_tpu.inference import quantization as jwoq
from deepspeed_tpu.inference.config import InferenceConfig
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.inference.v2 import SamplingParams as JaxSampling
from deepspeed_tpu.inference.v2.engine_factory import \
    build_hf_engine as jax_build_hf_engine
from deepspeed_tpu.models import registry as jreg
from deepspeed_tpu.models.gpt2 import GPT2 as JaxGPT2
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu_torch.checkpoint import gpt2_params_from_numpy
from deepspeed_tpu_torch.checkpoint import hf_loader as thf
from deepspeed_tpu_torch.inference import quantization as twoq
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceConfig,
                                              SamplingParams,
                                              build_hf_engine)
from deepspeed_tpu_torch.inference.v2.model_runner import GPT2RaggedRunner
from deepspeed_tpu_torch.models import registry as treg
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.ops.kernels.fp6_gemm import Fp6GemmWeight

VOCAB, HIDDEN, LAYERS, HEADS = 97, 64, 2, 4
UIDS = [0, 1, 2]
_rng = np.random.default_rng(7)
#: prompt lengths that straddle chunk and block edges; the last one runs
#: past max_seq_len - 1 within the decode, so positions clamp
PROMPTS = [_rng.integers(1, VOCAB, n).tolist() for n in (5, 13, 22)]
GEN = 10
SAMPLING = dict(temperature=0.9, top_k=12, top_p=0.95)


class _Model:
    def __init__(self):
        common = dict(vocab_size=VOCAB, max_seq_len=30, num_layers=LAYERS,
                      num_heads=HEADS, hidden_size=HIDDEN)
        self.jcfg = JaxGPT2Config(dtype=jnp.float32, **common)
        self.jparams = JaxGPT2(self.jcfg).init(
            jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
        # non-zero biases and LayerNorm affines, so that every leaf shows
        leaves, tdef = jax.tree.flatten(self.jparams)
        keys = jax.random.split(jax.random.PRNGKey(2), len(leaves))
        self.jparams = jax.tree.unflatten(tdef, [
            x + 0.05 * jax.random.normal(k, x.shape, x.dtype)
            for x, k in zip(leaves, keys)])
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.cfg = GPT2Config(dtype=torch.float32, **common)
        self.params = gpt2_params_from_numpy(self.tree, self.cfg,
                                             device="cpu",
                                             dtype=torch.float32)

    def jax_engine(self, params=None, **kw):
        return JaxEngine(self.jcfg, self.jparams if params is None
                         else params, JaxRagged(**_kw(**kw)))

    def engine(self, params=None, **kw):
        return InferenceEngineV2(self.cfg, self.params if params is None
                                 else params,
                                 RaggedInferenceConfig(**_kw(**kw)),
                                 device="cpu")


def _kw(**kw):
    base = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
                max_blocks_per_seq=8, dtype="float32",
                attention_impl="dense", decode_loop_steps=0,
                serve_pipeline_depth=2)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def model():
    return _Model()


def _stream(eng, sampling=None):
    first = eng.put(UIDS, [list(p) for p in PROMPTS], _greedy=True,
                    sampling=sampling)
    out = eng.decode_pipelined(UIDS, [first[u] for u in UIDS], GEN)
    toks = {u: [int(first[u])] + [int(t) for t in out[u]] for u in UIDS}
    for u in UIDS:
        eng.flush(u)
    assert eng.free_blocks == eng.config.num_blocks
    return toks


def test_runner_is_picked_from_the_config(model):
    eng = model.engine()
    assert isinstance(eng.runner, GPT2RaggedRunner)
    assert not eng.runner.supports_fused_woq
    assert (eng.runner.kv_heads, eng.runner.head_dim) == (HEADS,
                                                          HIDDEN // HEADS)


@pytest.mark.parametrize("impl", ["dense", "paged_flash"])
def test_step_logits_equal_jax(model, impl):
    """Last-token logits of a prefill (chunked: 22 tokens in chunks of 8)
    and of the next decode step, against the JAX runner's."""
    jeng = model.jax_engine()
    eng = model.engine(attention_impl=impl)
    for e in (jeng, eng):
        e.got = [e.put(UIDS, [list(p) for p in PROMPTS])]
        e.got.append(e.put(UIDS, [[3], [5], [7]]))
    for a, b in zip(jeng.got, eng.got):
        for u in UIDS:
            np.testing.assert_allclose(b[u], np.asarray(a[u]), rtol=0,
                                       atol=2e-5)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_streams_equal_jax(model, depth, mode):
    """put + decode_pipelined at depths 0 and 2, greedy and sampled
    (per-uid seeds): the port's tokens are the JAX engine's."""
    sp = jsp = None
    if mode == "sampled":
        sp = {u: SamplingParams(seed=10 + u, **SAMPLING) for u in UIDS}
        jsp = {u: JaxSampling(seed=10 + u, **SAMPLING) for u in UIDS}
    want = _stream(model.jax_engine(serve_pipeline_depth=depth), jsp)
    got = _stream(model.engine(serve_pipeline_depth=depth), sp)
    assert got == want
    if mode == "greedy":
        assert got == _stream(model.engine(serve_pipeline_depth=2 - depth))


@pytest.mark.parametrize("loop", [0, 4])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_generate_equals_jax(model, loop, mode):
    """``generate`` (prefill, then the decode loop in calls of ``loop``
    tokens where it fits, then the pipelined tail): the JAX engine's
    tokens."""
    samp = jsamp = None
    if mode == "sampled":
        samp = SamplingParams(**SAMPLING)
        jsamp = InferenceConfig(greedy=False, **SAMPLING)
    want = model.jax_engine(decode_loop_steps=loop).generate(
        PROMPTS, max_new_tokens=GEN, sampling=jsamp, seed=4)
    eng = model.engine(decode_loop_steps=loop)
    assert eng.generate(PROMPTS, max_new_tokens=GEN, sampling=samp,
                        seed=4) == want
    assert eng.free_blocks == eng.config.num_blocks


def test_int8_kv_pool_equals_jax(model):
    want = _stream(model.jax_engine(kv_cache_dtype="int8"))
    assert _stream(model.engine(kv_cache_dtype="int8")) == want
    want = model.jax_engine(kv_cache_dtype="int8",
                            decode_loop_steps=4).generate(
        PROMPTS, max_new_tokens=GEN)
    assert model.engine(kv_cache_dtype="int8", decode_loop_steps=4) \
        .generate(PROMPTS, max_new_tokens=GEN) == want


@pytest.mark.parametrize("woq", [{"num_bits": 8},
                                 {"dtype": "fp6", "fused_gemm": True}])
def test_quantized_tree_equals_jax(model, woq):
    """A weight-only-quantized GPT-2 (the JAX factory's module lists):
    each package quantizes its own tree, and the served tokens agree. The
    fp6 tree carries ``Fp6GemmWeight`` leaves, which the GPT-2 runner
    dequantizes at its use, as the JAX runner's
    ``dequantize_tree(keep_fused=False)``."""
    qcfg = {"quantized_weights": {
        "enabled": True, "modules": ["proj", "fc", "attn", "mlp"],
        "excluded_modules": ["embed", "wte", "wpe", "norm", "ln"], **woq}}
    jq = jwoq.quantize_model_params(model.jparams, qcfg)
    tq = twoq.quantize_model_params(model.params, qcfg)
    if "fused_gemm" in woq:
        assert isinstance(tq["h_0"]["mlp"]["c_fc"]["kernel"], Fp6GemmWeight)
    want = _stream(model.jax_engine(params=jq))
    assert _stream(model.engine(params=tq)) == want


# --------------------------------------------------------------------- #
# the HF path
# --------------------------------------------------------------------- #


def test_registry_gpt2_entry_equals_jax():
    d = {"model_type": "gpt2", "vocab_size": 50257, "n_positions": 1024,
         "n_embd": 1600, "n_layer": 48, "n_head": 25,
         "layer_norm_epsilon": 1e-5}
    jname, jcfg = jreg.config_from_hf(d)
    tname, tcfg = treg.config_from_hf(d)
    assert jname == tname == "gpt2"
    for f in ("vocab_size", "max_seq_len", "num_layers", "num_heads",
              "hidden_size", "layer_norm_eps", "mlp_ratio", "use_bias"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.head_dim == 64


@pytest.fixture(scope="module")
def gpt2_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    m = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=VOCAB, n_positions=32, n_embd=HIDDEN, n_layer=LAYERS,
        n_head=HEADS))
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn_like(p))
    d = tmp_path_factory.mktemp("gpt2")
    m.save_pretrained(d)
    return str(d)


def test_hf_gpt2_tree_equals_jax_loader(gpt2_dir):
    """The port's tree from the checkpoint equals the JAX loader's bit
    for bit (fp32 shards; Conv1D weights untransposed; the tied
    ``lm_head.weight`` dropped)."""
    _, jcfg, jtree = jhf.load_hf_model(gpt2_dir)
    arch, tcfg, ttree = thf.load_hf_model(gpt2_dir, device="cpu")
    assert arch == "gpt2" and isinstance(tcfg, GPT2Config)
    assert "lm_head" not in ttree

    def walk(j, t, path):
        assert set(j) == set(t), path
        for k in j:
            if isinstance(j[k], dict):
                walk(j[k], t[k], path + (k,))
            else:
                assert np.array_equal(np.asarray(j[k]), t[k].numpy()), \
                    path + (k,)
    walk(jtree, ttree, ())


@pytest.mark.parametrize("depth", [0, 2])
def test_build_hf_engine_gpt2_equals_jax(gpt2_dir, depth):
    kw = _kw(serve_pipeline_depth=depth, decode_loop_steps=4,
             max_blocks_per_seq=8)
    want = jax_build_hf_engine(gpt2_dir, engine_config=JaxRagged(**kw),
                               dtype="float32").generate(
        PROMPTS, max_new_tokens=GEN)
    eng = build_hf_engine(gpt2_dir, engine_config=RaggedInferenceConfig(
        **kw), dtype="float32", device="cpu")
    assert isinstance(eng.runner, GPT2RaggedRunner)
    assert eng.generate(PROMPTS, max_new_tokens=GEN) == want
    samp = SamplingParams(**SAMPLING)
    want = jax_build_hf_engine(gpt2_dir, engine_config=JaxRagged(**kw),
                               dtype="float32").generate(
        PROMPTS, max_new_tokens=GEN, seed=2,
        sampling=InferenceConfig(greedy=False, **SAMPLING))
    assert eng.generate(PROMPTS, max_new_tokens=GEN, sampling=samp,
                        seed=2) == want
    assert eng.free_blocks == eng.config.num_blocks
    # bf16 by default, as the JAX factory's config: the tree keeps fp32
    bf = build_hf_engine(gpt2_dir, device="cpu")
    assert bf.model_cfg.dtype == torch.bfloat16
    assert bf.params["wte"]["embedding"].dtype == torch.float32
