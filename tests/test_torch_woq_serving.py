"""Port parity for weight-only-quantized serving: the tiny Llama of the
JAX package's fused-fp6 serving test (hidden 128, 4 heads, 2 KV heads,
intermediate 512, fp32) quantized once by the JAX package, bridged with
``woq_params_from_numpy``, and served by both engines on the CPU.

int8, int4 (group 64) and fused fp6, with ``embed``, ``norm`` and
``lm_head`` excluded as in the JAX package's 7B example: greedy streams
token-identical to the JAX engine's, prefill logits within 1e-4 (fp32,
summation order). On the JAX side the fused fp6 GEMM runs its Pallas
kernel in interpret mode; on the port's, ``fp6_matmul``'s plain version
(CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantization as jwoq
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.checkpoint import (llama_params_from_numpy,
                                            woq_params_from_numpy)
from deepspeed_tpu_torch.inference import quantization as woq
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceConfig)
from deepspeed_tpu_torch.inference.v2.engine_v2 import _move_tree
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.ops.kernels import (Fp6GemmWeight, QuantizedTensor,
                                             fp6_gemm)

MODEL_KW = dict(max_seq_len=128, hidden_size=128, num_heads=4,
                num_kv_heads=2, intermediate_size=512)
MODES = {"int8": {"num_bits": 8},
         "int4": {"num_bits": 4},
         "fp6_fused": {"dtype": "fp6", "fused_gemm": True}}
PROMPT_LENS = (5, 11, 19)
NEW_TOKENS = 10
ENGINE_KW = dict(max_seqs=4, chunk_size=8, block_size=64, num_blocks=8,
                 max_blocks_per_seq=1, dtype="float32", decode_loop_steps=4)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 512, n).tolist() for n in PROMPT_LENS]


def _qcfg(mode):
    return {"quantized_weights": {
        **MODES[mode], "group_size": 64,
        "excluded_modules": ["embed", "norm", "lm_head"]}}


class _Ref:
    """The JAX side of one mode: its quantized tree, greedy streams and
    prefill logits, and the port's bridged copy of the tree."""

    def __init__(self, params, mode):
        jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **MODEL_KW)
        self.jtree = jwoq.quantize_model_params(params, _qcfg(mode))
        eng = JaxEngine(jcfg, self.jtree,
                        JaxRagged(attention_impl="dense", **ENGINE_KW))
        self.gen = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS)
        self.prompt = np.random.default_rng(4).integers(1, 512, 13).tolist()
        self.logits = eng.put([50], [self.prompt])[50]
        self.cfg = LlamaConfig.tiny(dtype=torch.float32, **MODEL_KW)
        self.tree = woq_params_from_numpy(jax.tree.map(np.asarray,
                                                       self.jtree),
                                          self.cfg, device="cpu")


@pytest.fixture(scope="module")
def refs():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **MODEL_KW)
    params = jllama.Llama(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = _Ref(params, mode)
        return cache[mode]
    return get


def _engine(ref, tree=None, **kw):
    return InferenceEngineV2(
        ref.cfg, ref.tree if tree is None else tree,
        RaggedInferenceConfig(**{**ENGINE_KW, **kw}), device="cpu")


@pytest.mark.parametrize("impl", ["dense", "paged_flash"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_woq_generate_token_identical_to_jax_engine(refs, mode, impl):
    """Three prompts (one past two chunks), the decode loop at 4 tokens a
    call and a put() tail; the leaves stay packed on the engine."""
    ref = refs(mode)
    eng = _engine(ref, attention_impl=impl)
    leaf = eng.params["layer_0"]["mlp"]["gate_proj"]["kernel"]
    assert isinstance(leaf, Fp6GemmWeight if mode == "fp6_fused"
                      else QuantizedTensor)
    fp6_gemm.reset_launch_counts()
    got = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    assert got == ref.gen
    assert eng.free_blocks == ENGINE_KW["num_blocks"]
    assert fp6_gemm.LAUNCHES["fp6_matmul"] == 0     # CPU: plain versions


@pytest.mark.parametrize("mode", sorted(MODES))
def test_woq_prefill_logits_match_jax_engine(refs, mode):
    """A 13-token prompt in 8-token chunks: the last chunk's logits."""
    ref = refs(mode)
    got = _engine(ref).put([0], [ref.prompt])[0]
    np.testing.assert_allclose(got, ref.logits, atol=1e-4, rtol=1e-4)


def test_woq_engine_equals_dense_engine_on_dequantized_tree(refs):
    """int8 served packed against the same tree dequantized up front:
    token-identical (the same f32 values reach the same products)."""
    ref = refs("int8")
    dense = woq.dequantize_tree(ref.tree)
    assert isinstance(dense["layer_0"]["attn"]["q_proj"]["kernel"],
                      torch.Tensor)
    assert _engine(ref, dense).generate(
        _prompts(), max_new_tokens=NEW_TOKENS) == ref.gen
    assert woq.woq_memory_bytes(ref.tree) < woq.woq_memory_bytes(dense) / 2


def test_port_quantized_tree_serves_like_the_bridged_one(refs):
    """quantize_model_params in the port on the bridged dense tree serves
    the same streams as the JAX-quantized tree (fused fp6)."""
    ref = refs("fp6_fused")
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **MODEL_KW)
    params = jllama.Llama(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    dense = llama_params_from_numpy(jax.tree.map(np.asarray, params),
                                    ref.cfg, device="cpu")
    tree = woq.quantize_model_params(dense, _qcfg("fp6_fused"))
    assert _engine(ref, tree).generate(
        _prompts(), max_new_tokens=NEW_TOKENS) == ref.gen


def test_move_tree_moves_packed_leaves_field_by_field(refs):
    tree = refs("int4").tree
    moved = _move_tree(tree, torch.device("meta"))
    leaf = moved["layer_1"]["attn"]["o_proj"]["kernel"]
    src = tree["layer_1"]["attn"]["o_proj"]["kernel"]
    assert isinstance(leaf, QuantizedTensor)
    assert leaf.values.is_meta and leaf.scale.is_meta and leaf.zero is None
    assert (leaf.shape, leaf.bits, leaf.group_size) == \
        (src.shape, src.bits, src.group_size)
    assert moved["embed"]["embedding"].is_meta


def test_woq_engine_requested_on_cuda_without_a_card_raises(refs,
                                                            monkeypatch):
    ref = refs("int8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngineV2(ref.cfg, ref.tree, RaggedInferenceConfig(
            **ENGINE_KW))
