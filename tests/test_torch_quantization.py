"""Port parity for weight-only quantization: the port's group quantizer
(plain version, CPU), minifloat quantizer and ``quantize_model_params``
against the JAX package's, on the same numpy inputs.

The JAX group quantizer runs its Pallas kernels in interpret mode. Codes,
scales and zeros must be the same bits: the port computes the division by
the constant qmax as XLA does (a multiply by its f32 reciprocal), ``x /
scale`` as a true division and rounds half to even."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantization as jwoq
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops import fp_quantizer as jfp
from deepspeed_tpu.ops.kernels import quantization as jq
from deepspeed_tpu_torch.checkpoint import (llama_params_from_numpy,
                                            woq_params_from_numpy)
from deepspeed_tpu_torch.inference import quantization as woq
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.ops import fp_quantizer as fp
from deepspeed_tpu_torch.ops.kernels import quantization as q


def _x(shape=(300, 517), seed=0):
    """Normal values at three magnitudes, one all-zero group at the front;
    300 x 517 is not a multiple of 64 or 128 (a ragged tail group)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:128] = 0.0
    x.reshape(-1)[1000:3000] *= 40.0
    x.reshape(-1)[5000:7000] *= 1e-3
    return x


def _pair(x, dtype):
    if dtype == "bf16":
        return jnp.asarray(x).astype(jnp.bfloat16), \
            torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _same(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(b, a, err_msg=what)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("group", [128, 64])
def test_quantize_blockwise_identical_to_jax(dtype, bits, symmetric, group):
    jx, tx = _pair(_x(), dtype)
    want = jq.quantize_blockwise(jx, bits=bits, group_size=group,
                                 symmetric=symmetric, interpret=True)
    got = q.quantize_blockwise(tx, bits=bits, group_size=group,
                               symmetric=symmetric)
    _same(want.values, got.values, "values")
    _same(want.scale, got.scale, "scale")
    if symmetric:
        assert got.zero is None
    else:
        _same(want.zero, got.zero, "zero")
    assert (got.shape, got.bits, got.group_size) == \
        (tuple(want.shape), want.bits, want.group_size)
    _same(jq.dequantize_blockwise(want), q.dequantize_blockwise(got),
          "dequantized")
    _same(jq.quant_dequant(jx, bits=bits, group_size=group,
                           symmetric=symmetric, interpret=True).astype(
                               jnp.float32),
          q.quant_dequant(tx, bits=bits, group_size=group,
                          symmetric=symmetric).float(), "quant_dequant")


@pytest.mark.parametrize("shape", [(5, 7), (1, 64), (3, 1000)])
def test_quantize_blockwise_small_and_single_group(shape):
    """Fewer elements than one group, exactly one group, and a tail of
    1000 % 256 = 232 elements (the default group)."""
    x = _x(shape, seed=len(shape) + shape[0])
    for bits in (8, 4):
        for sym in (True, False):
            want = jq.quantize_blockwise(jnp.asarray(x), bits=bits,
                                         symmetric=sym, interpret=True)
            got = q.quantize_blockwise(torch.from_numpy(x), bits=bits,
                                       symmetric=sym)
            _same(want.values, got.values, "values")
            _same(want.scale, got.scale, "scale")


def test_int4_pack_unpack_identical_to_jax():
    v = np.random.default_rng(1).integers(-7, 8, (6, 32)).astype(np.int8)
    packed = q.pack_int4(torch.from_numpy(v))
    _same(jq.pack_int4(jnp.asarray(v)), packed, "pack")
    _same(jq.unpack_int4(jnp.asarray(np.asarray(packed))),
          q.unpack_int4(packed), "unpack")
    _same(v, q.unpack_int4(packed), "round trip")


def test_quantize_blockwise_rejects_bad_arguments():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError):
        q.quantize_blockwise(x, bits=3)
    with pytest.raises(ValueError):
        q.quantize_blockwise(x, bits=4, group_size=5)
    with pytest.raises(ValueError, match="empty"):
        q.quantize_blockwise(torch.zeros(0, 6), bits=8)


@pytest.mark.parametrize("q_bits", [6, 8, 12])
@pytest.mark.parametrize("shape,group", [((300, 517), 128), ((64, 96), 64),
                                         ((1000,), 128)])
def test_fp_quantize_identical_to_jax(q_bits, shape, group):
    x = _x(shape, seed=q_bits) * 0.3
    want = jfp.fp_quantize(jnp.asarray(x), q_bits, group)
    got = fp.fp_quantize(torch.from_numpy(x), q_bits, group)
    _same(want.codes, got.codes, "codes")
    _same(want.scale, got.scale, "scale")
    assert (got.shape, got.q_bits, got.group_size, got.packed) == \
        (tuple(want.shape), q_bits, group, True)
    _same(jfp.fp_dequantize(want), fp.fp_dequantize(got), "dequantized")


# ---------------------------------------------------- quantize_model_params

MODEL_KW = dict(max_seq_len=128, hidden_size=128, num_heads=4,
                num_kv_heads=2, intermediate_size=512)


@pytest.fixture(scope="module")
def dense_trees():
    """The tiny Llama's flax tree (numpy) and the port's bridged copy."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **MODEL_KW)
    params = jllama.Llama(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, params)
    cfg = LlamaConfig.tiny(dtype=torch.float32, **MODEL_KW)
    return tree, cfg, llama_params_from_numpy(tree, cfg, device="cpu")


WOQ_CONFIGS = {
    "int8": {"num_bits": 8},
    "int4": {"num_bits": 4, "group_size": 64},
    "fp6": {"dtype": "fp6"},
    "fp6_fused": {"dtype": "fp6", "fused_gemm": True},
    "fp8": {"dtype": "fp8", "group_size": 64},
    "fp12": {"num_bits": 12},
    "int8_all": {"num_bits": 8, "excluded_modules": []},
    "fp6_fused_all": {"dtype": "fp6", "fused_gemm": True,
                      "excluded_modules": [], "modules": ["mlp", "embed",
                                                          "lm_head"]},
}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


@pytest.mark.parametrize("name", sorted(WOQ_CONFIGS))
def test_quantize_model_params_matches_jax(dense_trees, name):
    """The port's quantize_model_params on the bridged dense tree gives
    the leaves of the JAX function followed by woq_params_from_numpy, bit
    for bit, and the same woq_memory_bytes."""
    tree, cfg, params = dense_trees
    block = {"excluded_modules": ["embed", "norm", "lm_head"],
             **WOQ_CONFIGS[name]}
    qcfg = {"quantized_weights": block}
    jtree = jwoq.quantize_model_params(jax.tree.map(jnp.asarray, tree),
                                       qcfg)
    want = woq_params_from_numpy(jax.tree.map(np.asarray, jtree), cfg,
                                 device="cpu")
    got = woq.quantize_model_params(params, qcfg)
    kinds = set()
    for (path, w), (path2, g) in zip(_leaves(want), _leaves(got)):
        assert path == path2 and type(w) is type(g), (path, type(g))
        kinds.add(type(g).__name__)
        if isinstance(g, torch.Tensor):
            _same(w, g, path)
            continue
        for f in g._fields:
            a, b = getattr(w, f), getattr(g, f)
            if isinstance(b, torch.Tensor) or isinstance(a, torch.Tensor):
                _same(a, b, f"{path}.{f}")
            else:
                assert a == b, (path, f, a, b)
    expect = {"int8": "QuantizedTensor", "int4": "QuantizedTensor",
              "int8_all": "QuantizedTensor", "fp6": "FPQuantizedTensor",
              "fp8": "FPQuantizedTensor", "fp12": "FPQuantizedTensor",
              "fp6_fused": "Fp6GemmWeight",
              "fp6_fused_all": "Fp6GemmWeight"}[name]
    assert expect in kinds
    if name == "fp6_fused_all":
        # the embedding table never takes the fused layout
        assert isinstance(got["embed"]["embedding"], fp.FPQuantizedTensor)
    assert woq.woq_memory_bytes(got) == jwoq.woq_memory_bytes(jtree)
    assert woq.woq_memory_bytes(params) == jwoq.woq_memory_bytes(
        jax.tree.map(jnp.asarray, tree))


@pytest.mark.parametrize("name", ["int8", "fp8", "fp6_fused_all"])
def test_dequantize_tree_matches_jax(dense_trees, name):
    """The dense view of a quantized tree (fused fp6 GEMM leaves unpacked
    too) equals the JAX package's, leaf for leaf."""
    tree, cfg, params = dense_trees
    qcfg = {"quantized_weights": {"excluded_modules": ["norm"],
                                  **WOQ_CONFIGS[name]}}
    jtree = jwoq.quantize_model_params(jax.tree.map(jnp.asarray, tree),
                                       qcfg)
    got = woq.dequantize_tree(woq.quantize_model_params(params, qcfg))
    want = jwoq.dequantize_tree(jtree)
    want_np = dict(_leaves(jax.tree.map(np.asarray, want)))
    got_np = dict(_leaves(got))
    assert sorted(got_np) == sorted(want_np)
    for path, g in got_np.items():
        assert isinstance(g, torch.Tensor), path
        _same(want_np[path], g, path)


def test_quantize_model_params_errors_match_jax(dense_trees):
    tree, _, params = dense_trees
    jparams = jax.tree.map(jnp.asarray, tree)
    bad = [{}, {"quantized_weights": {"num_bits": 8, "fused_gemm": True}},
           {"quantized_weights": {"dtype": "fp8", "fused_gemm": True}},
           {"quantized_weights": {"dtype": "fp7"}}]
    for cfg in bad:
        with pytest.raises(ValueError) as want:
            jwoq.quantize_model_params(jparams, cfg)
        with pytest.raises(ValueError) as got:
            woq.quantize_model_params(params, cfg)
        assert str(got.value) == str(want.value)
    off = {"quantized_weights": {"enabled": False}}
    assert woq.quantize_model_params(params, off) is params


def test_woq_bridge_checks_packed_shapes(dense_trees):
    tree, cfg, _ = dense_trees
    jtree = jwoq.quantize_model_params(
        jax.tree.map(jnp.asarray, tree),
        {"quantized_weights": {"num_bits": 8,
                               "excluded_modules": ["embed"]}})
    npt = jax.tree.map(np.asarray, jtree)
    leaf = npt["layer_1"]["attn"]["o_proj"]["kernel"]
    npt["layer_1"]["attn"]["o_proj"]["kernel"] = leaf._replace(
        scale=leaf.scale[:-1])
    with pytest.raises(ValueError, match="o_proj"):
        woq_params_from_numpy(npt, cfg, device="cpu")
    npt["layer_1"]["attn"]["o_proj"]["kernel"] = leaf._replace(
        shape=(3, 3))
    with pytest.raises(ValueError, match="logical shape"):
        woq_params_from_numpy(npt, cfg, device="cpu")
    npt["layer_1"]["attn"]["o_proj"]["kernel"] = leaf
    npt["layer_1"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        woq_params_from_numpy(npt, cfg, device="cpu")


def test_llama2_7b_config_matches_jax():
    want = jllama.LlamaConfig.llama2_7b()
    got = LlamaConfig.llama2_7b()
    for f in ("vocab_size", "max_seq_len", "num_layers", "num_heads",
              "num_kv_heads", "hidden_size", "intermediate_size",
              "rope_theta", "rms_eps", "sliding_window", "qkv_bias",
              "tie_embeddings"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.head_dim == 128 and got.num_kv_heads == got.num_heads
