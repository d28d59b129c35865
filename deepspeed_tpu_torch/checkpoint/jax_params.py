"""Llama and GPT-2 parameter trees: from the JAX package's flax tree, or
seeded.

The Llama tree keeps flax's paths and layouts: ``embed/embedding``
``[V, M]``, ``layer_i/{input_norm,post_attn_norm}/scale`` ``[M]``,
``layer_i/attn/{q,k,v,o}_proj/kernel`` and
``layer_i/mlp/{gate,up,down}_proj/kernel`` as ``[in, out]``,
``final_norm/scale`` and ``lm_head/kernel`` ``[M, V]``. Matrices take the
requested dtype; norm scales stay fp32 (they multiply fp32 statistics).

So does the GPT-2 tree: ``wte/embedding`` [V, C], ``wpe/embedding``
[max_seq_len, C], ``h_i/{ln_1,ln_2}/{scale,bias}`` [C],
``h_i/attn/c_attn/{kernel [C, 3C], bias [3C]}``,
``h_i/attn/c_proj/{kernel [C, C], bias [C]}``,
``h_i/mlp/c_fc/{kernel [C, 4C], bias [4C]}``,
``h_i/mlp/c_proj/{kernel [4C, C], bias [C]}`` and ``ln_f/{scale,bias}``.
Dense kernels stay in flax's ``[in, out]`` layout (the port's ``Dense``
computes ``x @ kernel``). The LayerNorm scales and biases are fp32 whatever
``param_dtype`` is, as flax makes them (its ``nn.LayerNorm`` is built
without ``param_dtype``); every other leaf takes ``param_dtype``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..models.gpt2 import GPT2Config
from ..models.llama import LlamaConfig
from ..ops.fp_quantizer import FORMATS, FPQuantizedTensor
from ..ops.kernels.fp6_gemm import Fp6GemmWeight
from ..ops.kernels.quantization import QuantizedTensor
from ..utils.device import resolve_device
from ..utils.dtypes import resolve_dtype


def llama_param_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Nested dict of shapes mirroring the flax tree of ``Llama(cfg)``."""
    M, H, KV, D = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                   cfg.head_dim)
    I, V = cfg.intermediate_size, cfg.vocab_size
    tree: Dict[str, Any] = {"embed": {"embedding": (V, M)}}
    for li in range(cfg.num_layers):
        attn = {"q_proj": {"kernel": (M, H * D)},
                "k_proj": {"kernel": (M, KV * D)},
                "v_proj": {"kernel": (M, KV * D)},
                "o_proj": {"kernel": (H * D, M)}}
        if cfg.qkv_bias:
            attn["q_proj"]["bias"] = (H * D,)
            attn["k_proj"]["bias"] = (KV * D,)
            attn["v_proj"]["bias"] = (KV * D,)
        tree[f"layer_{li}"] = {
            "input_norm": {"scale": (M,)},
            "attn": attn,
            "post_attn_norm": {"scale": (M,)},
            "mlp": {"gate_proj": {"kernel": (M, I)},
                    "up_proj": {"kernel": (M, I)},
                    "down_proj": {"kernel": (I, M)}},
        }
    tree["final_norm"] = {"scale": (M,)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": (M, V)}
    return tree


def _is_scale(path: Tuple[str, ...]) -> bool:
    return path[-1] == "scale"


def _is_layer_norm(path: Tuple[str, ...]) -> bool:
    return len(path) > 1 and path[-2] in ("ln_1", "ln_2", "ln_f")


def _gpt2_dtype(path: Tuple[str, ...], dt: torch.dtype) -> torch.dtype:
    return torch.float32 if _is_layer_norm(path) else dt


def _map_tree(shapes: Mapping[str, Any], fn, path=()) -> Dict[str, Any]:
    out = {}
    for k, v in shapes.items():
        if isinstance(v, Mapping):
            out[k] = _map_tree(v, fn, path + (k,))
        else:
            out[k] = fn(path + (k,), tuple(v))
    return out


def llama_params_from_numpy(tree: Mapping[str, Any], cfg: LlamaConfig,
                            device: Any = None,
                            dtype: Any = None) -> Dict[str, Any]:
    """The JAX parameter tree (leaves as numpy arrays) -> the port's tree
    of torch tensors on ``device`` (default ``cuda``). Every path and
    shape is checked against ``cfg``; an extra or missing leaf raises."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype if dtype is not None else cfg.dtype)
    return _from_numpy(tree, llama_param_shapes(cfg), lambda path: dict(
        device=dev, dtype=torch.float32 if _is_scale(path) else dt))


def woq_params_from_numpy(tree: Mapping[str, Any], cfg: LlamaConfig,
                          device: Any = None,
                          dtype: Any = None) -> Dict[str, Any]:
    """The JAX package's weight-only-quantized Llama tree -> the port's.
    Its leaves are the JAX ``QuantizedTensor``, ``Fp6GemmWeight`` or
    ``FPQuantizedTensor`` (arrays as numpy), or dense numpy arrays; each
    packed leaf becomes the port's NamedTuple of the same name with the
    same bits on ``device`` (default ``cuda``), each dense leaf a tensor
    as :func:`llama_params_from_numpy` makes it. Paths, the logical shape
    of every leaf and the shapes of the packed arrays are checked."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype if dtype is not None else cfg.dtype)
    return _from_numpy(tree, llama_param_shapes(cfg), lambda path: dict(
        device=dev, dtype=torch.float32 if _is_scale(path) else dt),
        packed=lambda path, shape, node: _packed_leaf(path, shape, node,
                                                      dev))


def _packed_leaf(path, shape, node, dev):
    """A packed WOQ leaf of the JAX package (any NamedTuple with its
    field names) -> the port's, arrays copied bit for bit."""
    name = "/".join(path)
    if tuple(node.shape) != shape:
        raise ValueError(f"{name}: logical shape {tuple(node.shape)} != "
                         f"expected {shape}")
    n = math.prod(shape)

    def arr(field, want):
        a = getattr(node, field)
        if a is None:
            return None
        a = np.asarray(a)
        if a.shape != want:
            raise ValueError(f"{name}.{field}: shape {a.shape} != {want}")
        return torch.from_numpy(np.array(a)).to(dev)

    fields = tuple(node._fields)
    if fields == QuantizedTensor._fields:
        bits, gs = int(node.bits), int(node.group_size)
        ng = -(-n // gs)
        if bits not in (8, 4):
            raise ValueError(f"{name}: bits {bits}")
        return QuantizedTensor(
            arr("values", (ng, gs if bits == 8 else gs // 2)),
            arr("scale", (ng, 1)), arr("zero", (ng, 1)), shape, bits, gs)
    if fields == Fp6GemmWeight._fields:
        K, N = shape
        return Fp6GemmWeight(arr("bytes3", (3, K, N // 4)),
                             arr("scale", (4, N // 4)), shape)
    if fields == FPQuantizedTensor._fields:
        q_bits, gs = int(node.q_bits), int(node.group_size)
        if q_bits not in FORMATS:
            raise ValueError(f"{name}: q_bits {q_bits}")
        n_codes = -(-n // gs) * gs
        per = {8: (1, 1), 6: (4, 3), 12: (2, 3)}[q_bits]
        nbytes = -(-n_codes // per[0]) * per[1]
        return FPQuantizedTensor(arr("codes", (nbytes,)),
                                 arr("scale", (n_codes // gs, 1)), shape,
                                 q_bits, gs, bool(node.packed))
    raise TypeError(f"{name}: unknown packed leaf with fields {fields}")


def _from_numpy(tree: Mapping[str, Any], shapes: Mapping[str, Any],
                place, packed=None) -> Dict[str, Any]:
    """Copy every leaf of ``shapes`` out of the numpy ``tree`` into a
    tensor (``place(path)`` gives its device and dtype), checking its
    shape; a missing or an extra leaf raises. With ``packed``, a
    NamedTuple leaf becomes ``packed(path, shape, node)``."""

    def convert(path, shape):
        node: Any = tree
        for k in path:
            if k not in node:
                raise KeyError(f"missing parameter {'/'.join(path)}")
            node = node[k]
        if packed is not None and hasattr(node, "_fields"):
            return packed(path, shape, node)
        arr = np.asarray(node)
        if arr.shape != shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                             f"expected {shape}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))   # a copy
        return t.to(**place(path))

    out = _map_tree(shapes, convert)

    def check_extra(src, ref, path=()):
        for k, v in src.items():
            if k not in ref:
                raise KeyError(f"unexpected parameter {'/'.join(path + (k,))}")
            if isinstance(v, Mapping):
                check_extra(v, ref[k], path + (k,))

    check_extra(tree, shapes)
    return out


def init_llama_params(cfg: LlamaConfig, seed: int = 0, device: Any = None,
                      dtype: Any = None) -> Dict[str, Any]:
    """Seeded random weights made directly on ``device`` (default ``cuda``)
    with an explicit ``torch.Generator``. Matrices are normal with std
    1/sqrt(fan_in) (the embedding std 1), so activations stay O(1) through
    the layers and the logits are not flat; norm scales are ones."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype if dtype is not None else cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def make(path, shape):
        if _is_scale(path):
            return torch.ones(shape, dtype=torch.float32, device=dev)
        if path[-1] == "bias":
            return torch.zeros(shape, dtype=dt, device=dev)
        std = 1.0 if path[0] == "embed" else 1.0 / math.sqrt(shape[0])
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (t * std).to(dt)

    return _map_tree(llama_param_shapes(cfg), make)


def gpt2_param_shapes(cfg: GPT2Config) -> Dict[str, Any]:
    """Nested dict of shapes mirroring the flax tree of ``GPT2(cfg)``."""
    C, V = cfg.hidden_size, cfg.vocab_size
    F = cfg.mlp_ratio * C

    def dense(din, dout):
        d = {"kernel": (din, dout)}
        if cfg.use_bias:
            d["bias"] = (dout,)
        return d

    def norm():
        return {"scale": (C,), "bias": (C,)}

    tree: Dict[str, Any] = {"wte": {"embedding": (V, C)},
                            "wpe": {"embedding": (cfg.max_seq_len, C)}}
    for i in range(cfg.num_layers):
        tree[f"h_{i}"] = {
            "ln_1": norm(),
            "attn": {"c_attn": dense(C, 3 * C), "c_proj": dense(C, C)},
            "ln_2": norm(),
            "mlp": {"c_fc": dense(C, F), "c_proj": dense(F, C)},
        }
    tree["ln_f"] = norm()
    return tree


def gpt2_params_from_numpy(tree: Mapping[str, Any], cfg: GPT2Config,
                           device: Any = None,
                           dtype: Any = None) -> Dict[str, Any]:
    """The JAX GPT-2 tree (leaves as numpy arrays) -> the port's tree of
    torch tensors on ``device`` (default ``cuda``) in ``dtype`` (default
    ``cfg.param_dtype``; the LayerNorm leaves stay fp32). Paths and shapes
    are checked against ``cfg``."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype if dtype is not None else cfg.param_dtype)
    return _from_numpy(tree, gpt2_param_shapes(cfg), lambda path: dict(
        device=dev, dtype=_gpt2_dtype(path, dt)))


def init_gpt2_params(cfg: GPT2Config, seed: int = 0, device: Any = None,
                     dtype: Any = None) -> Dict[str, Any]:
    """Seeded random GPT-2 weights made directly on ``device`` (default
    ``cuda``) with an explicit ``torch.Generator``, at flax's default
    scales: Dense kernels and embeddings normal with variance 1/fan_in
    (an embedding's fan-in is its width), biases zero, LayerNorm scales
    one. The LayerNorm leaves are fp32, the rest ``dtype`` (default
    ``cfg.param_dtype``)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype if dtype is not None else cfg.param_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def make(path, shape):
        if path[-1] == "scale":
            return torch.ones(shape, dtype=_gpt2_dtype(path, dt), device=dev)
        if path[-1] == "bias":
            return torch.zeros(shape, dtype=_gpt2_dtype(path, dt),
                               device=dev)
        fan_in = shape[1] if path[-1] == "embedding" else shape[0]
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (t * (1.0 / math.sqrt(fan_in))).to(dt)

    return _map_tree(gpt2_param_shapes(cfg), make)
