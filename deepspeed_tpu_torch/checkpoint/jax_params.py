"""Parameter trees of the served families: from the JAX package's flax
tree, or seeded.

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

The dense families of A5.4 (OPT, BLOOM, GPT-NeoX, GPT-J, Falcon, Phi)
keep their flax trees too (``*_param_shapes``: the paths each JAX model's
``init`` makes). One pair of functions serves all six, keyed by the
config's type: :func:`family_params_from_numpy` and the seeded
:func:`init_family_params`. Their LayerNorm leaves (every ``scale`` and
``bias`` of a node named ``ln_*``, ``*layernorm`` or ``*layer_norm``)
stay fp32 whatever dtype the rest takes: a norm's affine multiplies fp32
statistics, and a bf16 copy of an fp32 flax leaf would round it.

The same pair serves the MoE families (``MixtralConfig``: Mixtral and
Qwen2-MoE, :func:`mixtral_param_shapes`): the Llama tree with each
layer's ``mlp`` replaced by ``moe/{gate, wi_gate, wi_up, wo}`` (or
``wi``, ``wo``) and, with a shared expert, ``shared_{gate,up,down}_proj``
and ``shared_expert_gate``. Its norm scales and the router ``gate`` (an
fp32 ``param`` in flax, read in fp32 by the router) stay fp32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..models.bloom import BloomConfig
from ..models.falcon import FalconConfig
from ..models.gpt2 import GPT2Config
from ..models.gpt_neox import GPTJConfig, GPTNeoXConfig
from ..models.llama import LlamaConfig
from ..models.mixtral import MixtralConfig
from ..models.opt import OPTConfig
from ..models.phi import PhiConfig
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


def mixtral_param_shapes(cfg: MixtralConfig) -> Dict[str, Any]:
    """Nested dict of shapes mirroring the flax tree of ``Mixtral(cfg)``:
    the Llama tree with a ``moe`` node for ``mlp`` (the router ``gate``
    [M, E] and the stacked experts, [E, in, out]) and Qwen2-MoE's shared
    expert beside it."""
    tree = llama_param_shapes(cfg)
    M, E, I = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size
    SE = cfg.shared_expert_size
    for li in range(cfg.num_layers):
        layer = tree[f"layer_{li}"]
        del layer["mlp"]
        moe: Dict[str, Any] = {"gate": (M, E)}
        if cfg.gated_experts:
            moe.update(wi_gate=(E, M, I), wi_up=(E, M, I), wo=(E, I, M))
        else:
            moe.update(wi=(E, M, I), wo=(E, I, M))
        layer["moe"] = moe
        if SE:
            layer["shared_gate_proj"] = {"kernel": (M, SE)}
            layer["shared_up_proj"] = {"kernel": (M, SE)}
            layer["shared_down_proj"] = {"kernel": (SE, M)}
            layer["shared_expert_gate"] = {"kernel": (M, 1)}
    return tree


def _is_scale(path: Tuple[str, ...]) -> bool:
    return path[-1] == "scale"


def _is_layer_norm(path: Tuple[str, ...]) -> bool:
    """A leaf of a LayerNorm node (``ln_1``, ``ln_f``, ``ln_attn``,
    ``input_layernorm``, ``self_attn_layer_norm``, ...)."""
    if len(path) < 2:
        return False
    n = path[-2]
    return n.startswith("ln_") or n.endswith(("layernorm", "layer_norm"))


def _ln_fp32_dtype(path: Tuple[str, ...], dt: torch.dtype) -> torch.dtype:
    """flax's dtypes for a tree of GPT-2 or a dense family: LayerNorm
    leaves fp32, the rest ``dt``."""
    return torch.float32 if _is_layer_norm(path) else dt


def _family_dtype(cfg: Any, path: Tuple[str, ...],
                  dt: torch.dtype) -> torch.dtype:
    """A leaf's dtype in :func:`family_params_from_numpy` /
    :func:`init_family_params`: fp32 for the MoE families' norm scales and
    router gate, and for a dense family's LayerNorm leaves; else ``dt``."""
    if isinstance(cfg, MixtralConfig):
        return torch.float32 if _is_scale(path) or path[-2:] == (
            "moe", "gate") else dt
    return _ln_fp32_dtype(path, dt)


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
    """The JAX package's weight-only-quantized Llama or MoE (Mixtral,
    Qwen2-MoE) tree -> the port's. Its leaves are the JAX
    ``QuantizedTensor``, ``Fp6GemmWeight`` or ``FPQuantizedTensor``
    (arrays as numpy), or dense numpy arrays; each packed leaf becomes the
    port's NamedTuple of the same name with the same bits on ``device``
    (default ``cuda``), each dense leaf a tensor as
    :func:`llama_params_from_numpy` (:func:`family_params_from_numpy` for
    the MoE families) makes it. Paths, the logical shape of every leaf
    and the shapes of the packed arrays are checked."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype if dtype is not None else cfg.dtype)
    return _from_numpy(tree, param_shapes(cfg), lambda path: dict(
        device=dev, dtype=_family_dtype(cfg, path, dt)
        if isinstance(cfg, MixtralConfig)
        else torch.float32 if _is_scale(path) else dt),
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
        device=dev, dtype=_ln_fp32_dtype(path, dt)))


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
            return torch.ones(shape, dtype=_ln_fp32_dtype(path, dt), device=dev)
        if path[-1] == "bias":
            return torch.zeros(shape, dtype=_ln_fp32_dtype(path, dt),
                               device=dev)
        fan_in = shape[1] if path[-1] == "embedding" else shape[0]
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (t * (1.0 / math.sqrt(fan_in))).to(dt)

    return _map_tree(gpt2_param_shapes(cfg), make)


# --------------------------------------------------------------------- #
# the dense families of A5.4 (the MoE families' tree is above)
# --------------------------------------------------------------------- #


def _dense(din: int, dout: int, bias: bool = True) -> Dict[str, Any]:
    d: Dict[str, Any] = {"kernel": (din, dout)}
    if bias:
        d["bias"] = (dout,)
    return d


def _norm(M: int) -> Dict[str, Any]:
    return {"scale": (M,), "bias": (M,)}


def opt_param_shapes(cfg: OPTConfig) -> Dict[str, Any]:
    """The flax tree of ``OPT(cfg)``: a ``word_embed_proj_dim`` embedding
    projected in and out (opt-350m), positions offset by 2, the final
    LayerNorm on pre-LN models only, ``lm_head`` when untied."""
    M, F, V = cfg.hidden_size, cfg.ffn_dim, cfg.vocab_size
    E = cfg.word_embed_proj_dim or M
    tree: Dict[str, Any] = {
        "embed_tokens": {"embedding": (V, E)},
        "embed_positions": {"embedding": (cfg.max_seq_len
                                          + cfg.POSITION_OFFSET, M)}}
    if E != M:
        tree["project_in"] = _dense(E, M, bias=False)
        tree["project_out"] = _dense(M, E, bias=False)
    for li in range(cfg.num_layers):
        tree[f"layer_{li}"] = {
            "self_attn": {f"{n}_proj": _dense(M, M)
                          for n in ("q", "k", "v", "out")},
            "self_attn_layer_norm": _norm(M),
            "fc1": _dense(M, F), "fc2": _dense(F, M),
            "final_layer_norm": _norm(M)}
    if cfg.do_layer_norm_before:
        tree["final_layer_norm"] = _norm(M)
    if not cfg.tie_embeddings:
        tree["lm_head"] = _dense(E, V, bias=False)
    return tree


def bloom_param_shapes(cfg: BloomConfig) -> Dict[str, Any]:
    """The flax tree of ``Bloom(cfg)``."""
    M, V = cfg.hidden_size, cfg.vocab_size
    tree: Dict[str, Any] = {"word_embeddings": {"embedding": (V, M)},
                            "word_embeddings_layernorm": _norm(M)}
    for li in range(cfg.num_layers):
        attn = {f"{n}_proj": _dense(M, M) for n in "qkv"}
        attn["dense"] = _dense(M, M)
        tree[f"layer_{li}"] = {
            "input_layernorm": _norm(M), "self_attention": attn,
            "post_attention_layernorm": _norm(M),
            "dense_h_to_4h": _dense(M, 4 * M),
            "dense_4h_to_h": _dense(4 * M, M)}
    tree["ln_f"] = _norm(M)
    if not cfg.tie_embeddings:
        tree["lm_head"] = _dense(M, V, bias=False)
    return tree


def gpt_neox_param_shapes(cfg: GPTNeoXConfig) -> Dict[str, Any]:
    """The flax tree of ``GPTNeoX(cfg)``: ``embed_out`` when untied."""
    M, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    HD = cfg.num_heads * cfg.head_dim
    tree: Dict[str, Any] = {"embed_in": {"embedding": (V, M)}}
    for li in range(cfg.num_layers):
        layer = {f"{n}_proj": _dense(M, HD) for n in "qkv"}
        layer.update({"input_layernorm": _norm(M), "dense": _dense(HD, M),
                      "post_attention_layernorm": _norm(M),
                      "dense_h_to_4h": _dense(M, I),
                      "dense_4h_to_h": _dense(I, M)})
        tree[f"layer_{li}"] = layer
    tree["final_layer_norm"] = _norm(M)
    if not cfg.tie_embeddings:
        tree["embed_out"] = _dense(M, V, bias=False)
    return tree


def gptj_param_shapes(cfg: GPTJConfig) -> Dict[str, Any]:
    """The flax tree of ``GPTJ(cfg)``: bias-free q/k/v/out, a biased
    ``lm_head`` when untied."""
    M, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    HD = cfg.num_heads * cfg.head_dim
    tree: Dict[str, Any] = {"wte": {"embedding": (V, M)}}
    for li in range(cfg.num_layers):
        layer = {f"{n}_proj": _dense(M, HD, bias=False) for n in "qkv"}
        layer.update({"ln_1": _norm(M),
                      "out_proj": _dense(HD, M, bias=False),
                      "fc_in": _dense(M, I), "fc_out": _dense(I, M)})
        tree[f"layer_{li}"] = layer
    tree["ln_f"] = _norm(M)
    if not cfg.tie_embeddings:
        tree["lm_head"] = _dense(M, V)
    return tree


def falcon_param_shapes(cfg: FalconConfig) -> Dict[str, Any]:
    """The flax tree of ``Falcon(cfg)``: bias-free projections, K/V at
    ``num_kv_heads`` width, ``ln_attn`` / ``ln_mlp`` on the new decoder
    architecture, ``post_attention_layernorm`` on a serial block."""
    M, V, D = cfg.hidden_size, cfg.vocab_size, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    tree: Dict[str, Any] = {"word_embeddings": {"embedding": (V, M)}}
    for li in range(cfg.num_layers):
        layer: Dict[str, Any] = {
            "self_attention": {
                "q_proj": _dense(M, H * D, bias=False),
                "k_proj": _dense(M, KV * D, bias=False),
                "v_proj": _dense(M, KV * D, bias=False),
                "dense": _dense(H * D, M, bias=False)},
            "mlp": {"dense_h_to_4h": _dense(M, 4 * M, bias=False),
                    "dense_4h_to_h": _dense(4 * M, M, bias=False)}}
        if cfg.new_decoder_architecture:
            layer.update(ln_attn=_norm(M), ln_mlp=_norm(M))
        else:
            layer["input_layernorm"] = _norm(M)
            if not cfg.parallel_attn:
                layer["post_attention_layernorm"] = _norm(M)
        tree[f"layer_{li}"] = layer
    tree["ln_f"] = _norm(M)
    if not cfg.tie_embeddings:
        tree["lm_head"] = _dense(M, V, bias=False)
    return tree


def phi_param_shapes(cfg: PhiConfig) -> Dict[str, Any]:
    """The flax tree of ``Phi(cfg)``: biased projections, a biased
    ``lm_head``."""
    M, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    tree: Dict[str, Any] = {"embed_tokens": {"embedding": (V, M)}}
    for li in range(cfg.num_layers):
        attn = {f"{n}_proj": _dense(M, M) for n in "qkv"}
        attn["dense"] = _dense(M, M)
        tree[f"layer_{li}"] = {"input_layernorm": _norm(M),
                               "self_attn": attn, "fc1": _dense(M, I),
                               "fc2": _dense(I, M)}
    tree["final_layernorm"] = _norm(M)
    tree["lm_head"] = _dense(M, V)
    return tree


#: the dense families' shape functions, by config type
FAMILY_SHAPES = {OPTConfig: opt_param_shapes, BloomConfig: bloom_param_shapes,
                 GPTNeoXConfig: gpt_neox_param_shapes,
                 GPTJConfig: gptj_param_shapes,
                 FalconConfig: falcon_param_shapes,
                 PhiConfig: phi_param_shapes,
                 MixtralConfig: mixtral_param_shapes}


def param_shapes(cfg: Any) -> Dict[str, Any]:
    """The tree of shapes of any served family's config."""
    fn = FAMILY_SHAPES.get(type(cfg))
    if fn is not None:
        return fn(cfg)
    if isinstance(cfg, LlamaConfig):
        return llama_param_shapes(cfg)
    if isinstance(cfg, GPT2Config):
        return gpt2_param_shapes(cfg)
    raise TypeError(f"no parameter tree for {type(cfg).__name__}")


def family_params_from_numpy(tree: Mapping[str, Any], cfg: Any,
                             device: Any = None,
                             dtype: Any = None) -> Dict[str, Any]:
    """The JAX tree of an OPT, BLOOM, GPT-NeoX, GPT-J, Falcon, Phi or MoE
    (Mixtral, Qwen2-MoE) model (leaves as numpy arrays) -> the port's tree
    of torch tensors on ``device`` (default ``cuda``) in ``dtype``
    (default ``cfg.param_dtype``, the MoE configs' ``cfg.dtype``), the
    leaves of :func:`_family_dtype` fp32. Paths and shapes are checked
    against ``cfg``; an extra or missing leaf raises."""
    dev = resolve_device(device)
    dt = _default_dtype(cfg, dtype)
    return _from_numpy(tree, FAMILY_SHAPES[type(cfg)](cfg), lambda path: dict(
        device=dev, dtype=_family_dtype(cfg, path, dt)))


def _default_dtype(cfg: Any, dtype: Any) -> torch.dtype:
    if dtype is None:
        dtype = getattr(cfg, "param_dtype", None) or cfg.dtype
    return resolve_dtype(dtype)


def init_family_params(cfg: Any, seed: int = 0, device: Any = None,
                       dtype: Any = None) -> Dict[str, Any]:
    """Seeded random weights of a dense or MoE family made directly on
    ``device`` (default ``cuda``) with an explicit ``torch.Generator``:
    Dense kernels and expert stacks normal with std 1/sqrt(fan_in),
    embeddings with std 1/sqrt(width) (1 for the MoE families, as
    :func:`init_llama_params`), biases zero, norm scales one; the leaves
    of :func:`_family_dtype` fp32, the rest in ``dtype`` (default as
    :func:`family_params_from_numpy`)."""
    dev = resolve_device(device)
    dt = _default_dtype(cfg, dtype)
    moe = isinstance(cfg, MixtralConfig)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def make(path, shape):
        ldt = _family_dtype(cfg, path, dt)
        if path[-1] == "scale":
            return torch.ones(shape, dtype=ldt, device=dev)
        if path[-1] == "bias":
            return torch.zeros(shape, dtype=ldt, device=dev)
        if path[-1] == "embedding":
            fan_in = 1 if moe else shape[1]
        else:
            fan_in = shape[-2]
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (t * (1.0 / math.sqrt(fan_in))).to(ldt)

    return _map_tree(FAMILY_SHAPES[type(cfg)](cfg), make)
