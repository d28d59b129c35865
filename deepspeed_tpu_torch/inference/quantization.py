"""Weight-only quantization (WOQ) for inference (port of
``deepspeed_tpu/inference/quantization.py``).

Matching weight leaves of a nested parameter dict are quantized once, at
load, to int8 / int4 group storage (``ops/kernels/quantization.py``: the
CUDA kernels for CUDA tensors), to minifloat storage
(``ops/fp_quantizer.py``) or to the fused fp6 GEMM layout
(``ops/kernels/fp6_gemm.py``). The ragged runner dequantizes each leaf at
its use (``model_runner.woq_mm``); fp6 GEMM leaves stay packed and go
through the fused kernel. In an MoE tree, as in the JAX quantizer, the
3-D expert stacks (``moe/wi_gate`` ...) take the generic packed form
(the fused fp6 layout is for 2-D weights) and are dequantized at their
use, before the grouped GEMM; the 2-D leaves (the shared expert, and the
router, which ``_moe_mlp`` unpacks rather than send its tiny product to
the fp6 kernel) are packed as any other.

Config schema (the JAX package's):
    {"quantized_weights": {"enabled": true, "num_bits": 8,
                           "group_size": 128, "modules": [".*"],
                           "excluded_modules": ["embed"],
                           "dtype": "fp6", "fused_gemm": false}}
Paths are the dotted flax paths of the tree (``layer_0.attn.q_proj.kernel``);
a pattern matches as a substring or as a regular expression.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Mapping, Sequence

import torch

from ..ops.fp_quantizer import FPQuantizedTensor, fp_dequantize, fp_quantize
from ..ops.kernels.fp6_gemm import (Fp6GemmWeight, fp6_gemm_pack,
                                    fp6_gemm_unpack)
from ..ops.kernels.quantization import (QuantizedTensor, dequantize_blockwise,
                                        quantize_blockwise)

logger = logging.getLogger(__name__)

#: the packed leaf types a WOQ tree may hold
WOQ_LEAVES = (QuantizedTensor, FPQuantizedTensor, Fp6GemmWeight)


def _leaf_path(path: Sequence[str]) -> str:
    return ".".join(str(k) for k in path)


def _matches(path: str, patterns: Sequence[str]) -> bool:
    for p in patterns:
        if p in path:
            return True
        try:
            if re.search(p, path):
                return True
        except re.error:
            pass   # pattern is a plain name with regex metachars
    return False


def _map_leaves(tree: Any, fn, path=()) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def quantize_model_params(params: Any, cfg: Dict) -> Any:
    """Replace matching >= 2-D floating leaves with quantized storage."""
    if "quantized_weights" not in cfg:
        raise ValueError(
            "WOQ config must contain a 'quantized_weights' block "
            f"(got keys {sorted(cfg)})")
    block = cfg["quantized_weights"]
    if not block.get("enabled", True):
        return params
    bits = int(block.get("num_bits", 8))
    group = int(block.get("group_size", 128))
    modules = list(block.get("modules", [".*"]))
    excluded = list(block.get("excluded_modules", []))
    # num_bits 6/12 (or an explicit dtype "fp6"/"fp8"/"fp12") select the
    # minifloat formats; bare num_bits=8 keeps its int8 meaning
    fused = bool(block.get("fused_gemm", False))
    dtype_key = str(block.get("dtype", "")).lower()
    if fused and (dtype_key not in ("", "fp6") or
                  (not dtype_key and bits != 6)):
        raise ValueError(
            "quantized_weights.fused_gemm is only implemented for the "
            f"fp6 serving dtype (got dtype={dtype_key or bits!r}); drop "
            "fused_gemm or use dtype: 'fp6'")
    if dtype_key.startswith("fp"):
        if dtype_key not in ("fp6", "fp8", "fp12"):
            raise ValueError(
                f"quantized_weights.dtype must be one of "
                f"'fp6'/'fp8'/'fp12' (minifloat serving formats), "
                f"got {dtype_key!r}")
        bits = int(dtype_key[2:])
        fp_mode = True
    else:
        fp_mode = bits in (6, 12)
    count = [0]

    def leaf(path, x):
        ps = _leaf_path(path)
        if not isinstance(x, torch.Tensor) or x.dim() < 2 \
                or not x.is_floating_point():
            return x
        if excluded and _matches(ps, excluded):
            return x
        if not _matches(ps, modules):
            return x
        count[0] += 1
        if fp_mode:
            # the fused layout is for matmul weights only: an embedding
            # table is read by a gather, which needs a dense array
            if fused and bits == 6 and x.dim() == 2 and x.shape[1] % 4 == 0 \
                    and not ps.endswith("embedding"):
                return fp6_gemm_pack(x)
            return fp_quantize(x, q_bits=bits, group_size=group)
        return quantize_blockwise(x, bits=bits, group_size=group)

    out = _map_leaves(params, leaf)
    logger.info("WOQ: quantized %d weight tensors to %s%d (group %d)",
                count[0], "fp" if fp_mode else "int", bits, group)
    return out


def dequantize_leaf(x: Any) -> Any:
    """One leaf of :func:`dequantize_tree`: an f32 tensor for a packed
    leaf, anything else as it is."""
    if isinstance(x, QuantizedTensor):
        return dequantize_blockwise(x)
    if isinstance(x, FPQuantizedTensor):
        return fp_dequantize(x)
    if isinstance(x, Fp6GemmWeight):
        return fp6_gemm_unpack(x)
    return x


def dequantize_tree(params: Any) -> Any:
    """Dequantized (dense) view of a WOQ params tree, fused fp6 GEMM
    leaves included."""
    return _map_leaves(params, lambda _, x: dequantize_leaf(x))


def woq_memory_bytes(params: Any) -> int:
    """Weight-storage bytes of a (possibly WOQ) params tree."""
    total = [0]

    def add(_, x):
        if isinstance(x, WOQ_LEAVES):
            total[0] += sum(t.numel() * t.element_size() for t in x
                            if isinstance(t, torch.Tensor))
        elif isinstance(x, torch.Tensor):
            total[0] += x.numel() * x.element_size()
        return x

    _map_leaves(params, add)
    return total[0]
