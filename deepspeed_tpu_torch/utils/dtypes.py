"""Dtype-name mapping (port of ``deepspeed_tpu/utils/dtypes.py``)."""

from __future__ import annotations

from typing import Any

import torch

DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
}


def resolve_dtype(name: Any) -> torch.dtype:
    """A dtype name (``"bf16"``, ``"float32"``, ...) or a ``torch.dtype``
    -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    if not isinstance(name, str):
        raise TypeError(f"expected a dtype name or torch.dtype, got {name!r}")
    try:
        return DTYPES[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown dtype '{name}'. Known: {sorted(DTYPES)}")


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast the floating-point tensors of a nested dict/list/tuple tree to
    ``dtype``; other leaves unchanged. fp32 returns the tree as it is."""
    if dtype == torch.float32:
        return tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
