"""Nested parameter dicts (flax's layout) <-> flat ``"a.b.c"`` dicts (what
``torch.func.functional_call`` and the engine's foreach updates take)."""

from __future__ import annotations

from typing import Any, Dict, Mapping


def flatten(tree: Mapping[str, Any], sep: str = ".",
            prefix: str = "") -> Dict[str, Any]:
    """Leaves of a nested dict keyed by their joined paths, in the tree's
    own key order."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, sep, key + sep))
        else:
            out[key] = v
    return out


def unflatten(flat: Mapping[str, Any], sep: str = ".") -> Dict[str, Any]:
    """The nested dict of a flat ``{"a.b.c": leaf}`` dict."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split(sep)
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out
