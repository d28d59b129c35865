"""Typed config base machinery (port of
``deepspeed_tpu/config/config_utils.py``; the port keeps its own copy).

Every sub-config is a dataclass built from a (possibly partial) JSON dict,
with the literal string ``"auto"`` meaning "resolve me later", warnings for
unknown keys, and deprecated-key aliasing.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Type, TypeVar

logger = logging.getLogger("deepspeed_tpu_torch")

AUTO = "auto"

T = TypeVar("T", bound="ConfigModel")


def is_auto(value: Any) -> bool:
    return isinstance(value, str) and value.lower() == AUTO


@dataclasses.dataclass
class ConfigModel:
    """Base for all sub-configs. Fields whose default factory is a
    ConfigModel subclass are built recursively from nested dicts; a bare
    bool stands for ``{"enabled": value}``."""

    @classmethod
    def from_dict(cls: Type[T], data: Optional[Dict[str, Any]] = None,
                  path: str = "") -> T:
        data = dict(data or {})
        field_map = {f.name: f for f in dataclasses.fields(cls)
                     if not f.name.startswith("_")}
        for old, new in getattr(cls, "DEPRECATED_ALIASES", {}).items():
            if old in data:
                logger.warning(f"Config key '{path}{old}' is deprecated; "
                               f"use '{new}'")
                data.setdefault(new, data.pop(old))
        kwargs = {}
        for key, value in data.items():
            if key not in field_map:
                logger.warning(f"Unknown config key '{path}{key}' — ignored")
                continue
            sub_cls = _nested_config_class(field_map[key])
            if sub_cls is not None and isinstance(value, dict):
                kwargs[key] = sub_cls.from_dict(value, path=f"{path}{key}.")
            elif sub_cls is not None and isinstance(value, bool):
                kwargs[key] = sub_cls.from_dict({"enabled": value},
                                                path=f"{path}{key}.")
            else:
                kwargs[key] = value
        return cls(**kwargs)


def _nested_config_class(f: dataclasses.Field) -> Optional[Type[ConfigModel]]:
    """If the field's default factory builds a ConfigModel, that class."""
    factory = f.default_factory  # type: ignore[misc]
    if isinstance(factory, type) and issubclass(factory, ConfigModel):
        return factory
    return None
