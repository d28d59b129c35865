"""``build_hf_engine``: an HF checkpoint directory -> a running ragged
engine (port of ``deepspeed_tpu/inference/v2/engine_factory.py``).

``config.json`` -> arch and model config (``models/registry.py``), shards
-> parameter tree (``checkpoint/hf_loader.py``), optional weight-only
quantization (``inference/quantization.py``), then
:class:`InferenceEngineV2`. The port serves the architectures that the
JAX package sends to the dense Llama runner; the other architectures JAX
serves raise ``NotImplementedError`` naming queue item A5.4, and both
checks come before any shard is read.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Optional

from ...checkpoint.hf_loader import load_hf_model
from ...utils.device import resolve_device
from ...utils.dtypes import resolve_dtype
from .config import RaggedInferenceConfig
from .engine_v2 import InferenceEngineV2

logger = logging.getLogger(__name__)

#: architectures the JAX package serves through build_hf_engine
_RAGGED_ARCHES = {"llama", "mistral", "qwen", "qwen2", "phi3", "phi", "gpt2",
                  "opt", "mixtral", "qwen2_moe", "bloom", "gpt_neox", "gptj"}
#: ... of which the port has a runner for (the dense Llama runner)
_PORTED_ARCHES = {"llama", "mistral", "qwen", "qwen2", "phi3"}

#: the JAX factory's module lists for quantization_mode "wf8" / "wf4"
WOQ_MODULES = ["proj", "fc", "attn", "mlp"]
WOQ_EXCLUDED = ["embed", "wte", "wpe", "norm", "ln"]


def build_hf_engine(model_dir: str,
                    engine_config: Optional[RaggedInferenceConfig] = None,
                    dtype: Optional[str] = None,
                    quantization_mode: Optional[str] = None,
                    strict: bool = True,
                    tp_size: Optional[int] = None,
                    draft_model_dir: Optional[str] = None,
                    device: Any = None) -> InferenceEngineV2:
    """Build a ragged inference engine from a HuggingFace checkpoint dir.

    ``dtype``: the compute dtype (default the config's, bf16); the
    weights keep the checkpoint's dtype. ``quantization_mode``: None,
    ``"wf8"`` (int8 weight-only) or ``"wf4"`` (int4), as the JAX
    factory's. ``tp_size`` > 1 is refused by the config (multi-device
    serving is not ported). ``device`` defaults to ``cuda`` and raises
    without a card; pass ``"cpu"`` for the plain path. Each tensor goes to
    the device as it is read."""
    if draft_model_dir is not None:
        raise NotImplementedError(
            "draft_model_dir: speculative decoding is not ported yet "
            "(queue item A5.2)")
    with open(os.path.join(model_dir, "config.json")) as f:
        arch_name = json.load(f).get("model_type", "").lower()
    if arch_name not in _RAGGED_ARCHES:
        # fail BEFORE reading the (possibly multi-GB) weight shards
        raise ValueError(
            f"architecture '{arch_name}' is not servable via build_hf_engine "
            f"(have {sorted(_RAGGED_ARCHES)}); load params yourself and use "
            "InferenceEngineV2")
    if arch_name not in _PORTED_ARCHES:
        raise NotImplementedError(
            f"architecture '{arch_name}': its ragged runner is not ported "
            f"yet (queue item A5.4); ported: {sorted(_PORTED_ARCHES)}")
    bits = None
    if quantization_mode:
        bits = {"wf8": 8, "wf4": 4}.get(quantization_mode)
        if bits is None:
            raise ValueError(
                f"quantization_mode must be 'wf8' or 'wf4', "
                f"got {quantization_mode!r}")
    cfg = engine_config or RaggedInferenceConfig()
    if tp_size is not None:
        cfg = dataclasses.replace(cfg, tp_size=int(tp_size))
    dev = resolve_device(device)
    arch, model_cfg, params = load_hf_model(model_dir, strict=strict,
                                            device=dev)
    if dtype is not None:
        model_cfg = dataclasses.replace(model_cfg,
                                        dtype=resolve_dtype(dtype))
    if bits is not None:
        from ..quantization import quantize_model_params
        params = quantize_model_params(params, {"quantized_weights": {
            "enabled": True, "num_bits": bits, "modules": WOQ_MODULES,
            "excluded_modules": WOQ_EXCLUDED}})
    engine = InferenceEngineV2(model_cfg, params, cfg, device=dev)
    logger.info("build_hf_engine: %s from %s (quant=%s)", arch, model_dir,
                quantization_mode or "off")
    return engine
