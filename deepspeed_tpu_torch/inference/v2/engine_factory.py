"""``build_hf_engine``: an HF checkpoint directory -> a running ragged
engine (port of ``deepspeed_tpu/inference/v2/engine_factory.py``).

``config.json`` -> arch and model config (``models/registry.py``), shards
-> parameter tree (``checkpoint/hf_loader.py``), optional weight-only
quantization (``inference/quantization.py``), then
:class:`InferenceEngineV2`, and with ``draft_model_dir`` a draft model
paired for speculative decoding (``attach_draft``). The port serves
every architecture the JAX factory serves: the dense Llama family
(llama, mistral, qwen, qwen2, phi3), gpt2, opt, bloom, gpt_neox, gptj,
phi, and the MoE families mixtral and qwen2_moe. An architecture the JAX
factory does not serve (falcon among them: it has no HF name map, and
``InferenceEngineV2`` serves its config) raises ``ValueError`` before
any shard is read.
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

#: architectures the JAX package serves through build_hf_engine, all of
#: them ported
_RAGGED_ARCHES = {"llama", "mistral", "qwen", "qwen2", "phi3", "phi", "gpt2",
                  "opt", "mixtral", "qwen2_moe", "bloom", "gpt_neox", "gptj"}

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
    serving is not ported). ``draft_model_dir``: a small draft checkpoint
    of the target's vocabulary (any ported family), loaded with the same
    ``dtype`` override and paired by ``engine.attach_draft``; speculation
    uses it when the config's ``spec_decode`` is "draft". ``device``
    defaults to ``cuda`` and raises without a card; pass ``"cpu"`` for
    the plain path. Each tensor goes to the device as it is read."""
    for d in (model_dir, draft_model_dir):
        if d is not None:
            _check_servable(d)

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
    if draft_model_dir is not None:
        d_arch, d_cfg, d_params = load_hf_model(draft_model_dir,
                                                strict=strict, device=dev)
        if dtype is not None:
            d_cfg = dataclasses.replace(d_cfg, dtype=resolve_dtype(dtype))
        engine.attach_draft(d_cfg, d_params)
        logger.info("build_hf_engine: draft %s from %s (spec_decode=%s)",
                    d_arch, draft_model_dir, cfg.spec_decode)
    logger.info("build_hf_engine: %s from %s (quant=%s)", arch, model_dir,
                quantization_mode or "off")
    return engine


def _check_servable(model_dir: str) -> None:
    """Refuse a checkpoint whose architecture build_hf_engine does not
    serve (ValueError), from its ``config.json`` alone."""
    with open(os.path.join(model_dir, "config.json")) as f:
        arch_name = json.load(f).get("model_type", "").lower()
    if arch_name not in _RAGGED_ARCHES:
        # fail BEFORE reading the (possibly multi-GB) weight shards
        raise ValueError(
            f"architecture '{arch_name}' is not servable via build_hf_engine "
            f"(have {sorted(_RAGGED_ARCHES)}); load params yourself and use "
            "InferenceEngineV2")
