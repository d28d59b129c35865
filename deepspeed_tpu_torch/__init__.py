"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference; this package mirrors
its module paths (``deepspeed_tpu_torch/inference/v2/engine_v2.py`` is the
counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py``) and imports
neither JAX nor the JAX package. Hot-path kernels are hand-written CUDA
under ``ops/kernels/csrc/``, built with nvcc on first use — never at
import time.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back.

Training on one card (GPT-2, the Llama family, Mixtral / Qwen2-MoE and
the dense families: ``models.registry.get_arch(name).make_model``)::

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, make_model
    model, init_fn, loss_fn = make_model(GPT2Config.xl_1p3b())
    engine, _, _, _ = initialize(loss_fn=loss_fn, params=init_fn(seed=0),
                                 config=ds_config)
    loss = engine.train_batch({"tokens": tokens})     # [B, T+1]
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from .utils.device import resolve_device

__all__ = ["initialize", "resolve_device"]


def initialize(*, loss_fn: Optional[Callable] = None, params: Any = None,
               config: Any = None, device: Any = None
               ) -> Tuple[Any, Any, Any, Any]:
    """Build a training engine (port of ``deepspeed_tpu.initialize``).
    Returns ``(engine, optimizer, dataloader, lr_scheduler)``; the
    optimizer and the schedule are the engine's own, the dataloader is
    None (not ported). ``loss_fn(params, batch, key) -> loss`` is the
    model (``key`` a threefry key, ``utils/random.py``), ``params`` its nested parameter dict, ``config`` a ds_config
    dict, JSON path or ``Config``. Runs on ``cuda`` unless
    ``device="cpu"``; without a card it raises."""
    from .config.config import Config
    from .runtime.engine import Engine
    dev = resolve_device(device)
    if loss_fn is None:
        raise ValueError("initialize() requires loss_fn")
    if params is None:
        raise ValueError("initialize() requires params (the model's "
                         "parameter dict)")
    engine = Engine(loss_fn=loss_fn, params=params,
                    config=Config.load(config), device=dev)
    return engine, engine.optimizer, None, engine.lr_schedule
