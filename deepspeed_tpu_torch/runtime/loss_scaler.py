"""Static and dynamic fp16 loss scaling (port of
``deepspeed_tpu/runtime/loss_scaler.py``).

The JAX package carries the scaler state through its compiled step and
gates the update with ``jnp.where``. The port's engine is eager: the state
is a small host-side record, and ``update_state`` takes the overflow flag
the engine has already read back (fp16 only; the JAX package reads it back
too, to count skipped steps).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

from ..config.config import FP16Config


class LossScaleState(NamedTuple):
    scale: float
    growth_tracker: int      # consecutive non-overflow steps
    hysteresis: int          # remaining overflow tolerance
    overflows: int           # total skipped steps


def init_state(cfg: FP16Config) -> LossScaleState:
    if not cfg.enabled:
        scale = 1.0
    elif cfg.loss_scale != 0.0:
        scale = float(cfg.loss_scale)
    else:
        scale = float(2.0 ** cfg.initial_scale_power)
    return LossScaleState(scale=scale, growth_tracker=0,
                          hysteresis=int(cfg.hysteresis), overflows=0)


def grads_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """A 0-d bool tensor: every gradient element is finite."""
    flags = [torch.isfinite(g).all() for g in grads]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def update_state(state: LossScaleState, finite: bool,
                 cfg: FP16Config) -> LossScaleState:
    """Dynamic loss-scale update: an overflow consumes hysteresis, then
    halves the scale (not below ``min_loss_scale``); ``loss_scale_window``
    clean steps double it. A static scale passes through unchanged."""
    if not cfg.enabled:
        return state
    if cfg.loss_scale != 0.0:
        return state._replace(overflows=state.overflows + (0 if finite else 1))
    full_hyst = int(cfg.hysteresis)
    if not finite:
        spent = state.hysteresis <= 1
        return LossScaleState(
            scale=max(state.scale / 2.0, float(cfg.min_loss_scale))
            if spent else state.scale,
            growth_tracker=0,
            hysteresis=state.hysteresis if spent else state.hysteresis - 1,
            overflows=state.overflows + 1)
    tracker = state.growth_tracker + 1
    grow = tracker >= cfg.loss_scale_window
    if cfg.consecutive_hysteresis:
        hyst = full_hyst
    else:
        hyst = full_hyst if grow else state.hysteresis
    return LossScaleState(scale=state.scale * 2.0 if grow else state.scale,
                          growth_tracker=0 if grow else tracker,
                          hysteresis=hyst, overflows=state.overflows)
