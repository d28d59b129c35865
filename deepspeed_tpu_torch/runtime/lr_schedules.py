"""LR schedules (port of ``deepspeed_tpu/runtime/lr_schedules.py``).

Host-side ``step -> lr`` functions with the JAX package's names and
parameter keys, so a ds_config ``scheduler`` block drops in: WarmupLR,
WarmupDecayLR, WarmupCosineLR, OneCycle, LRRangeTest and Constant. They
return Python floats; the engine reads one per step.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

Schedule = Callable[[int], float]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def _warmup_frac(step: float, warmup_num_steps: int, warmup_type: str
                 ) -> float:
    if warmup_type == WARMUP_LOG_RATE:
        frac = math.log1p(step) / math.log(warmup_num_steps)
    else:
        frac = step / warmup_num_steps
    return _clip(frac, 0.0, 1.0)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000,
              warmup_type: str = WARMUP_LOG_RATE, **_unused) -> Schedule:
    """WarmupLR: warm up (log1p by default) then hold at warmup_max_lr."""
    warmup_num_steps = max(2, warmup_num_steps)
    delta = warmup_max_lr - warmup_min_lr

    def sched(step):
        return warmup_min_lr + delta * _warmup_frac(
            float(step), warmup_num_steps, warmup_type)

    return sched


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001,
                    warmup_num_steps: int = 1000,
                    warmup_type: str = WARMUP_LOG_RATE,
                    **_unused) -> Schedule:
    """WarmupDecayLR: warmup then linear decay to 0 at total_num_steps."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)
    warmup_num_steps = max(2, warmup_num_steps)

    def sched(step):
        step = float(step)
        if step < warmup_num_steps:
            return base(step)
        decay = _clip((total_num_steps - step)
                      / max(1.0, total_num_steps - warmup_num_steps),
                      0.0, 1.0)
        return warmup_max_lr * decay

    return sched


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000,
                     cos_min_ratio: float = 0.0001,
                     warmup_type: str = WARMUP_LINEAR_RATE,
                     base_lr: float = 0.001, **_unused) -> Schedule:
    """WarmupCosineLR: ratio-based warmup then cosine decay."""
    warmup_num_steps = max(2, warmup_num_steps)

    def sched(step):
        step = float(step)
        if step < warmup_num_steps:
            wfrac = _warmup_frac(step, warmup_num_steps, warmup_type)
            return base_lr * (warmup_min_ratio
                              + (1.0 - warmup_min_ratio) * wfrac)
        progress = _clip((step - warmup_num_steps)
                         / max(1.0, total_num_steps - warmup_num_steps),
                         0.0, 1.0)
        return base_lr * (cos_min_ratio + (1.0 - cos_min_ratio) * 0.5
                          * (1.0 + math.cos(math.pi * progress)))

    return sched


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              cycle_first_stair_count: int = 0,
              cycle_second_stair_count: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              post_cycle_decay: bool = True, **_unused) -> Schedule:
    """OneCycle: linear up, linear down, then optional decay."""
    second = (cycle_second_step_size if cycle_second_step_size is not None
              else cycle_first_step_size)
    total_cycle = cycle_first_step_size + second

    def sched(step):
        step = float(step)
        if decay_step_size > 0 and decay_lr_rate > 0 and step >= total_cycle:
            decay_steps = math.floor((step - total_cycle) / decay_step_size)
            return cycle_min_lr / (1.0 + decay_lr_rate
                                   * max(decay_steps, 0.0))
        if step < cycle_first_step_size:
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (
                step / cycle_first_step_size)
        down = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * (
            (step - cycle_first_step_size) / max(second, 1))
        return max(down, cycle_min_lr)

    return sched


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False,
                  **_unused) -> Schedule:
    """LRRangeTest: lr = min_lr * (1 + rate * interval)."""

    def sched(step):
        interval = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + lr_range_test_step_rate
                                       * interval)

    return sched


def constant_lr(lr: float = 0.001, **_unused) -> Schedule:
    def sched(step):
        return float(lr)
    return sched


SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
    "OneCycle": one_cycle,
    "LRRangeTest": lr_range_test,
    "Constant": constant_lr,
}


def build_schedule(sched_type: Optional[str], params: Dict[str, Any],
                   base_lr: Optional[float] = None) -> Schedule:
    """A schedule from a ds_config ``scheduler`` block; with none
    configured, the optimizer's base lr held constant."""
    if sched_type is None:
        return constant_lr(lr=base_lr if base_lr is not None else 0.001)
    if sched_type not in SCHEDULES:
        raise ValueError(f"Unknown scheduler type '{sched_type}'. "
                         f"Known: {sorted(SCHEDULES)}")
    params = dict(params)
    if sched_type == "WarmupCosineLR" and base_lr is not None:
        params.setdefault("base_lr", base_lr)
    return SCHEDULES[sched_type](**params)
