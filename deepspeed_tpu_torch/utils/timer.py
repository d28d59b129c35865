"""Wall-clock and throughput timers (port of
``deepspeed_tpu/utils/timer.py``: ``SynchronizedWallClockTimer``,
``ThroughputTimer``, ``NoopTimer`` and the timer names).

A timer's boundary takes an optional ``barrier_value``: a tensor whose
work must be done before the clock is read. For a CUDA tensor that is a
``torch.cuda.synchronize`` of its device, so the phase's time is the
card's, not the host's enqueue; a CPU tensor is already computed and
needs no wait. A failing synchronize raises (a deferred CUDA error
surfaces here, as it would at any other host read).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self.started = False
        self._start_time = 0.0
        self._elapsed = 0.0
        self.count = 0

    def start(self, barrier_value=None):
        if self.started:
            return
        if barrier_value is not None:
            _block(barrier_value)
        self._start_time = time.perf_counter()
        self.started = True

    def stop(self, barrier_value=None, record: bool = True):
        if not self.started:
            return
        if barrier_value is not None:
            _block(barrier_value)
        if record:
            self._elapsed += time.perf_counter() - self._start_time
            self.count += 1
        self.started = False

    def elapsed(self, reset: bool = True) -> float:
        """Elapsed seconds since last reset."""
        value = self._elapsed
        if self.started:
            value += time.perf_counter() - self._start_time
        if reset:
            self._elapsed = 0.0
            self.count = 0
        return value

    def mean(self) -> float:
        return self._elapsed / max(self.count, 1)

    def reset(self):
        self._elapsed = 0.0
        self.count = 0
        self.started = False


def _block(value) -> None:
    """Wait until ``value`` (a tensor, or a list / tuple / dict of them)
    is computed: synchronize each CUDA device it lives on."""
    if isinstance(value, dict):
        value = list(value.values())
    devices = {t.device for t in (value if isinstance(value, (list, tuple))
                                  else [value])
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class SynchronizedWallClockTimer:
    """Named-timer group; ``log()`` prints ms per phase like the reference."""

    def __init__(self):
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def has_timer(self, name: str) -> bool:
        return name in self.timers

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False, ranks=None):
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {ms:.2f}")
        if parts:
            log_dist("time (ms) | " + " | ".join(parts), ranks=ranks)

    def get_mean(self, names: List[str], normalizer: float = 1.0) -> Dict[str, float]:
        return {
            name: self.timers[name].mean() * 1000.0 / normalizer
            for name in names
            if name in self.timers
        }


class NoopTimer:
    class _N:
        def start(self, *a, **k): ...
        def stop(self, *a, **k): ...
        def reset(self): ...
        def elapsed(self, *a, **k): return 0.0
        def mean(self): return 0.0

    def __init__(self):
        self._n = self._N()

    def __call__(self, name):
        return self._n

    def has_timer(self, name):
        return False

    def log(self, *a, **k): ...
    def get_mean(self, *a, **k): return {}


class ThroughputTimer:
    """Samples/sec + TFLOPS reporting (reference utils/timer.py:199)."""

    def __init__(self, batch_size: int, steps_per_output: int = 100,
                 monitor_memory: bool = False, logging_fn=None):
        self.batch_size = max(batch_size, 1)
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or log_dist
        self.initialized = False
        self.global_step_count = 0
        self.start_time = 0.0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self.micro_step_count = 0
        self._started = False

    def update_epoch_count(self):
        self.initialized = False

    def start(self):
        self.start_time = time.perf_counter()
        self._started = True

    def stop(self, global_step: bool, report_speed: bool = True, flops_per_sample: Optional[float] = None):
        if not self._started:
            return
        self._started = False
        duration = time.perf_counter() - self.start_time
        self.total_elapsed_time += duration
        self.step_elapsed_time += duration
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
            if report_speed and self.global_step_count % self.steps_per_output == 0:
                samples_per_sec = self.avg_samples_per_sec()
                msg = (f"step={self.global_step_count}, "
                       f"RunningAvgSamplesPerSec={samples_per_sec:.4f}, "
                       f"CurrSamplesPerSec={self.batch_size / self.step_elapsed_time:.4f}")
                if flops_per_sample:
                    tflops = samples_per_sec * flops_per_sample / 1e12
                    msg += f", TFLOPS={tflops:.2f}"
                self.logging(msg)
            self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        if self.global_step_count == 0 or self.total_elapsed_time == 0:
            return 0.0
        return (self.global_step_count * self.batch_size) / self.total_elapsed_time
