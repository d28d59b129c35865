"""Step watchdog — stall detection for hung steps / wedged collectives.

Port of ``deepspeed_tpu/resilience/watchdog.py``, host code that the port keeps its
own copy of (it imports nothing of the JAX package).

Communication-heavy schedules (ZeRO++ quantized collectives, EP all-to-all)
add collective phases per step; a wedged collective presents as a step that
simply never finishes, with no error anywhere. The reference stack leans on
torch-elastic's worker heartbeats; under single-controller SPMD the
idiomatic equivalent is an in-process heartbeat thread:

  - the engine calls :meth:`step_start` / :meth:`step_end` around each
    compiled step (and :meth:`phase` at named sub-phases);
  - the thread compares the in-flight step's age against
    ``stall_factor x`` the trailing-median step time;
  - on a stall it logs a diagnosis naming the last phase and the last
    collective recorded through ``comm._record`` (so a hung collective is
    *named*, not just implied), and — when ``action='abort'`` — hard-exits
    with ``MEMBERSHIP_CHANGE_EXIT`` so the elastic agent restarts the
    worker from the newest checkpoint.

An optional ``heartbeat_file`` receives a small JSON blob every check
interval; external supervisors (k8s liveness probes, the elastic agent)
can watch its mtime without attaching to the process.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..utils.logging import logger

#: the elastic agent's "cooperative membership change" exit code (the JAX
#: package's ``elasticity/elastic_agent.MEMBERSHIP_CHANGE_EXIT``): a
#: supervisor restarts the worker on it
MEMBERSHIP_CHANGE_EXIT = 99


class StepWatchdog:
    def __init__(self, stall_factor: float = 5.0,
                 check_interval_s: float = 2.0,
                 min_median_samples: int = 3,
                 min_stall_s: float = 10.0,
                 action: str = "log",
                 heartbeat_file: Optional[str] = None,
                 history: int = 64,
                 on_stall: Optional[Callable[[dict], None]] = None,
                 abort_exit_code: Optional[int] = None):
        if action not in ("log", "abort"):
            raise ValueError(f"watchdog action must be log|abort, got {action!r}")
        self.stall_factor = float(stall_factor)
        self.check_interval_s = float(check_interval_s)
        self.min_median_samples = int(min_median_samples)
        self.min_stall_s = float(min_stall_s)
        self.action = action
        self.heartbeat_file = heartbeat_file
        self.on_stall = on_stall
        if abort_exit_code is None:
            abort_exit_code = MEMBERSHIP_CHANGE_EXIT
        self.abort_exit_code = int(abort_exit_code)

        self._durations: deque = deque(maxlen=int(history))
        self._lock = threading.Lock()
        self._step: Optional[int] = None        # in-flight step, None = idle
        self._step_t0 = 0.0
        self._last_phase = "idle"
        self._stall_reported_for: Optional[int] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="step-watchdog")
        self._thread.start()

    # ------------------------- engine-facing ------------------------- #

    def step_start(self, step: int) -> None:
        with self._lock:
            self._step = int(step)
            self._step_t0 = time.monotonic()
            self._last_phase = "step"

    def phase(self, name: str) -> None:
        with self._lock:
            self._last_phase = str(name)

    def step_end(self, step: int) -> None:
        with self._lock:
            if self._step is not None:
                self._durations.append(time.monotonic() - self._step_t0)
            self._step = None
            self._last_phase = "idle"

    def step_abort(self) -> None:
        """The step died (exception mid-step): go idle WITHOUT recording a
        duration — a stale in-flight marker would otherwise read as a
        stall forever (and action='abort' would kill a recovered
        process)."""
        with self._lock:
            self._step = None
            self._last_phase = "idle"

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    # --------------------------- the thread --------------------------- #

    def _median(self) -> Optional[float]:
        if len(self._durations) < self.min_median_samples:
            return None
        return statistics.median(self._durations)

    def check_once(self, now: Optional[float] = None) -> Optional[dict]:
        """One stall evaluation (also called directly by tests). Returns the
        diagnosis dict when a stall is detected, else None."""
        now = time.monotonic() if now is None else now
        with self._lock:
            step, t0 = self._step, self._step_t0
            phase = self._last_phase
            median = self._median()
        if step is None or median is None:
            return None
        elapsed = now - t0
        budget = max(self.stall_factor * median, self.min_stall_s)
        if elapsed <= budget or self._stall_reported_for == step:
            return None
        self._stall_reported_for = step
        diag = {
            "step": step,
            "elapsed_s": round(elapsed, 3),
            "median_step_s": round(median, 3),
            "stall_factor": self.stall_factor,
            "last_phase": phase,
            # the port records no collectives yet (A8): none is named
            "last_collective": None,
            "action": self.action,
        }
        logger.error(
            f"WATCHDOG: step {step} stalled — {elapsed:.1f}s elapsed vs "
            f"median {median:.3f}s (budget {budget:.1f}s); last phase "
            f"'{phase}', last collective {diag['last_collective']}")
        try:
            # dump every live phase flight recorder (telemetry/
            # flight_recorder.py): the postmortem shows the spans leading
            # into the stall. Best-effort — a dump failure must never
            # mask the stall being reported.
            from ..telemetry.flight_recorder import auto_dump
            diag["flight_dumps"] = auto_dump("watchdog_stall")
        except Exception as e:
            logger.warning(f"watchdog flight dump failed: {e}")
        if self.on_stall is not None:
            try:
                self.on_stall(diag)
            except Exception as e:   # a broken callback must not kill the dog
                logger.warning(f"watchdog on_stall callback failed: {e}")
        if self.action == "abort":
            logger.error(f"WATCHDOG: aborting for restart "
                         f"(exit {self.abort_exit_code})")
            os._exit(self.abort_exit_code)
        return diag

    def _heartbeat(self) -> None:
        if not self.heartbeat_file:
            return
        with self._lock:
            blob = {
                "time": time.time(),
                "in_step": self._step,
                "last_phase": self._last_phase,
                "steps_recorded": len(self._durations),
                "median_step_s": self._median(),
            }
        try:
            tmp = self.heartbeat_file + ".tmp"
            with open(tmp, "w") as f:
                json.dump(blob, f)
            os.replace(tmp, self.heartbeat_file)
        except OSError as e:
            logger.warning(f"watchdog heartbeat write failed: {e}")

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self._heartbeat()
                self.check_once()
            except Exception as e:    # never let the watchdog thread die
                logger.warning(f"watchdog check failed: {e}")
