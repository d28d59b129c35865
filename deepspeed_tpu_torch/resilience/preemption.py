"""Preemption grace handling — SIGTERM → final checkpoint → elastic exit.

Port of ``deepspeed_tpu/resilience/preemption.py``, host code that the port keeps its
own copy of (it imports nothing of the JAX package).

TPU preemption (spot/maintenance) delivers SIGTERM with a short grace
window. The flow here mirrors the reference's elastic story (torn-down
workers resume from the newest checkpoint via ``DSElasticAgent``):

  1. :class:`PreemptionHandler` installs signal handlers that only set a
     flag (signal-safe; the previous handler is chained);
  2. the engine polls the flag at the step boundary — the only point where
     ``TrainState`` is consistent — performs an *urgent save*, and exits
     with ``MEMBERSHIP_CHANGE_EXIT``;
  3. the elastic agent (``elasticity/elastic_agent.py``) treats that exit
     as a cooperative membership change and re-launches against the
     surviving device set; ``load_checkpoint`` restores the exact
     ``global_steps`` / optimizer state.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional

from ..utils.logging import logger

_DEFAULT_SIGNALS = ("SIGTERM",)


def _resolve(name) -> signal.Signals:
    if isinstance(name, str):
        return getattr(signal.Signals, name)
    return signal.Signals(name)


class PreemptionHandler:
    """Flag-setting signal handler with chaining and manual triggering.

    Handlers can only be installed from the main thread (CPython rule);
    installation from another thread degrades to manual-only mode
    (:meth:`request` still works) with a warning.
    """

    def __init__(self, signals: Iterable = _DEFAULT_SIGNALS):
        self._event = threading.Event()
        self._signal: Optional[int] = None
        self._previous = {}
        self._installed = False
        sigs = [_resolve(s) for s in signals]
        if threading.current_thread() is threading.main_thread():
            for sig in sigs:
                self._previous[sig] = signal.signal(sig, self._on_signal)
            self._installed = True
        else:
            logger.warning(
                "PreemptionHandler built off the main thread: signal "
                "handlers not installed; only request() will trigger it")

    def _on_signal(self, signum, frame):
        self._signal = signum
        self._event.set()
        logger.warning(f"preemption signal {signal.Signals(signum).name} "
                       f"received — will checkpoint at the step boundary")
        prev = self._previous.get(signal.Signals(signum))
        if callable(prev):
            prev(signum, frame)

    # ------------------------------------------------------------------ #

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    @property
    def signal_received(self) -> Optional[int]:
        return self._signal

    def request(self) -> None:
        """Trigger preemption without a real signal (tests, external
        schedulers that know the deadline out-of-band)."""
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def uninstall(self) -> None:
        """Restore the previous handlers (tests must not leak handlers)."""
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
            except (ValueError, TypeError):
                pass
        self._previous.clear()
        self._installed = False
