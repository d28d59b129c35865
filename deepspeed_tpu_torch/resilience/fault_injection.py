"""Deterministic fault injection.

Port of ``deepspeed_tpu/resilience/fault_injection.py``, host code that the port keeps its
own copy of (it imports nothing of the JAX package).

TPU fleets lose runs to preemption mid-save, torn checkpoint files, hung
collectives, and host OOM — failure modes that never occur in a clean CI
box. The :class:`FaultInjector` makes every recovery path in this repo
testable on CPU: it fires a crash (or an I/O error) at a *named site* the
production code passes through, driven either by env vars (subprocess
crash drills — ``bin/dstpu_faultdrill``) or programmatically (in-process
tests).

Sites (see docs/resilience.md):

    ``pre_save``             before any checkpoint byte is written
    ``mid_save``             after the state file is written into the tmp
                             dir: the file is TORN (truncated) first, then
                             the crash fires — simulates a kill mid-write
    ``post_save_pre_latest`` tag dir fully durable, ``latest`` not yet
                             updated — simulates preemption between rename
                             and publish
    ``collective``           inside ``comm._record`` (trace time) — a crash
                             while a collective-bearing program is being
                             built
    ``step``                 at the top of ``Engine.train_batch`` once
                             ``global_steps >= at_step``

Serve sites (the v2 ragged engine's pipeline, docs/resilience.md
"Serving"): each models a replica dying at a different point of the
plan/dispatch/commit overlap window — the serve drill
(``bin/dstpu_faultdrill --mode serve``) crashes at every one and proves
journal/manifest replay is token-identical:

    ``pre_dispatch``         a planned step exists, nothing enqueued yet
    ``mid_commit``           ahead of a commit's blocking readback —
                             tokens journaled so far are durable, the
                             in-flight ring is lost
    ``during_prefill_chunk`` a multi-token prefill chunk was just planned
    ``during_cow_copy``      between a partial-tail prefix match and its
                             copy-on-write block-copy dispatch

Env protocol (read lazily on first :func:`get_fault_injector` call):

    DSTPU_FAULT_SITE       one of the names above (unset = disabled)
    DSTPU_FAULT_MODE       exit | raise | ioerror        (default: exit)
    DSTPU_FAULT_STEP       step gate for the ``step`` site (default: 0)
    DSTPU_FAULT_SKIP       skip the first N arrivals at the site
    DSTPU_FAULT_TIMES      fire at most N times           (default: 1)
    DSTPU_FAULT_EXIT_CODE  exit code for mode=exit        (default: 1)
    DSTPU_FAULT_ONCE_FILE  marker path: if it exists the injector is
                           disarmed; touched right before firing — a
                           restarted worker with the same env recovers
                           instead of crash-looping
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ..utils.logging import logger

#: the canonical site names (docs + faultdrill iterate over these)
FAULT_SITES = ("pre_save", "mid_save", "post_save_pre_latest",
               "collective", "step",
               # serve-side sites (InferenceEngineV2's pipeline)
               "pre_dispatch", "mid_commit", "during_prefill_chunk",
               "during_cow_copy",
               # disaggregated-serving site (docs/serving.md): inside a
               # prefill specialist's handoff_out gather loop, BEFORE
               # any source state is released — the drill proves an
               # aborted handoff loses nothing (bin/dstpu_faultdrill
               # --mode disagg)
               "during_handoff_gather")

#: the serve-loop subset (bin/dstpu_faultdrill --mode serve drills these;
#: the train drill keeps its original five). The disagg site is drilled
#: by its own fleet-shaped mode, not the single-engine serve loop —
#: a lone engine never hands off.
TRAIN_FAULT_SITES = FAULT_SITES[:5]
SERVE_FAULT_SITES = FAULT_SITES[5:9]
DISAGG_FAULT_SITE = FAULT_SITES[9]


class InjectedFault(RuntimeError):
    """Raised by mode='raise' injections (in-process tests)."""


class FaultInjector:
    """Fires a configured failure when execution reaches the armed site.

    ``mode``:
      - ``exit``    — ``os._exit(exit_code)``: a hard crash, no atexit /
                      finally blocks run (the realistic preemption model;
                      works from writer threads too)
      - ``raise``   — raise :class:`InjectedFault` (in-process tests)
      - ``ioerror`` — raise ``OSError`` (exercises save retry-with-backoff)
    """

    def __init__(self, site: Optional[str] = None, mode: str = "exit",
                 at_step: int = 0, skip: int = 0, times: int = 1,
                 exit_code: int = 1, once_file: Optional[str] = None):
        if site is not None and site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}; valid: {FAULT_SITES}")
        if mode not in ("exit", "raise", "ioerror"):
            raise ValueError(f"unknown fault mode {mode!r}")
        self.site = site
        self.mode = mode
        self.at_step = int(at_step)
        self.skip = int(skip)
        self.times = int(times)
        self.exit_code = int(exit_code)
        self.once_file = once_file
        self._fired = 0
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env=os.environ) -> "FaultInjector":
        return cls(
            site=env.get("DSTPU_FAULT_SITE") or None,
            mode=env.get("DSTPU_FAULT_MODE", "exit"),
            at_step=int(env.get("DSTPU_FAULT_STEP", "0")),
            skip=int(env.get("DSTPU_FAULT_SKIP", "0")),
            times=int(env.get("DSTPU_FAULT_TIMES", "1")),
            exit_code=int(env.get("DSTPU_FAULT_EXIT_CODE", "1")),
            once_file=env.get("DSTPU_FAULT_ONCE_FILE") or None,
        )

    # ------------------------------------------------------------------ #

    def armed(self, site: str) -> bool:
        if self.site != site or self._fired >= self.times:
            return False
        if self.once_file and os.path.exists(self.once_file):
            return False
        return True

    def maybe_fire(self, site: str, step: Optional[int] = None,
                   torn_file: Optional[str] = None) -> None:
        """Fire if ``site`` is armed. ``step`` gates the ``step`` site;
        ``torn_file`` (mid_save) is truncated to half before the crash so
        a torn write really exists on disk when the process dies."""
        if not self.armed(site):
            return
        if site == "step" and step is not None and step < self.at_step:
            return
        with self._lock:
            if self.skip > 0:
                self.skip -= 1
                return
            if self._fired >= self.times:
                return
            self._fired += 1
        if self.once_file:
            # touch BEFORE dying: the restarted worker must not re-fire
            with open(self.once_file, "w") as f:
                f.write(site)
        if torn_file and os.path.exists(torn_file) and self.mode != "ioerror":
            size = os.path.getsize(torn_file)
            with open(torn_file, "r+b") as f:
                f.truncate(max(1, size // 2))
        logger.error(f"FAULT INJECTION: firing {self.mode} at site "
                     f"'{site}' (step={step})")
        try:
            # leave a flight-recorder trace artifact next to the crash
            # (telemetry/flight_recorder.py; no-op unless
            # DSTPU_FLIGHT_DIR is set) — the drill asserts its presence.
            # Must never interfere with the fault being injected.
            from ..telemetry.flight_recorder import auto_dump
            auto_dump(f"fault_{site}")
        except Exception:
            pass
        if self.mode == "ioerror":
            raise OSError(f"injected I/O error at site '{site}'")
        if self.mode == "raise":
            raise InjectedFault(f"injected fault at site '{site}'")
        os._exit(self.exit_code)


class _NoopInjector(FaultInjector):
    def __init__(self):
        super().__init__(site=None)

    def armed(self, site: str) -> bool:
        return False

    def maybe_fire(self, site, step=None, torn_file=None):
        return


_NOOP = _NoopInjector()
_INJECTOR: Optional[FaultInjector] = None


def get_fault_injector() -> FaultInjector:
    """The process-wide injector; built from env on first use. Disabled
    (no-op) unless DSTPU_FAULT_SITE is set or a test installed one."""
    global _INJECTOR
    if _INJECTOR is None:
        if os.environ.get("DSTPU_FAULT_SITE"):
            _INJECTOR = FaultInjector.from_env()
        else:
            _INJECTOR = _NOOP
    return _INJECTOR


def set_fault_injector(inj: Optional[FaultInjector]) -> None:
    """Install an injector (tests), or None to re-read the env lazily."""
    global _INJECTOR
    _INJECTOR = inj
