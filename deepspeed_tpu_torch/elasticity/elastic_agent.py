"""Elastic restart agent (the port's own copy of
``deepspeed_tpu/elasticity/elastic_agent.py``, which imports nothing of
JAX).

Parity with the reference's ``DSElasticAgent`` (``elasticity/elastic_agent.py:32``,
a torch-elastic ``LocalElasticAgent`` subclass that re-spawns workers on
membership change), as a **supervisor loop**: run the training command;
on failure (or an explicit membership-change exit code) re-launch it
against the currently-available device set, with the elastic config
pinned in the environment (``ensure_immutable_elastic_config`` checks it
runtime-side) — recovery is checkpoint-based (restart ->
``load_checkpoint``). ``MEMBERSHIP_CHANGE_EXIT`` is the one in
``resilience/watchdog.py``. The port's engine trains on one card: a
worker handed ``DSTPU_ELASTIC_WORLD_SIZE`` above 1 refuses it (A8).

Preemption-aware hardening:

  - supervisor SIGTERM/SIGINT are FORWARDED to the worker, which (with
    ``resilience.preemption`` enabled) writes a final checkpoint and exits
    ``MEMBERSHIP_CHANGE_EXIT``; the agent then exits instead of restarting
    — a preempted host drains gracefully end to end;
  - crash restarts back off exponentially, and a **crash-loop budget**
    (consecutive fast failures) stops a wedged fleet from restarting
    forever; cooperative membership-change exits never count against it;
  - every lifecycle event lands in a JSON **restart ledger** for
    postmortems (``resilience/ledger.py``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import time
from typing import Callable, Dict, Optional, Sequence

from ..resilience.ledger import RestartLedger
from ..resilience.watchdog import MEMBERSHIP_CHANGE_EXIT
from ..utils.logging import logger
from .elasticity import ELASTICITY_ENV, compute_elastic_config

__all__ = ["MEMBERSHIP_CHANGE_EXIT", "run_elastic"]


def run_elastic(
    cmd: Sequence[str],
    elastic_config: Dict,
    max_restarts: int = 100,
    discover_world: Optional[Callable[[], int]] = None,
    min_restart_interval_s: float = 5.0,
    env: Optional[Dict[str, str]] = None,
    grace_period_s: float = 30.0,
    backoff_base_s: float = 1.0,
    backoff_max_s: float = 60.0,
    crash_loop_budget: int = 5,
    crash_loop_window_s: float = 60.0,
    ledger_path: Optional[str] = None,
) -> int:
    """Supervise ``cmd`` with elastic restarts.

    ``discover_world`` returns the currently-available device count (default:
    keep the last value); each (re)launch validates it against the elastic
    device-count set and exports the pinned elastic config plus
    ``DSTPU_ELASTIC_WORLD_SIZE`` for the worker.

    On supervisor SIGTERM/SIGINT the signal is forwarded to the worker,
    which gets ``grace_period_s`` to write a final checkpoint; the agent
    then returns without restarting. Crash restarts (exit != 0 and !=
    ``MEMBERSHIP_CHANGE_EXIT``) back off exponentially from
    ``backoff_base_s``; ``crash_loop_budget`` consecutive failures that die
    within ``crash_loop_window_s`` abort the supervision entirely.
    ``ledger_path`` (or env ``DSTPU_RESTART_LEDGER``) records a JSON audit
    trail. Returns the final exit code (0 on success)."""
    batch, valid_dp = compute_elastic_config(
        {"elasticity": dict(elastic_config, enabled=True)})
    # compute_elastic_config returns DATA-PARALLEL rank counts; the agent
    # compares device counts, so scale by the model-parallel degree
    mp = int(elastic_config.get("model_parallel_size", 1) or 1)
    valid_counts = [c * mp for c in valid_dp]
    logger.info(f"elastic agent: batch={batch}, valid device counts="
                f"{valid_counts} (dp counts {valid_dp} x mp {mp})")

    ledger = RestartLedger(ledger_path
                           or os.environ.get("DSTPU_RESTART_LEDGER"))

    stop_signal = {"num": None, "time": None}
    proc_box = {"proc": None}

    def _on_signal(signum, frame):
        # NO ledger write here: the handler runs reentrantly on the main
        # thread and could truncate a record() already in progress — the
        # supervise loop records the event once the wait returns
        stop_signal["num"] = signum
        stop_signal["time"] = time.time()
        p = proc_box["proc"]
        logger.warning(
            f"elastic agent: received {signal.Signals(signum).name}; "
            f"forwarding to worker and draining (grace {grace_period_s}s)")
        if p is not None and p.poll() is None:
            try:
                p.send_signal(signum)
            except OSError:
                pass

    previous_handlers = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous_handlers[sig] = signal.signal(sig, _on_signal)
    except ValueError:
        # not the main thread (tests) — signals degrade to kill-by-caller
        previous_handlers = {}

    restarts = 0
    consecutive_fast_failures = 0
    world = discover_world() if discover_world else 0
    try:
        while True:
            child_env = dict(os.environ)
            child_env[ELASTICITY_ENV] = json.dumps(dict(elastic_config,
                                                        enabled=True))
            if world:
                if world not in valid_counts:
                    usable = [c for c in valid_counts if c <= world]
                    if not usable:
                        raise RuntimeError(
                            f"no elastic device count <= available {world} "
                            f"(valid: {valid_counts})")
                    world = max(usable)
                child_env["DSTPU_ELASTIC_WORLD_SIZE"] = str(world)
            child_env.update(env or {})

            start = time.time()
            proc = subprocess.Popen(list(cmd), env=child_env)
            proc_box["proc"] = proc
            ledger.record("launch", restarts=restarts, world=world or None,
                          pid=proc.pid, t_start=start)
            if stop_signal["num"] is not None:
                # signal raced the launch: forward it now
                try:
                    proc.send_signal(stop_signal["num"])
                except OSError:
                    pass
            rc = None
            while rc is None:
                try:
                    rc = proc.wait(timeout=0.5)
                except subprocess.TimeoutExpired:
                    t0 = stop_signal["time"]
                    if t0 is not None and time.time() - t0 > grace_period_s:
                        logger.error(
                            f"elastic agent: worker ignored the signal for "
                            f"{grace_period_s}s; killing")
                        ledger.record("grace_expired",
                                      grace_period_s=grace_period_s)
                        proc.kill()
                        rc = proc.wait()
                except KeyboardInterrupt:
                    # SIGINT outside our handler (non-main-thread installs)
                    stop_signal["num"] = signal.SIGINT
                    stop_signal["time"] = stop_signal["time"] or time.time()
                    try:
                        proc.send_signal(signal.SIGINT)
                    except OSError:
                        pass
            runtime = time.time() - start
            proc_box["proc"] = None

            if stop_signal["num"] is not None:
                # drain: the worker already got the signal; give it the
                # grace period to finish its final checkpoint (train) or
                # publish its replay manifest (serve — the v2 engine's
                # drain() writes DSTPU_SERVE_DRAIN_MANIFEST and the
                # restarted/survivor replica re-admits from it), then
                # stop supervising — a preempted host must NOT restart
                ledger.record("signal", signum=int(stop_signal["num"]),
                              name=signal.Signals(stop_signal["num"]).name)
                manifest = child_env.get("DSTPU_SERVE_DRAIN_MANIFEST")
                if manifest and not os.path.exists(manifest):
                    manifest = None        # drain never published it
                ledger.record("drained", rc=rc, runtime_s=round(runtime, 3),
                              serve_manifest=manifest,
                              t_start=start, t_end=start + runtime)
                logger.warning(f"elastic agent: draining after signal; "
                               f"worker exit {rc}"
                               + (f", replay manifest {manifest}"
                                  if manifest else ""))
                return 0 if rc in (0, MEMBERSHIP_CHANGE_EXIT) else rc

            if rc == 0:
                ledger.record("success", runtime_s=round(runtime, 3),
                              t_start=start, t_end=start + runtime)
                return 0

            restarts += 1
            membership = rc == MEMBERSHIP_CHANGE_EXIT
            if membership:
                consecutive_fast_failures = 0
            elif runtime < crash_loop_window_s:
                consecutive_fast_failures += 1
            else:
                consecutive_fast_failures = 0

            if restarts > max_restarts:
                logger.error(f"elastic agent: giving up after {restarts - 1} "
                             f"restarts (last exit {rc})")
                ledger.record("giveup", reason="max_restarts", rc=rc,
                              restarts=restarts - 1,
                              t_start=start, t_end=start + runtime)
                return rc
            if consecutive_fast_failures >= crash_loop_budget:
                logger.error(
                    f"elastic agent: crash loop — {consecutive_fast_failures} "
                    f"consecutive failures inside {crash_loop_window_s}s; "
                    f"giving up (last exit {rc})")
                ledger.record("giveup", reason="crash_loop", rc=rc,
                              consecutive_fast_failures=consecutive_fast_failures,
                              t_start=start, t_end=start + runtime)
                return rc

            backoff = 0.0
            if not membership and consecutive_fast_failures > 0:
                backoff = min(
                    backoff_base_s * (2 ** (consecutive_fast_failures - 1)),
                    backoff_max_s)
            wait_s = max(backoff,
                         min_restart_interval_s - runtime
                         if runtime < min_restart_interval_s else 0.0)
            if discover_world:
                world = discover_world()
            logger.warning(
                f"elastic agent: worker exited {rc} "
                f"({'membership change' if membership else 'failure'}), "
                f"restart {restarts}/{max_restarts} with "
                f"world={world or 'unchanged'}"
                + (f" after {wait_s:.1f}s backoff" if wait_s else ""))
            ledger.record("restart", rc=rc, restarts=restarts,
                          membership_change=membership,
                          backoff_s=round(wait_s, 3), world=world or None,
                          runtime_s=round(runtime, 3),
                          t_start=start, t_end=start + runtime)
            if wait_s:
                time.sleep(wait_s)
    finally:
        for sig, prev in previous_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
