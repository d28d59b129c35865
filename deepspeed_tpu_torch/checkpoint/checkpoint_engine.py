"""Pluggable checkpoint backends (port of
``deepspeed_tpu/checkpoint/checkpoint_engine.py``).

  - :class:`SyncCheckpointEngine` — write-through (the default).
  - :class:`AsyncCheckpointEngine` — ``save`` hands the host copy of the
    state (``engine_checkpoint.host_leaves``, complete before ``save`` is
    called) to a background thread and returns; ``commit`` waits for the
    write and publishes ``latest`` only after the tag's files are
    durable. A failed write raises at the next ``commit`` or ``save``.

Select via config: ``checkpoint: {"async_save": true}``. An ``atexit``
hook flushes every live async writer, so the last checkpoint of a run is
never cut short by the interpreter's exit.
"""

from __future__ import annotations

import atexit
import threading
import weakref
from typing import Dict, List, Optional

from ..utils.logging import log_dist, logger
from .engine_checkpoint import Leaf, publish_latest, save_state_tree

#: live async engines: flush_all_pending() lets another engine instance
#: (or process teardown) wait out in-flight background writes before
#: reading a checkpoint directory
_LIVE_ASYNC = weakref.WeakSet()


def flush_all_pending() -> None:
    for eng in list(_LIVE_ASYNC):
        eng.commit()


# daemon writer threads die at interpreter shutdown; without this the last
# checkpoint of a run could be silently truncated
atexit.register(flush_all_pending)


class CheckpointEngine:
    """create -> save -> commit, one tag at a time.

    ``save`` persists the leaves under ``ckpt_dir``; with ``publish`` as
    ``(save_dir, tag)`` the ``latest`` pointer is written only after the
    tag is durable and re-validated (``engine_checkpoint.publish_latest``).
    """

    def create(self, tag: str) -> None:  # noqa: D401 — reference API name
        """Begin a checkpoint under ``tag``."""

    def save(self, leaves: List[Leaf], ckpt_dir: str,
             extra_meta: Optional[Dict] = None,
             publish: Optional[tuple] = None,
             retries: Optional[int] = None,
             retry_backoff_s: Optional[float] = None,
             stats: Optional[Dict] = None) -> None:
        raise NotImplementedError

    def commit(self) -> None:
        """Block until all pending saves are durable."""


class SyncCheckpointEngine(CheckpointEngine):
    def save(self, leaves, ckpt_dir, extra_meta=None, publish=None,
             retries=None, retry_backoff_s=None, stats=None):
        save_state_tree(leaves, ckpt_dir, extra_meta=extra_meta,
                        retries=retries, retry_backoff_s=retry_backoff_s,
                        stats=stats)
        if publish is not None:
            publish_latest(*publish)


class AsyncCheckpointEngine(CheckpointEngine):
    """Background-thread writer. The leaves must already be host copies,
    so training goes on while serialization and disk I/O run off-thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        _LIVE_ASYNC.add(self)

    def save(self, leaves, ckpt_dir, extra_meta=None, publish=None,
             retries=None, retry_backoff_s=None, stats=None):
        self.commit()

        def _write():
            try:
                save_state_tree(leaves, ckpt_dir, extra_meta=extra_meta,
                                retries=retries,
                                retry_backoff_s=retry_backoff_s,
                                stats=stats)
                if publish is not None:
                    publish_latest(*publish)
            except BaseException as e:  # surfaced on next commit/save
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()
        log_dist(f"async checkpoint write started -> {ckpt_dir}")

    def commit(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint write failed: {err}") from err


def build_checkpoint_engine(name: str) -> CheckpointEngine:
    name = (name or "sync").lower()
    if name in ("sync", "torch", "default"):
        return SyncCheckpointEngine()
    if name in ("async", "nebula"):
        return AsyncCheckpointEngine()
    logger.warning(f"unknown checkpoint engine '{name}', using sync")
    return SyncCheckpointEngine()
