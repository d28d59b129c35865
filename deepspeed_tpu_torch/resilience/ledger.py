"""Restart ledger — a JSON audit trail of worker lifecycle events.

Port of ``deepspeed_tpu/resilience/ledger.py``, host code that the port keeps its
own copy of (it imports nothing of the JAX package).

The elastic agent appends one record per supervisor event (launch, exit,
restart, backoff, give-up, forwarded signal). Postmortems on a flaky fleet
need exactly this: when did the run start crash-looping, what exit codes,
which world sizes. The file is a single JSON document
``{"events": [...]}`` rewritten atomically on every append — always
parseable, even if the supervisor itself dies mid-write.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ..utils.logging import logger


class RestartLedger:
    def __init__(self, path: Optional[str]):
        self.path = path
        self._events: List[Dict[str, Any]] = []
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self._events = json.load(f).get("events", [])
            except (OSError, ValueError) as e:
                logger.warning(f"restart ledger {path} unreadable ({e}); "
                               f"starting fresh")

    def record(self, event: str, **fields) -> Dict[str, Any]:
        rec = {"event": event, "time": time.time(), **fields}
        self._events.append(rec)
        if self.path:
            try:
                tmp = self.path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"events": self._events}, f, indent=2)
                os.replace(tmp, self.path)
            except OSError as e:
                logger.warning(f"restart ledger write failed: {e}")
        return rec

    def replace(self, old: Optional[Dict[str, Any]], event: str,
                **fields) -> Dict[str, Any]:
        """Record ``event`` after removing ``old`` (a record previously
        returned by :meth:`record`/:meth:`replace`) by IDENTITY — the
        bounded-collapse primitive for high-frequency markers whose
        history only needs the latest entry (the train observer's
        ``train_progress`` events)."""
        if old is not None:
            for i in range(len(self._events) - 1, -1, -1):
                if self._events[i] is old:
                    del self._events[i]
                    break
        return self.record(event, **fields)

    @property
    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)
