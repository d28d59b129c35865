"""Optional ``torch.profiler`` hooks, gated on ``DSTPU_TRACE_DIR`` (port
of ``deepspeed_tpu/telemetry/trace.py``, where they drive
``jax.profiler``).

The flight recorder answers "what was the HOST doing"; a device timeline
needs the profiler. Set ``DSTPU_TRACE_DIR`` and :func:`maybe_trace`
captures CPU and CUDA activity of its body and exports a Chrome trace
(``chrome://tracing`` / Perfetto) under that directory; unset, both
helpers are inert nullcontexts.

While any profiler runs, the serve engine's plan / dispatch / commit
phases are named ranges in the trace (``telemetry/serve.py``
``ServeObserver.phase``), so each kernel launch shows under the phase
that enqueued it.
"""

from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext
from typing import Optional


def trace_dir() -> Optional[str]:
    return os.environ.get("DSTPU_TRACE_DIR") or None


def trace_path(label: str) -> Optional[str]:
    """Where :func:`maybe_trace` exports ``label``'s Chrome trace (None
    with ``DSTPU_TRACE_DIR`` unset)."""
    d = trace_dir()
    return os.path.join(d, f"{label}.json") if d else None


@contextmanager
def maybe_trace(label: str = "dstpu"):
    """A ``torch.profiler.profile`` (CPU, and CUDA when a card is
    present) around the body when DSTPU_TRACE_DIR is set, exported as a
    Chrome trace at ``<dir>/<label>.json``; yields whether tracing is
    active."""
    path = trace_path(label)
    if path is None:
        yield False
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield True
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)


def annotate(name: str):
    """A ``torch.profiler.record_function`` range when tracing is enabled
    (names a host span inside the captured timeline), else a free
    nullcontext."""
    if not trace_dir():
        return nullcontext()
    import torch
    return torch.profiler.record_function(name)
