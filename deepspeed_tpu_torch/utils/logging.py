"""Rank-aware logging.

Port of ``deepspeed_tpu/utils/logging.py``, host code that the port keeps its
own copy of (it imports nothing of the JAX package).

``logger`` plus ``log_dist``, which only emits on the requested ranks:
the ``torch.distributed`` rank when a process group is initialised,
else 0.
"""

from __future__ import annotations

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name: str = "deepspeed_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        logger_.addHandler(handler)
    return logger_


logger = _create_logger(
    level=LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info").lower(), logging.INFO)
)


def _process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given host ranks (default: rank 0 only).

    ``ranks=[-1]`` logs on every host. Mirrors the semantics of the reference
    ``log_dist`` (deepspeed/utils/logging.py).
    """
    my_rank = _process_index()
    ranks = ranks if ranks is not None else [0]
    if -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message: str) -> None:
    _warn_once_impl(message)


@functools.lru_cache(None)
def _warn_once_impl(message: str) -> None:
    logger.warning(message)


def see_memory_usage(message: str, force: bool = False) -> None:
    """Log the card's live / peak / total memory."""
    if not force:
        return
    import torch
    if not torch.cuda.is_available():
        logger.info(f"{message} | (memory stats unavailable: no CUDA "
                    f"device)")
        return
    gib = 1024 ** 3
    in_use = torch.cuda.memory_allocated() / gib
    peak = torch.cuda.max_memory_allocated() / gib
    limit = torch.cuda.get_device_properties(0).total_memory / gib
    logger.info(f"{message} | {torch.cuda.get_device_name(0)} | MA "
                f"{in_use:.2f} GB | Peak {peak:.2f} GB | Limit "
                f"{limit:.2f} GB")
