"""Elastic batch-size computation (the port's own copy of
``deepspeed_tpu/elasticity/elasticity.py``, which imports nothing of JAX).

Capability parity with the reference's ``elasticity/elasticity.py``
(``compute_elastic_config:233``, v0.1 ``:83`` / v0.2 ``:126`` algorithms,
``ensure_immutable_elastic_config:208`` — SURVEY.md §5 "Failure detection /
elastic recovery"): given allowed micro-batch sizes and a max acceptable
global batch, pick the global batch size compatible with the *largest set of
device counts*, so the scheduler can scale the job up/down without touching
convergence (global batch stays fixed; micro×GAS×dp re-factorizes).

v0.1 searches batch sizes built by scaling each micro-batch (and their LCM)
to the nearest highly-composite multiple. v0.2 works at node granularity
with a fixed ``model_parallel_size`` and ``num_gpus_per_node`` (here:
chips per host), and also returns the chosen micro-batch.

The knob names keep ds_config spelling ("gpus" are devices). The port's
engine runs on one card: a world above 1 is multi-device training
(ROADMAP A8).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.logging import logger

#: smallest highly composite numbers — enough for ~720K batch sizes
#: (the reference uses the same table; it is a mathematical constant list)
_HCN = [
    1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840, 1260,
    1680, 2520, 5040, 7560, 10080, 15120, 20160, 25200, 27720, 45360,
    50400, 55440, 83160, 110880, 166320, 221760, 277200, 332640, 498960,
    554400, 665280, 720720,
]

#: env var carrying the scheduler's view of the elastic config
ELASTICITY_ENV = "DSTPU_ELASTICITY_CONFIG"


class ElasticityError(RuntimeError):
    pass


class ElasticityConfigError(ElasticityError):
    pass


class ElasticityIncompatibleWorldSize(ElasticityError):
    pass


def _lcm(values: Sequence[int]) -> int:
    out = 1
    for v in values:
        out = out * v // math.gcd(out, v)
    return out


def _candidate_batch_sizes(bases: Sequence[int], max_batch: int) -> List[int]:
    """Scale each base to the largest HCN multiple <= max_batch."""
    out = set()
    for base in bases:
        if base >= max_batch:
            out.add(base)
            continue
        limit = max_batch // base
        hcn = max(h for h in _HCN if h <= limit)
        out.add(hcn * base)
    return sorted(out)


def _valid_device_counts(batch: int, micro_batches: Sequence[int],
                         lo: int, hi: int) -> List[int]:
    """All device counts in [lo, hi] for which batch = micro*gas*n works."""
    valid = set()
    for mb in micro_batches:
        if batch % mb:
            continue
        slots = batch // mb          # micro-batches per global batch
        for n in range(1, int(math.isqrt(slots)) + 1):
            if slots % n == 0:
                for d in (n, slots // n):
                    if lo <= d <= hi:
                        valid.add(d)
    return sorted(valid)


def _best_batch(micro_batches: Sequence[int], max_batch: int, lo: int,
                hi: int, prefer_larger: bool) -> Tuple[int, List[int]]:
    if any(mb > max_batch for mb in micro_batches):
        raise ElasticityConfigError(
            f"every micro batch must be <= max_acceptable_batch_size "
            f"({max_batch}); got {list(micro_batches)}")
    bases = list(micro_batches) + [_lcm(micro_batches)]
    best = (min(micro_batches), [])
    for cand in _candidate_batch_sizes(bases, max_batch):
        counts = _valid_device_counts(cand, micro_batches, lo, hi)
        better = len(counts) > len(best[1]) or (
            len(counts) == len(best[1]) and
            (cand > best[0] if prefer_larger else cand < best[0]))
        if better:
            best = (cand, counts)
    return best


def _v01(micro_batches, max_batch, min_dev=None, max_dev=None,
         prefer_larger=True):
    min_dev = min_dev or 1
    max_dev = max_dev or max_batch // min(micro_batches)
    return _best_batch(micro_batches, max_batch, min_dev, max_dev,
                       prefer_larger)


def _v02(micro_batches, max_batch, current_devices, min_dev, max_dev,
         prefer_larger=True, devices_per_node=1, model_parallel_size=1):
    if devices_per_node % model_parallel_size:
        raise ElasticityError(
            f"num_gpus_per_node ({devices_per_node}) must be divisible by "
            f"model_parallel_size ({model_parallel_size}) in elasticity v0.2")
    dp_per_node = devices_per_node // model_parallel_size

    current_dp_ranks = max(1, current_devices // model_parallel_size)

    def pick_micro(batch: int) -> Optional[int]:
        # the micro batch must divide the per-DP-RANK batch (model-parallel
        # ranks share samples, they don't add batch slots)
        chosen = None
        for mb in micro_batches:
            if (batch // current_dp_ranks) % mb == 0:
                if chosen is None or (prefer_larger and mb > chosen):
                    chosen = mb
        return chosen

    batch, node_counts = _v01(
        micro_batches, max_batch // dp_per_node,
        max(1, min_dev // devices_per_node),
        max(1, max_dev // devices_per_node), prefer_larger)
    batch *= dp_per_node
    dp_counts = [n * dp_per_node for n in node_counts]
    if current_devices // model_parallel_size in dp_counts:
        return batch, dp_counts, pick_micro(batch)

    # current allocation not in the preferred set: fit a batch to it
    current_dp = (current_devices // devices_per_node) * dp_per_node
    fitted = [mb * current_dp * (max_batch // (mb * current_dp))
              for mb in micro_batches if mb * current_dp <= max_batch]
    if not fitted:
        raise ElasticityIncompatibleWorldSize(
            f"no micro batch in {list(micro_batches)} fits "
            f"{current_devices} devices under max batch {max_batch}")
    batch = max(fitted) if prefer_larger else min(fitted)
    return batch, [current_dp], pick_micro(batch)


def compute_elastic_config(config, world_size: int = 0,
                           return_microbatch: bool = False):
    """Compute (final_batch_size, valid_device_counts[, micro_batch]).

    ``config`` is a Config, an ElasticityConfig, or a ds_config-style dict
    with an ``elasticity`` block. When ``world_size`` > 0 the current world
    must be in the valid set (raises ElasticityIncompatibleWorldSize
    otherwise) and the per-world micro-batch is resolved.
    """
    ecfg = _as_elastic_cfg(config)
    if not ecfg["enabled"]:
        raise ElasticityConfigError("elasticity block is not enabled")
    micro = list(ecfg["micro_batch_sizes"])
    if not micro or any(m <= 0 for m in micro):
        raise ElasticityConfigError(
            f"micro_batch_sizes must be positive: {micro}")
    version = float(ecfg["version"])
    if version >= 0.2:
        ws = world_size or ecfg["num_gpus_per_node"]
        batch, counts, mb = _v02(
            micro, ecfg["max_train_batch_size"], ws,
            ecfg["min_gpus"], ecfg["max_gpus"],
            devices_per_node=ecfg["num_gpus_per_node"],
            model_parallel_size=ecfg["model_parallel_size"])
    else:
        batch, counts = _v01(micro, ecfg["max_train_batch_size"],
                             ecfg["min_gpus"], ecfg["max_gpus"])
        mb = None

    if world_size > 0:
        dp = world_size // ecfg["model_parallel_size"]
        if dp not in counts:
            raise ElasticityIncompatibleWorldSize(
                f"world size {world_size} (dp {dp}) not in the elastic set "
                f"{counts} for batch {batch}")
        if mb is None:
            per = batch // dp
            fits = [m for m in micro if per % m == 0]
            if not fits:
                raise ElasticityIncompatibleWorldSize(
                    f"no configured micro batch divides {per} "
                    f"(batch {batch} over dp {dp})")
            mb = max(fits)
    if return_microbatch:
        return batch, counts, mb
    return batch, counts


def ensure_immutable_elastic_config(runtime_cfg) -> None:
    """Fail if the scheduler launched this job under a different elastic
    config than the runtime sees (env ``DSTPU_ELASTICITY_CONFIG``)."""
    if ELASTICITY_ENV not in os.environ:
        logger.warning(
            f"{ELASTICITY_ENV} not set; cannot guarantee the resource "
            "scheduler scales this job with compatible device counts")
        return
    sched = json.loads(os.environ[ELASTICITY_ENV])
    run = _as_elastic_cfg(runtime_cfg)
    for key in ("max_train_batch_size", "micro_batch_sizes", "version"):
        sv = sched.get(key)
        if sv is not None and sv != run[key]:
            raise ElasticityConfigError(
                f"elastic config mismatch: scheduler saw {key}={sv}, "
                f"runtime has {key}={run[key]}")


def _as_elastic_cfg(config) -> Dict:
    if isinstance(config, dict):
        block = config.get("elasticity", config)
        get = block.get
    else:
        block = getattr(config, "elasticity", config)
        get = lambda k, d=None: getattr(block, k, d)  # noqa: E731
    return {
        "enabled": bool(get("enabled", False)),
        "max_train_batch_size": int(get("max_train_batch_size", 2000)),
        "micro_batch_sizes": list(get("micro_batch_sizes", [2, 4, 6])),
        "min_gpus": int(get("min_gpus", 1)),
        "max_gpus": int(get("max_gpus", 10000)),
        "version": float(get("version", 0.2)),
        "num_gpus_per_node": int(get("num_gpus_per_node", 1)),
        "model_parallel_size": int(get("model_parallel_size", 1)),
    }
