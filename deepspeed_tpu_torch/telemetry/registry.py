"""Metrics registry — counters, gauges and streaming histograms.

Port of ``deepspeed_tpu/telemetry/registry.py``, host code that the port keeps its
own copy of (it imports nothing of the JAX package).

The observability substrate every serving/scheduling decision in
ROADMAP's fleet item keys on (docs/observability.md): per-request SLO
numbers (TTFT/TPOT/queue-wait percentiles, goodput), cache and pool
health, and comm-schedule counters as *first-class engine outputs*
instead of ad-hoc bench arithmetic.

Design constraints (why this is not just a dict of floats):

  * **Host-only, commit-boundary cheap.** Every record call is a few
    Python arithmetic ops on host ints/floats — no device access, no
    locks on the count path. The serve engine records inside its
    existing host-side plan/commit boundaries and never waits on the
    device.
  * **Percentiles without samples.** :class:`Histogram` is a log-bucketed
    streaming sketch (DDSketch-style): bucket ``i`` holds values in
    ``(gamma^(i-1), gamma^i]`` with ``gamma = (1+alpha)/(1-alpha)``, so
    any quantile is answered with relative error <= ``alpha`` (default
    5%) from O(log range) ints — p50/p99 over millions of tokens with no
    sample buffer.
  * **No-op when off.** ``DSTPU_TELEMETRY=0`` routes every caller to the
    :class:`NullRegistry`, whose metric handles are shared do-nothing
    singletons — the zero-overhead kill switch (``bench.py serve_obs``
    measures the on-path against it).

Metric names live in :data:`REGISTERED_METRICS`, the JAX package's
catalog as it stands.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: metric-name catalog: name -> one-line meaning (the JAX package's,
#: name for name)
REGISTERED_METRICS = {
    # -- serve request lifecycle (counters) ---------------------------- #
    "serve_requests_admitted": "fresh requests admitted by put()",
    "serve_requests_completed": "requests flushed after clean completion",
    "serve_requests_shed": "requests load-shed (kv_pool_exhausted)",
    "serve_requests_deadline_expired": "requests aborted past deadline",
    "serve_requests_aborted": "requests cancelled via engine.abort()",
    "serve_requests_rejected_draining": "fresh requests refused mid-drain",
    "serve_requests_rejected_admission":
        "offers rejected at the admission door (typed, retriable)",
    "serve_requests_drained": "live requests manifested by drain()",
    "serve_tokens_committed": "output tokens committed (host-visible)",
    "serve_steps": "engine steps dispatched",
    "serve_steps_device_fed": "steps fed from the device token buffer",
    "serve_step_retries": "transient dispatch failures retried",
    # -- speculative decoding (counters) -------------------------------- #
    "spec_proposed": "draft tokens proposed for verification",
    "spec_accepted": "draft tokens accepted by greedy verification",
    "spec_rounds": "speculative propose/verify rounds committed",
    # -- serve latency (histograms, seconds) --------------------------- #
    "serve_ttft_s": "admission -> first committed token",
    "serve_tpot_s": "per-token gap between committed tokens",
    "serve_queue_wait_s": "admission -> first scheduled chunk",
    "serve_plan_s": "per-step plan (scheduler + staging) time",
    "serve_dispatch_s": "per-step dispatch (enqueue) time",
    "serve_commit_block_s": "per-commit blocking readback time",
    # -- step-time attribution (histograms + one labelled counter) ----- #
    "serve_commit_apply_s": "per-commit host-side apply (bookkeeping) time",
    "serve_host_gap_s": "per-step residual host time between brackets",
    "serve_step_wall_s": "per-committed-step wall-clock inside the loop",
    "serve_attrib_seconds_total":
        "cumulative attribution seconds (label: component)",
    # -- prefix cache (counters + gauges) ------------------------------ #
    "prefix_matched_tokens": "prompt tokens served from cached blocks",
    "prefix_prefill_tokens": "prompt tokens that ran a prefill chunk",
    "prefix_cow_copies": "partial-tail copy-on-write block copies",
    "prefix_hit_blocks": "full cached blocks matched",
    "prefix_evicted_blocks": "cached device blocks destroyed (cap + pressure)",
    "prefix_evicted_cap": "cached blocks destroyed by the index cap",
    "prefix_evicted_pressure": "cached blocks destroyed under pool pressure",
    "prefix_cached_blocks": "blocks currently held by the cache",
    "prefix_evictable_blocks": "refcount-0 cached blocks (reclaimable)",
    # -- hierarchical KV: the host-RAM tier (counters + gauge + hist) -- #
    "prefix_demoted_blocks": "device blocks demoted to the host tier",
    "prefix_promoted_blocks": "host-tier blocks promoted back on device",
    "prefix_host_hit_blocks": "matched blocks served from the host tier",
    "prefix_host_evicted_blocks": "host-tier blocks destroyed at its cap",
    "prefix_host_blocks": "blocks currently resident on the host tier",
    "prefix_promote_wait_s": "per-request promotion dispatch wait",
    # -- KV pool (gauges) ---------------------------------------------- #
    "kv_pool_blocks_total": "KV pool capacity in blocks",
    "kv_pool_blocks_free": "allocator-free KV blocks",
    "kv_pool_bytes_total": "KV pool bytes across all chips",
    "kv_pool_bytes_per_chip": "KV pool bytes one chip holds",
    # -- comm schedule (counters, auditor-canonical kinds) ------------- #
    "comm_traced_all_reduce": "all-reduce sites traced (program builds)",
    "comm_traced_all_gather": "all-gather sites traced (incl. ring sites)",
    "comm_traced_reduce_scatter": "reduce-scatter sites traced (incl. ring sites)",
    "comm_traced_ppermute": "raw ppermute sites traced",
    "comm_traced_all_to_all": "all-to-all sites traced",
    "comm_traced_broadcast": "broadcast sites traced",
    # -- FLOPs / roofline (gauges, phase-labelled) --------------------- #
    "achieved_tflops": "achieved TFLOPS for a phase (label: phase)",
    "flops_per_step": "model FLOPs per step for a phase (label: phase)",
    "mxu_utilization": "achieved/peak FLOPs fraction (label: phase)",
    # -- training observatory (telemetry/train.py) --------------------- #
    "train_steps": "committed train steps the observer closed",
    "train_samples": "training samples consumed by committed steps",
    "train_steps_skipped": "overflow-skipped (fp16) train steps",
    "train_nonfinite_steps": "steps with non-finite loss/grad-norm",
    "train_anomalies": "anomaly sentinel trips (nonfinite + z-score)",
    "train_data_wait_s": "between-step span (caller's data fetch)",
    "train_stage_s": "per-step staging (validation, arming, swap-in)",
    "train_dispatch_s": "per-step compiled-step dispatch time",
    "train_device_execute_s": "per-step exposed device wait at readback",
    "train_commit_apply_s": "per-step host bookkeeping after readback",
    "train_host_gap_s": "per-step residual host time between brackets",
    "train_step_wall_s": "per-committed-step wall between exit boundaries",
    "train_attrib_seconds_total":
        "cumulative train attribution seconds (label: component)",
    "train_loss": "last committed step's mean loss",
    "train_grad_norm": "last committed step's global grad norm",
    "train_goodput_frac": "productive fraction of the run's wall clock",
    # -- admission control (serving/admission.py) ----------------------- #
    "admission_window": "admission door's current AIMD concurrency bound",
    "admission_level": "current brownout ladder level (0 = normal)",
    "admission_rejected": "door rejections the controller issued",
    "admission_retry_after_s": "retry hints carried by door rejections",
    "brownout_transitions":
        "brownout ladder moves (label: direction=enter|exit)",
    # -- disaggregated serving handoff (serving/pool.py) ---------------- #
    "serve_handoff_seqs": "sequences handed prefill->decode (source side)",
    "serve_handoff_blocks": "KV blocks moved by handoffs",
    "serve_handoff_bytes": "KV payload bytes moved by handoffs",
    "serve_handoff_seqs_in": "migrated sequences adopted (destination side)",
    "serve_handoff_fallback_replays":
        "handoffs that fell back to manifest replay",
    "serve_handoff_exposed_s": "per-handoff exposed (non-overlapped) wall",
    # -- flight recorder (counter) -------------------------------------- #
    "flight_spans_dropped": "flight-recorder spans evicted by ring wrap",
}


def series_capacity() -> int:
    """Bounded per-metric time-series ring length
    (``DSTPU_SERIES_CAPACITY``, default 120 samples)."""
    return int(os.environ.get("DSTPU_SERIES_CAPACITY", "120") or "120")


def series_interval() -> float:
    """Minimum seconds between time-series samples
    (``DSTPU_SERIES_EVERY_S``, default 1.0; the serve observer calls
    ``maybe_sample`` at every commit boundary and this throttles it)."""
    return float(os.environ.get("DSTPU_SERIES_EVERY_S", "1.0") or "1.0")


def telemetry_enabled() -> bool:
    """The process-wide kill switch: ``DSTPU_TELEMETRY=0`` (or
    ``false``/``off``) disables every registry, recorder and bridge."""
    return os.environ.get("DSTPU_TELEMETRY", "1") \
        not in ("0", "false", "off")


class Counter:
    """Monotone float counter. ``inc`` is the hot path — one add."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n=1.0):
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = v


class Histogram:
    """Log-bucketed streaming histogram (DDSketch-style).

    ``observe(v, n)`` adds ``n`` occurrences of value ``v`` to the bucket
    ``ceil(log_gamma(v))``; ``quantile(q)`` walks the (sorted) buckets
    and returns the geometric midpoint of the covering bucket, clamped
    to the observed [min, max] — relative error <= ``alpha`` by
    construction, exact-ish on single-bucket (constant) distributions.
    Non-positive values land in a dedicated zero bucket.
    """

    __slots__ = ("alpha", "gamma", "_lg", "buckets", "zero", "count",
                 "sum", "min", "max")

    def __init__(self, alpha: float = 0.05):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self.gamma)
        self.buckets: Dict[int, int] = {}
        self.zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v, n=1):
        self.count += n
        self.sum += v * n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.zero += n
            return
        i = math.ceil(math.log(v) / self._lg)
        b = self.buckets
        b[i] = b.get(i, 0) + n

    def quantile(self, q: float) -> Optional[float]:
        if self.count <= 0:
            return None
        # nearest-rank (1-based ceil(q*n)) — an upper quantile over a
        # tiny count lands on the top value instead of collapsing into
        # the median bucket; converges to interpolated percentiles as
        # counts grow, within the alpha bucket error
        target = q * self.count
        if self.zero and target <= self.zero:
            return min(0.0, self.max)
        acc = self.zero
        for i in sorted(self.buckets):
            acc += self.buckets[i]
            if acc >= target:
                est = 2.0 * self.gamma ** i / (self.gamma + 1.0)
                return max(self.min, min(est, self.max))
        return self.max

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into this sketch bucket-wise — EXACT: two
        sketches with the same ``gamma`` hold integer counts in the same
        bucket lattice, so the merged buckets (and zero bucket, count,
        min, max) are identical to a single sketch fed the union of the
        two observation streams — merged quantiles therefore equal
        single-stream quantiles on the same data, which is what makes
        this the fleet-rollup primitive (``MetricsRegistry.merge``).
        Mixed-gamma merges are refused rather than silently degraded —
        except when one side holds no positive observations (an idle
        replica's sketch, or one holding only the lattice-free zero
        bucket): such a side carries no bucket information, so the
        merge adopts the populated side's lattice and stays exact."""
        if other.buckets and self.buckets:
            if not math.isclose(self.gamma, other.gamma,
                                rel_tol=1e-12):
                raise ValueError(
                    f"histogram merge needs identical gamma "
                    f"({self.gamma} vs {other.gamma}) — bucket-wise "
                    f"merge is only exact on one bucket lattice")
        elif other.buckets:
            self.alpha = other.alpha
            self.gamma = other.gamma
            self._lg = other._lg
        b = self.buckets
        for i, n in other.buckets.items():
            b[i] = b.get(i, 0) + n
        self.zero += other.zero
        self.count += other.count
        self.sum += other.sum
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max
        return self

    def state(self) -> Dict[str, Any]:
        """JSON-safe full sketch state (buckets included) — what
        ``snapshot()`` exports so :func:`merge_snapshots` can rebuild
        and merge exactly across processes."""
        out: Dict[str, Any] = {"alpha": self.alpha, "count": self.count,
                               "sum": self.sum, "zero": self.zero,
                               "buckets": {str(i): n for i, n
                                           in self.buckets.items()}}
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
        return out

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "Histogram":
        h = cls(alpha=float(state.get("alpha", 0.05)))
        h.count = int(state.get("count", 0))
        h.sum = float(state.get("sum", 0.0))
        h.zero = int(state.get("zero", 0))
        h.buckets = {int(i): int(n)
                     for i, n in state.get("buckets", {}).items()}
        if h.count:
            h.min = float(state["min"])
            h.max = float(state["max"])
        return h

    def summary(self) -> Dict[str, Any]:
        """Percentile summary PLUS the full sketch state: ``buckets`` /
        ``zero`` / ``alpha`` ride along so an exported snapshot stays
        exactly mergeable (:func:`merge_snapshots`). ``alpha`` is kept
        even when empty — an idle replica's sketch rebuilds on the
        lattice it was configured with, not the default."""
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "alpha": self.alpha}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "alpha": self.alpha,
            "zero": self.zero,
            "buckets": {str(i): n for i, n in self.buckets.items()},
        }


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


_LABEL_RE = None


def _dedupe_source(base: str, labels: Dict[str, Any],
                   used: set) -> None:
    """Suffix ``labels['source']`` until ``(base, labels)`` is a fresh
    key in ``used`` (mutates ``labels``; records the final key). Two
    distinct merge inputs must never silently overwrite one gauge."""
    orig = labels.get("source", "")
    key = _key(base, labels)
    n = 0
    while key in used:
        n += 1
        labels["source"] = f"{orig}#{n}"
        key = _key(base, labels)
    used.add(key)


def _parse_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`_key`: ``name{a="b",c="d"}`` -> (name, labels).
    Label values never contain quotes (they come from ``str()`` of knob
    values / phase names), so a non-greedy quoted scan is exact."""
    global _LABEL_RE
    if "{" not in key:
        return key, {}
    if _LABEL_RE is None:
        import re
        _LABEL_RE = re.compile(r'(\w+)="([^"]*)"')
    name, inner = key.split("{", 1)
    return name, {k: v for k, v in _LABEL_RE.findall(inner.rstrip("}"))}


class MetricsRegistry:
    """A named family of metrics with snapshot / Prometheus / JSON
    export and optional monitor bridges (telemetry.attach_monitor).

    Metric handles are get-or-create by (name, labels) and safe to cache
    — the serve observer binds its hot counters once at engine build."""

    enabled = True

    def __init__(self, name: str = "default"):
        self.name = name
        self._metrics: Dict[str, Any] = {}
        self._types: Dict[str, str] = {}
        self._bridges: List[Any] = []
        self.created_at = time.time()
        # bounded per-metric time series: key -> deque[(wall_t, value)]
        # (counters + gauges; histograms export their full sketch state
        # instead). maybe_sample() throttles to one sample per
        # DSTPU_SERIES_EVERY_S; the ring keeps the last
        # DSTPU_SERIES_CAPACITY samples — a month-long process holds a
        # constant-size series.
        self._series: Dict[str, deque] = {}
        self._series_cap = max(2, series_capacity())
        self._series_every = series_interval()
        self._last_sample = 0.0

    # ------------------------- metric handles ------------------------- #

    def _get(self, kind: str, cls, name: str, labels: Dict[str, Any],
             **kw):
        prev = self._types.get(name)
        if prev is not None and prev != kind:
            raise ValueError(
                f"metric {name!r} already registered as {prev}")
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = cls(**kw)
            self._metrics[key] = m
            self._types[name] = kind
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, alpha: float = 0.05,
                  **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels, alpha=alpha)

    def metric_names(self) -> List[str]:
        """Base metric names (labels stripped) registered so far."""
        return sorted(self._types)

    # ------------------------- time series ----------------------------- #

    def sample(self, now: Optional[float] = None) -> None:
        """Append one time-series point per counter/gauge. Bounded ring
        per key; pure host arithmetic (the serve observer drives this
        from its commit boundary via :meth:`maybe_sample`)."""
        now = time.time() if now is None else now
        for key, m in self._metrics.items():
            if isinstance(m, (Counter, Gauge)):
                dq = self._series.get(key)
                if dq is None:
                    dq = deque(maxlen=self._series_cap)
                    self._series[key] = dq
                dq.append((now, m.value))
        self._last_sample = now

    def maybe_sample(self, now: Optional[float] = None) -> None:
        """Sample iff ``DSTPU_SERIES_EVERY_S`` elapsed since the last
        sample — the per-commit throttle."""
        now = time.time() if now is None else now
        if now - self._last_sample >= self._series_every:
            self.sample(now)

    def series(self) -> Dict[str, List[List[float]]]:
        """{metric key: [[t, value], ...]} — the sampled rings, oldest
        first. Exported alongside snapshots; ``bin/dstpu_top`` turns
        counter series into per-window rates and sparklines."""
        return {key: [[t, v] for t, v in dq]
                for key, dq in self._series.items() if len(dq)}

    def rate(self, name: str, window_s: Optional[float] = None,
             **labels) -> Optional[float]:
        """Windowed rate of a sampled counter: (last - earliest-within-
        window) / dt, or None with fewer than two samples. ``window_s``
        None uses the whole ring."""
        dq = self._series.get(_key(name, labels))
        if not dq or len(dq) < 2:
            return None
        t1, v1 = dq[-1]
        t0, v0 = dq[0]
        if window_s is not None:
            for t, v in dq:
                if t >= t1 - window_s:
                    t0, v0 = t, v
                    break
        return (v1 - v0) / (t1 - t0) if t1 > t0 else None

    # ------------------------- fleet rollup ---------------------------- #

    @classmethod
    def merge(cls, registries: Sequence["MetricsRegistry"],
              name: str = "fleet",
              sources: Optional[Sequence[str]] = None
              ) -> "MetricsRegistry":
        """Roll N registries (e.g. one per serving replica) into one:
        counters SUM, gauges keep per-source identity via an added
        ``source`` label (a pool's free-block gauges must stay per
        replica, not averaged into fiction), histograms merge
        bucket-wise EXACTLY (same gamma ⇒ merged quantiles identical to
        a single stream over the union — :meth:`Histogram.merge`).

        ``sources`` is the STABLE label scheme the fleet path uses
        (docs/observability.md "Fleet rollup"): one label per input
        registry, keyed by replica id — NOT by insertion index — so
        repeated rollups of the same replicas produce identical gauge
        keys regardless of membership-list order, and a rollup of
        rollups stays idempotent. Without ``sources`` the labels fall
        back to each registry's ``name``, disambiguated by index on
        collision (index suffixes are order-dependent; fleet callers
        should always pass ids). A short ``sources`` list is refused —
        it would silently drop replicas. A gauge that ALREADY carries a
        ``source`` label (this registry is itself a rollup) keeps it —
        re-merging rollups preserves the original per-replica
        identities — and if two DIFFERENT inputs still land on one
        gauge key (two pools each holding a replica named "a"), the
        later source is suffixed rather than silently overwriting the
        earlier value."""
        registries = list(registries)
        if sources is not None:
            src_list = [str(s) for s in sources]
            if len(src_list) != len(registries):
                raise ValueError(
                    f"sources has {len(src_list)} entries for "
                    f"{len(registries)} registries — a short list would "
                    f"silently drop replicas from the rollup")
        else:
            src_list = [reg.name for reg in registries]
        out = cls(name)
        seen: Dict[str, int] = {}
        gauge_keys: set = set()
        for reg, src in zip(registries, src_list):
            n = seen.get(src, 0)
            seen[src] = n + 1
            if n:
                src = f"{src}#{n}"
            for key, m in reg._metrics.items():
                base, labels = _parse_key(key)
                if isinstance(m, Counter):
                    out.counter(base, **labels).inc(m.value)
                elif isinstance(m, Gauge):
                    labels.setdefault("source", src)
                    _dedupe_source(base, labels, gauge_keys)
                    out.gauge(base, **labels).set(m.value)
                elif isinstance(m, Histogram):
                    out.histogram(base, alpha=m.alpha,
                                  **labels).merge(m)
        return out

    # --------------------------- exports ------------------------------ #

    def snapshot(self) -> Dict[str, Any]:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} —
        histogram values are ``summary()`` dicts (count/sum/min/max/
        p50/p90/p99)."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for key, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.summary()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition: counters/gauges as-is, histograms
        as summaries (quantile label rows + _count/_sum)."""
        lines: List[str] = []
        seen_type = set()
        for key, m in sorted(self._metrics.items()):
            base = key.split("{", 1)[0]
            if isinstance(m, Counter):
                if base not in seen_type:
                    lines.append(f"# TYPE {base} counter")
                    seen_type.add(base)
                lines.append(f"{key} {m.value:g}")
            elif isinstance(m, Gauge):
                if base not in seen_type:
                    lines.append(f"# TYPE {base} gauge")
                    seen_type.add(base)
                lines.append(f"{key} {m.value:g}")
            else:
                if base not in seen_type:
                    lines.append(f"# TYPE {base} summary")
                    seen_type.add(base)
                labels = key[len(base):].strip("{}")
                for q in (0.5, 0.9, 0.99):
                    val = m.quantile(q)
                    if val is None:
                        continue
                    ql = f'quantile="{q}"'
                    full = f"{base}{{{labels + ',' if labels else ''}{ql}}}"
                    lines.append(f"{full} {val:g}")
                lines.append(f"{base}_count{{{labels}}} {m.count}"
                             if labels else f"{base}_count {m.count}")
                lines.append(f"{base}_sum{{{labels}}} {m.sum:g}"
                             if labels else f"{base}_sum {m.sum:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self, extra: Optional[Dict[str, Any]] = None) -> str:
        blob = {"time": time.time(), "registry": self.name,
                "uptime_s": time.time() - self.created_at}
        if extra:
            blob.update(extra)
        blob.update(self.snapshot())
        series = self.series()
        if series:
            blob["series"] = series
        return json.dumps(blob)

    def export(self, path: str,
               extra: Optional[Dict[str, Any]] = None) -> None:
        """Atomic JSON snapshot publish (tmp + rename) — the file
        ``bin/dstpu_top`` tails; a reader never sees a torn snapshot."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(self.to_json(extra))
        os.replace(tmp, path)

    # ---------------------- monitor bridging -------------------------- #

    def tick(self, step: int) -> None:
        """Drive attached monitor bridges (telemetry.attach_monitor):
        each emits a snapshot to its MonitorMaster every
        ``interval_steps``. Called by the serve observer at commit
        boundaries and usable from any train loop."""
        for b in self._bridges:
            b.step(step)


class _NullMetric:
    """Shared do-nothing handle for counters/gauges/histograms when
    telemetry is off — callers keep their cached-handle code shape."""

    __slots__ = ()
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, n=1.0):
        return

    def set(self, v):
        return

    def observe(self, v, n=1):
        return

    def quantile(self, q):
        return None

    def summary(self):
        return {"count": 0, "sum": 0.0}


_NULL_METRIC = _NullMetric()


class NullRegistry(MetricsRegistry):
    """The DSTPU_TELEMETRY=0 path: every handle is the shared no-op
    metric, every export is empty. ``enabled`` lets callers skip work
    (building label dicts, timestamps) entirely."""

    enabled = False

    def counter(self, name, **labels):
        return _NULL_METRIC

    def gauge(self, name, **labels):
        return _NULL_METRIC

    def histogram(self, name, alpha=0.05, **labels):
        return _NULL_METRIC

    def snapshot(self):
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def tick(self, step):
        return

    def sample(self, now=None):
        return

    def maybe_sample(self, now=None):
        return

    def series(self):
        return {}

    def rate(self, name, window_s=None, **labels):
        return None


def merge_snapshots(snaps: Sequence[Dict[str, Any]],
                    sources: Optional[Iterable[str]] = None
                    ) -> Dict[str, Any]:
    """Merge exported snapshot dicts (``MetricsRegistry.snapshot()`` /
    the ``export()`` JSON) with the same semantics as
    :meth:`MetricsRegistry.merge` — counters sum, gauges gain a
    ``source`` label, histograms rebuild from their exported bucket
    state (:meth:`Histogram.from_state`) and merge bucket-wise exactly.
    This is the cross-process path: N replicas each publish a snapshot
    file, the pool rolls them up without sharing memory. ``sources``
    overrides the per-snapshot label (default: the snapshot's
    ``registry`` name, index-disambiguated)."""
    snaps = list(snaps)
    src_list = list(sources) if sources is not None else [
        snap.get("registry") or f"r{i}" for i, snap in enumerate(snaps)]
    if len(src_list) != len(snaps):
        raise ValueError(
            f"sources has {len(src_list)} entries for {len(snaps)} "
            f"snapshots — a short list would silently drop replicas "
            f"from the rollup")
    seen: Dict[str, int] = {}
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    gauge_keys: set = set()
    hists: Dict[str, Histogram] = {}
    for snap, src in zip(snaps, src_list):
        n = seen.get(src, 0)
        seen[src] = n + 1
        if n:
            src = f"{src}#{n}"
        for key, v in snap.get("counters", {}).items():
            counters[key] = counters.get(key, 0.0) + v
        for key, v in snap.get("gauges", {}).items():
            base, labels = _parse_key(key)
            # an already-rolled-up snapshot's gauges keep their
            # original per-replica source (re-merging rollups must not
            # collapse replicas onto one key); residual collisions
            # (two pools each holding a replica named "a") suffix
            # rather than overwrite
            labels.setdefault("source", src)
            _dedupe_source(base, labels, gauge_keys)
            gauges[_key(base, labels)] = v
        for key, state in snap.get("histograms", {}).items():
            h = Histogram.from_state(state)
            if key in hists:
                hists[key].merge(h)
            else:
                hists[key] = h
    return {
        "registry": f"fleet({len(src_list)})",
        "time": max((s.get("time", 0.0) for s in snaps), default=0.0),
        "counters": dict(sorted(counters.items())),
        "gauges": dict(sorted(gauges.items())),
        "histograms": {k: hists[k].summary() for k in sorted(hists)},
    }


_DEFAULT: Optional[MetricsRegistry] = None


def new_registry(name: str = "default") -> MetricsRegistry:
    """A fresh registry honoring the DSTPU_TELEMETRY kill switch."""
    return MetricsRegistry(name) if telemetry_enabled() else \
        NullRegistry(name)


def get_registry() -> MetricsRegistry:
    """The process-default registry (train-side metrics, comm counters).
    Serve engines carry their OWN registry (``engine.metrics``) so two
    engines in one process — e.g. a drill's dead replica and survivor —
    never mix request stats."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = new_registry("default")
    return _DEFAULT


def set_registry(reg: Optional[MetricsRegistry]) -> None:
    """Install a registry (tests), or None to re-read the env lazily."""
    global _DEFAULT
    _DEFAULT = reg


# ---------------------------------------------------------------------- #
# cross-subsystem recording helpers
# ---------------------------------------------------------------------- #

#: comm-facade op name -> the program auditor's canonical collective
#: kind (analysis/program_audit.py COLLECTIVE_PRIMS values) — the ring
#: builders record their decomposed sites as reduce_scatter/all_gather,
#: so these counters and an audited CollectiveBudget speak the same
#: vocabulary (per-hop execution counts come from the auditor's
#: trip-weighted reports, not from here).
COMM_CANONICAL_KINDS = {
    "all_reduce": "all_reduce",
    "inference_all_reduce": "all_reduce",
    "all_gather": "all_gather",
    "reduce_scatter": "reduce_scatter",
    "ppermute": "ppermute",
    "all_to_all_single": "all_to_all",
    "broadcast": "broadcast",
}


def comm_counter(op: str) -> None:
    """Count a traced collective site on the default registry, keyed by
    canonical kind. Called from ``comm._record`` — TRACE time, like the
    CommsLogger: 'sites the programs being built contain', not per-step
    executions (the auditor's trip-weighted counts cover those)."""
    kind = COMM_CANONICAL_KINDS.get(op)
    if kind is None:
        return
    reg = get_registry()
    if reg.enabled:
        reg.counter("comm_traced_" + kind).inc()


def record_phase_tflops(phase: str, flops_per_step: float,
                        latency_s: float,
                        utilization: Optional[float] = None,
                        registry: Optional[MetricsRegistry] = None
                        ) -> float:
    """Set the phase-labelled achieved-TFLOPS / FLOPs-per-step gauges
    from a model-shape FLOPs estimate plus a measured step time — the
    one roofline formula the flops profiler and the bench phases share
    (satellite: replaces bench-local arithmetic where they overlap).
    Returns the achieved TFLOPS."""
    tf = flops_per_step / latency_s / 1e12 if latency_s > 0 else 0.0
    reg = registry if registry is not None else get_registry()
    if reg.enabled:
        reg.gauge("achieved_tflops", phase=phase).set(tf)
        reg.gauge("flops_per_step", phase=phase).set(flops_per_step)
        if utilization is not None:
            reg.gauge("mxu_utilization", phase=phase).set(utilization)
    return tf
