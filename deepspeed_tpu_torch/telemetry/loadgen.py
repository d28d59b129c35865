"""Open-loop, wall-clock load generation for the v2 ragged engine.

Port of ``deepspeed_tpu/telemetry/loadgen.py``, host code that the port
keeps its own copy of (it imports nothing of the JAX package). The
arrival processes, workload mixes and ``build_requests`` give the JAX
package's schedules and requests bit for bit for the same (process, mix,
n, seed); the driver reports under the same keys. Its entry point is
``python -m deepspeed_tpu_torch.telemetry.loadgen`` (the JAX package's
``bin/dstpu_loadgen``), which builds port engines on ``--device``
(``cuda`` unless asked otherwise). Not ported yet: the sequence- and
expert-parallel engines (``--seq`` / ``--ep`` above 1, ROADMAP A8) and
the ``serve_moe`` section of ``--mix moe_decode_heavy``, which reads the
expert residency report (A8) and the audited collective share (A9).

A closed loop only offers a new request when an old one completes, so
the engine is never observed *past* its capacity and the measured
"throughput" is just the engine's pace. This module drives any
``InferenceEngineV2`` (or ``ReplicaPool``) **open-loop**: request
arrival times come from a seeded stochastic process evaluated against
the WALL CLOCK, and the arrival clock is **never back-pressured by
engine state** — when the engine falls behind, late arrivals queue in
the driver (their measured queue-wait/TTFT grows, which is the
phenomenon being measured) or are shed after ``shed_after_s``; they
never stall the generator. Offered load is an independent variable,
goodput/latency are the response.

Pieces:

  * arrival processes — :class:`PoissonArrivals` (exponential gaps),
    :class:`UniformArrivals` (deterministic spacing),
    :class:`SpikeArrivals` (a rate spike over a base rate),
    :class:`TraceArrivals` (recorded-trace replay). All seeded: the same
    (process, seed, n) always yields the identical schedule, so runs
    are reproducible and on-vs-off comparisons see the same offered
    stream.
  * :class:`WorkloadMix` — prompt/generation length distributions, a
    shared-prefix fraction (those prompts open with one common preamble
    and ride the prefix cache), and a per-request deadline fraction.
  * :func:`run_open_loop` — the driver: admit due arrivals through
    ``put(..., arrivals=..., deadlines=...)`` (so the engine's SLO
    stamps anchor at the request's scheduled arrival, not at whenever
    admission happened), decode in short pipelined bursts between
    admission polls, and emit a structured :class:`LoadResult` — offered
    vs completed vs goodput rates, TTFT/TPOT/queue-wait p50/p90/p99
    aggregated through the telemetry registry's streaming histograms,
    and the shed/deadline-miss breakdown.
  * :func:`sweep_capacity` — offered-QPS sweep locating the knee: the
    highest offered rate whose goodput fraction still meets the SLO
    threshold.

The driver's per-iteration work (:meth:`_OpenLoopDriver._admit_due`,
:meth:`_OpenLoopDriver._decode_burst`) brackets the engine's overlapped
pipeline, so it makes no device read of its own: a host sync there would
serialize the very hot path whose capacity is being measured.
"""

from __future__ import annotations

import heapq
import json
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .registry import Histogram

# ---------------------------------------------------------------------- #
# arrival processes
# ---------------------------------------------------------------------- #


class ArrivalProcess:
    """Seeded generator of nondecreasing arrival offsets (seconds from
    the run's t=0). ``schedule(n)`` is a pure function of the process's
    construction arguments — determinism is the contract the capacity
    bench and the on-vs-off parity gates stand on."""

    kind = "base"

    def schedule(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def describe(self) -> Dict[str, Any]:
        return {"process": self.kind}


class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals at ``rate_rps`` offered requests/second —
    i.i.d. exponential inter-arrival gaps from a seeded RNG."""

    kind = "poisson"

    def __init__(self, rate_rps: float, seed: int = 0):
        if rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        self.rate_rps = float(rate_rps)
        self.seed = int(seed)

    def schedule(self, n: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed)
        return np.cumsum(rng.exponential(1.0 / self.rate_rps, size=n))

    def describe(self) -> Dict[str, Any]:
        return {"process": self.kind, "rate_rps": self.rate_rps,
                "seed": self.seed}


class UniformArrivals(ArrivalProcess):
    """Deterministic arrivals: one request every ``1/rate_rps`` seconds
    (the jitter-free control against the Poisson runs)."""

    kind = "uniform"

    def __init__(self, rate_rps: float):
        if rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        self.rate_rps = float(rate_rps)

    def schedule(self, n: int) -> np.ndarray:
        return (np.arange(n, dtype=np.float64) + 1.0) / self.rate_rps

    def describe(self) -> Dict[str, Any]:
        return {"process": self.kind, "rate_rps": self.rate_rps}


class SpikeArrivals(ArrivalProcess):
    """Piecewise-constant-rate arrivals: ``base_rps`` everywhere except
    a ``[start_s, start_s + dur_s)`` window offered at ``mult x
    base_rps`` — the overload-drill traffic spike. Seeded exponential
    unit-rate gaps are mapped through the closed-form inverse of the
    integrated rate, so the spike's edges are exact and the same seed
    always yields the identical schedule (the controller on-vs-off
    comparison sees the same offered stream)."""

    kind = "spike"

    def __init__(self, base_rps: float, mult: float, start_s: float,
                 dur_s: float, seed: int = 0):
        if base_rps <= 0 or mult <= 0:
            raise ValueError(
                f"base_rps and mult must be > 0, got {base_rps}/{mult}")
        if start_s < 0 or dur_s <= 0:
            raise ValueError(
                f"need start_s >= 0 and dur_s > 0, got "
                f"{start_s}/{dur_s}")
        self.base_rps = float(base_rps)
        self.mult = float(mult)
        self.start_s = float(start_s)
        self.dur_s = float(dur_s)
        self.seed = int(seed)

    def schedule(self, n: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed)
        # cumulative unit-rate exponentials, inverted through the
        # integrated rate L(t): L = base*t up to the spike, slope
        # base*mult inside it, base again past it
        u = np.cumsum(rng.exponential(1.0, size=n))
        a = self.base_rps * self.start_s            # L at spike start
        b = a + self.base_rps * self.mult * self.dur_s   # L at spike end
        t_pre = u / self.base_rps
        t_in = self.start_s + (u - a) / (self.base_rps * self.mult)
        t_post = self.start_s + self.dur_s + (u - b) / self.base_rps
        return np.where(u <= a, t_pre, np.where(u <= b, t_in, t_post))

    def describe(self) -> Dict[str, Any]:
        return {"process": self.kind, "base_rps": self.base_rps,
                "mult": self.mult, "start_s": self.start_s,
                "dur_s": self.dur_s, "seed": self.seed}


class TraceArrivals(ArrivalProcess):
    """Recorded-trace replay: arrival offsets from a captured workload
    (a JSON list of seconds, absolute or already-relative — the
    schedule is normalized to start at 0). ``time_scale`` compresses or
    stretches the trace (0.5 = replay at double speed)."""

    kind = "trace"

    def __init__(self, times: Sequence[float], time_scale: float = 1.0,
                 path: Optional[str] = None):
        if not len(times):
            raise ValueError("empty arrival trace")
        t = np.sort(np.asarray(times, dtype=np.float64))
        self.times = (t - t[0]) * float(time_scale)
        self.time_scale = float(time_scale)
        self.path = path

    @classmethod
    def from_file(cls, path: str,
                  time_scale: float = 1.0) -> "TraceArrivals":
        with open(path, encoding="utf-8") as f:
            blob = json.load(f)
        times = blob["arrivals"] if isinstance(blob, dict) else blob
        return cls(times, time_scale=time_scale, path=path)

    def schedule(self, n: int) -> np.ndarray:
        if n > len(self.times):
            raise ValueError(
                f"trace holds {len(self.times)} arrivals, {n} requested")
        return self.times[:n].copy()

    def describe(self) -> Dict[str, Any]:
        span = float(self.times[-1]) if len(self.times) > 1 else 0.0
        return {"process": self.kind, "n_times": int(len(self.times)),
                "time_scale": self.time_scale, "path": self.path,
                "rate_rps": round(len(self.times) / span, 3)
                if span > 0 else None}


# ---------------------------------------------------------------------- #
# workload mix
# ---------------------------------------------------------------------- #


@dataclass
class Request:
    """One offered request: identity, scheduled arrival offset, prompt,
    decode budget, optional per-request deadline. ``group`` is the
    shared-prefix group index (None for unique-prompt requests) — the
    fleet bench reads it to check routing affinity."""

    uid: int
    arrival_s: float
    prompt: List[int]
    gen_len: int
    deadline_s: Optional[float] = None
    group: Optional[int] = None
    #: traffic class for brownout shedding: 0 = interactive (protected),
    #: 1 = batch/background (shed first at ladder level L4)
    klass: int = 0


@dataclass
class WorkloadMix:
    """Seeded request-shape distribution. ``shared_prefix_frac`` of the
    requests open with a common ``shared_prefix_len``-token preamble
    (the prefix-cache hit population); ``prefix_group_count`` spreads
    those over that many DISTINCT preambles (>1 is the replica-fleet
    workload: more shared-prefix groups than one replica's cache wants
    to hold, so routing affinity — not cache size — decides the
    fleet-wide hit rate); ``deadline_frac`` of the requests carry a
    ``deadline_s`` deadline measured from their scheduled arrival."""

    prompt_lens: Sequence[int] = (128, 256, 512)
    prompt_probs: Sequence[float] = (0.4, 0.4, 0.2)
    gen_lens: Sequence[int] = (32, 64, 128)
    gen_probs: Sequence[float] = (0.3, 0.5, 0.2)
    shared_prefix_frac: float = 0.0
    shared_prefix_len: int = 0
    prefix_group_count: int = 1
    #: hierarchical-KV working-set pattern (0 = off): offer a
    #: shared-prefix working set of ~this many KV blocks — the group
    #: count is derived as ceil(blocks·prefix_block_tokens /
    #: shared_prefix_len) (at least prefix_group_count) and EVERY
    #: request opens with a preamble, assigned by GROUP CYCLING
    #: (request i -> group i mod G) instead of a uniform draw: each
    #: preamble is revisited at exact period G, the honest pattern for
    #: a tier whose whole point is surviving between revisits (uniform
    #: assignment revisits hot groups too soon and cold ones maybe
    #: never). Size it >= 3x the engine's device pool to measure the
    #: host tier (bench.py serve_hier's workload).
    prefix_working_set_blocks: int = 0
    #: tokens per KV block the working-set sizing assumes (the target
    #: engine's block_size; the CLI's tiny engine uses 16)
    prefix_block_tokens: int = 16
    deadline_frac: float = 0.0
    deadline_s: float = 0.0
    #: fraction of requests tagged class-1 (batch/background) — the
    #: traffic the brownout ladder sheds FIRST under overload. Drawn
    #: from an independent seeded stream, so arming it never perturbs
    #: the prompts/budgets existing (mix, seed) pairs produce.
    batch_frac: float = 0.0
    vocab_size: int = 32000
    #: fixed prompt pool (recorded-prompt replay): when set, each
    #: request draws its prompt from this pool (seeded choice) instead
    #: of random tokens — prompt_lens/shared-prefix knobs are then
    #: ignored. This is how content-sensitive workloads (speculative
    #: decoding's self-drafting acceptance, cache-content studies)
    #: ride the observatory: offered load stays the independent
    #: variable while prompt CONTENT stays the controlled one.
    prompt_pool: Optional[Sequence[Sequence[int]]] = None

    @classmethod
    def prefill_heavy(cls, vocab_size: int = 32000,
                      **overrides) -> "WorkloadMix":
        """The disaggregated-serving workload preset
        (``--mix prefill_heavy``, docs/serving.md
        "Disaggregated serving"): prompts an order of magnitude longer
        than generations, so prefill FLOPs dominate the offered work
        and a colocated replica keeps stalling its decode streams
        behind arriving prompt chunks — the regime where splitting the
        fleet into prefill and decode specialists wins on BOTH TTFT and
        TPOT tails. Sized for the tiny CPU-harness engine (sequences
        cap at 256 tokens); real deployments scale the lengths, not the
        ratio. ``overrides`` pass through to the constructor."""
        kw: Dict[str, Any] = dict(
            prompt_lens=(96, 160), prompt_probs=(0.5, 0.5),
            gen_lens=(4, 8), gen_probs=(0.5, 0.5),
            vocab_size=vocab_size)
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def long_context(cls, pool_span_tokens: int = 256,
                     vocab_size: int = 32000,
                     **overrides) -> "WorkloadMix":
        """The long-context serving preset (``--mix
        long_context``, docs/serving.md "Long-context serving"):
        log-spaced prompt lengths from short up to ``pool_span_tokens``
        (the target engine's whole KV pool span — the longest prompts
        push per-sequence context PAST what a single chip's pool shard
        holds, the regime sequence-parallel serving exists for), drawn
        uniformly so every decade of context length is represented, and
        generations kept small (the long-context interactive shape:
        huge document in, short answer out). Sized by the CALLER's pool
        — pass ``pool_span_tokens = num_blocks_per_seq * block_size``
        for the engine under test."""
        span = max(64, int(pool_span_tokens))
        # 4 log-spaced rungs: span/8, span/4, span/2, ~span (headroom
        # for the generation so the chain never overflows its table)
        lens = sorted({max(16, span // 8), max(32, span // 4),
                       max(48, span // 2), max(56, span - 16)})
        kw: Dict[str, Any] = dict(
            prompt_lens=tuple(lens),
            prompt_probs=tuple([1.0 / len(lens)] * len(lens)),
            gen_lens=(4, 8), gen_probs=(0.5, 0.5),
            vocab_size=vocab_size)
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def moe_decode_heavy(cls, vocab_size: int = 32000,
                         **overrides) -> "WorkloadMix":
        """The expert-parallel MoE serving preset (``--mix
        moe_decode_heavy``, docs/serving.md "Expert-parallel MoE
        serving"): short prompts with generations several times longer,
        so single-token decode steps dominate the offered work — the
        regime where the per-step dispatch/combine ``all_to_all`` pair
        is the whole comm bill and the sharded experts' HBM saving has
        to be paid for in exchange latency. Pair with ``--ep`` and read
        the ``serve_moe`` report section."""
        kw: Dict[str, Any] = dict(
            prompt_lens=(8, 16), prompt_probs=(0.5, 0.5),
            gen_lens=(24, 48), gen_probs=(0.5, 0.5),
            vocab_size=vocab_size)
        kw.update(overrides)
        return cls(**kw)

    def describe(self) -> Dict[str, Any]:
        return {
            "prompt_mix": list(self.prompt_lens)
            if self.prompt_pool is None
            else f"pool({len(self.prompt_pool)})",
            "gen_mix": list(self.gen_lens),
            "shared_prefix_frac": self.shared_prefix_frac,
            "shared_prefix_len": self.shared_prefix_len,
            "prefix_group_count": self.prefix_group_count,
            "prefix_working_set_blocks": self.prefix_working_set_blocks,
            "deadline_frac": self.deadline_frac,
            "deadline_s": self.deadline_s,
            "batch_frac": self.batch_frac,
        }


def build_requests(process: ArrivalProcess, mix: WorkloadMix, n: int,
                   seed: int = 0, uid_base: int = 0) -> List[Request]:
    """Materialize ``n`` requests: arrival offsets from ``process``,
    shapes/contents from ``mix`` under ``seed``. Pure and deterministic
    — request identity (prompt, budget, deadline) depends only on
    (mix, seed, index), never on engine timing, so per-request token
    streams are comparable across instrumentation settings."""
    arrivals = process.schedule(n)
    rng = np.random.RandomState(seed)
    plens = rng.choice(list(mix.prompt_lens), size=n,
                       p=list(mix.prompt_probs))
    glens = rng.choice(list(mix.gen_lens), size=n, p=list(mix.gen_probs))
    shared = rng.random_sample(n) < mix.shared_prefix_frac
    deadlined = rng.random_sample(n) < mix.deadline_frac
    # shared-prefix preambles: one (the single-group classic),
    # prefix_group_count distinct ones (the fleet workload), or the
    # hierarchical-KV WORKING-SET pattern (prefix_working_set_blocks):
    # enough groups to cover the requested block footprint, every
    # request prefixed, groups CYCLED so each preamble is revisited at
    # exact period G. The pre-existing paths draw exactly what they
    # always drew, so request identity under existing (mix, seed)
    # pairs is unchanged.
    if mix.prefix_working_set_blocks > 0:
        if mix.shared_prefix_len <= 0:
            raise ValueError(
                "prefix_working_set_blocks needs shared_prefix_len > 0")
        if int(min(mix.prompt_lens)) <= mix.shared_prefix_len:
            # the per-request guard below would silently strip the
            # preamble from such prompts — the working-set pattern
            # would then measure NOTHING; fail loud instead
            raise ValueError(
                f"prefix_working_set_blocks: every prompt must exceed "
                f"the {mix.shared_prefix_len}-token preamble (shortest "
                f"prompt_len is {min(mix.prompt_lens)})")
        per = max(1, -(-mix.shared_prefix_len
                       // max(1, mix.prefix_block_tokens)))
        G = max(mix.prefix_group_count,
                -(-mix.prefix_working_set_blocks // per))
        prefixes = [rng.randint(1, mix.vocab_size,
                                size=mix.shared_prefix_len).tolist()
                    for _ in range(G)]
        group_of = np.arange(n, dtype=np.int64) % G
        shared = np.ones(n, bool)
    elif mix.shared_prefix_len and mix.prefix_group_count > 1:
        prefixes = [rng.randint(1, mix.vocab_size,
                                size=mix.shared_prefix_len).tolist()
                    for _ in range(mix.prefix_group_count)]
        group_of = rng.randint(0, mix.prefix_group_count, size=n)
    else:
        prefixes = [rng.randint(1, mix.vocab_size,
                                size=mix.shared_prefix_len).tolist()
                    if mix.shared_prefix_len else []]
        group_of = np.zeros(n, np.int64)
    pool = list(mix.prompt_pool) if mix.prompt_pool else None
    pool_pick = rng.randint(0, len(pool), size=n) if pool else None
    # traffic classes from an INDEPENDENT seeded stream: arming
    # batch_frac must not shift the main RNG's draw sequence, so every
    # pre-existing (mix, seed) pair keeps byte-identical request
    # identity (prompts, budgets, deadlines)
    if mix.batch_frac > 0:
        krng = np.random.RandomState(seed + 7919)
        klasses = (krng.random_sample(n) < mix.batch_frac).astype(int)
    else:
        klasses = np.zeros(n, np.int64)
    out: List[Request] = []
    for i in range(n):
        plen = int(plens[i])
        g = int(group_of[i])
        prefix = prefixes[g]
        if pool is not None:
            # recorded-prompt replay: content from the pool, identity
            # still (mix, seed, index)-deterministic
            prompt = list(pool[int(pool_pick[i])])
            group = None
        elif shared[i] and prefix and plen > len(prefix):
            body = rng.randint(1, mix.vocab_size,
                               size=plen - len(prefix)).tolist()
            prompt = prefix + body
            group = g
        else:
            prompt = rng.randint(1, mix.vocab_size, size=plen).tolist()
            group = None
        out.append(Request(
            uid=uid_base + i, arrival_s=float(arrivals[i]),
            prompt=prompt, gen_len=int(glens[i]),
            deadline_s=mix.deadline_s
            if deadlined[i] and mix.deadline_s > 0 else None,
            group=group, klass=int(klasses[i])))
    return out


# ---------------------------------------------------------------------- #
# the open-loop driver
# ---------------------------------------------------------------------- #


@dataclass
class LoadResult:
    """One open-loop pass: the structured report plus the per-request
    committed token streams (the parity-gate evidence)."""

    report: Dict[str, Any]
    streams: Dict[int, List[int]] = field(default_factory=dict)


class _OpenLoopDriver:
    """One pass of :func:`run_open_loop` — split into the per-iteration
    hot methods (`_admit_due`, `_decode_burst`) and cold bookkeeping."""

    def __init__(self, engine, requests: Sequence[Request],
                 decode_burst: int, shed_after_s: float,
                 poll_s: float, max_live: Optional[int] = None,
                 sampling: Any = None, admission: Any = None,
                 retry_budget: int = 0, retry_base_s: float = 0.05,
                 retry_seed: int = 0):
        self.engine = engine
        self.requests = sorted(requests, key=lambda r: r.arrival_s)
        self.decode_burst = max(1, int(decode_burst))
        self.shed_after_s = shed_after_s
        self.poll_s = poll_s
        #: SamplingParams template applied to EVERY offered request
        #: (per-uid seeds derive from the uid when the template names
        #: none — streams stay deterministic per request identity)
        self.sampling = sampling
        self.max_live = max(1, int(max_live)) \
            if max_live is not None else None
        #: AdmissionController (serving/admission.py) or None. Armed,
        #: the door REJECTS offers beyond the controller's window
        #: (typed records with retry_after_s hints) instead of holding
        #: them; None keeps the exact pre-controller hold-at-door path
        #: (``max_live`` is the controller's responsibility when armed)
        self.admission = admission
        # client retry discipline: jittered exponential backoff
        # honoring the rejection's retry_after_s hint, bounded by
        # retry_budget attempts per request; retried requests keep
        # their ORIGINAL identity (uid + arrival stamp)
        self.retry_budget = max(0, int(retry_budget))
        self.retry_base_s = float(retry_base_s)
        self._retry_rng = random.Random(retry_seed)
        self.retryq: List[Tuple[float, int, int, Request]] = []
        self._retry_n = 0
        self._retried_uids: set = set()
        self.retry_stats = {"attempts": 0, "exhausted": 0,
                            "abandoned": 0, "succeeded_after_retry": 0}
        #: EWMA of observed admit->complete service time — the client's
        #: estimate of the minimum useful deadline remainder: retrying
        #: with less budget than this left only wastes an engine slot
        self._serv_ewma: Optional[float] = None
        self.pending: deque = deque(self.requests)
        self.live: Dict[int, Dict[str, Any]] = {}
        self.streams: Dict[int, List[int]] = {}
        self.by_uid = {r.uid: r for r in self.requests}
        # outcome bookkeeping
        self.completed: Dict[int, float] = {}    # uid -> completion offset
        self.shed_late: List[int] = []
        #: driver-side structured rejections, SAME record shape as the
        #: engine's (uid/reason/time/retry_after_s) — the report
        #: classifies both through one merged view, so driver sheds and
        #: engine sheds can never be double- or un-counted
        self.rejected_driver: Dict[int, Dict[str, Any]] = {}
        self.offer_lags: List[float] = []
        self.first_seen: Dict[int, float] = {}   # driver-side fallback
        self._stamp_cache: Dict[int, Dict[str, float]] = {}
        # decode accounting (the fastgen HBM-roofline inputs)
        self.decode_time_s = 0.0
        self.decode_tokens = 0
        self.decode_steps = 0
        self.decode_ctx_step_sum = 0
        self.decode_step_lat = Histogram()
        self.t0 = 0.0

    # ----------------------------- hot loop ----------------------------- #

    def _admit_due(self, now: float) -> None:
        """Offer every arrival whose scheduled time has passed. The
        schedule is the precomputed process output — engine state never
        delays an offer (the open-loop invariant); it only decides
        whether the offered request is admitted, held at the door
        (``max_live`` concurrency bound — held requests keep their
        ORIGINAL arrival stamp, so door wait lands in queue-wait/TTFT),
        queued into this batch late, or shed (``shed_after_s``).

        With an :class:`~..serving.AdmissionController`
        armed the door changes semantics: offers beyond the
        controller's window (or class-shed by the brownout ladder) are
        REJECTED with typed retriable records instead of held — holding
        past the knee is exactly the collapse the controller exists to
        prevent. Due retries re-offer through the same door."""
        adm = self.admission
        if adm is not None:
            adm.poll(self.t0 + now)
        due: List[Request] = []
        while self.retryq and self.retryq[0][0] <= now:
            _, _, attempt, r = heapq.heappop(self.retryq)
            if adm is not None \
                    and not adm.door(len(self.live) + len(due), r.klass):
                self._door_reject(r, now, attempt)
                continue
            due.append(r)
        while self.pending and self.pending[0].arrival_s <= now:
            if adm is None and self.max_live is not None \
                    and len(self.live) + len(due) >= self.max_live:
                break
            r = self.pending.popleft()
            lag = now - r.arrival_s
            self.offer_lags.append(lag)
            if self.shed_after_s > 0 and lag > self.shed_after_s:
                self.shed_late.append(r.uid)
                self.rejected_driver[r.uid] = {
                    "uid": r.uid, "reason": "shed_late",
                    "time": time.time(), "retry_after_s": None,
                    "lag_s": round(lag, 4)}
                continue
            if adm is not None \
                    and not adm.door(len(self.live) + len(due), r.klass):
                self._door_reject(r, now, 0)
                continue
            due.append(r)
        if not due:
            return
        arrivals: Dict[int, float] = {}
        deadlines: Dict[int, float] = {}
        for r in due:
            t_arr, dl = r.arrival_s, r.deadline_s
            if r.uid in self._retried_uids:
                # a re-offer restarts the ENGINE clock: stamping the
                # original arrival would book the client's backoff as
                # engine queue wait and feed it back into the
                # controller's evidence (a retry storm indistinguishable
                # from real overload). The deadline stays anchored at
                # the original arrival — only the remainder is granted.
                if dl is not None:
                    dl = max(0.0, t_arr + dl - now)
                t_arr = now
            arrivals[r.uid] = self.t0 + t_arr
            if dl is not None:
                deadlines[r.uid] = dl
        sampling = {r.uid: self.sampling for r in due} \
            if self.sampling is not None else None
        res = self.engine.put([r.uid for r in due],
                              [r.prompt for r in due], _greedy=True,
                              arrivals=arrivals, deadlines=deadlines,
                              sampling=sampling)
        t_seen = time.monotonic() - self.t0
        for r in due:
            if r.uid in res:
                tok = res[r.uid]
                self.streams[r.uid] = [tok]
                self.first_seen[r.uid] = t_seen
                if r.uid in self._retried_uids:
                    self._retried_uids.discard(r.uid)
                    self.retry_stats["succeeded_after_retry"] += 1
                if r.gen_len <= 1:
                    self._finish(r.uid, "completed")
                else:
                    self.live[r.uid] = {"last": tok,
                                        "remaining": r.gen_len - 1}
            # admitted-then-rejected (deadline/shed inside put) and
            # refused requests both carry engine.rejections records —
            # the report's breakdown reads them after the pass

    def _door_reject(self, r: Request, now: float, attempt: int) -> None:
        """One typed door rejection plus the client's retry half of the
        contract: re-offer after max(the controller's ``retry_after_s``
        hint, jittered exponential backoff), up to ``retry_budget``
        attempts. A retried request keeps its ORIGINAL uid, and its
        deadline/goodput stay anchored at the first offer — retries
        never launder SLO outcomes. Only the ENGINE clock (queue
        wait/TTFT) restarts at the re-offer, so client backoff is not
        booked as engine queue time (see :meth:`_admit_due`).
        Hot path: dict/heap stores and host arithmetic only."""
        rec = self.admission.reject(r.uid, klass=r.klass)
        if attempt >= self.retry_budget:
            self.retry_stats["exhausted"] += 1
            self._retried_uids.discard(r.uid)
            return
        hint = rec.get("retry_after_s") or 0.0
        back = self.retry_base_s * (2.0 ** attempt) \
            * (0.5 + self._retry_rng.random())
        t_next = now + max(hint, back)
        if r.deadline_s is not None \
                and t_next + (self._serv_ewma or 0.0) \
                >= r.arrival_s + r.deadline_s:
            # the deadline remainder at retry time would not even cover
            # the observed service time — a rational client abandons
            # rather than burn a slot on a request the engine must
            # expire anyway (a zombie that produces no goodput but
            # still displaces requests that could have met their SLO)
            self.retry_stats["abandoned"] += 1
            self._retried_uids.discard(r.uid)
            return
        self.retry_stats["attempts"] += 1
        self._retried_uids.add(r.uid)
        self._retry_n += 1
        heapq.heappush(self.retryq,
                       (t_next, self._retry_n, attempt + 1, r))

    def _decode_burst(self) -> None:
        """One short pipelined decode burst over the live set — short so
        the admission poll (the arrival clock) runs between bursts."""
        eng = self.engine
        # bind the pre-burst views ONCE: against a replica pool these
        # are merged-dict properties rebuilt per access, so a per-uid
        # property read would cost O(live² · replicas) host time inside
        # the very loop being measured (the post-burst rejection check
        # below stays a fresh read — aborts can land DURING the burst)
        seqs = eng.state.sequences
        rejected = eng.rejections
        uids = [u for u in self.live
                if u in seqs and u not in rejected]
        for u in list(self.live):
            if u not in uids:
                self.live.pop(u)            # shed/expired mid-flight
        if not uids:
            return
        burst = self.decode_burst
        adm = self.admission
        if adm is not None and adm.decode_burst_cap < burst:
            # brownout L3 (throughput_cap): shorter bursts return to the
            # admission poll sooner, trading batch throughput for
            # arrival-clock fidelity exactly when the door must act
            burst = max(1, adm.decode_burst_cap)
        budgets = [min(burst, self.live[u]["remaining"])
                   for u in uids]
        ctx = 0
        for u in uids:
            ctx += seqs[u].seen_tokens
        t0 = time.perf_counter()
        outs = eng.decode_pipelined(
            uids, [self.live[u]["last"] for u in uids], budgets)
        dt = time.perf_counter() - t0
        steps = 0
        got_total = 0
        t_seen = time.monotonic() - self.t0
        rejected = eng.rejections           # re-read: aborts can land
        for u in uids:                      # DURING the burst
            got = outs.get(u) or []
            if got:
                self.streams[u].extend(got)
                self.first_seen.setdefault(u, t_seen)
            got_total += len(got)
            if len(got) > steps:
                steps = len(got)
            if u in rejected:
                self.live.pop(u, None)      # aborted inside the burst
                continue
            st = self.live[u]
            st["remaining"] -= len(got)
            if got:
                st["last"] = got[-1]
            if st["remaining"] <= 0:
                self.live.pop(u)
                self._finish(u, "completed")
        self.decode_time_s += dt
        self.decode_tokens += got_total
        self.decode_steps += steps
        self.decode_ctx_step_sum += steps * ctx
        if steps:
            self.decode_step_lat.observe(dt / steps)

    # --------------------------- cold paths ---------------------------- #

    def _finish(self, uid: int, outcome: str) -> None:
        """Clean completion: read the per-seq SLO stamps (PR 8) before
        the flush releases the descriptor, then flush."""
        seq = self.engine.state.get(uid)
        now = time.monotonic() - self.t0
        self.completed[uid] = now
        if seq is not None:
            self._stamps_of(uid, seq)
            self.engine.flush(uid)

    def _stamps_of(self, uid: int, seq) -> None:
        r = self.by_uid[uid]
        st = {"arrival_s": r.arrival_s}
        if seq.admitted_at is not None:
            adm = seq.admitted_at - self.t0
            serv = (time.monotonic() - self.t0) - adm
            if serv > 0:
                self._serv_ewma = serv if self._serv_ewma is None \
                    else 0.8 * self._serv_ewma + 0.2 * serv
            if seq.first_sched_at is not None:
                st["queue_wait_s"] = seq.first_sched_at - seq.admitted_at
            if seq.first_token_at is not None:
                st["ttft_s"] = seq.first_token_at - seq.admitted_at
                n_tok = len(self.streams.get(uid, ()))
                if seq.last_token_at is not None and n_tok > 1:
                    st["tpot_s"] = (seq.last_token_at
                                    - seq.first_token_at) / (n_tok - 1)
            st["admitted_s"] = adm
        self._stamp_cache[uid] = st

    def run(self) -> LoadResult:
        self.t0 = time.monotonic()
        while self.pending or self.live or self.retryq:
            now = time.monotonic() - self.t0
            self._admit_due(now)
            if self.live:
                self._decode_burst()
            elif self.pending or self.retryq:
                # idle until the earlier of the next scheduled arrival
                # and the next due retry (poll_s-capped so the
                # admission controller keeps ticking while idle)
                nxt = [r[0] for r in self.retryq[:1]]
                if self.pending:
                    nxt.append(self.pending[0].arrival_s)
                wait = self.t0 + min(nxt) - time.monotonic()
                if wait > 0:
                    time.sleep(min(wait, self.poll_s))
        duration = time.monotonic() - self.t0
        return LoadResult(report=self._report(duration),
                          streams=self.streams)

    def _report(self, duration: float) -> Dict[str, Any]:
        eng = self.engine
        n = len(self.requests)
        span = self.requests[-1].arrival_s if n else 0.0
        # per-pass latency histograms from the per-seq SLO stamps
        # (telemetry on), falling back to driver-observed first-output
        # times when the engine runs uninstrumented — the report always
        # has TTFT, just at burst granularity in the fallback
        h = {name: Histogram() for name in
             ("ttft_s", "tpot_s", "queue_wait_s")}
        stamps_used = 0
        for uid in self.completed:
            st = self._stamp_cache.get(uid, {})
            if "ttft_s" in st:
                stamps_used += 1
                h["ttft_s"].observe(st["ttft_s"])
                if "queue_wait_s" in st:
                    h["queue_wait_s"].observe(st["queue_wait_s"])
                if "tpot_s" in st:
                    h["tpot_s"].observe(st["tpot_s"])
            elif uid in self.first_seen:
                h["ttft_s"].observe(self.first_seen[uid]
                                    - self.by_uid[uid].arrival_s)
        # outcome breakdown over ONE merged record view: driver-side
        # records (shed_late) and engine records (shed/deadline/drain/
        # door) share a shape, and every offered uid is classified
        # exactly once — so the rows sum to offered - completed in
        # every mode, by construction (balance_ok asserts it)
        merged = dict(self.rejected_driver)
        for uid, rec in eng.rejections.items():
            if uid in self.by_uid:
                merged[uid] = rec
        shed = deadline = drained = adm_rej = other = 0
        shed_late_n = 0
        for uid in self.by_uid:
            if uid in self.completed:
                continue
            rec = merged.get(uid)
            reason = rec.get("reason") if rec else None
            if reason == "kv_pool_exhausted":
                shed += 1
            elif reason == "deadline_exceeded":
                deadline += 1
            elif reason == "draining":
                drained += 1
            elif reason == "shed_late":
                shed_late_n += 1
            elif reason == "admission_overload":
                adm_rej += 1
            else:
                # recordless non-completion should be impossible; fold
                # it into "other" so the balance stays a hard invariant
                other += 1
        completed = len(self.completed)
        # goodput: completed AND met its deadline (deadline-free
        # requests count on completion; the engine aborts most late
        # ones, this closes the completed-just-past-deadline window)
        goodput = 0
        for uid, t_done in self.completed.items():
            r = self.by_uid[uid]
            if r.deadline_s is None \
                    or t_done - r.arrival_s <= r.deadline_s:
                goodput += 1
        offered_rate = n / span if span > 0 else None
        lags = self.offer_lags
        refused = sum(1 for uid, rec in merged.items()
                      if uid not in self.streams
                      and rec.get("reason") != "shed_late")
        report = {
            "requests": {
                "offered": n,
                "admitted": n - shed_late_n - refused,
                "completed": completed,
                "goodput": goodput,
                "shed": shed,
                "deadline_expired": deadline,
                "shed_late": shed_late_n,
                "rejected_draining": drained,
                "rejected_admission": adm_rej,
                "rejected_other": other,
                "balance_ok": completed + shed + deadline + drained
                + shed_late_n + adm_rej + other == n,
            },
            "rates_rps": {
                "offered": round(offered_rate, 3)
                if offered_rate else None,
                "completed": round(completed / duration, 3)
                if duration > 0 else None,
                "goodput": round(goodput / duration, 3)
                if duration > 0 else None,
            },
            "goodput_frac": goodput / n if n else None,
            "latency": {name: hist.summary()
                        for name, hist in h.items()},
            "latency_source": "registry_stamps"
            if stamps_used else "driver_observed",
            "open_loop": {
                "max_offer_lag_s": round(max(lags), 4) if lags else 0.0,
                "mean_offer_lag_s": round(sum(lags) / len(lags), 4)
                if lags else 0.0,
            },
            "decode": {
                "time_s": round(self.decode_time_s, 4),
                "tokens": self.decode_tokens,
                "steps": self.decode_steps,
                "ctx_step_sum": self.decode_ctx_step_sum,
                "step_lat": self.decode_step_lat.summary(),
            },
            "output_tokens": sum(len(s) for s in self.streams.values()),
            "duration_s": round(duration, 4),
        }
        if duration > 0:
            report["output_tokens_per_sec"] = round(
                report["output_tokens"] / duration, 2)
        if self.retry_budget > 0 or self.retry_stats["attempts"]:
            report["retries"] = dict(self.retry_stats,
                                     budget=self.retry_budget)
        if self.admission is not None:
            report["admission"] = self.admission.state()
        return report


def run_open_loop(engine, requests: Sequence[Request],
                  decode_burst: int = 8, shed_after_s: float = 0.0,
                  poll_s: float = 0.02,
                  max_live: Optional[int] = None,
                  sampling: Any = None,
                  admission: Any = None,
                  retry_budget: int = 0,
                  retry_base_s: float = 0.05) -> LoadResult:
    """Drive one open-loop pass of ``requests`` against ``engine``.

    The arrival clock is the precomputed schedule against
    ``time.monotonic()`` — never gated on engine completions. Late
    offers (engine busy in a burst) are admitted with their ORIGINAL
    arrival stamp (``put(..., arrivals=...)``), so measured queue-wait
    and TTFT include the driver-side wait; offers later than
    ``shed_after_s`` past their arrival are shed driver-side
    (0 = queue indefinitely). ``decode_burst`` bounds how long the
    admission poll can starve (smaller = finer arrival granularity,
    more host/dispatch round-trips); ``max_live`` bounds in-engine
    concurrency (further due requests wait at the door with their
    arrival stamp intact — their wait is measured, not hidden).

    ``sampling`` (a SamplingParams template, or None for greedy)
    attaches per-request sampling at admission — the engine then
    selects tokens on-device per slot; speculative decoding (the
    engine's ``spec_decode`` knob) needs no driver support at all,
    because ``decode_pipelined`` routes greedy batches through it
    transparently.

    ``admission`` (an :class:`~..serving.
    AdmissionController`, usually from
    :func:`~..serving.build_admission`) changes the door's
    semantics: offers beyond the controller's window are REJECTED with
    typed retriable records instead of held, and the driver plays the
    client half of the retry contract — up to ``retry_budget``
    re-offers per request after max(the record's ``retry_after_s``
    hint, jittered exponential backoff from ``retry_base_s``), with
    the ORIGINAL arrival identity so goodput accounting stays honest.

    Leaves the engine empty (every request completed, aborted or
    flushed) and accumulates rejection records in
    ``engine.rejections``."""
    return _OpenLoopDriver(engine, requests, decode_burst, shed_after_s,
                           poll_s, max_live=max_live,
                           sampling=sampling, admission=admission,
                           retry_budget=retry_budget,
                           retry_base_s=retry_base_s).run()


# ---------------------------------------------------------------------- #
# capacity search
# ---------------------------------------------------------------------- #


def sweep_capacity(engine, rates: Sequence[float], n_per_rate: int,
                   mix: WorkloadMix, seed: int = 0,
                   goodput_slo_frac: float = 0.9,
                   process: str = "poisson",
                   decode_burst: int = 8, shed_after_s: float = 0.0,
                   max_live: Optional[int] = None,
                   sampling: Any = None,
                   admission: Any = None,
                   retry_budget: int = 0,
                   retry_base_s: float = 0.05) -> Dict[str, Any]:
    """Sweep offered QPS and locate the knee: the highest offered rate
    whose goodput fraction still meets ``goodput_slo_frac``. Each rate
    runs an independent seeded pass (disjoint uid ranges; the engine's
    compiled programs stay warm across passes). Returns the
    goodput-vs-offered-load curve plus the located knee."""
    if process not in ("poisson", "uniform"):
        # a recorded trace pins its own rate — sweeping offered rates
        # over it has no meaning, and silently substituting Poisson
        # would measure a different workload than the caller asked for
        raise ValueError(
            f"sweep_capacity supports 'poisson'|'uniform' arrivals, "
            f"got {process!r}")
    curve: List[Dict[str, Any]] = []
    for i, rate in enumerate(sorted(rates)):
        proc = UniformArrivals(rate) if process == "uniform" \
            else PoissonArrivals(rate, seed=seed + i)
        reqs = build_requests(proc, mix, n_per_rate, seed=seed + i,
                              uid_base=(i + 1) * 1_000_000)
        res = run_open_loop(engine, reqs, decode_burst=decode_burst,
                            shed_after_s=shed_after_s, max_live=max_live,
                            sampling=sampling, admission=admission,
                            retry_budget=retry_budget,
                            retry_base_s=retry_base_s)
        rep = res.report
        lat = rep["latency"]
        curve.append({
            "offered_rps": round(rate, 3),
            "offered_realized_rps": rep["rates_rps"]["offered"],
            "completed_rps": rep["rates_rps"]["completed"],
            "goodput_rps": rep["rates_rps"]["goodput"],
            "goodput_frac": round(rep["goodput_frac"], 4)
            if rep["goodput_frac"] is not None else None,
            "ttft_ms_p50": _ms(lat["ttft_s"].get("p50")),
            "ttft_ms_p99": _ms(lat["ttft_s"].get("p99")),
            "shed": rep["requests"]["shed"],
            "deadline_expired": rep["requests"]["deadline_expired"],
            "shed_late": rep["requests"]["shed_late"],
            "rejected_admission": rep["requests"]["rejected_admission"],
        })
    knee = None
    for row in curve:
        gf = row["goodput_frac"]
        if gf is not None and gf >= goodput_slo_frac:
            if knee is None or row["offered_rps"] > knee["offered_rps"]:
                knee = row
    return {
        "curve": curve,
        "slo_goodput_frac": goodput_slo_frac,
        "knee_rps": knee["offered_rps"] if knee else None,
        "knee_goodput_rps": knee["goodput_rps"] if knee else None,
        "n_per_rate": n_per_rate,
        "process": process,
        "seed": seed,
    }


def _ms(v: Optional[float]) -> Optional[float]:
    return round(1e3 * v, 3) if v is not None else None


def disagg_report(pool) -> Dict[str, Any]:
    """The ``disagg`` report section for a phase-specialist fleet
    (docs/serving.md "Disaggregated serving"): handoff volume (source-
    counted), adoptions, fallback replays, the exposed-wait tail the
    serve_disagg bench gates on, and per-role utilization rolled up
    from the per-replica registries (``serve_tokens_committed`` /
    ``serve_steps`` attribute each role's share of the work)."""
    roles: Dict[str, Dict[str, Any]] = {}
    handoffs = {"out": 0.0, "adopted": 0.0, "fallback_replays": 0.0,
                "blocks": 0.0, "bytes": 0.0}
    exposed = Histogram()
    total_tokens = 0.0
    for rep in pool.replicas():
        if rep.state == "dead":
            continue
        r = roles.setdefault(rep.role, {
            "replicas": 0, "requests_admitted": 0,
            "tokens_committed": 0, "steps": 0, "live_sequences": 0})
        r["replicas"] += 1
        r["live_sequences"] += len(rep.engine.state.sequences)
        m = rep.engine.metrics
        if m is None:
            continue
        r["requests_admitted"] += int(
            m.counter("serve_requests_admitted").value)
        tok = m.counter("serve_tokens_committed").value
        r["tokens_committed"] += int(tok)
        total_tokens += tok
        r["steps"] += int(m.counter("serve_steps").value)
        handoffs["out"] += m.counter("serve_handoff_seqs").value
        handoffs["adopted"] += m.counter("serve_handoff_seqs_in").value
        handoffs["fallback_replays"] += m.counter(
            "serve_handoff_fallback_replays").value
        handoffs["blocks"] += m.counter("serve_handoff_blocks").value
        handoffs["bytes"] += m.counter("serve_handoff_bytes").value
        exposed.merge(m.histogram("serve_handoff_exposed_s"))
    for r in roles.values():
        r["token_share"] = round(
            r["tokens_committed"] / total_tokens, 4) \
            if total_tokens else None
    return {
        "roles": roles,
        "handoffs": {k: int(v) if k != "bytes" else v
                     for k, v in handoffs.items()},
        "exposed_wait_s": exposed.summary(),
    }


# ---------------------------------------------------------------------- #
# CLI (python -m deepspeed_tpu_torch.telemetry.loadgen)
# ---------------------------------------------------------------------- #


def _tiny_engine(max_seqs: int = 8, num_blocks: int = 96,
                 block_size: int = 16, vocab: int = 96,
                 spec: str = "off", spec_k: int = 4,
                 host_blocks: int = 0, seq_size: int = 1,
                 device: Any = None, params: Any = None):
    """The JAX package's CLI/harness GPT-2 engine (2 layers, hidden 32,
    fp32, dense attention, depth 2, prefix cache) as a port engine on
    ``device`` (default ``cuda``) — small enough that a decode step is a
    few ms. Its weights are a seeded draw (``init_gpt2_params``, seed 0)
    unless ``params`` (the port's tree, e.g. the JAX engine's weights
    carried across) is given. ``spec`` arms speculative decoding
    (``--spec``); ``host_blocks`` arms the hierarchical-KV host-RAM tier
    (``--host-blocks``). ``seq_size`` above 1 is A8."""
    import torch

    from ..checkpoint import init_gpt2_params
    from ..inference.v2 import InferenceEngineV2, RaggedInferenceConfig
    from ..models.gpt2 import GPT2Config
    from ..utils.device import resolve_device
    if seq_size > 1:
        raise NotImplementedError(
            "the sequence-parallel engine (--seq above 1) is not ported "
            "yet (queue item A8)")
    dev = resolve_device(device)
    mcfg = GPT2Config(vocab_size=vocab, max_seq_len=block_size * 16,
                      num_layers=2, num_heads=2, hidden_size=32,
                      dtype=torch.float32)
    if params is None:
        params = init_gpt2_params(mcfg, seed=0, device=dev)
    cfg = RaggedInferenceConfig(
        max_seqs=max_seqs, chunk_size=16, block_size=block_size,
        num_blocks=num_blocks, max_blocks_per_seq=16, dtype="float32",
        attention_impl="dense", decode_loop_steps=0,
        serve_pipeline_depth=2, prefix_cache=True,
        prefix_cache_host_blocks=host_blocks,
        spec_decode=spec, spec_k=spec_k)
    return InferenceEngineV2(mcfg, params, cfg, device=dev), mcfg


#: the tiny MoE engine's expert FFN width; its dense-matched reference
#: uses top_k x this (same ACTIVE params per token, no routing)
_TINY_MOE_INTERMEDIATE = 32


def _tiny_moe_engine(max_seqs: int = 8, num_blocks: int = 96,
                     block_size: int = 16, ep: int = 1,
                     dense_match: bool = False, device: Any = None):
    """The JAX package's Mixtral-style harness engine (4 experts, top-2
    routing, fp32, dense attention) as a port engine on ``device``
    (default ``cuda``), with seeded weights (``init_family_params`` /
    ``init_llama_params``, seed 0). ``dense_match=True`` instead builds
    the dense reference at MATCHED ACTIVE PARAMS — a plain Llama runner
    whose FFN width equals ``top_k x`` the expert width, so per-token
    GEMM work matches and the throughput ratio isolates routing +
    dispatch overhead. ``ep`` above 1 (the expert axis) is A8."""
    import torch

    from ..checkpoint import init_family_params, init_llama_params
    from ..inference.v2 import InferenceEngineV2, RaggedInferenceConfig
    from ..models.llama import LlamaConfig
    from ..models.mixtral import MixtralConfig
    from ..utils.device import resolve_device
    if ep > 1 and not dense_match:
        raise NotImplementedError(
            "the expert-parallel engine (--ep above 1) is not ported yet "
            "(queue item A8)")
    dev = resolve_device(device)
    common = dict(vocab_size=96, max_seq_len=block_size * 16,
                  num_layers=2, num_heads=2, num_kv_heads=2,
                  hidden_size=32, dtype=torch.float32)
    if dense_match:
        mcfg = LlamaConfig(intermediate_size=2 * _TINY_MOE_INTERMEDIATE,
                           **common)
        params = init_llama_params(mcfg, seed=0, device=dev)
    else:
        mcfg = MixtralConfig(intermediate_size=_TINY_MOE_INTERMEDIATE,
                             num_experts=4, experts_top_k=2, **common)
        params = init_family_params(mcfg, seed=0, device=dev)
    cfg = RaggedInferenceConfig(
        max_seqs=max_seqs, chunk_size=16, block_size=block_size,
        num_blocks=num_blocks, max_blocks_per_seq=16, dtype="float32",
        attention_impl="dense", decode_loop_steps=0,
        serve_pipeline_depth=2, prefix_cache=True)
    return InferenceEngineV2(mcfg, params, cfg, device=dev), mcfg


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m deepspeed_tpu_torch.telemetry.loadgen`` — run an
    open-loop pass (or a rate sweep) against a self-contained tiny engine
    on ``--device`` (``cuda`` unless asked otherwise; ``cpu`` runs the
    plain path) and print the report JSON. ``--replicas N`` swaps the
    single engine for an N-replica :class:`~..serving.ReplicaPool` (same
    knobs, same report shape, plus a ``fleet`` section) with the routing
    policy from ``--policy`` / ``DSTPU_FLEET_POLICY``. The env knobs
    mirror the flags (flags win), as in the JAX package's
    ``bin/dstpu_loadgen``."""
    import argparse
    import os

    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.telemetry.loadgen",
        description="open-loop wall-clock load generator for the v2 "
                    "ragged engine or a replica-pool fleet")
    ap.add_argument("--device", default="cuda",
                    help="where the tiny engines run: cuda (default; "
                         "raises without a card) or cpu")
    ap.add_argument("--rate", default=os.environ.get(
        "DSTPU_LOADGEN_RATE", "8"),
        help="offered req/s; a comma list runs a capacity sweep")
    ap.add_argument("--requests", type=int, default=int(os.environ.get(
        "DSTPU_LOADGEN_REQS", "32")))
    ap.add_argument("--seed", type=int, default=int(os.environ.get(
        "DSTPU_LOADGEN_SEED", "0")))
    ap.add_argument("--burst", type=int, default=int(os.environ.get(
        "DSTPU_LOADGEN_BURST", "8")),
        help="decode tokens per pipelined burst between admission polls")
    ap.add_argument("--process", choices=("poisson", "uniform", "trace"),
                    default=os.environ.get("DSTPU_LOADGEN_PROCESS",
                                           "poisson"))
    ap.add_argument("--trace", default=os.environ.get(
        "DSTPU_LOADGEN_TRACE"),
        help="JSON arrival-trace file for --process trace")
    ap.add_argument("--shed-after", type=float, default=float(
        os.environ.get("DSTPU_LOADGEN_SHED_AFTER_S", "0")),
        help="driver-side shed bound in seconds (0 = queue forever)")
    ap.add_argument("--temperature", type=float, default=float(
        os.environ.get("DSTPU_LOADGEN_TEMPERATURE", "0") or "0"),
        help="per-request sampling temperature (0 = greedy; the "
             "on-device per-slot sampler, seeds derived per uid)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sampling top-k filter (with --temperature > 0)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="sampling top-p filter (with --temperature > 0)")
    ap.add_argument("--spec", default=os.environ.get(
        "DSTPU_LOADGEN_SPEC", "off"), choices=("off", "ngram"),
        help="arm speculative decoding on the tiny engine(s) — the "
             "observatory then drives draft/verify traffic and the "
             "report carries the acceptance rate")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens per speculation round")
    ap.add_argument("--mix", default=os.environ.get(
        "DSTPU_LOADGEN_MIX", "custom"),
        choices=("custom", "prefill_heavy", "long_context",
                 "moe_decode_heavy"),
        help="workload preset: prefill_heavy offers long prompts with "
             "short generations (the disaggregated-serving regime) and "
             "overrides --prompt-len/--gen-len; long_context offers "
             "log-spaced prompts up to the engine's whole per-sequence "
             "pool span with small generations and adds a 'longctx' "
             "report section; moe_decode_heavy (the expert-parallel "
             "regime) is not ported yet (A8, A9)")
    ap.add_argument("--seq", type=int, default=int(os.environ.get(
        "DSTPU_LOADGEN_SEQ", "1") or "1"),
        help="sequence-parallel width (above 1: not ported yet, A8)")
    ap.add_argument("--ep", type=int, default=int(os.environ.get(
        "DSTPU_LOADGEN_EP", "1") or "1"),
        help="expert-parallel width (above 1: not ported yet, A8)")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--shared-prefix-frac", type=float, default=0.0)
    ap.add_argument("--prefix-groups", type=int, default=1,
                    help="distinct shared preambles (>1 = the fleet "
                         "routing workload)")
    ap.add_argument("--prefix-working-set-blocks", type=int,
                    default=int(os.environ.get(
                        "DSTPU_LOADGEN_PREFIX_WS", "0") or "0"),
                    help="offer a group-cycled shared-prefix working "
                         "set of ~this many KV blocks (the hierarchical"
                         "-KV workload; size it >= 3x the device pool)")
    ap.add_argument("--host-blocks", type=int,
                    default=int(os.environ.get(
                        "DSTPU_LOADGEN_HOST_BLOCKS", "0") or "0"),
                    help="arm the tiny engine's host-RAM prefix-cache "
                         "tier with this many blocks (0 = off)")
    ap.add_argument("--num-blocks", type=int,
                    default=int(os.environ.get(
                        "DSTPU_LOADGEN_NUM_BLOCKS", "96") or "96"),
                    help="tiny engine KV pool size in blocks — shrink "
                         "it below the working set to exercise the "
                         "host tier")
    ap.add_argument("--deadline-s", type=float, default=0.0)
    ap.add_argument("--deadline-frac", type=float, default=0.0)
    ap.add_argument("--batch-frac", type=float, default=float(
        os.environ.get("DSTPU_LOADGEN_BATCH_FRAC", "0") or "0"),
        help="fraction of requests tagged lowest-class (klass=1, "
             "batch) — the brownout ladder's shed_lowclass level "
             "sheds these first")
    ap.add_argument("--admission", default=os.environ.get(
        "DSTPU_LOADGEN_ADMISSION", "off"), choices=("on", "off"),
        help="arm the knee-seeking AdmissionController at the door "
             "(DSTPU_ADMISSION=0 still kills it)")
    ap.add_argument("--retry-budget", type=int, default=int(
        os.environ.get("DSTPU_LOADGEN_RETRY_BUDGET", "0") or "0"),
        help="client retries per door-rejected request (jittered "
             "exponential backoff honoring retry_after_s)")
    ap.add_argument("--retry-base", type=float, default=float(
        os.environ.get("DSTPU_LOADGEN_RETRY_BASE_S", "0.05") or "0.05"),
        help="base backoff seconds for the retry schedule")
    ap.add_argument("--spike-mult", type=float, default=float(
        os.environ.get("DSTPU_LOADGEN_SPIKE_MULT", "0") or "0"),
        help="overlay a rate spike of this multiple on --rate "
             "(0 = steady; poisson process only)")
    ap.add_argument("--spike-start", type=float, default=float(
        os.environ.get("DSTPU_LOADGEN_SPIKE_START_S", "1") or "1"),
        help="spike onset, seconds into the run")
    ap.add_argument("--spike-dur", type=float, default=float(
        os.environ.get("DSTPU_LOADGEN_SPIKE_DUR_S", "2") or "2"),
        help="spike duration in seconds")
    ap.add_argument("--replicas", type=int, default=int(os.environ.get(
        "DSTPU_FLEET_REPLICAS", "1")),
        help="serve through a ReplicaPool of N tiny engines instead of "
             "one engine")
    ap.add_argument("--policy", default=None,
        choices=("random", "round_robin", "prefix_aware"),
        help="fleet routing policy (default: DSTPU_FLEET_POLICY or "
             "prefix_aware)")
    ap.add_argument("--roles", default=os.environ.get(
        "DSTPU_FLEET_ROLES"),
        help="comma list of per-replica phase roles (prefill/decode/"
             "mixed) for --replicas N — arms disaggregated serving; "
             "the report gains a 'disagg' section (DSTPU_DISAGG=0 "
             "still forces everything mixed)")
    ap.add_argument("--slo-goodput", type=float, default=0.9,
                    help="goodput fraction the sweep's knee must meet")
    ap.add_argument("--out", default=None,
                    help="also write the report JSON here")
    args = ap.parse_args(argv)

    if args.seq > 1 or args.ep > 1:
        raise NotImplementedError(
            "--seq / --ep above 1 (sequence- and expert-parallel serving "
            "over several cards) are not ported yet (queue item A8)")
    if args.mix == "moe_decode_heavy":
        # its report section reads the expert residency gauge and the
        # audited all_to_all share of the decode step
        raise NotImplementedError(
            "--mix moe_decode_heavy's serve_moe section is not ported yet "
            "(queue items A8: expert_memory_report, A9: comm_share)")
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)
    pool = None
    if args.replicas > 1:
        from ..serving import ReplicaPool, build_replica_engines
        mcfg_box = []

        def factory(i, d):
            e, m = _tiny_engine(num_blocks=args.num_blocks,
                                spec=args.spec, spec_k=args.spec_k,
                                host_blocks=args.host_blocks,
                                seq_size=args.seq, device=d)
            mcfg_box.append(m)
            return e

        engines = build_replica_engines(factory, args.replicas,
                                        devices=[dev])
        mcfg = mcfg_box[0]
        roles = [r.strip() for r in args.roles.split(",")] \
            if args.roles else None
        pool = ReplicaPool(engines, policy=args.policy, roles=roles)
        eng = pool
    else:
        eng, mcfg = _tiny_engine(num_blocks=args.num_blocks,
                                 spec=args.spec, spec_k=args.spec_k,
                                 host_blocks=args.host_blocks,
                                 seq_size=args.seq, device=dev)
    sampling = None
    if args.temperature > 0:
        from ..inference.v2 import SamplingParams
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p)
    if args.mix == "prefill_heavy":
        mix = WorkloadMix.prefill_heavy(
            vocab_size=mcfg.vocab_size,
            deadline_frac=args.deadline_frac,
            deadline_s=args.deadline_s,
            batch_frac=args.batch_frac)
    elif args.mix == "long_context":
        # span = the tiny engine's whole per-sequence table
        # (max_blocks_per_seq=16 x block_size=16 -> 256 tokens)
        mix = WorkloadMix.long_context(
            pool_span_tokens=16 * 16,
            vocab_size=mcfg.vocab_size,
            deadline_frac=args.deadline_frac,
            deadline_s=args.deadline_s,
            batch_frac=args.batch_frac)
    else:
        mix = WorkloadMix(
            prompt_lens=(args.prompt_len,), prompt_probs=(1.0,),
            gen_lens=(args.gen_len,), gen_probs=(1.0,),
            shared_prefix_frac=args.shared_prefix_frac,
            # full 16-token blocks (the tiny engine's block size) so
            # the shared span is actually cacheable; shorter prompts
            # get no prefix rather than a sub-block span no match can
            # ever hit. The working-set pattern always needs a preamble
            # — it exists to cycle one — and takes the LONGEST
            # block-aligned span the prompt affords (up to 3 blocks),
            # so the group count is working-set/preamble-blocks and a
            # realistic request count actually revisits each group.
            shared_prefix_len=min(
                3, max(1, (args.prompt_len - 8) // 16)) * 16
            if args.prefix_working_set_blocks > 0
            else (16 if args.shared_prefix_frac > 0
                  and args.prompt_len >= 24 else 0),
            prefix_group_count=max(1, args.prefix_groups),
            prefix_working_set_blocks=max(
                0, args.prefix_working_set_blocks),
            prefix_block_tokens=16,
            deadline_frac=args.deadline_frac, deadline_s=args.deadline_s,
            batch_frac=args.batch_frac,
            vocab_size=mcfg.vocab_size)
    adm = None
    if args.admission == "on":
        # explicit opt-in arms the controller; DSTPU_ADMISSION=0 (or
        # telemetry off) still wins inside build_admission
        from ..serving import build_admission
        adm = build_admission(eng)
    rates = [float(r) for r in str(args.rate).split(",") if r]
    if len(rates) > 1:
        if args.process == "trace":
            ap.error("--process trace replays a recorded schedule and "
                     "cannot sweep offered rates; give one --rate or "
                     "use poisson/uniform")
        if args.spike_mult > 0:
            ap.error("--spike-mult overlays a spike on ONE --rate; a "
                     "sweep already varies the offered load")
        out = sweep_capacity(
            eng, rates, args.requests, mix, seed=args.seed,
            goodput_slo_frac=args.slo_goodput, process=args.process,
            decode_burst=args.burst, shed_after_s=args.shed_after,
            sampling=sampling, admission=adm,
            retry_budget=args.retry_budget,
            retry_base_s=args.retry_base)
    else:
        if args.process == "trace":
            if not args.trace:
                ap.error("--process trace needs --trace FILE")
            proc: ArrivalProcess = TraceArrivals.from_file(args.trace)
        elif args.process == "uniform":
            proc = UniformArrivals(rates[0])
        elif args.spike_mult > 0:
            proc = SpikeArrivals(rates[0], args.spike_mult,
                                 args.spike_start, args.spike_dur,
                                 seed=args.seed)
        else:
            proc = PoissonArrivals(rates[0], seed=args.seed)
        reqs = build_requests(proc, mix, args.requests, seed=args.seed)
        res = run_open_loop(eng, reqs, decode_burst=args.burst,
                            shed_after_s=args.shed_after,
                            sampling=sampling, admission=adm,
                            retry_budget=args.retry_budget,
                            retry_base_s=args.retry_base)
        out = {"arrival": proc.describe(), "workload": mix.describe(),
               **res.report}
        slo = eng.slo_report()
        if slo:
            out["slo_cumulative"] = {
                "goodput_frac": slo["goodput_frac"],
                "ttft_ms_p50": _ms(slo["ttft_s"].get("p50")),
                "ttft_ms_p99": _ms(slo["ttft_s"].get("p99")),
                "spec_accept_rate": slo.get("spec_accept_rate"),
            }
    if args.temperature > 0:
        out["sampling"] = {"temperature": args.temperature,
                           "top_k": args.top_k, "top_p": args.top_p}
    if args.spec != "off":
        out["spec"] = {"mode": args.spec, "k": args.spec_k}
    if args.host_blocks > 0 and pool is None:
        # hierarchical-KV evidence: tier residency + churn + the
        # host-served share of all matched tokens
        st = eng.prefix_stats
        out["hier_kv"] = {
            "host_blocks": args.host_blocks,
            "host_cached_blocks": st.get("host_cached_blocks", 0),
            "demoted": st.get("demoted", 0),
            "promoted": st.get("promoted", 0),
            "host_hit_blocks": st.get("host_hit_blocks", 0),
            "host_evicted": st.get("host_evicted", 0),
            "host_hit_frac": round(st.get("host_hit_frac", 0.0), 4),
            "skipped_prefill_frac": round(
                st.get("prefill_chunks_skipped_frac", 0.0), 4),
        }
    if args.mix == "long_context":
        # long-context evidence: the seq width, the per-chip vs total
        # pool bytes, and the longest rung
        reps = [r.engine for r in pool.replicas()] if pool is not None \
            else [eng]
        kvrep = reps[0].state.kv_memory_report()
        out["longctx"] = {
            "seq_size": kvrep.get("seq_size", 1),
            "prompt_rungs": list(mix.prompt_lens),
            "longest_prompt": max(mix.prompt_lens),
            "kv_pool_bytes_total": kvrep["kv_pool_bytes_total"],
            "kv_pool_bytes_per_chip": kvrep["kv_pool_bytes_per_chip"],
        }
    if pool is not None:
        from ..serving import fleet_prefix_stats
        out["fleet"] = {
            "replicas": args.replicas,
            "router": pool.router.describe(),
            "prefix": fleet_prefix_stats(pool),
            "slo_merged": bool(pool.fleet_registry() is not None),
        }
        if any(r.role != "mixed" for r in pool.replicas()):
            out["disagg"] = disagg_report(pool)
    blob = json.dumps(out)
    print(blob)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(blob)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
