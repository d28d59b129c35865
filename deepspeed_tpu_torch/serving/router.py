"""Request router for the replica-pool serving fleet.

Port of ``deepspeed_tpu/serving/router.py``, host code that the port keeps its
own copy of (it imports nothing of the JAX package).

Places each fresh request on one replica of a :class:`~.pool.ReplicaPool`
by a pluggable policy (``ReplicaPool(policy=...)`` /
``DSTPU_FLEET_POLICY``):

  * ``random``       — seeded uniform choice over available replicas
    (the control the fleet bench compares against);
  * ``round_robin``  — cycle over available replicas in id order;
  * ``prefix_aware`` — score every available replica and take the max.

The ``prefix_aware`` score composes the three signals ROADMAP's fleet
item names, all already maintained by lower layers:

  * **cached-prefix overlap** — how many of the request's prompt tokens
    the replica's content-addressed prefix cache would serve from
    already-written KV blocks (``PrefixCache.match`` is a pure host trie
    walk over the chain keys: full matched blocks plus the
    copy-on-write tail span). Requests sharing a system prompt
    gravitate to the replica that already holds its blocks, so the
    fleet-wide skipped-prefill fraction approaches the single-replica
    warm-cache number instead of paying one cold prefill per replica
    per preamble;
  * **queue depth** — live sequences over slots: with no cache signal
    the score reduces to least-loaded, which is also the fallback that
    keeps one hot preamble from collapsing the whole fleet onto one
    replica;
  * **SLO headroom** — distance of the replica's own TTFT p99 (its
    per-engine ``MetricsRegistry``) from the fleet's TTFT target:
    a replica already violating its SLO stops attracting traffic even
    when its cache looks attractive.

``score = w_prefix·overlap_frac − w_queue·queue_frac
          + w_headroom·headroom``   (headroom term only with a target).

Determinism is part of the contract (the fleet drill replays routing
decisions): the same request sequence against the same replica states
yields the same placements — ties (e.g. a cold fleet where every score
is equal) break through a seeded RNG, so cold traffic spreads without
becoming irreproducible.

``select``/``score`` are hot paths: they run
between the engines' overlapped pipelines on the admission path and
must never block on a device sync — every input they read (trie walk,
host dicts, streaming-histogram quantiles) is host-side metadata by
construction.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence

#: the pluggable placement policies (validated at construction)
ROUTING_POLICIES = ("random", "round_robin", "prefix_aware")


class NoServingReplicaError(RuntimeError):
    """Every replica is draining, dead or not yet joined — the pool has
    nowhere to place the request (the caller turns this into a
    structured rejection, never a crash)."""


class Router:
    def __init__(self, policy: str = "prefix_aware", seed: int = 0,
                 slo_ttft_s: float = 0.0, w_prefix: float = 1.0,
                 w_queue: float = 1.0, w_headroom: float = 0.25,
                 w_demoted: float = 0.5, w_admission: float = 0.25):
        # w_queue >= w_prefix on purpose: overlap_frac < 1 always, so a
        # SATURATED replica (queue_frac -> 1) loses to an idle one even
        # on a perfect cache hit — affinity concentrates traffic only
        # up to the point where it would starve the rest of the fleet
        if policy not in ROUTING_POLICIES:
            raise ValueError(
                f"routing policy must be one of {ROUTING_POLICIES}, "
                f"got {policy!r}")
        self.policy = policy
        self.seed = int(seed)
        self.slo_ttft_s = float(slo_ttft_s)
        self.w_prefix = float(w_prefix)
        self.w_queue = float(w_queue)
        self.w_headroom = float(w_headroom)
        # hierarchical KV: host-tier (demoted) overlap counts, but at a
        # discount — a demoted hit still skips the prefill FLOPs, yet
        # pays the promotion copies a device-resident chain would not;
        # given the choice, the request belongs on the replica that
        # holds the chain on device
        self.w_demoted = float(w_demoted)
        # admission-controller headroom (1 - windowed queue-wait p99 /
        # SLO, written onto the replica by the controller's tick):
        # steers toward replicas whose DOOR has slack, complementing
        # queue_frac's instantaneous occupancy with windowed evidence.
        # Free when no controller runs — the attribute stays None
        self.w_admission = float(w_admission)
        self._rng = random.Random(self.seed)
        self._rr = 0
        self.stats = {"dispatched": 0, "ties_broken": 0}

    # ------------------------------------------------------------------ #
    # scoring + selection — the admission hot path
    # ------------------------------------------------------------------ #

    def score(self, replica, prompt: Sequence[int]) -> float:
        """The prefix-aware placement score of one replica for one
        prompt. Pure host arithmetic: a trie walk over cached chain
        keys, two dict-size reads and (with an SLO target) a streaming
        histogram quantile — never a device sync."""
        n = len(prompt)
        if n == 0:
            overlap = 0.0
        else:
            tiered = getattr(replica, "prefix_overlap_tiered", None)
            if tiered is not None:
                # demoted (host-tier) overlap at a discount — see
                # __init__; plain prefix_overlap keeps fakes/tests and
                # pre-tier replica objects working unchanged
                dev, host = tiered(prompt)
                overlap = (dev + self.w_demoted * host) / n
            else:
                overlap = replica.prefix_overlap(prompt) / n
        s = self.w_prefix * overlap - self.w_queue * replica.queue_frac()
        if self.slo_ttft_s > 0:
            s += self.w_headroom * replica.slo_headroom(self.slo_ttft_s)
        ah = getattr(replica, "admission_headroom", None)
        if ah is not None:
            s += self.w_admission * ah
        return s

    def select(self, replicas: Sequence[Any], prompt: Sequence[int],
               explain: Optional[Dict[str, Any]] = None,
               phase: Optional[str] = None):
        """Place ``prompt`` on one of ``replicas``. Only AVAILABLE
        replicas (serving and not draining) are candidates — a draining
        replica's live sequences ride its manifest, and handing it fresh
        work would just bounce off the engine's admission refusal.
        Raises :class:`NoServingReplicaError` when none are available.

        ``explain`` (a dict the caller owns) is filled with the decision
        evidence — the policy, every candidate's score under
        ``prefix_aware``, the chosen replica id and whether a tie broke
        — so the pool's routing-decision trace span can carry exactly
        what the router saw (pure host bookkeeping; None skips it).

        Deterministic given (policy, seed, call history, replica
        states): exact-score ties break through the seeded RNG, so a
        cold fleet spreads reproducibly.

        Role filter (disaggregated serving, docs/serving.md): ``phase``
        names the work being placed — ``"prefill"`` keeps replicas whose
        role is ``prefill`` or ``mixed``, ``"decode"`` keeps ``decode``
        or ``mixed``, None skips the filter. When no capable specialist
        of the needed kind is available the filter degrades to every
        available replica rather than failing — an all-``mixed`` fleet
        (DSTPU_DISAGG=0) therefore routes exactly as before, and a fleet
        that lost its only prefill specialist still serves.

        Slot admission control, applied BEFORE any policy: a replica
        already at its slot capacity (``queue_frac() >= 1``) is only a
        candidate when every available replica is — placing fresh work
        on a full replica makes its engine juggle more sequences than
        slots (pause/offload churn, multi-second tails) while a
        neighbor idles, and no cache hit is worth that."""
        avail = [r for r in replicas if r.available]
        if not avail:
            raise NoServingReplicaError(
                f"no serving replica among {len(replicas)} "
                f"(all draining, dead or not joined)")
        if phase is not None:
            capable = [r for r in avail
                       if getattr(r, "role", "mixed") in (phase, "mixed")]
            avail = capable or avail
        open_ = [r for r in avail if r.queue_frac() < 1.0]
        avail = open_ or avail
        self.stats["dispatched"] += 1
        if explain is not None:
            explain["policy"] = self.policy
            if phase is not None:
                explain["phase"] = phase
        if self.policy == "round_robin":
            pick = avail[self._rr % len(avail)]
            self._rr += 1
            if explain is not None:
                explain["chosen"] = pick.replica_id
            return pick
        if self.policy == "random":
            pick = avail[self._rng.randrange(len(avail))]
            if explain is not None:
                explain["chosen"] = pick.replica_id
            return pick
        best_score = None
        ties: List[Any] = []
        scores: Optional[Dict[str, float]] = \
            {} if explain is not None else None
        for r in avail:
            s = self.score(r, prompt)
            if scores is not None:
                scores[r.replica_id] = round(s, 6)
            if best_score is None or s > best_score:
                best_score = s
                ties = [r]
            elif s == best_score:
                ties.append(r)
        if len(ties) > 1:
            self.stats["ties_broken"] += 1
            pick = ties[self._rng.randrange(len(ties))]
        else:
            pick = ties[0]
        if explain is not None:
            explain["scores"] = scores
            explain["chosen"] = pick.replica_id
            explain["tie_break"] = len(ties) > 1
        return pick

    # ------------------------------------------------------------------ #

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"policy": self.policy, "seed": self.seed,
                               **self.stats}
        if self.policy == "prefix_aware":
            out.update(w_prefix=self.w_prefix, w_queue=self.w_queue,
                       w_headroom=self.w_headroom,
                       w_demoted=self.w_demoted,
                       w_admission=self.w_admission,
                       slo_ttft_s=self.slo_ttft_s or None)
        return out
