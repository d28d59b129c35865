"""Step-time attribution — where every millisecond of a serve step goes
(port of ``deepspeed_tpu/telemetry/attribution.py``, its serve half).

The observatory can say a step was slow; this module says WHY. The
serve observer (telemetry/serve.py) already brackets the pipeline's
host-side boundaries; with ``DSTPU_ATTRIB=1`` (default) it additionally
closes the books on every committed step, so a step's wall clock
decomposes into:

  * ``plan``            — scheduler + staged-buffer fill
    (``serve_plan_s``);
  * ``dispatch``        — compiled-step enqueue (``serve_dispatch_s``;
    fused decode/verify dispatches land here too);
  * ``device_execute``  — the exposed device wait at the commit's
    blocking readback (``serve_commit_block_s``, the engine's
    ``_readback``): card time the pipeline failed to hide under host
    work;
  * ``commit_apply``    — host-side commit application after the
    readback: token bookkeeping, journal appends, rollbacks, deferred
    flushes (``serve_commit_apply_s``);
  * ``host_gap``        — the RESIDUAL: loop time inside the serve loop
    but outside every bracket (resume scans, deadline sweeps, ring
    bookkeeping, GC pauses — ``serve_host_gap_s``). This is the
    component a "mysteriously slow" step usually hides in, which is
    why it is measured as the closure of the sum rather than by
    enumerating its causes;
  * ``promote_wait``    — the hierarchical-KV promotion dispatch wait
    the ADMISSION path pays (``prefix_promote_wait_s``; put()-side, so
    it is reported as its own component, not part of the step sum).

By construction ``plan + dispatch + device_execute + commit_apply +
host_gap`` equals the serve loop's wall clock (each step's wall is the
interval between commit boundaries; the loop exit closes the tail), so
the components sum to externally measured step wall-clock within
tolerance. Everything is host-side ``perf_counter`` arithmetic at the
engine's existing boundaries.

The train partition (``TRAIN_*``, ``train_attribution_report``) comes
with the training observatory (A7.6); :func:`comm_share`, the
program-audited collective share, with the program auditor (A9).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

#: component -> the histogram whose SUM carries its seconds. Order is
#: the attribution bar's render order; the first five are the step-wall
#: partition, promote_wait is admission-side.
ATTRIBUTION_COMPONENTS = (
    ("plan", "serve_plan_s"),
    ("dispatch", "serve_dispatch_s"),
    ("device_execute", "serve_commit_block_s"),
    ("commit_apply", "serve_commit_apply_s"),
    ("host_gap", "serve_host_gap_s"),
    ("promote_wait", "prefix_promote_wait_s"),
)

#: the components that partition one committed step's wall clock
STEP_WALL_COMPONENTS = ("plan", "dispatch", "device_execute",
                        "commit_apply", "host_gap")

#: the train half of the JAX module, ported with the training
#: observatory (A7.6)
_TRAIN_NAMES = ("TRAIN_ATTRIBUTION_COMPONENTS",
                "TRAIN_STEP_WALL_COMPONENTS", "TRAIN_WALL_HIST",
                "train_attribution_report")


def __getattr__(name: str):
    if name in _TRAIN_NAMES:
        raise NotImplementedError(
            f"telemetry.attribution.{name}: the train attribution is not "
            f"ported yet (queue item A7.6)")
    raise AttributeError(name)


def _hist_sums(snap: Mapping[str, Any]) -> Dict[str, float]:
    """{histogram name: sum seconds} from a registry snapshot (the
    ``snapshot()`` dict or an exported JSON blob)."""
    hists = snap.get("histograms", {})
    out: Dict[str, float] = {}
    for key, s in hists.items():
        out[key.split("{", 1)[0]] = float(s.get("sum", 0.0))
    return out


def component_totals(snap: Mapping[str, Any],
                     prev: Optional[Mapping[str, Any]] = None,
                     components: Any = ATTRIBUTION_COMPONENTS
                     ) -> Dict[str, float]:
    """Per-component attributed seconds from a snapshot — deltas against
    ``prev`` when given (a measured window: warm-up must not pollute
    it). ``components`` selects the partition."""
    cur = _hist_sums(snap)
    old = _hist_sums(prev) if prev is not None else {}
    return {comp: max(0.0, cur.get(h, 0.0) - old.get(h, 0.0))
            for comp, h in components}


def step_wall_total(snap: Mapping[str, Any],
                    prev: Optional[Mapping[str, Any]] = None,
                    wall_hist: str = "serve_step_wall_s") -> float:
    """Total step wall-clock seconds the observer accounted
    (the ``serve_step_wall_s`` sum, optionally delta'd)."""
    cur = _hist_sums(snap).get(wall_hist, 0.0)
    old = _hist_sums(prev).get(wall_hist, 0.0) \
        if prev is not None else 0.0
    return max(0.0, cur - old)


def attribution_report(snap: Mapping[str, Any],
                       prev: Optional[Mapping[str, Any]] = None,
                       components: Any = ATTRIBUTION_COMPONENTS,
                       wall_components: Any = STEP_WALL_COMPONENTS,
                       wall_hist: str = "serve_step_wall_s"
                       ) -> Dict[str, Any]:
    """The attribution summary over a snapshot (or a window between two
    snapshots): per-component seconds and fractions of the step wall,
    the dominant component, and the closure error
    (``|wall − Σ components| / wall``; a large residual means a new
    unbracketed code path crept into the loop)."""
    comps = component_totals(snap, prev, components=components)
    wall = step_wall_total(snap, prev, wall_hist=wall_hist)
    step_sum = sum(comps[c] for c in wall_components)
    denom = wall if wall > 0 else step_sum
    out: Dict[str, Any] = {
        "components_s": {c: round(v, 6) for c, v in comps.items()},
        "step_wall_s": round(wall, 6),
        "components_sum_s": round(step_sum, 6),
        "closure_err_frac": round(abs(wall - step_sum) / denom, 6)
        if denom > 0 else None,
        "fracs": {c: round(comps[c] / denom, 4) if denom > 0 else None
                  for c in wall_components},
    }
    if denom > 0:
        out["dominant"] = max(wall_components,
                              key=lambda c: comps[c])
    else:
        out["dominant"] = None
    return out


def comm_share(engine, program: str = "step_greedy_fb"
               ) -> Optional[Dict[str, Any]]:
    """The JAX package derives the collective share of a serve program
    from its program auditor's counts; the port's auditor is A9."""
    raise NotImplementedError(
        "telemetry.attribution.comm_share: the program auditor it reads "
        "is not ported yet (queue item A9)")
