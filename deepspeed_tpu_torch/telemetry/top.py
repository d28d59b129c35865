"""``python -m deepspeed_tpu_torch.telemetry.top`` — render serving
metrics snapshots.

Port of ``deepspeed_tpu/telemetry/top.py`` (the JAX package's
``bin/dstpu_top``), host code that the port keeps its own copy of (it
imports nothing of the JAX package). For the same snapshot JSON it
renders the JAX text, character for character. Not ported yet: the
training view (``--train``, :func:`render_train`), which reads the
training observatory's exports and skew report (ROADMAP A7.6).

Reads the atomic JSON export a running engine publishes at
``DSTPU_TELEMETRY_EXPORT`` (every ``DSTPU_TELEMETRY_EXPORT_EVERY``
committed steps) and renders a compact operator view: request outcome
counts and rates, TTFT/TPOT/queue-wait percentiles, goodput, prefix
cache hit fraction and KV pool occupancy. When the snapshot carries the
registry's sampled time series (``series`` — DSTPU_SERIES_* knobs), the
render adds per-window rates and sparklines, so even a ONE-SHOT render
shows the recent rate history. ``--watch N`` refreshes every N seconds
(rates then also derive from consecutive snapshots).

Fleet mode: MULTIPLE export files (repeated ``--file``, positional
paths, or a shell-quoted glob like ``'profiles/replica_*.json'``) are
rolled up through the EXACT cross-process merge
(``telemetry.merge_snapshots`` — counters sum, gauges gain stable
``source`` labels, histogram quantiles equal a single stream over the
union) and rendered as ONE fleet view plus a per-source breakdown line
per replica (docs/observability.md "Fleet rollup").
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple


def _ms(v: Optional[float]) -> str:
    return "-" if v is None else f"{v * 1e3:8.1f}"


def _frac(n: float, d: float) -> Optional[float]:
    return n / d if d else None


def _pct(v: Optional[float]) -> str:
    return "-" if v is None else f"{v * 100:5.1f}%"


def load_snapshot(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(vals: List[float], width: int = 32) -> str:
    """Unicode block sparkline over the last ``width`` values (empty
    string for fewer than 2 points)."""
    vals = [v for v in vals if v is not None][-width:]
    if len(vals) < 2:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[3] * len(vals)
    scale = (len(_SPARK) - 1) / (hi - lo)
    return "".join(_SPARK[int((v - lo) * scale)] for v in vals)


def _series_rates(pairs: List[List[float]]) -> List[float]:
    """Per-window rates from a sampled counter series [[t, v], ...]."""
    out: List[float] = []
    for (t0, v0), (t1, v1) in zip(pairs, pairs[1:]):
        if t1 > t0:
            out.append((v1 - v0) / (t1 - t0))
    return out


def _series_ratio(num: List[List[float]],
                  den: List[List[float]]) -> List[float]:
    """Per-window Δnum/Δden over two counter series sampled on the
    same clock (the speculative accept-rate trend); windows where the
    denominator did not move are skipped."""
    out: List[float] = []
    for (n0, d0), (n1, d1) in zip(zip(num, den), zip(num[1:], den[1:])):
        dd = d1[1] - d0[1]
        if dd > 0:
            out.append((n1[1] - n0[1]) / dd)
    return out


#: attribution components in render order: (label, histogram, bar char,
#: window-dominant initial, counter-label component name)
_ATTRIB_ROWS = (
    ("plan", "serve_plan_s", "█", "p", "plan"),
    ("dispatch", "serve_dispatch_s", "▓", "d", "dispatch"),
    ("execute", "serve_commit_block_s", "▒", "x", "device_execute"),
    ("apply", "serve_commit_apply_s", "░", "c", "commit_apply"),
    ("host gap", "serve_host_gap_s", "·", "g", "host_gap"),
)


def _attrib_fracs(hists: Dict[str, Any], rows=_ATTRIB_ROWS):
    """((label, frac), ...) + dominant label from the component
    histograms' sums; None before any attributed step. ``rows`` selects
    the partition (serve default; _TRAIN_ATTRIB_ROWS for --train)."""
    sums = [(label, float(hists.get(name, {}).get("sum", 0.0)), ch)
            for label, name, ch, _, _ in rows]
    total = sum(s for _, s, _ in sums)
    if total <= 0.0:
        return None
    fracs = [(label, s / total) for label, s, _ in sums]
    dominant = max(sums, key=lambda r: r[1])[0]
    return fracs, dominant


def _attrib_bar(fracs, rows=_ATTRIB_ROWS, width: int = 44) -> str:
    """One-line proportional bar over the step-wall components, each
    component its own fill glyph (legend rides the fraction row)."""
    chars = {label: ch for label, _, ch, _, _ in rows}
    out = ""
    for label, f in fracs:
        out += chars[label] * max(1 if f > 0.005 else 0,
                                  round(f * width))
    return f"[{out[:width + len(fracs)]}]"


def _attrib_window_dominants(series: Dict[str, Any],
                             rows=_ATTRIB_ROWS,
                             counter: str = "serve_attrib_seconds_total",
                             width: int = 32) -> str:
    """Per-sample-window dominant component as a trail of initials (the
    sampled ``*_attrib_seconds_total{component=...}`` counter series):
    one glyph per window, newest right — a drifting dominant (say
    compute windows giving way to host-gap windows) reads at a
    glance."""
    per_comp = {}
    for _, _, _, init, comp in rows:
        key = f'{counter}{{component="{comp}"}}'
        pairs = series.get(key, [])
        if pairs:
            # keyed by sample TIMESTAMP: one registry sample() stamps
            # every live counter with the same clock value, so equal
            # timestamps ARE the same window — while a late-created
            # component (a fused-decode fleet plans nothing until it
            # switches paths) simply has no entry for early windows
            # instead of shifting everyone's alignment
            per_comp[init] = dict(pairs)
    if not per_comp:
        return ""
    times = sorted({t for m in per_comp.values() for t in m})
    if len(times) < 2:
        return ""
    out = []
    for t0, t1 in list(zip(times, times[1:]))[-width:]:
        deltas = {init: m[t1] - m[t0] for init, m in per_comp.items()
                  if t0 in m and t1 in m}
        if not deltas:
            out.append("-")
            continue
        best = max(deltas, key=deltas.get)
        out.append(best if deltas[best] > 0 else "-")
    return "".join(out)


def render(snap: Dict[str, Any], prev: Optional[Dict[str, Any]] = None
           ) -> str:
    """The operator table for one snapshot; ``prev`` (an earlier
    snapshot) turns counter deltas into rates."""
    c = snap.get("counters", {})
    g = snap.get("gauges", {})
    h = snap.get("histograms", {})
    series = snap.get("series", {})

    def series_rate(name: str) -> Optional[float]:
        rates = _series_rates(series.get(name, []))
        return rates[-1] if rates else None

    def rate(name: str) -> str:
        if prev is not None:
            dt = snap.get("time", 0.0) - prev.get("time", 0.0)
            if dt <= 0:
                return "      -"
            d = c.get(name, 0.0) - prev.get("counters", {}).get(name, 0.0)
            return f"{d / dt:7.1f}"
        # one-shot render: the sampled series still yields a rate
        r = series_rate(name)
        return f"{r:7.1f}" if r is not None else "      -"

    lines: List[str] = []
    when = time.strftime("%H:%M:%S",
                         time.localtime(snap.get("time", time.time())))
    lines.append(f"dstpu_top — registry '{snap.get('registry', '?')}' "
                 f"@ {when}  (uptime {snap.get('uptime_s', 0.0):.0f}s)")
    lines.append("")
    lines.append("requests            total     /s")
    for label, name in (("admitted", "serve_requests_admitted"),
                        ("completed", "serve_requests_completed"),
                        ("shed", "serve_requests_shed"),
                        ("deadline", "serve_requests_deadline_expired"),
                        ("adm-reject", "serve_requests_rejected_admission"),
                        ("aborted", "serve_requests_aborted"),
                        ("drained", "serve_requests_drained")):
        lines.append(f"  {label:<14}{c.get(name, 0):9.0f} {rate(name)}")
    good = c.get("serve_requests_completed", 0.0)
    bad = (c.get("serve_requests_shed", 0.0)
           + c.get("serve_requests_deadline_expired", 0.0)
           + c.get("serve_requests_rejected_draining", 0.0)
           + c.get("serve_requests_rejected_admission", 0.0)
           + c.get("serve_requests_aborted", 0.0))
    lines.append(f"  goodput        {_pct(_frac(good, good + bad))}")
    lines.append("")
    lines.append(f"tokens committed {c.get('serve_tokens_committed', 0):11.0f}"
                 f"  {rate('serve_tokens_committed')} tok/s   "
                 f"steps {c.get('serve_steps', 0):.0f} "
                 f"(device-fed {c.get('serve_steps_device_fed', 0):.0f})")
    prop = c.get("spec_proposed", 0.0)
    if prop:
        acc = c.get("spec_accepted", 0.0)
        lines.append(
            f"speculation    proposed {prop:.0f}   accepted {acc:.0f}   "
            f"accept rate {_pct(_frac(acc, prop))}   "
            f"rounds {c.get('spec_rounds', 0):.0f}")
    # disaggregated serving: only rendered once a prefill→decode handoff
    # has actually happened (colocated fleets never pay for the line).
    # A fleet-merged view sums both sides, so seqs counts the prefill
    # exports and adopted the decode-side restores — they diverge only
    # while migrations are in flight or falling back to replay.
    hoff = c.get("serve_handoff_seqs", 0.0)
    if hoff:
        ex = h.get("serve_handoff_exposed_s", {})
        lines.append(
            f"handoff        seqs {hoff:.0f}   "
            f"adopted {c.get('serve_handoff_seqs_in', 0):.0f}   "
            f"replayed {c.get('serve_handoff_fallback_replays', 0):.0f}   "
            f"blocks {c.get('serve_handoff_blocks', 0):.0f}   "
            f"{c.get('serve_handoff_bytes', 0.0) / 1e6:.1f} MB   "
            f"exposed p99 {_ms(ex.get('p99'))} ms")
    lines.append("")
    lines.append("latency (ms)          p50      p90      p99    count")
    for label, name in (("ttft", "serve_ttft_s"),
                        ("tpot", "serve_tpot_s"),
                        ("queue wait", "serve_queue_wait_s"),
                        ("commit block", "serve_commit_block_s")):
        s = h.get(name, {})
        lines.append(f"  {label:<14}{_ms(s.get('p50'))} {_ms(s.get('p90'))}"
                     f" {_ms(s.get('p99'))} {s.get('count', 0):8d}")
    # step-time attribution bar (docs/observability.md "Step-time
    # attribution"): where the committed steps' wall clock went, from
    # the component histograms' sums — plus the per-window dominant
    # component off the sampled serve_attrib_seconds_total series
    attrib = _attrib_fracs(h)
    if attrib is not None:
        fracs, dominant = attrib
        lines.append("")
        lines.append("step time      " + "  ".join(
            f"{name} {_pct(f)}" for name, f in fracs) +
            f"   dominant: {dominant}")
        lines.append("  " + _attrib_bar(fracs))
        doms = _attrib_window_dominants(series, _ATTRIB_ROWS)
        if doms:
            lines.append(f"  dominant/window  {doms}  "
                         f"(p=plan d=dispatch x=execute c=apply "
                         f"g=host-gap)")
    lines.append("")
    hit = c.get("prefix_matched_tokens", 0.0)
    ran = c.get("prefix_prefill_tokens", 0.0)
    def g_sum(name: str) -> float:
        # a fleet-merged snapshot carries gauges under per-replica
        # source labels; the headline row sums them (pool capacity /
        # occupancy across the fleet is the sum of the replicas')
        if name in g:
            return g[name]
        return sum(v for k, v in g.items()
                   if k.split("{", 1)[0] == name)

    lines.append(f"prefix cache   hit frac {_pct(_frac(hit, hit + ran))}"
                 f"   cached {g_sum('prefix_cached_blocks'):.0f}"
                 f" blocks (evictable {g_sum('prefix_evictable_blocks'):.0f})"
                 f"   cow {c.get('prefix_cow_copies', 0):.0f}"
                 f"   evicted {c.get('prefix_evicted_blocks', 0):.0f}")
    demoted = c.get("prefix_demoted_blocks", 0.0)
    host_now = g_sum("prefix_host_blocks")
    if demoted or host_now:
        # hierarchical KV: the host-RAM tier line — resident blocks,
        # demote/promote churn, host-served hits, true losses at the
        # tier's own cap, and the promotion dispatch wait the plan path
        # actually paid (the exposed slice of a demoted hit's cost)
        pw = h.get("prefix_promote_wait_s", {})
        lines.append(
            f"host tier      {host_now:.0f} blocks resident   "
            f"demoted {demoted:.0f}   "
            f"promoted {c.get('prefix_promoted_blocks', 0):.0f}   "
            f"host hits {c.get('prefix_host_hit_blocks', 0):.0f}   "
            f"lost {c.get('prefix_host_evicted_blocks', 0):.0f}   "
            f"promote wait p99 {_ms(pw.get('p99'))} ms")
    total = g_sum("kv_pool_blocks_total")
    free = g_sum("kv_pool_blocks_free")
    per_chip = [v for k, v in g.items()
                if k.split("{", 1)[0] == "kv_pool_bytes_per_chip"]
    lines.append(f"kv pool        occupancy "
                 f"{_pct(_frac(total - free, total))}   "
                 f"{free:.0f}/{total:.0f} blocks free   "
                 f"{max(per_chip, default=0.0) / 1e6:.1f} MB/chip")
    lvls = [v for k, v in g.items()
            if k.split("{", 1)[0] == "admission_level"]
    if lvls or "admission_window" in g:
        # overload-control status (docs/serving.md "Overload control"):
        # which brownout level the fleet is in and why. Window sums
        # across replicas (door concurrency is additive); level takes
        # the WORST replica — a fleet is as browned out as its most
        # pressured member
        from ..serving.admission import BROWNOUT_LEVELS
        lvl = int(max(lvls, default=0.0))
        lvl = min(lvl, len(BROWNOUT_LEVELS) - 1)
        trans = sum(v for k, v in c.items()
                    if k.split("{", 1)[0] == "brownout_transitions")
        lines.append(
            f"admission      window {g_sum('admission_window'):.0f}   "
            f"level {lvl} ({BROWNOUT_LEVELS[lvl]})   "
            f"door rejects {c.get('admission_rejected', 0):.0f}   "
            f"brownout moves {trans:.0f}")
    dropped = c.get("flight_spans_dropped", 0.0)
    if dropped:
        lines.append(f"flight ring    {dropped:.0f} spans dropped "
                     f"(ring wrapped — raise DSTPU_FLIGHT_CAPACITY for "
                     f"longer postmortems)")
    # sampled time series -> per-window rate sparklines (the recent
    # history a single snapshot carries; DSTPU_SERIES_* knobs)
    spark_rows = []
    for label, name in (("admitted/s", "serve_requests_admitted"),
                        ("completed/s", "serve_requests_completed"),
                        ("tokens/s", "serve_tokens_committed")):
        rates = _series_rates(series.get(name, []))
        spark = _sparkline(rates)
        if spark:
            spark_rows.append(f"  {label:<14}{rates[-1]:9.1f}  {spark}")
    # speculative acceptance trend: per-window Δaccepted/Δproposed over
    # the two sampled counter series (windows with no proposals skip)
    accs = _series_ratio(series.get("spec_accepted", []),
                         series.get("spec_proposed", []))
    spark = _sparkline(accs)
    if spark:
        spark_rows.append(f"  {'accept rate':<14}{accs[-1]:9.2f}  {spark}")
    if spark_rows:
        lines.append("")
        lines.append("rates (sampled series)   now  trend")
        lines.extend(spark_rows)
    return "\n".join(lines)


def render_train(snap: Dict[str, Any],
                 prev: Optional[Dict[str, Any]] = None,
                 per_source: Optional[List[Tuple[str, Dict[str, Any]]]]
                 = None) -> str:
    """The training-observatory view (``--train``): not ported yet."""
    raise NotImplementedError(
        "telemetry.top.render_train (--train) is not ported yet (queue "
        "item A7.6: telemetry/train.py, the training observatory and its "
        "skew report)")


def _resolve_paths(file_args: List[str],
                   positional: List[str]) -> List[str]:
    """Expand the --file/positional path set: each entry may be a
    literal path or a glob pattern (shells that did not expand it —
    quoted, or no match locally). Order-stable, de-duplicated."""
    out: List[str] = []
    for raw in list(file_args) + list(positional):
        hits = sorted(_glob.glob(raw)) if _glob.has_magic(raw) else [raw]
        for p in hits or [raw]:
            if p not in out:
                out.append(p)
    return out


def load_fleet(paths: List[str]
               ) -> Tuple[Dict[str, Any], List[Tuple[str, Dict[str, Any]]]]:
    """Load every snapshot and merge EXACTLY (counters sum, gauges gain
    stable source labels, histograms bucket-merge). Sources are the
    snapshots' registry names when unique (the replica-pool path names
    each registry after its replica id), else the file basenames.
    Returns (merged, [(source, snapshot), ...])."""
    from .registry import merge_snapshots
    snaps = [load_snapshot(p) for p in paths]
    names = [s.get("registry") or "" for s in snaps]
    if len(set(names)) == len(snaps) and all(names):
        sources = names
    else:
        sources = [os.path.splitext(os.path.basename(p))[0]
                   for p in paths]
    merged = merge_snapshots(snaps, sources=sources)
    # the merged view keeps the newest uptime so the header stays sane
    merged["uptime_s"] = max((s.get("uptime_s", 0.0) for s in snaps),
                             default=0.0)
    return merged, list(zip(sources, snaps))


def render_sources(per_source: List[Tuple[str, Dict[str, Any]]]) -> str:
    """The per-replica breakdown under a fleet render: one line per
    source file with its own outcome counts, token total and TTFT p99."""
    lines = ["", "per-source breakdown        admitted completed     "
                 "tokens  ttft p99(ms)"]
    for src, snap in per_source:
        c = snap.get("counters", {})
        h = snap.get("histograms", {}).get("serve_ttft_s", {})
        lines.append(
            f"  {src:<24}{c.get('serve_requests_admitted', 0):10.0f}"
            f"{c.get('serve_requests_completed', 0):10.0f}"
            f"{c.get('serve_tokens_committed', 0):11.0f}"
            f"  {_ms(h.get('p99'))}")
    return "\n".join(lines)


def merge_trace_files(paths: List[str], out_path: str) -> int:
    """``--merge-trace``: merge flight-dump Chrome traces into one
    fleet timeline and summarize the request tracks it reconstructs
    (docs/observability.md "Distributed tracing")."""
    from .flight_recorder import (atomic_json_dump, merge_chrome_traces,
                                  request_tracks)
    if len(paths) < 1:
        print("dstpu_top --merge-trace: need at least one flight dump",
              file=sys.stderr)
        return 2
    dumps = []
    for p in paths:
        try:
            dumps.append(load_snapshot(p))
        except (OSError, ValueError) as e:
            print(f"dstpu_top: unreadable flight dump {p}: {e}",
                  file=sys.stderr)
            return 2
    sources = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    if len(set(sources)) != len(sources):
        # two replicas each writing flight_0.json into their own dir
        # must NOT collapse onto one source — that would re-introduce
        # the same-uid tid collision the merge exists to fix. Prefer
        # dir/basename; suffix any residual duplicates.
        sources = [os.path.join(os.path.basename(os.path.dirname(
            os.path.abspath(p))), s) for p, s in zip(paths, sources)]
        seen: Dict[str, int] = {}
        for i, s in enumerate(sources):
            n = seen.get(s, 0)
            seen[s] = n + 1
            if n:
                sources[i] = f"{s}#{n}"
    try:
        merged = merge_chrome_traces(dumps, sources)
    except ValueError as e:
        print(f"dstpu_top: {e}", file=sys.stderr)
        return 2
    atomic_json_dump(out_path, merged)
    tracks = request_tracks(merged)
    n_ev = sum(1 for e in merged["traceEvents"] if e.get("ph") != "M")
    print(f"merged {len(dumps)} flight dumps -> {out_path}: "
          f"{n_ev} spans, {len(tracks)} request tracks, "
          f"{merged['otherData']['spans_dropped']} dropped")
    cross = 0
    for name, evs in sorted(tracks.items()):
        srcs = sorted({e.get('args', {}).get('source') for e in evs})
        if len(srcs) > 1:
            cross += 1
        print(f"  {name:<32}{len(evs):4d} spans   "
              f"sources: {', '.join(s for s in srcs if s)}")
    if cross:
        print(f"  ({cross} track(s) span multiple sources — "
              f"drain/replay continuations stitched by trace context)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dstpu_top",
        description="render one serving engine's telemetry export, or "
                    "merge several replicas' exports into one fleet "
                    "view (docs/observability.md)")
    ap.add_argument("paths", nargs="*", default=[],
                    help="export file(s); globs accepted — more than "
                         "one renders the merged fleet view")
    ap.add_argument("--file", action="append", default=[],
                    help="export file or glob (repeatable; default: "
                         "$DSTPU_TELEMETRY_EXPORT)")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                    help="refresh every N seconds (0 = one-shot)")
    ap.add_argument("--train", action="store_true",
                    help="render the training-observatory view (step "
                         "rates, attribution bar, goodput, anomaly "
                         "counters; several per-host exports add the "
                         "straggler table)")
    ap.add_argument("--merge-trace", metavar="OUT", default=None,
                    help="treat the paths as flight-recorder Chrome-"
                         "trace dumps, merge them onto one fleet "
                         "timeline (tracks namespaced by source, "
                         "trace-context spans stitched across "
                         "replicas) and write the merged trace to OUT")
    args = ap.parse_args(argv)
    paths = _resolve_paths(args.file, args.paths)
    if args.merge_trace:
        return merge_trace_files(paths, args.merge_trace)
    if not paths and os.environ.get("DSTPU_TELEMETRY_EXPORT"):
        paths = [os.environ["DSTPU_TELEMETRY_EXPORT"]]
    if not paths:
        print("dstpu_top: no export file (--file, paths or "
              "DSTPU_TELEMETRY_EXPORT)", file=sys.stderr)
        return 2
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"dstpu_top: export file not found: {missing[0]} — is "
              f"the engine running with DSTPU_TELEMETRY_EXPORT set?",
              file=sys.stderr)
        return 2
    prev = None
    while True:
        try:
            if len(paths) == 1:
                snap = load_snapshot(paths[0])
                out = render_train(snap, prev) if args.train \
                    else render(snap, prev)
            else:
                snap, per_source = load_fleet(paths)
                if args.train:
                    out = render_train(snap, prev,
                                       per_source=per_source)
                else:
                    out = render(snap, prev) + "\n" \
                        + render_sources(per_source)
        except (OSError, ValueError) as e:
            print(f"dstpu_top: unreadable snapshot: {e}",
                  file=sys.stderr)
            return 2
        if args.watch > 0:
            print("\x1b[2J\x1b[H" + out, flush=True)
        else:
            print(out)
            return 0
        prev = snap
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
