"""Port parity for serving telemetry, on the CPU.

- The JAX package's own registry, histogram, flight-recorder, merge,
  time-series, rollup and monitor-bridge cases
  (``tests/unit/test_telemetry.py``) run here on the port's modules: the
  classes are compiled from that file with its imports of the telemetry
  modules pointed at the port (the snapshot renderer too). So are its
  serve-engine cases, with its ``_engine`` replaced by a port engine (the
  tiny Llama below, fp32, dense attention, depth 2, prefix cache).
- The same event sequence fed to both packages' registries gives equal
  snapshots, and equal ``merge_snapshots``.
- The same workload served by the JAX engine and the port engine gives
  equal counters, equal histogram counts, equal metric names, equal
  gauges (the KV pool's bytes too: both pools hold ``num_blocks + 1``
  blocks), the same phase spans per step in the flight ring, and equal
  SLO-report counts.
- For the same snapshot JSON (one engine's export, a fleet merge, with
  sampled series, admission and handoff rows) the port's renderer gives
  the JAX text character for character, and so do its fleet view and
  trace merge.
- Step-time attribution closes: the components sum to the window's wall
  within 0.35 and to the observer's own step wall within 1%.
- ``DSTPU_TELEMETRY=0`` gives the same tokens and ``metrics is None``.
"""

import json
import time

import numpy as np
import pytest

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.telemetry.attribution import (
    STEP_WALL_COMPONENTS, attribution_report, component_totals)
from torch_port_cases import jax_engine, port_cases, port_engine

#: the JAX test file's serve-engine configuration
BASE = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
            max_blocks_per_seq=16, dtype="float32", attention_impl="dense",
            decode_loop_steps=0, serve_pipeline_depth=2, prefix_cache=True)


def _engine(**kw):
    return port_engine(BASE, **kw)


def _jax_engine(**kw):
    return jax_engine(BASE, **kw)


(TestHistogram, TestRegistry, TestFlightRecorder, TestServeTelemetry,
 TestHistogramMerge, TestFleetRollup, TestTimeSeries,
 TestFlightDropsAndRequestSpans, TestRollupHardening,
 TestMonitorBridge) = port_cases(
    "tests/unit/test_telemetry.py",
    ("TestHistogram", "TestRegistry", "TestFlightRecorder",
     "TestServeTelemetry", "TestHistogramMerge", "TestFleetRollup",
     "TestTimeSeries", "TestFlightDropsAndRequestSpans",
     "TestRollupHardening", "TestMonitorBridge"),
    ("telemetry.registry", "telemetry.flight_recorder", "telemetry.top",
     "telemetry", "inference.v2", "resilience.fault_injection"),
    overrides={"_engine": _engine})
# the CSV monitor writer is the JAX package's monitor/ (A9), not the
# bridge: its case stays with the JAX tests
del TestMonitorBridge.test_csv_monitor_keeps_handles


# ------------------------------------------------------------------ #
# the registries of both packages on one event sequence
# ------------------------------------------------------------------ #


def _feed(pkg):
    """One registry per package, fed the same seeded events."""
    rng = np.random.default_rng(3)
    regs = []
    for name in ("a", "b"):
        r = pkg.registry.MetricsRegistry(name)
        r.counter("serve_steps").inc(int(rng.integers(1, 9)))
        r.counter("serve_attrib_seconds_total",
                  component="plan").inc(float(rng.uniform()))
        r.gauge("kv_pool_blocks_free").set(int(rng.integers(0, 64)))
        r.gauge("achieved_tflops", phase="serve").set(float(rng.uniform()))
        for v in rng.lognormal(-4, 1.5, 500):
            r.histogram("serve_ttft_s").observe(float(v))
        for v in rng.uniform(0, 1e-3, 300):
            r.histogram("serve_tpot_s", alpha=0.01).observe(float(v))
        r.histogram("serve_queue_wait_s").observe(0.0)
        regs.append(r)
    return regs


def test_registry_snapshots_equal_across_packages():
    from deepspeed_tpu.telemetry import registry as jreg
    from deepspeed_tpu_torch.telemetry import registry as treg

    class J:
        registry = jreg

    class T:
        registry = treg

    jr, tr = _feed(J), _feed(T)
    for a, b in zip(jr, tr):
        assert a.snapshot() == b.snapshot()
        assert a.to_prometheus() == b.to_prometheus()
    assert jreg.MetricsRegistry.merge(jr, name="f").snapshot() == \
        treg.MetricsRegistry.merge(tr, name="f").snapshot()
    js = jtel.merge_snapshots([r.snapshot() for r in jr],
                              sources=["x", "y"])
    ts = ttel.merge_snapshots([r.snapshot() for r in tr],
                              sources=["x", "y"])
    assert js == ts
    assert jtel.REGISTERED_METRICS == ttel.REGISTERED_METRICS


# ------------------------------------------------------------------ #
# the JAX engine and the port engine on one workload
# ------------------------------------------------------------------ #

N_TOK = 8
_rng = np.random.default_rng(55)
_SHARED = _rng.integers(1, 512, 10).tolist()
PROMPTS = [_SHARED + _rng.integers(1, 512, 5).tolist() for _ in range(3)]


def _serve(eng, n=N_TOK):
    toks = {}
    for u, p in enumerate(PROMPTS):
        r = eng.put([u], [list(p)], _greedy=True)
        toks[u] = [int(r[u])]
    while True:
        live = [u for u in toks if len(toks[u]) < n]
        if not live:
            break
        k = min(2, n - min(len(toks[u]) for u in live))
        outs = eng.decode_pipelined(live, [toks[u][-1] for u in live], k)
        for u in live:
            toks[u].extend(outs[u][:n - len(toks[u])])
    eng.abort(1)
    for u in list(toks):
        eng.flush(u)
    return toks


def _phase_steps(flight):
    """The flight ring's engine-phase spans, grouped by step."""
    out = {}
    for name, _, _, step, _ in flight.spans:
        if name in ("plan", "dispatch", "commit"):
            out.setdefault(step, []).append(name)
    return out


@pytest.fixture(scope="module")
def served_pair():
    jeng, teng = _jax_engine(), _engine()
    jt, tt = _serve(jeng), _serve(teng)
    return jeng, teng, jt, tt


def test_counters_histograms_and_spans_equal_jax(served_pair):
    jeng, teng, jt, tt = served_pair
    assert tt == jt
    jeng._obs.sync_gauges()
    teng._obs.sync_gauges()
    js, ts = jeng.metrics.snapshot(), teng.metrics.snapshot()
    assert set(jeng.metrics.metric_names()) == \
        set(teng.metrics.metric_names())
    assert set(js["counters"]) == set(ts["counters"])
    # the attribution mirror carries seconds: equal keys, not values
    sec = {k for k in js["counters"] if k.startswith("serve_attrib")}
    assert {k: v for k, v in ts["counters"].items() if k not in sec} == \
        {k: v for k, v in js["counters"].items() if k not in sec}
    assert set(js["histograms"]) == set(ts["histograms"])
    for k in js["histograms"]:
        assert ts["histograms"][k]["count"] == \
            js["histograms"][k]["count"], k
    assert set(js["gauges"]) == set(ts["gauges"])
    for k in js["gauges"]:
        assert ts["gauges"][k] == js["gauges"][k], k
    assert _phase_steps(teng.flight) == _phase_steps(jeng.flight)
    total = sum(len(t) for t in tt.values())
    c = ts["counters"]
    assert c["serve_tokens_committed"] == total
    assert c["serve_requests_completed"] == len(PROMPTS) - 1
    assert c["serve_requests_aborted"] == 1
    assert ts["histograms"]["serve_ttft_s"]["count"] == len(PROMPTS)
    assert ts["histograms"]["serve_tpot_s"]["count"] == total - len(PROMPTS)


def test_slo_report_counts_equal_jax(served_pair):
    jeng, teng, _, _ = served_pair
    jr, tr = jeng.slo_report(), teng.slo_report()
    assert set(jr) == set(tr)
    assert tr["requests"] == jr["requests"]
    assert tr["spec"] == jr["spec"]
    assert tr["tokens_committed"] == jr["tokens_committed"]
    assert tr["goodput_frac"] == jr["goodput_frac"]
    for k in ("ttft_s", "tpot_s", "queue_wait_s"):
        assert tr[k]["count"] == jr[k]["count"]


def test_request_spans_equal_jax(served_pair):
    """Each request's lifecycle marks come in the JAX engine's order."""
    jeng, teng, jt, _ = served_pair

    def marks(eng, uid):
        return [s[0] for s in eng.flight.spans
                if s[4] and s[4].get("uid") == uid]

    for u in jt:
        assert marks(teng, u) == marks(jeng, u), u


# ------------------------------------------------------------------ #
# step-time attribution
# ------------------------------------------------------------------ #


def test_attribution_closes_on_the_wall():
    eng = _engine(prefix_cache=False, block_size=8)
    uids = [0, 1, 2]
    first = eng.put(uids, PROMPTS, _greedy=True)
    warm = eng.decode_pipelined(uids, [first[u] for u in uids], 2)
    snap0 = eng.metrics.snapshot()
    t0 = time.perf_counter()
    eng.decode_pipelined(uids, [warm[u][-1] for u in uids], 16)
    wall = time.perf_counter() - t0
    snap1 = eng.metrics.snapshot()
    comps = component_totals(snap1, snap0)
    comp_sum = sum(comps[c] for c in STEP_WALL_COMPONENTS)
    assert abs(wall - comp_sum) / wall < 0.35, (wall, comps)
    for c in STEP_WALL_COMPONENTS:
        assert comps[c] > 0.0, (c, comps)
    rep = attribution_report(snap1, snap0)
    assert rep["dominant"] in STEP_WALL_COMPONENTS
    assert rep["closure_err_frac"] < 0.01
    # the fused loop's window closes the same way
    snap2 = eng.metrics.snapshot()
    eng.decode_batch(uids, [0, 0, 0], 4)
    rep = attribution_report(eng.metrics.snapshot(), snap2)
    assert rep["closure_err_frac"] < 0.01
    assert rep["components_s"]["device_execute"] > 0.0


def test_attribution_train_half_and_comm_share_name_their_items():
    from deepspeed_tpu_torch.telemetry import attribution
    with pytest.raises(NotImplementedError, match="A7.6"):
        attribution.train_attribution_report({})
    with pytest.raises(NotImplementedError, match="A9"):
        attribution.comm_share(None)
    # the A6b names are the port's own now
    from deepspeed_tpu_torch.telemetry import (MonitorBridge,
                                               attach_monitor, loadgen,
                                               monitor_bridge,
                                               run_open_loop,
                                               sweep_capacity)
    assert run_open_loop is loadgen.run_open_loop
    assert sweep_capacity is loadgen.sweep_capacity
    assert attach_monitor is monitor_bridge.attach_monitor
    assert MonitorBridge is monitor_bridge.MonitorBridge
    with pytest.raises(NotImplementedError, match="A7.6"):
        from deepspeed_tpu_torch.telemetry import goodput_report  # noqa


def test_telemetry_off_same_tokens_no_metrics(served_pair, monkeypatch):
    _, _, _, tt = served_pair
    monkeypatch.setenv("DSTPU_TELEMETRY", "0")
    eng = _engine()
    assert eng.metrics is None and eng.flight is None
    assert eng.slo_report() == {}
    assert _serve(eng) == tt


def test_profiler_ranges_name_the_phases(tmp_path, monkeypatch):
    """Under ``maybe_trace`` the exported Chrome trace holds the plan,
    dispatch and commit ranges."""
    import json
    eng = _engine()
    monkeypatch.setenv("DSTPU_TRACE_DIR", str(tmp_path))
    with ttel.maybe_trace("serve") as on:
        assert on
        r = eng.put([0], [PROMPTS[0]], _greedy=True)
        eng.decode_pipelined([0], [r[0]], 3)
    ev = json.loads(open(ttel.trace_path("serve")).read())["traceEvents"]
    names = {e.get("name") for e in ev}
    assert {"plan", "dispatch", "commit"} <= names
    monkeypatch.delenv("DSTPU_TRACE_DIR")
    with ttel.maybe_trace("x") as on:
        assert not on


# ------------------------------------------------------------------ #
# the snapshot renderer: the JAX text for the same snapshot
# ------------------------------------------------------------------ #

def _rich_registry(name, seed):
    """A registry carrying every row the renderer draws: outcomes,
    speculation, handoffs, attribution components and their sampled
    counter series, prefix and host tier, the pool, admission, dropped
    flight spans, and sampled rate series."""
    from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry
    rng = np.random.default_rng(seed)
    r = MetricsRegistry(name)
    for c in ("serve_requests_admitted", "serve_requests_completed",
              "serve_requests_shed", "serve_requests_deadline_expired",
              "serve_requests_rejected_admission", "serve_requests_aborted",
              "serve_requests_drained", "serve_steps_device_fed",
              "spec_proposed", "spec_rounds", "serve_handoff_seqs",
              "serve_handoff_seqs_in", "serve_handoff_fallback_replays",
              "serve_handoff_blocks", "prefix_matched_tokens",
              "prefix_prefill_tokens", "prefix_cow_copies",
              "prefix_evicted_blocks", "prefix_demoted_blocks",
              "prefix_promoted_blocks", "prefix_host_hit_blocks",
              "prefix_host_evicted_blocks", "admission_rejected",
              "flight_spans_dropped"):
        r.counter(c).inc(int(rng.integers(1, 50)))
    r.counter("serve_handoff_bytes").inc(float(rng.uniform(1e6, 1e9)))
    r.counter("brownout_transitions", level="2").inc(3)
    for g, v in (("prefix_cached_blocks", 17), ("prefix_evictable_blocks", 5),
                 ("prefix_host_blocks", 9), ("kv_pool_blocks_total", 64),
                 ("kv_pool_blocks_free", 40),
                 ("kv_pool_bytes_per_chip", 133120),
                 ("admission_window", 6), ("admission_level", 2)):
        r.gauge(g).set(v)
    for h in ("serve_ttft_s", "serve_tpot_s", "serve_queue_wait_s",
              "serve_commit_block_s", "serve_handoff_exposed_s",
              "prefix_promote_wait_s", "serve_plan_s", "serve_dispatch_s",
              "serve_commit_apply_s", "serve_host_gap_s"):
        for v in rng.lognormal(-5, 1.0, 40):
            r.histogram(h).observe(float(v))
    steps, tok = r.counter("serve_steps"), r.counter("serve_tokens_committed")
    acc = r.counter("spec_accepted")
    comps = {c: r.counter("serve_attrib_seconds_total", component=c)
             for c in ("plan", "dispatch", "device_execute", "commit_apply",
                       "host_gap")}
    for i in range(12):
        steps.inc(int(rng.integers(1, 9)))
        tok.inc(int(rng.integers(10, 90)))
        acc.inc(int(rng.integers(0, 4)))
        r.counter("spec_proposed").inc(4)
        for c in comps.values():
            c.inc(float(rng.uniform(0, 0.02)))
        r.counter("serve_requests_completed").inc(int(rng.integers(0, 3)))
        r.sample(now=1000.0 + i)
    return r


def _both(fn, *a, **k):
    from deepspeed_tpu.telemetry import top as jtop
    from deepspeed_tpu_torch.telemetry import top as ttop
    return getattr(jtop, fn)(*a, **k), getattr(ttop, fn)(*a, **k)


def test_top_render_equals_jax(served_pair):
    _, teng, _, _ = served_pair
    # exported snapshots carry their time and uptime (the header reads
    # them: a snapshot without would render the clock at the call)
    snaps = [json.loads(r.to_json()) for r in
             (teng.metrics, _rich_registry("r0", 1), _rich_registry("r1", 2))]
    for snap in snaps:
        j, t = _both("render", snap)
        assert t == j and "goodput" in t and "ttft" in t
    for row in ("speculation", "handoff", "step time", "dominant/window",
                "host tier", "admission", "flight ring",
                "rates (sampled series)"):
        assert row in t, row
    later = json.loads(_rich_registry("r0", 3).to_json())
    later["time"] = snaps[1]["time"] + 2.5
    j, t = _both("render", later, snaps[1])
    assert t == j


def test_top_fleet_view_and_cli_equal_jax(tmp_path, capsys):
    from deepspeed_tpu.telemetry import top as jtop
    from deepspeed_tpu_torch.telemetry import top as ttop
    paths = []
    for i in range(2):
        p = str(tmp_path / f"replica_{i}.json")
        _rich_registry(f"r{i}", 10 + i).export(p)
        paths.append(p)
    (jm, jsrc), (tm, tsrc) = _both("load_fleet", paths)
    assert tm == jm and tsrc == jsrc
    j, t = _both("render_sources", tsrc)
    assert t == j
    outs = []
    for mod in (jtop, ttop):
        assert mod.main([str(tmp_path / "replica_*.json")]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and "per-source breakdown" in outs[1]
    assert ttop.main([str(tmp_path / "missing.json")]) == 2
    with pytest.raises(NotImplementedError, match="A7.6"):
        ttop.main(["--train", paths[0]])


def test_top_trace_merge_equals_jax(tmp_path, capsys):
    from deepspeed_tpu.telemetry import top as jtop
    from deepspeed_tpu_torch.telemetry import top as ttop
    eng = _engine()
    r = eng.put([0, 1], [PROMPTS[0], PROMPTS[1]], _greedy=True)
    eng.decode_pipelined([0, 1], [r[0], r[1]], 3)
    dumps = []
    for i in range(2):
        d = tmp_path / f"d{i}"
        d.mkdir()
        p = str(d / "flight_0.json")
        eng.flight.dump(p, reason="test")
        dumps.append(p)
    outs = []
    for k, mod in enumerate((jtop, ttop)):
        out = str(tmp_path / f"merged_{k}.json")
        assert mod.merge_trace_files(dumps, out) == 0
        outs.append((json.loads(open(out).read()),
                     capsys.readouterr().out.replace(out, "OUT")))
    assert outs[1] == outs[0]
