"""Fault drill — crash a short train or serve loop at every injection
site, then prove it recovers.

Port of ``deepspeed_tpu/resilience/faultdrill.py`` (the JAX package's
``bin/dstpu_faultdrill``): host code that the port keeps its own copy of
(it imports nothing of the JAX package). Run it as ``python -m
deepspeed_tpu_torch.resilience.faultdrill --mode serve`` (or ``--mode
train --sites ...``). Each worker is a subprocess (``python -c "from
deepspeed_tpu_torch.resilience.faultdrill import ..."``) that builds port
GPT-2 engines (2 layers, hidden 32, fp32, seeded weights) on the device
``--device`` names (``cuda`` unless asked otherwise; ``cpu`` runs the
plain path).

``--mode train`` (the default), for each training site: a worker trains
the tiny GPT-2 ``DRILL_STEPS`` steps, checkpointing every step, and the
armed site crashes it (``os._exit``; the save sites after two clean
saves, ``step`` at ``DRILL_FAULT_STEP``); a second worker resumes from
the newest valid tag and must finish with ``latest`` pointing at a tag
that validates. Not ported: the ``collective`` site, which fires in the
comm facade (ROADMAP A8), and ``train_goodput``, the goodput-ledger drill
(A7.6); selecting either raises ``NotImplementedError`` before any
worker runs, so the default site list raises and ``--mode train`` takes
``--sites pre_save,mid_save,post_save_pre_latest,step``.

``--mode serve``, for each site in
:data:`~.fault_injection.SERVE_FAULT_SITES` plus the cooperative
``sigterm`` drain:

  1. run a serve worker (v2 ragged engine, prefix cache on, pipelined
     depth 2, write-ahead replay journal armed) over a shared-prefix
     workload once with NO fault to record the uninterrupted greedy
     oracle;
  2. crash it — a hard ``os._exit`` at the armed serve site (the journal
     alone carries the committed state), or for ``sigterm`` a real
     SIGTERM the worker sends itself mid-decode (the engine drains and
     atomically publishes a replay manifest, exiting
     ``MEMBERSHIP_CHANGE_EXIT`` like a preempted replica);
  3. re-run in recovery: ``load_replay_state`` (manifest preferred,
     journal fallback), ``engine.replay`` on a fresh engine, decode
     every sequence to the full budget, and assert the streams are
     TOKEN-IDENTICAL to the oracle with the block pool fully recovered.

``--mode fleet`` kills one replica of a pool under offered load;
``--mode disagg`` aborts a KV handoff mid-gather, then kills the prefill
specialist; ``--mode overload`` drills the admission controller instead
of a crash site: calibrate this host's capacity rate-relatively, find
the knee (highest offered rate holding the goodput SLO), then throw a
2.5x-capacity spike at the engine twice — controller off (must
collapse below 0.85x knee goodput) and controller on with rational
retrying clients (must hold >=0.95x, queue-wait p99 inside SLO, retry
balance closed, ladder engaged, steady state silent).

Exit 0 only when every site both crashed and recovered.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import List, Optional

from .fault_injection import (DISAGG_FAULT_SITE, FAULT_SITES,
                              SERVE_FAULT_SITES, TRAIN_FAULT_SITES)

#: serve drill shape: requests sharing a prefix, tokens served per uid
SERVE_DRILL_REQS = 3
SERVE_DRILL_TOKENS = 8
#: the cooperative-drain pseudo-site (a real SIGTERM, not an injector)
SIGTERM_SITE = "sigterm"

#: fleet drill shape (``--mode fleet``): replicas, shared-prefix groups,
#: requests offered before/after the kill, tokens served per uid
FLEET_REPLICAS = 3
FLEET_GROUPS = 2
FLEET_REQS = 6
FLEET_LATE_REQS = 2
FLEET_TOKENS = 8
FLEET_SITE = "fleet_sigterm"

#: the overload drill's pseudo-site (``--mode overload``): a
#: 2.5x-capacity traffic spike, admission controller on vs off
OVERLOAD_SITE = "serve_overload"

#: disaggregated-serving drill (``--mode disagg``): a prefill+decode
#: specialist pair; one clean handoff wave, one wave whose handoff is
#: killed mid-gather followed by a SIGTERM on the prefill specialist,
#: one post-kill wave — token parity vs a colocated oracle throughout
DISAGG_SITE = DISAGG_FAULT_SITE
DISAGG_WAVE = 3
DISAGG_TOKENS = 6


#: the goodput drill's pseudo-site (not ported: A7.6)
GOODPUT_SITE = "train_goodput"

#: steps the training drill's worker takes; the step site fires at
#: DRILL_FAULT_STEP
DRILL_STEPS = 5
DRILL_FAULT_STEP = 3

#: where the drill's workers build their engines (``main --device``;
#: the workers read it as DRILL_DEVICE)
_DEVICE = {"name": "cuda"}

#: the sites of the JAX drill that the port does not drill yet, with
#: the queue item that brings each
NOT_PORTED = {
    "collective": "the collective site fires in the comm facade, which is "
                  "multi-device training (ROADMAP A8)",
    GOODPUT_SITE: "the goodput-ledger drill needs the training "
                  "observatory's goodput ledger (ROADMAP A7.6)",
}


def _refuse(site: str) -> None:
    if site in NOT_PORTED:
        raise NotImplementedError(
            f"fault drill site '{site}' is not ported: {NOT_PORTED[site]}")


def _drill_device():
    """The worker's device: DRILL_DEVICE (``cuda`` unless the drill was
    asked for ``cpu``); without a card ``cuda`` raises."""
    from ..utils.device import resolve_device
    return resolve_device(os.environ.get("DRILL_DEVICE", "cuda"))


def _drill_gpt2(max_seq_len: int, dev):
    """The drill's tiny GPT-2 (vocab 96, 2 layers, 2 heads, hidden 32,
    fp32) and its seeded weights on ``dev``: every worker of a drill
    draws the same ones."""
    import torch

    from ..checkpoint import init_gpt2_params
    from ..models.gpt2 import GPT2Config
    mcfg = GPT2Config(vocab_size=96, max_seq_len=max_seq_len,
                      num_layers=2, num_heads=2, hidden_size=32,
                      dtype=torch.float32)
    return mcfg, init_gpt2_params(mcfg, seed=0, device=dev)


def _worker() -> int:
    """The training drill's worker (subprocess; configured by env):
    trains the drill's GPT-2 DRILL_STEPS steps on seeded batches,
    checkpointing every step to ``DRILL_SAVE_DIR``, after resuming from
    it when a checkpoint is there; writes its ``global_steps`` to
    ``DRILL_PROGRESS_FILE`` after each step."""
    import numpy as np
    import torch

    from .. import initialize
    from ..models.gpt2 import make_model

    save_dir = os.environ["DRILL_SAVE_DIR"]
    progress_file = os.environ["DRILL_PROGRESS_FILE"]
    dev = _drill_device()
    mcfg, params = _drill_gpt2(32, dev)
    engine, _, _, _ = initialize(
        loss_fn=make_model(mcfg)[2], params=params, device=dev, config={
            "train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
            "steps_per_print": 1000,
        })
    engine.load_checkpoint(save_dir)
    while engine.global_steps < DRILL_STEPS:
        rng = np.random.RandomState(engine.global_steps)
        batch = {"tokens": torch.from_numpy(rng.randint(
            0, mcfg.vocab_size, size=(engine.config.train_batch_size, 18)))}
        engine.train_batch(batch)
        engine.save_checkpoint(save_dir)
        with open(progress_file, "w") as f:
            json.dump({"global_steps": engine.global_steps}, f)
    return 0


def _serve_worker() -> int:
    """The serve drill's worker (subprocess; configured by env). Serves
    SERVE_DRILL_REQS shared-prefix requests for SERVE_DRILL_TOKENS greedy
    tokens each through a tiny pipelined v2 engine.

    ``DRILL_SERVE_PHASE``:
      - ``oracle``  — uninterrupted run; writes {uid: tokens} to
        ``DRILL_ORACLE_FILE``.
      - ``serve``   — journal armed (``DSTPU_SERVE_JOURNAL`` is set by
        the drill); an armed fault site ``os._exit``s mid-serve, or
        (``DRILL_SIGTERM_AFTER_ROUND``) the worker SIGTERMs itself and
        the PreemptionHandler->drain path publishes the manifest and
        exits ``MEMBERSHIP_CHANGE_EXIT``.
      - ``recover`` — load_replay_state(manifest, journal), replay on a
        fresh engine, decode every sequence to the full budget, write
        {uid: tokens} + pool verdict to ``DRILL_RESULT_FILE``.
    """
    import signal

    import numpy as np

    from ..inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                load_replay_state)
    from .preemption import PreemptionHandler
    from .watchdog import MEMBERSHIP_CHANGE_EXIT

    phase = os.environ["DRILL_SERVE_PHASE"]
    n_tok = SERVE_DRILL_TOKENS

    dev = _drill_device()
    mcfg, params = _drill_gpt2(128, dev)
    # the JAX engine reads DSTPU_SERVE_JOURNAL itself; the port's engine
    # takes the journal through its config
    cfg = RaggedInferenceConfig(
        max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
        max_blocks_per_seq=16, dtype="float32", attention_impl="dense",
        decode_loop_steps=0, serve_pipeline_depth=2, prefix_cache=True,
        serve_journal=os.environ.get("DSTPU_SERVE_JOURNAL", ""))
    eng = InferenceEngineV2(mcfg, params, cfg, device=dev)

    # shared 10-token preamble, block_size 4: two full shared blocks per
    # later request plus a partial-tail CoW copy — every serve fault
    # site is on this workload's path
    rng = np.random.default_rng(55)
    shared = rng.integers(1, 96, 10).tolist()
    prompts = [shared + rng.integers(1, 96, 5).tolist()
               for _ in range(SERVE_DRILL_REQS)]
    uids = list(range(SERVE_DRILL_REQS))

    if phase == "recover":
        state = load_replay_state(os.environ.get("DRILL_MANIFEST"),
                                  os.environ.get("DRILL_JOURNAL"))
        if state is None:
            print("faultdrill serve: no manifest or journal to recover "
                  "from", file=sys.stderr)
            return 2
        out = eng.replay(state)
        toks = {int(s["uid"]): list(s["generated"])
                for s in state["sequences"]}
        for u in list(toks):
            if u in out and len(toks[u]) < n_tok:
                toks[u].append(int(out[u]))
        while True:
            short = [u for u in toks if len(toks[u]) < n_tok]
            if not short:
                break
            outs = eng.decode_pipelined(
                short, [toks[u][-1] for u in short],
                [n_tok - len(toks[u]) for u in short])
            for u in short:
                toks[u].extend(outs[u][:n_tok - len(toks[u])])
        for u in list(toks):
            eng.flush(u)
        with open(os.environ["DRILL_RESULT_FILE"], "w") as f:
            json.dump({"tokens": {str(u): t for u, t in toks.items()},
                       "replayed": len(toks),
                       "pool_recovered":
                           eng.free_blocks == cfg.num_blocks,
                       "prefix_stats": {
                           k: v for k, v in eng.prefix_stats.items()
                           if isinstance(v, (int, float))}}, f)
        return 0

    handler = PreemptionHandler() if phase == "serve" else None
    if handler is not None:
        eng.attach_preemption(handler)
    sigterm_round = int(os.environ.get("DRILL_SIGTERM_AFTER_ROUND", "-1"))

    toks = {}
    for u, p in zip(uids, prompts):
        r = eng.put([u], [list(p)], _greedy=True)
        if u in r:
            toks[u] = [int(r[u])]
    rounds = 0
    while True:
        live = [u for u in toks if len(toks[u]) < n_tok
                and u in eng.state.sequences]
        if not live:
            break
        if rounds == sigterm_round:
            # a REAL preemption signal, delivered with the next decode
            # call's pipeline live: the drive loop polls the handler's
            # flag, commits what's in flight and unwinds
            os.kill(os.getpid(), signal.SIGTERM)
        outs = eng.decode_pipelined(live, [toks[u][-1] for u in live], 2)
        for u in live:
            toks[u].extend(outs[u][:n_tok - len(toks[u])])
        rounds += 1
        if handler is not None and handler.preempted:
            manifest = eng.drain(os.environ.get("DRILL_MANIFEST"))
            print(f"faultdrill serve: drained "
                  f"{len(manifest['sequences'])} sequences after "
                  f"SIGTERM", file=sys.stderr)
            return MEMBERSHIP_CHANGE_EXIT

    if phase == "oracle":
        with open(os.environ["DRILL_ORACLE_FILE"], "w") as f:
            json.dump({str(u): t for u, t in toks.items()}, f)
    return 0


def _fleet_worker() -> int:
    """The fleet drill's worker (subprocess; configured by env): a
    replica POOL under offered load loses one member to a real SIGTERM
    mid-decode and must come out token-identical.

    One process plays the whole drill — the in-process pool is the
    single-host fleet shape, and a process-wide SIGTERM mapped to one
    replica's PreemptionHandler is exactly what a per-host preemption
    looks like from inside that host:

      1. ORACLE: a kill-free pool of FLEET_REPLICAS tiny engines serves
         FLEET_REQS shared-prefix requests (FLEET_GROUPS preambles) plus
         FLEET_LATE_REQS unique late arrivals; records {uid: tokens}.
      2. DRILL: a fresh identical pool serves the same workload; at the
         kill round the BUSIEST replica gets a PreemptionHandler and the
         worker SIGTERMs itself. The pool absorbs the drain — survivors
         replay the manifest with their warm prefix caches — then a
         LATE JOINER registers and the late requests are admitted.
      3. GATES (written to DRILL_RESULT_FILE): token parity for every
         request vs the oracle; ``pool.fully_recovered`` on the victim's
         manifest; the merged survivor rollup's TTFT quantiles EXACTLY
         equal to a single-stream histogram of the driver-observed TTFT
         values (the fleet-rollup exactness oracle, end-to-end through
         real engines); merged admitted == sum of per-replica admitted;
         the joiner took traffic; ledger carries the fleet events.
    """
    import signal

    import numpy as np

    from ..inference.v2 import InferenceEngineV2, RaggedInferenceConfig
    from ..serving import ReplicaPool, single_stream_oracle
    from ..telemetry.registry import Histogram, merge_snapshots
    from .ledger import RestartLedger
    from .preemption import PreemptionHandler

    n_tok = FLEET_TOKENS
    dev = _drill_device()
    mcfg, params = _drill_gpt2(256, dev)

    def engine():
        cfg = RaggedInferenceConfig(
            max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
            max_blocks_per_seq=32, dtype="float32",
            attention_impl="dense", decode_loop_steps=0,
            serve_pipeline_depth=2, prefix_cache=True)
        return InferenceEngineV2(mcfg, params, cfg, device=dev)

    # workload: FLEET_GROUPS shared 12-token preambles (3 full blocks
    # each — the replay lands on a survivor whose cache already holds
    # them) + unique tails; the late arrivals are unique-prompt (the
    # traffic a cold joiner wins on the queue term)
    rng = np.random.default_rng(77)
    prefixes = [rng.integers(1, 96, 12).tolist()
                for _ in range(FLEET_GROUPS)]
    prompts = {u: prefixes[u % FLEET_GROUPS]
               + rng.integers(1, 96, 5).tolist()
               for u in range(FLEET_REQS)}
    late = {100 + i: rng.integers(1, 96, 9).tolist()
            for i in range(FLEET_LATE_REQS)}

    def drive(pool, kill_round=None, joiner=False):
        toks = {}
        ttft = {}

        def admit(batch):
            out = pool.put(list(batch), [batch[u] for u in batch],
                           _greedy=True)
            for u in batch:
                if u in out:
                    toks[u] = [int(out[u])]

        def finish(u):
            seq = pool.state.get(u)
            if seq is not None and seq.first_token_at is not None \
                    and seq.admitted_at is not None:
                rep = pool.owner_of(u)
                ttft[u] = (seq.first_token_at - seq.admitted_at,
                           rep.replica_id if rep is not None else None)
            pool.flush(u)

        admit(prompts)
        rounds = 0
        victim = None
        while True:
            live = [u for u in toks if len(toks[u]) < n_tok
                    and u in pool.state.sequences]
            if not live and len(toks) == len(prompts) + len(late):
                break
            if rounds == kill_round:
                # the busiest replica takes the preemption: a real
                # process-level SIGTERM routed to ITS handler alone —
                # the single-process stand-in for a per-host signal
                busy = {}
                for u in live:
                    rep = pool.owner_of(u)
                    if rep is not None:
                        busy[rep.replica_id] = \
                            busy.get(rep.replica_id, 0) + 1
                vid = max(busy, key=busy.get)
                victim = pool.replica(vid)
                victim.engine.attach_preemption(PreemptionHandler())
                os.kill(os.getpid(), signal.SIGTERM)
            if live:
                outs = pool.decode_pipelined(
                    live, [toks[u][-1] for u in live], 2)
                for u in live:
                    toks[u].extend(outs[u][:n_tok - len(toks[u])])
            if rounds == kill_round and joiner:
                pool.add_replica(engine(), replica_id="joiner")
            if rounds == (kill_round if kill_round is not None else 1) \
                    and len(toks) == len(prompts):
                admit(late)          # offered load continues post-kill
            for u in list(toks):
                if len(toks[u]) >= n_tok and u in pool.state.sequences:
                    finish(u)
            rounds += 1
        for u in list(toks):
            if pool.state.get(u) is not None:
                finish(u)
        return toks, ttft, victim

    oracle_pool = ReplicaPool([engine() for _ in range(FLEET_REPLICAS)],
                              policy="prefix_aware", seed=0)
    oracle, _, _ = drive(oracle_pool)

    ledger = RestartLedger(os.environ.get("DRILL_FLEET_LEDGER"))
    pool = ReplicaPool([engine() for _ in range(FLEET_REPLICAS)],
                       policy="prefix_aware", seed=0, ledger=ledger)
    toks, ttft, victim = drive(pool, kill_round=1, joiner=True)

    result = {
        "replicas": FLEET_REPLICAS,
        "fault_fired": victim is not None and victim.state == "dead",
        "victim": victim.replica_id if victim is not None else None,
        "manifested": len(victim.manifest["sequences"])
        if victim is not None and victim.manifest else 0,
        "pool_recovered": bool(
            victim.manifest["pool"]["fully_recovered"])
        if victim is not None and victim.manifest else False,
        "token_parity": toks == oracle and len(toks) == len(oracle),
        "joiner_requests": sum(
            1 for _u, (_t, rid) in ttft.items() if rid == "joiner"),
    }
    # fleet-rollup exactness: the merged survivors' TTFT histogram must
    # equal a single-stream sketch of the driver-observed TTFT values —
    # same observations through two paths (per-engine registries ->
    # export-shaped states -> exact merge vs one raw-value stream)
    survivors = [r for r in pool.replicas() if r.state == "serving"]
    snaps = [r.engine.metrics.snapshot() for r in survivors]
    merged = merge_snapshots(snaps, sources=[r.replica_id
                                             for r in survivors])
    surv_ids = {r.replica_id for r in survivors}
    values = [t for t, rid in ttft.values() if rid in surv_ids]
    single = single_stream_oracle(values)
    mstate = merged["histograms"].get("serve_ttft_s", {})
    mhist = Histogram.from_state(mstate)
    result["rollup_count_exact"] = mhist.count == single.count
    result["rollup_quantiles_exact"] = all(
        mhist.quantile(q) == single.quantile(q)
        for q in (0.5, 0.9, 0.99))
    result["rollup_admitted_exact"] = (
        merged["counters"].get("serve_requests_admitted", 0)
        == sum(s["counters"].get("serve_requests_admitted", 0)
               for s in snaps))
    events = {e["event"] for e in ledger.events}
    result["ledger_events"] = sorted(events)
    result["ledger_ok"] = {"fleet_drain", "fleet_replay",
                           "fleet_join"} <= events
    with open(os.environ["DRILL_RESULT_FILE"], "w") as f:
        json.dump(result, f)
    ok = (result["fault_fired"] and result["token_parity"]
          and result["pool_recovered"] and result["manifested"] > 0
          and result["rollup_count_exact"]
          and result["rollup_quantiles_exact"]
          and result["rollup_admitted_exact"]
          and result["joiner_requests"] >= 1 and result["ledger_ok"])
    return 0 if ok else 1


def drill_fleet(workdir: str, verbose: bool = True) -> dict:
    """Kill-one-of-N drill for the replica pool: SIGTERM the busiest
    replica mid-decode under offered load, gate on token-identical
    replay on the survivors, exact pool recovery on the victim, an
    exactly-merged fleet rollup, and a late joiner taking traffic."""
    site_dir = os.path.join(workdir, "fleet")
    os.makedirs(site_dir, exist_ok=True)
    result_file = os.path.join(site_dir, "result.json")
    env = _serve_env(site_dir, "fleet",
                     DRILL_RESULT_FILE=result_file,
                     DRILL_FLEET_LEDGER=os.path.join(site_dir,
                                                     "ledger.json"))
    env.pop("DSTPU_RESTART_LEDGER", None)
    rc = _run_worker(env, fn="_fleet_worker")
    result = {"site": FLEET_SITE, "mode": "fleet", "worker_rc": rc}
    if os.path.exists(result_file):
        with open(result_file) as f:
            result.update(json.load(f))
    result["recovered"] = (
        rc == 0 and result.get("fault_fired") is True
        and result.get("token_parity") is True
        and result.get("pool_recovered") is True)
    if verbose:
        print(f"[faultdrill:fleet] rc={rc} "
              f"victim={result.get('victim')} "
              f"manifested={result.get('manifested')} "
              f"parity={result.get('token_parity')} "
              f"rollup_exact={result.get('rollup_quantiles_exact')} "
              f"joiner={result.get('joiner_requests')} "
              f"recovered={result['recovered']}", file=sys.stderr)
    return result


def _disagg_worker() -> int:
    """The disagg drill's worker (subprocess; configured by env): a
    prefill specialist + decode specialist pair must survive BOTH ways
    a handoff can die, token-identical to a colocated oracle.

      wave A  clean: requests land on the prefill specialist, hand off,
              and decode to completion on the decode specialist
      wave B  an injected ``during_handoff_gather`` fault aborts the
              handoff mid-gather — nothing may be lost (the sequences
              stay live on the source); then the prefill specialist
              takes a real SIGTERM mid-decode and the pool absorbs the
              drain (manifest replay onto the decode specialist)
      wave C  fresh post-kill traffic: the phase filter degrades
              gracefully and the survivor takes it

    Gates (written to DRILL_RESULT_FILE): token parity vs a one-replica
    oracle for every wave; the fault fired exactly once; wave A was
    adopted via handoff (``serve_handoff_seqs_in`` on the destination);
    wave B stayed on the source after the abort; the victim's manifest
    reports full pool recovery; wave C landed on the survivor."""
    import signal

    import numpy as np

    from ..inference.v2 import InferenceEngineV2, RaggedInferenceConfig
    from ..serving import ReplicaPool
    from .fault_injection import FaultInjector, set_fault_injector
    from .preemption import PreemptionHandler

    n_tok = DISAGG_TOKENS
    dev = _drill_device()
    mcfg, params = _drill_gpt2(256, dev)

    def engine():
        cfg = RaggedInferenceConfig(
            max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
            max_blocks_per_seq=32, dtype="float32",
            attention_impl="dense", decode_loop_steps=0,
            serve_pipeline_depth=2, prefix_cache=True)
        return InferenceEngineV2(mcfg, params, cfg, device=dev)

    rng = np.random.default_rng(11)
    waves = [{w * 10 + i: rng.integers(1, 96, 10 + i).tolist()
              for i in range(DISAGG_WAVE)} for w in range(3)]

    def serve_wave(pool, batch, sigterm_victim=None):
        """Admit one wave, decode every uid to n_tok, flush; returns
        ({uid: tokens}, {uid: final owner id}). ``sigterm_victim``: a
        replica id that takes a PreemptionHandler + a real SIGTERM
        after the first decode round."""
        toks, owners = {}, {}
        out = pool.put(list(batch), [batch[u] for u in batch],
                       _greedy=True)
        for u in batch:
            if u in out:
                toks[u] = [int(out[u])]
        rounds = 0
        while True:
            live = [u for u in toks if len(toks[u]) < n_tok
                    and u in pool.state.sequences]
            if not live:
                break
            if rounds == 1 and sigterm_victim is not None:
                victim = pool.replica(sigterm_victim)
                victim.engine.attach_preemption(PreemptionHandler())
                os.kill(os.getpid(), signal.SIGTERM)
                sigterm_victim = None
            outs = pool.decode_pipelined(
                live, [toks[u][-1] for u in live], 2)
            for u in live:
                toks[u].extend(outs[u][:n_tok - len(toks[u])])
            rounds += 1
        for u in list(toks):
            rep = pool.owner_of(u)
            owners[u] = rep.replica_id if rep is not None else None
            if pool.state.get(u) is not None:
                pool.flush(u)
        return toks, owners

    # oracle: one colocated mixed replica, same waves in the same order
    oracle_pool = ReplicaPool([engine()], policy="prefix_aware", seed=0)
    oracle = {}
    for batch in waves:
        t, _ = serve_wave(oracle_pool, batch)
        oracle.update(t)

    pool = ReplicaPool([engine(), engine()], policy="prefix_aware",
                       seed=0, replica_ids=["pre", "dec"],
                       roles=["prefill", "decode"])
    toks = {}

    # wave A: clean disagg path — prefill on "pre", adopt on "dec"
    t, owners_a = serve_wave(pool, waves[0])
    toks.update(t)
    dec_m = pool.replica("dec").engine.metrics
    adopted = int(dec_m.counter("serve_handoff_seqs_in").value)

    # wave B: abort the handoff mid-gather, then kill the source.
    # mode=raise — the pool's migration loop must catch it and leave
    # every sequence live on the prefill source (nothing released).
    inj = FaultInjector(site=DISAGG_SITE, mode="raise", times=1)
    set_fault_injector(inj)
    out_b = pool.put(list(waves[1]), [waves[1][u] for u in waves[1]],
                     _greedy=True)
    fault_fired = inj._fired == 1
    set_fault_injector(None)
    owners_b0 = {u: pool.owner_of(u).replica_id for u in waves[1]
                 if pool.owner_of(u) is not None}
    abort_safe = bool(owners_b0) and all(
        rid == "pre" for rid in owners_b0.values())
    for u, tk in out_b.items():
        toks[u] = [int(tk)]
    rounds = 0
    while True:
        live = [u for u in toks if len(toks[u]) < n_tok
                and u in pool.state.sequences]
        if not live:
            break
        if rounds == 1:
            victim = pool.replica("pre")
            victim.engine.attach_preemption(PreemptionHandler())
            os.kill(os.getpid(), signal.SIGTERM)
        outs = pool.decode_pipelined(live, [toks[u][-1] for u in live], 2)
        for u in live:
            toks[u].extend(outs[u][:n_tok - len(toks[u])])
        rounds += 1
    victim = pool.replica("pre")
    pool_recovered = bool(
        victim.manifest["pool"]["fully_recovered"]) \
        if victim.manifest else False
    for u in waves[1]:
        if pool.state.get(u) is not None:
            pool.flush(u)

    # wave C: fresh post-kill traffic — the phase filter has no serving
    # prefill candidate left, so placement degrades to the survivor
    t, owners_c = serve_wave(pool, waves[2])
    toks.update(t)

    result = {
        "fault_fired": fault_fired,
        "handoff_adopted": adopted,
        "handoff_wave_on_dest": all(
            rid == "dec" for rid in owners_a.values()),
        "abort_safe": abort_safe,
        "pool_recovered": pool_recovered,
        "post_kill_on_survivor": all(
            rid == "dec" for rid in owners_c.values()),
        "token_parity": toks == oracle and len(toks) == len(oracle),
    }
    with open(os.environ["DRILL_RESULT_FILE"], "w") as f:
        json.dump(result, f)
    ok = (result["fault_fired"] and result["token_parity"]
          and result["abort_safe"] and result["pool_recovered"]
          and result["handoff_adopted"] >= DISAGG_WAVE
          and result["handoff_wave_on_dest"]
          and result["post_kill_on_survivor"])
    return 0 if ok else 1


def drill_disagg(workdir: str, verbose: bool = True) -> dict:
    """Disaggregated-serving drill: abort a KV handoff mid-gather with
    an injected fault (nothing may be lost), then SIGTERM the prefill
    specialist mid-decode (drain replay onto the decode specialist),
    gating on token parity vs a colocated oracle throughout."""
    site_dir = os.path.join(workdir, "disagg")
    os.makedirs(site_dir, exist_ok=True)
    result_file = os.path.join(site_dir, "result.json")
    env = _serve_env(site_dir, "disagg", DRILL_RESULT_FILE=result_file)
    # the drill builds its own role assignment; ambient disagg knobs
    # must not leak into the worker
    env.pop("DSTPU_FLEET_ROLES", None)
    env.pop("DSTPU_DISAGG", None)
    rc = _run_worker(env, fn="_disagg_worker")
    result = {"site": DISAGG_SITE, "mode": "disagg", "worker_rc": rc}
    if os.path.exists(result_file):
        with open(result_file) as f:
            result.update(json.load(f))
    result["recovered"] = (
        rc == 0 and result.get("fault_fired") is True
        and result.get("token_parity") is True
        and result.get("abort_safe") is True
        and result.get("pool_recovered") is True)
    if verbose:
        print(f"[faultdrill:disagg] rc={rc} "
              f"adopted={result.get('handoff_adopted')} "
              f"abort_safe={result.get('abort_safe')} "
              f"parity={result.get('token_parity')} "
              f"survivor={result.get('post_kill_on_survivor')} "
              f"recovered={result['recovered']}", file=sys.stderr)
    return result


def drill_train_goodput(workdir: str, verbose: bool = True) -> dict:
    """The goodput-ledger drill: not ported (A7.6)."""
    _refuse(GOODPUT_SITE)


def _run_worker(env: dict, fn: str = "_worker") -> int:
    env = dict(env)
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-c",
           "import sys; from deepspeed_tpu_torch.resilience.faultdrill "
           f"import {fn}; sys.exit({fn}())"]
    return subprocess.run(cmd, env=env).returncode


def drill_site(site: str, workdir: str, verbose: bool = True) -> dict:
    """Crash-then-recover drill for one training site. Returns a result
    dict with ``recovered`` True/False plus diagnostics."""
    _refuse(site)
    site_dir = os.path.join(workdir, site)
    os.makedirs(site_dir, exist_ok=True)
    save_dir = os.path.join(site_dir, "ckpt")
    progress_file = os.path.join(site_dir, "progress.json")
    marker = os.path.join(site_dir, "fired.marker")

    env = dict(os.environ)
    env.update({
        "DRILL_DEVICE": _DEVICE["name"],
        "DRILL_SAVE_DIR": save_dir,
        "DRILL_PROGRESS_FILE": progress_file,
        "DSTPU_FAULT_SITE": site,
        "DSTPU_FAULT_MODE": "exit",
        "DSTPU_FAULT_STEP": str(DRILL_FAULT_STEP),
        "DSTPU_FAULT_ONCE_FILE": marker,
        # save sites: let a couple of clean saves land first so recovery
        # has a previous tag to fall back to
        "DSTPU_FAULT_SKIP": "2" if site in (
            "pre_save", "mid_save", "post_save_pre_latest") else "0",
    })

    result = {"site": site}
    rc_crash = _run_worker(env)
    result["crash_rc"] = rc_crash
    result["fault_fired"] = os.path.exists(marker)
    if rc_crash == 0 or not result["fault_fired"]:
        result["recovered"] = False
        result["error"] = ("worker did not crash — injection site never "
                           "reached")
        return result

    rc_rec = _run_worker(env)             # marker disarms the injector
    result["recover_rc"] = rc_rec
    progress = {}
    if os.path.exists(progress_file):
        with open(progress_file) as f:
            progress = json.load(f)
    result["final_steps"] = progress.get("global_steps")

    from ..checkpoint.engine_checkpoint import (
        LATEST_FILE, validate_checkpoint_dir)
    latest_ok = False
    latest_path = os.path.join(save_dir, LATEST_FILE)
    if os.path.exists(latest_path):
        with open(latest_path) as f:
            tag = f.read().strip()
        latest_ok, reason = validate_checkpoint_dir(
            os.path.join(save_dir, tag))
        result["latest_tag"] = tag
        if not latest_ok:
            result["latest_invalid"] = reason
    result["recovered"] = (rc_rec == 0
                           and progress.get("global_steps") == DRILL_STEPS
                           and latest_ok)
    if verbose:
        print(f"[faultdrill:{site}] crash_rc={rc_crash} "
              f"recover_rc={rc_rec} final_steps={result['final_steps']} "
              f"recovered={result['recovered']}", file=sys.stderr)
    return result


def _serve_env(workdir: str, phase: str, **extra) -> dict:
    env = dict(os.environ)
    for k in ("DSTPU_FAULT_SITE", "DSTPU_SERVE_JOURNAL",
              "DSTPU_SERVE_DRAIN_MANIFEST", "DSTPU_FLIGHT_DIR",
              "DSTPU_TELEMETRY"):
        env.pop(k, None)
    env.update({
        "DRILL_DEVICE": _DEVICE["name"],
        "DRILL_SERVE_PHASE": phase,
        "DRILL_ORACLE_FILE": os.path.join(workdir, "oracle.json"),
    })
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _serve_oracle(workdir: str) -> Optional[dict]:
    """The uninterrupted greedy streams, computed once per drill workdir
    and shared by every serve site (greedy decode is deterministic, so
    one oracle serves them all)."""
    path = os.path.join(workdir, "oracle.json")
    if not os.path.exists(path):
        rc = _run_worker(_serve_env(workdir, "oracle"), fn="_serve_worker")
        if rc != 0 or not os.path.exists(path):
            return None
    with open(path) as f:
        return json.load(f)


def drill_serve_site(site: str, workdir: str, verbose: bool = True) -> dict:
    """Crash-then-replay drill for one serve site (or ``sigterm``):
    kill a serving replica mid-stream, recover on a fresh engine from
    the manifest/journal, assert token parity with the uninterrupted
    run and full block-pool recovery."""
    site_dir = os.path.join(workdir, f"serve_{site}")
    os.makedirs(site_dir, exist_ok=True)
    journal = os.path.join(site_dir, "replay.jsonl")
    manifest = os.path.join(site_dir, "manifest.json")
    result_file = os.path.join(site_dir, "result.json")
    marker = os.path.join(site_dir, "fired.marker")

    result = {"site": site, "mode": "serve"}
    oracle = _serve_oracle(workdir)
    if oracle is None:
        result.update(recovered=False, error="oracle run failed")
        return result

    env = _serve_env(workdir, "serve",
                     DRILL_JOURNAL=journal, DRILL_MANIFEST=manifest,
                     DSTPU_SERVE_JOURNAL=journal,
                     # crash-path observability: the injector (or the
                     # sigterm drain) must leave a Chrome-trace flight
                     # dump next to the replay state — asserted below
                     DSTPU_FLIGHT_DIR=site_dir)
    if site == SIGTERM_SITE:
        # a REAL preemption signal mid-decode: PreemptionHandler ->
        # pipeline unwind -> drain() -> atomic manifest publish
        env["DRILL_SIGTERM_AFTER_ROUND"] = "1"
    else:
        # a hard os._exit at the armed site: no drain ran, the
        # write-ahead journal alone carries the committed chains. The
        # skips land the crash mid-stream with state worth replaying.
        env.update({
            "DSTPU_FAULT_SITE": site,
            "DSTPU_FAULT_MODE": "exit",
            "DSTPU_FAULT_ONCE_FILE": marker,
            "DSTPU_FAULT_SKIP": {"pre_dispatch": "4", "mid_commit": "3",
                                 "during_prefill_chunk": "2",
                                 "during_cow_copy": "1"}.get(site, "0"),
        })
    rc_crash = _run_worker(env, fn="_serve_worker")
    result["crash_rc"] = rc_crash
    # 99 = MEMBERSHIP_CHANGE_EXIT: the cooperative drain's exit code
    fired = os.path.exists(marker) if site != SIGTERM_SITE \
        else rc_crash == 99
    result["fault_fired"] = fired
    if rc_crash == 0 or not fired:
        result.update(recovered=False,
                      error="worker did not crash — injection site never "
                            "reached")
        return result
    if site == SIGTERM_SITE and not os.path.exists(manifest):
        result.update(recovered=False,
                      error="drain published no manifest")
        return result
    # the crash (injector fire) or drain must have auto-dumped the phase
    # flight recorder — the trace artifact a postmortem starts from
    # (docs/observability.md). Validated as loadable Chrome-trace JSON.
    dumps = [f for f in os.listdir(site_dir)
             if f.startswith("flight_") and f.endswith(".json")]
    flight_ok = False
    for f in dumps:
        try:
            with open(os.path.join(site_dir, f)) as fh:
                trace = json.load(fh)
            flight_ok |= isinstance(trace.get("traceEvents"), list)
        except ValueError:
            pass
    result["flight_dump"] = flight_ok

    rc_rec = _run_worker(
        _serve_env(workdir, "recover", DRILL_JOURNAL=journal,
                   DRILL_MANIFEST=manifest, DRILL_RESULT_FILE=result_file),
        fn="_serve_worker")
    result["recover_rc"] = rc_rec
    replayed = {}
    if os.path.exists(result_file):
        with open(result_file) as f:
            replayed = json.load(f)
    toks = replayed.get("tokens", {})
    result["replayed_sequences"] = replayed.get("replayed")
    result["pool_recovered"] = replayed.get("pool_recovered")
    # every sequence the dead replica owed tokens to must finish with a
    # stream identical to the uninterrupted run (a request admitted
    # AFTER the kill point never entered the journal — the client
    # retries it; everything admitted must replay exactly)
    parity = bool(toks) and all(toks[u] == oracle[u] for u in toks)
    result["token_parity"] = parity
    result["recovered"] = (rc_rec == 0 and parity
                           and replayed.get("pool_recovered") is True
                           and flight_ok)
    if verbose:
        print(f"[faultdrill:serve:{site}] crash_rc={rc_crash} "
              f"recover_rc={rc_rec} replayed={result['replayed_sequences']} "
              f"parity={parity} recovered={result['recovered']}",
              file=sys.stderr)
    return result


def _overload_worker() -> int:
    """The overload drill's worker (subprocess; configured by env): the
    same engine serves a 2.5x-capacity traffic spike twice — admission
    controller OFF, then ON — and the gates are the overload
    drill's acceptance criteria:

      1. CAPACITY: a saturating deadline-free burst; the completed rate
         IS the service capacity C.
      2. KNEE: ``sweep_capacity`` over 0.5/0.7/0.9 x C on the deadline
         workload locates the knee (highest offered rate whose goodput
         fraction still meets the SLO) and its goodput RATE.
      3. SPIKE x2: the SAME seeded :class:`SpikeArrivals` schedule —
         knee-rate steady state with a 2.5 x C window — offered once
         uncontrolled and once through an armed
         :class:`AdmissionController` with client retries.
      4. GATES (written to DRILL_RESULT_FILE): controller-on goodput
         rate >= 0.95 x the knee goodput rate; controller-off collapses
         below 0.85 x; completed-request queue-wait p99 stays within
         the deadline on the controlled run; the controller visibly
         engaged (ladder transitions or door rejections); both reports'
         outcome breakdowns balance exactly.
    """
    from ..serving.admission import AdmissionController
    from ..telemetry.loadgen import (PoissonArrivals, SpikeArrivals,
                                     WorkloadMix, _tiny_engine,
                                     build_requests, run_open_loop,
                                     sweep_capacity)

    eng, mcfg = _tiny_engine(max_seqs=8, num_blocks=96,
                             device=_drill_device())

    def mk_mix(deadline_s: float = 0.0) -> WorkloadMix:
        return WorkloadMix(
            prompt_lens=(16,), prompt_probs=(1.0,),
            gen_lens=(8,), gen_probs=(1.0,),
            deadline_frac=1.0 if deadline_s else 0.0,
            deadline_s=deadline_s, vocab_size=mcfg.vocab_size)

    # 0) warmup: pay the first-call costs (allocations, kernel builds)
    # OUTSIDE every timed phase — a cold capacity pass would measure
    # them, not the service rate
    run_open_loop(eng, build_requests(PoissonArrivals(500.0, seed=0),
                                      mk_mix(), 10, seed=0,
                                      uid_base=6_000_000))

    # 1) capacity: a saturating 1-second burst, no deadlines — the
    # completed rate is what the engine can actually serve. Two
    # passes: the first sizes the second (everything downstream is
    # rate-RELATIVE, so the drill means the same thing on any host)
    slots = eng.config.max_seqs
    est = run_open_loop(eng, build_requests(
        PoissonArrivals(500.0, seed=1), mk_mix(), 32, seed=1,
        uid_base=7_000_000), max_live=slots
    ).report["rates_rps"]["completed"] or 1.0
    n_cap = max(32, int(2.0 * est))
    # max_live pins the engine at exactly its slot count: saturated
    # WITHOUT oversubscription churn, i.e. the peak service rate
    cap_rps = run_open_loop(eng, build_requests(
        PoissonArrivals(4.0 * est, seed=11), mk_mix(), n_cap, seed=11,
        uid_base=7_500_000), max_live=slots
    ).report["rates_rps"]["completed"] or est
    # deadline ~8 requests' worth of service time (floored above OS
    # scheduling noise): generous at the knee, unmeetable once an
    # uncontrolled queue builds
    deadline_s = max(0.25, 8.0 / cap_rps)
    mix = mk_mix(deadline_s)

    # 2) locate the knee on the deadline workload — ~2 s of steady
    # state at the highest probed rate
    n_sweep = max(48, int(1.8 * cap_rps))
    sweep = sweep_capacity(
        eng, [0.5 * cap_rps, 0.7 * cap_rps, 0.9 * cap_rps], n_sweep,
        mix, seed=2, goodput_slo_frac=0.9)
    knee_rps = sweep["knee_rps"]
    knee_goodput_rps = sweep["knee_goodput_rps"]
    if knee_rps is None:
        # no sweep row met the SLO (a very noisy host) — steer by the
        # best goodput rate observed so the spike still compares on/off
        best = max(sweep["curve"], key=lambda r: r["goodput_rps"] or 0.0)
        knee_rps = best["offered_rps"]
        knee_goodput_rps = best["goodput_rps"] or 1.0

    # 3) the spike: steady state AT the knee, then a 2.5 x capacity
    # window long enough that the uncontrolled backlog (~1.5 x C x dur
    # requests, several deadlines deep) cannot hide inside the deadline
    spike_rps = 2.5 * cap_rps
    dur_s = max(1.0, 3.0 * deadline_s)
    start_s = 1.0
    mult = spike_rps / knee_rps
    n = int(knee_rps * (start_s + 1.0) + spike_rps * dur_s)
    proc = SpikeArrivals(knee_rps, mult, start_s, dur_s, seed=3)

    off = run_open_loop(
        eng, build_requests(proc, mix, n, seed=3, uid_base=8_000_000)
    ).report

    ctrl = AdmissionController(eng, window_s=0.5,
                               qw_slo_s=deadline_s / 4, tick_s=0.05,
                               hysteresis_s=0.5,
                               retry_cap_s=deadline_s)
    # pre-warm the browned-out step shapes (halved prefill chunk, spec
    # off): without this the ladder's first engagement pays their first
    # allocations mid-spike, and the stall feeds back into the
    # controller's own queue-wait evidence as phantom overload
    for lvl in (3, 0):
        ctrl.apply_level(lvl)
        run_open_loop(
            eng,
            build_requests(PoissonArrivals(est), mk_mix(), 12,
                           seed=40 + lvl, uid_base=9_900_000 + lvl),
            max_live=slots)
    # snapshot past the OFF run's cumulative history: the controller
    # must steer on ITS run's evidence, not the preceding collapse
    ctrl.prime()
    on = run_open_loop(
        eng, build_requests(proc, mix, n, seed=3, uid_base=9_000_000),
        admission=ctrl, retry_budget=2, retry_base_s=0.05).report

    on_g = on["rates_rps"]["goodput"] or 0.0
    off_g = off["rates_rps"]["goodput"] or 0.0
    qw_p99 = on["latency"]["queue_wait_s"].get("p99")
    gates = {
        "on_holds_knee": on_g >= 0.95 * knee_goodput_rps,
        "off_collapses": off_g < 0.85 * knee_goodput_rps,
        "qw_p99_within_slo": qw_p99 is not None
        and qw_p99 <= deadline_s,
        "controller_engaged": on["admission"]["transitions"] >= 1
        or on["requests"]["rejected_admission"] > 0,
        "balance_ok_off": off["requests"]["balance_ok"],
        "balance_ok_on": on["requests"]["balance_ok"],
    }
    result = {
        "capacity_rps": round(cap_rps, 3),
        "deadline_s": round(deadline_s, 4),
        "knee_rps": round(knee_rps, 3),
        "knee_goodput_rps": round(knee_goodput_rps, 3),
        "spike": {"base_rps": round(knee_rps, 3),
                  "spike_rps": round(spike_rps, 3),
                  "start_s": start_s, "dur_s": round(dur_s, 3),
                  "requests": n},
        "off": {"goodput_rps": round(off_g, 3),
                "requests": off["requests"],
                "queue_wait_p99_s":
                off["latency"]["queue_wait_s"].get("p99")},
        "on": {"goodput_rps": round(on_g, 3),
               "requests": on["requests"],
               "queue_wait_p99_s": qw_p99,
               "retries": on.get("retries"),
               "admission": on["admission"]},
        "gates": gates,
    }
    with open(os.environ["DRILL_RESULT_FILE"], "w") as f:
        json.dump(result, f)
    return 0 if all(gates.values()) else 1


def drill_overload(workdir: str, verbose: bool = True) -> dict:
    """Overload drill: a 2.5x-capacity traffic spike served by the same
    engine with the admission controller off (must collapse below
    0.85 x the knee goodput rate) and on (must hold >= 0.95 x with
    queue-wait p99 inside the deadline) — the overload robustness
    gate."""
    site_dir = os.path.join(workdir, "overload")
    os.makedirs(site_dir, exist_ok=True)
    result_file = os.path.join(site_dir, "result.json")
    env = _serve_env(site_dir, "overload", DRILL_RESULT_FILE=result_file)
    # the worker arms/disarms the controller itself — a caller's kill
    # switch or tuning knobs must not skew the on-vs-off comparison
    for k in list(env):
        if k.startswith("DSTPU_ADMISSION") \
                and k != "DSTPU_ADMISSION_DEBUG":
            env.pop(k)
    rc = _run_worker(env, fn="_overload_worker")
    result = {"site": OVERLOAD_SITE, "mode": "overload", "rc": rc}
    if os.path.exists(result_file):
        with open(result_file) as f:
            result.update(json.load(f))
    gates = result.get("gates") or {}
    result["recovered"] = rc == 0 and bool(gates) \
        and all(gates.values())
    if verbose:
        print(f"[faultdrill:{OVERLOAD_SITE}] rc={rc} "
              f"knee={result.get('knee_goodput_rps')}rps "
              f"on={result.get('on', {}).get('goodput_rps')}rps "
              f"off={result.get('off', {}).get('goodput_rps')}rps "
              f"gates={gates} recovered={result['recovered']}",
              file=sys.stderr)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m deepspeed_tpu_torch.resilience.faultdrill``. Sites the
    port does not drill (``collective``: A8; ``train_goodput``: A7.6)
    raise before any worker runs, so the default ``--mode train`` (every
    training site) and ``all`` raise: name the training sites with
    ``--sites``."""
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.resilience.faultdrill",
        description="crash a short train or serve loop at each "
                    "fault-injection site and verify recovery (exit "
                    "non-zero on any unrecovered failure)")
    ap.add_argument("--mode", default="train",
                    choices=("train", "serve", "fleet", "train_goodput",
                             "overload", "disagg", "all"),
                    help="train: checkpoint-recovery drill (its "
                         "collective site is A8); serve: drain/replay "
                         "drill (serve "
                         "sites + sigterm); fleet: kill-one-of-N "
                         "replica-pool drill (SIGTERM under offered "
                         "load, survivor replay + rollup exactness); "
                         "train_goodput: the goodput-ledger drill (not "
                         "ported: A7.6); overload: 2.5x-capacity "
                         "spike, admission controller on vs off; disagg: "
                         "aborted-handoff + prefill-specialist-kill "
                         "drill; all: every mode")
    ap.add_argument("--sites", default=None,
                    help="comma-separated site subset (default: every "
                         "site of the selected mode)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh tempdir)")
    ap.add_argument("--device", default="cuda",
                    help="where the workers build their engines: cuda "
                         "(default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device
    _DEVICE["name"] = str(resolve_device(args.device))

    serve_sites = list(SERVE_FAULT_SITES) + [SIGTERM_SITE]
    if args.sites:
        sites = [s for s in args.sites.split(",") if s]
        valid = set(FAULT_SITES) | {SIGTERM_SITE, FLEET_SITE,
                                    GOODPUT_SITE, OVERLOAD_SITE}
        unknown = set(sites) - valid
        if unknown:
            ap.error(f"unknown sites {sorted(unknown)}; valid: "
                     f"{sorted(valid)}")
    elif args.mode == "train":
        sites = list(TRAIN_FAULT_SITES)
    elif args.mode == "serve":
        sites = serve_sites
    elif args.mode == "fleet":
        sites = [FLEET_SITE]
    elif args.mode == "train_goodput":
        sites = [GOODPUT_SITE]
    elif args.mode == "overload":
        sites = [OVERLOAD_SITE]
    elif args.mode == "disagg":
        sites = [DISAGG_SITE]
    else:
        sites = (list(TRAIN_FAULT_SITES) + serve_sites
                 + [FLEET_SITE, GOODPUT_SITE, OVERLOAD_SITE,
                    DISAGG_SITE])
    for site in sites:                     # refused before any run
        _refuse(site)
    workdir = args.workdir or tempfile.mkdtemp(prefix="dstpu_faultdrill_")

    results = [drill_fleet(workdir) if site == FLEET_SITE
               else drill_site(site, workdir)
               if site in TRAIN_FAULT_SITES
               else drill_overload(workdir)
               if site == OVERLOAD_SITE
               else drill_disagg(workdir)
               if site == DISAGG_SITE
               else drill_serve_site(site, workdir)
               for site in sites]
    ok = all(r["recovered"] for r in results)
    print(json.dumps({"ok": ok, "results": results}, indent=2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
