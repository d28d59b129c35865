"""Preemption-safe drain/replay for the v2 ragged serving engine (port of
``deepspeed_tpu/inference/v2/drain.py``, the same manifest and journal
format: a manifest or journal written by either package replays on the
other).

The training side survives preemption through checkpoints; a serving
replica has no checkpoint — its durable state is *which requests
it owes tokens to*. This module gives the engine two complementary ways
to carry that state across a death:

  * **Replay manifest** (cooperative drain): on SIGTERM the engine stops
    admitting, unwinds the plan/dispatch/commit pipeline, and
    ``build_manifest`` captures every live sequence as ``(uid, prompt
    tokens, tokens generated so far, scheduler state)``. A restarted or
    survivor engine re-``put()``s ``prompt + generated`` and greedy
    continuation is token-identical to the uninterrupted run — KV content
    is a deterministic function of the token chain, so nothing but the
    chain needs to survive. On shared-prefix workloads the re-prefill is
    mostly prefix-cache block hits (the survivor's cache retains the
    prompt's refcount-0 blocks).
  * **Replay journal** (hard crash): an append-only JSONL write-ahead log
    — one ``admit`` record per admission, one ``tokens`` record per
    committed step, ``finish`` on flush. A SIGKILL/``os._exit`` leaves no
    chance to build a manifest; ``manifest_from_journal`` reconstructs
    the same manifest shape from the journal's committed prefix. Tokens
    that were generated but not yet journaled are simply re-generated —
    greedy decode is deterministic, so the replayed stream is identical
    either way.

Only *committed* tokens enter the journal/manifest: speculative pipeline
steps that were dispatched but never committed (or killed by the EOS
rollback) are invisible here by construction, which is exactly what makes
replay exact at any kill point.

Everything in this module is host-side (json over ints); the journal
methods run on the serve loop's commit path — they append to a buffered
file and never touch the device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

MANIFEST_VERSION = 1


class ServeDrainError(RuntimeError):
    """Drain protocol misuse (e.g. drain() from inside the pipeline)."""


class EngineDrainingError(RuntimeError):
    """The engine is draining and refuses new work (replay() on a drained
    replica, or an explicit caller probe)."""


class ServeStepError(RuntimeError):
    """A serve step failed even after bounded retry-with-backoff."""


class ReplayJournal:
    """Append-only JSONL write-ahead log of serving state.

    Records are flushed to the OS per write, so a hard ``os._exit`` loses
    at most the record being written; ``fsync=True`` additionally survives machine loss.
    A torn trailing line (killed mid-write) is tolerated by the reader.
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._f = open(path, "a", encoding="utf-8")

    def _write(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def admit(self, uid: int, prompt: List[int],
              sampling: Optional[Dict[str, Any]] = None,
              trace: Optional[str] = None) -> None:
        """A (possibly re-)admitted sequence: the full prompt chain. A
        later ``admit`` for the same uid supersedes the earlier one (a
        replayed sequence's prompt is its whole resumed chain).
        ``sampling`` (a SamplingParams dict) and ``trace`` (the fleet
        trace context) ride along so a hard-crash replay keeps sampled
        streams deterministic and the replayed spans on their track."""
        rec = {"e": "admit", "uid": int(uid),
               "prompt": [int(t) for t in prompt]}
        if sampling:
            rec["sampling"] = sampling
        if trace:
            rec["trace"] = trace
        self._write(rec)

    def tokens(self, per_uid: Dict[int, List[int]]) -> None:
        """Tokens COMMITTED this step, batched across slots (one record
        per commit keeps the journal off the per-token path)."""
        if per_uid:
            self._write({"e": "tokens",
                         "t": {str(u): [int(t) for t in v]
                               for u, v in per_uid.items() if v}})

    def finish(self, uid: int) -> None:
        self._write({"e": "finish", "uid": int(uid)})

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def manifest_from_journal(path: str) -> Dict[str, Any]:
    """Reconstruct a replay manifest from a journal left by a hard crash:
    the committed prefix of every sequence admitted and not finished.
    A torn trailing record (the process died mid-write) ends the replay
    cleanly — everything before it is intact by the flush discipline."""
    seqs: Dict[int, Dict[str, Any]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                break                      # torn tail record: stop here
            if rec.get("e") == "admit":
                seqs[int(rec["uid"])] = {"prompt": list(rec["prompt"]),
                                         "generated": [],
                                         "sampling": rec.get("sampling"),
                                         "trace": rec.get("trace")}
            elif rec.get("e") == "tokens":
                for u, toks in rec.get("t", {}).items():
                    if int(u) in seqs:
                        seqs[int(u)]["generated"].extend(toks)
            elif rec.get("e") == "finish":
                seqs.pop(int(rec["uid"]), None)
    return {
        "version": MANIFEST_VERSION,
        "source": "journal",
        "time": time.time(),
        "sequences": [
            {"uid": uid, "prompt": s["prompt"], "generated": s["generated"],
             "sampling": s.get("sampling"), "trace": s.get("trace"),
             "scheduler": {}}
            for uid, s in sorted(seqs.items())],
    }


def build_manifest(engine) -> Dict[str, Any]:
    """Snapshot every live sequence of a (quiesced) engine: the token
    chain that must re-enter a queue somewhere, plus the scheduler-state
    diagnostics a postmortem wants. Call only with no steps in flight —
    the engine's ``drain()`` enforces that."""
    from .sequence import SequenceStatus
    seqs = []
    for uid, seq in sorted(engine.state.sequences.items()):
        if seq.status is SequenceStatus.FINISHED:
            continue
        if not seq.prompt_log and not seq.gen_log:
            continue                       # nothing replayable
        seqs.append({
            "uid": uid,
            "prompt": list(seq.prompt_log),
            "generated": list(seq.gen_log),
            # sampled requests replay deterministically only with their
            # sampling identity restored (seed + position-folded keys)
            "sampling": seq.sampling.to_dict()
            if seq.sampling is not None else None,
            # the fleet trace context: the port has no tracing yet (A6)
            "trace": None,
            "scheduler": engine.scheduler.describe(seq),
        })
    return {
        "version": MANIFEST_VERSION,
        "source": "drain",
        "time": time.time(),
        "config": {
            "block_size": engine.config.block_size,
            "num_blocks": engine.config.num_blocks,
            "prefix_cache": bool(engine.config.prefix_cache),
            "serve_pipeline_depth": engine.pipeline_depth,
            "tp_size": engine.config.tp_size,
            # the seq shard map: chain ordinal o homes on chip
            # o % seq_size. Replay re-prefills, so a restore engine may
            # use ANY seq_size — recorded for audit, not a constraint
            "seq_size": max(1, int(getattr(engine.config, "seq_size", 1))),
            # likewise audit-only: expert placement never enters the
            # manifest (token chains are geometry-free), so an ep=2
            # drain replays on an ep=1 survivor and vice versa
            "ep_size": max(1, int(getattr(engine.config, "ep_size", 1))),
        },
        "sequences": seqs,
    }


def write_manifest(manifest: Dict[str, Any], path: str) -> None:
    """Atomic publish (tmp + fsync + rename) — the same torn-write
    discipline as the checkpoint layer: a reader never sees a partial
    manifest, even if the drain itself is preempted."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_manifest(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        m = json.load(f)
    v = m.get("version")
    if v != MANIFEST_VERSION:
        raise ServeDrainError(
            f"replay manifest {path} has version {v!r}, expected "
            f"{MANIFEST_VERSION}")
    return m


def load_replay_state(manifest_path: Optional[str],
                      journal_path: Optional[str]) -> Optional[Dict[str, Any]]:
    """Recovery entry point for a restarted replica: prefer the drain
    manifest (cooperative shutdown wrote a complete snapshot), fall back
    to journal reconstruction (hard crash), None when neither exists."""
    if manifest_path and os.path.exists(manifest_path):
        return load_manifest(manifest_path)
    if journal_path and os.path.exists(journal_path):
        return manifest_from_journal(journal_path)
    return None
