"""Speculative decoding for the v2 ragged engine: proposers and acceptance
(port of ``deepspeed_tpu/inference/v2/speculative.py``, host code only).

A proposer guesses up to K next tokens a sequence; one verify pass of the
runner's decode loop (``RaggedRunnerBase.decode_loop`` with
``draft_toks``: step t consumes the caller's token instead of its own
last output) scores the model's greedy choice after every draft prefix,
and the host accepts the longest agreeing prefix. Each round commits
``accepted_drafts + 1`` tokens a sequence: the +1 is the model's own token
at the first disagreement, or the bonus token when every draft survives.
The rejected positions' KV is rolled back by ``StateManager.trim_blocks``
(the engine's ``decode_spec``), which keeps prefix-cache refcounts exact.

Greedy verification is exact: a draft is accepted only where it equals
what greedy decode emits there, so the token streams are those of
non-speculative greedy decode. Sampled sequences bypass speculation.

Two proposers:

  * :class:`NgramProposer` -- self-drafting (prompt lookup): the
    continuation of the last n-gram's previous occurrence in the
    sequence's own history. ``noise`` perturbs a seeded fraction of the
    proposals (a calibration knob for tests and benchmarks; the JAX
    package's ``DSTPU_SPEC_NOISE`` variable is not ported, A9).
  * :class:`DraftModelProposer` -- a small draft model of the same
    vocabulary, served by its own engine on the target engine's device;
    its KV state tracks the target's accepted history (rollback by the
    same trim, a one-token catch-up after a full acceptance).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from .blocked_allocator import OutOfBlocksError


def accept_length(drafts: Sequence[int], emitted: Sequence[int]) -> int:
    """Longest accepted draft prefix: ``j`` such that
    ``drafts[i] == emitted[i]`` for every ``i < j`` -- draft i+1 is what
    greedy decode emits after consuming drafts ``1..i``. ``drafts`` is the
    verify input row without its leading last-committed token,
    ``[d_1..d_K]``; ``emitted`` is the verify output row ``[m_0..m_K]``."""
    j = 0
    while j < len(drafts) and drafts[j] == emitted[j]:
        j += 1
    return j


class NgramProposer:
    """Self-drafting: match the tail n-gram of the sequence's history
    against its earlier occurrences and propose the tokens that followed
    (falling back to shorter grams, then to repeating the last token)."""

    kind = "ngram"

    def __init__(self, n: int = 3, noise: float = 0.0,
                 noise_seed: int = 0, vocab_size: int = 0):
        self.n = max(1, int(n))
        #: calibration only: perturb this seeded fraction of the proposed
        #: tokens, so that acceptance can be pinned; 0 in production
        self.noise = float(noise)
        self.noise_seed = int(noise_seed)
        self.vocab_size = int(vocab_size)

    def propose_batch(self, seqs: Sequence[Any],
                      histories: Sequence[List[int]],
                      k: int) -> List[List[int]]:
        """Per-sequence draft lists, each up to ``k`` tokens."""
        return [self.propose(s, h, k) for s, h in zip(seqs, histories)]

    def propose(self, seq, history: List[int], k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing ``history`` (which ends
        with the sequence's last committed, not yet consumed token)."""
        h = history
        out: List[int] = []
        ln = len(h)
        for g in range(min(self.n, ln - 1), 0, -1):
            tail = h[ln - g:]
            # the newest earlier occurrence wins; stop before the tail's
            # own position
            for p in range(ln - g - 1, -1, -1):
                if h[p:p + g] == tail:
                    out = h[p + g:p + g + k]
                    break
            if out:
                break
        if not out:
            out = [h[-1]]
        while len(out) < k:
            out.append(out[-1])
        out = out[:k]
        if self.noise > 0.0 and self.vocab_size > 1:
            # seeded per (uid, position): the same on every rerun
            rng = np.random.default_rng(
                (self.noise_seed * 1_000_003
                 + seq.uid * 7_919 + seq.seen_tokens) & 0x7FFFFFFF)
            for i in range(len(out)):
                if rng.random() < self.noise:
                    jump = 1 + rng.integers(0, self.vocab_size - 1)
                    out[i] = int((out[i] + jump) % self.vocab_size)
        return out

    def observe_commit(self, seq, seen0: int, accepted: List[int],
                       drafts: List[int]) -> None:
        """History is read from the sequence at each propose: nothing to
        roll back."""

    def drop(self, uid: int) -> None:
        pass


class DraftModelProposer:
    """A small draft model proposing for the target engine.

    The draft runs as its own ``InferenceEngineV2`` (same slot and block
    geometry, its own KV pool) over a model of the target's vocabulary.
    Before every propose ``draft.seen_tokens == target.seen_tokens`` with
    the same next input token. One propose is one greedy ``decode_batch(k)``
    on the draft; after the target's verify, ``observe_commit`` rolls the
    draft back to the accepted prefix (the accepted drafts are the draft's
    own consumed inputs, so their KV is right) or feeds the one-token
    catch-up a full acceptance owes.
    """

    kind = "draft"

    def __init__(self, draft_engine):
        self.draft = draft_engine
        self._last_drafts: Dict[int, List[int]] = {}

    def _sync(self, seq, history: List[int]) -> None:
        """(Re-)admit ``seq`` on the draft engine so that its state
        matches the target's: prefill all but the last, unconsumed token.
        Covers first sight, reuse after a flush, and drift (re-prefilled
        from scratch)."""
        d = self.draft.state.get(seq.uid)
        if d is not None and (d.seen_tokens != seq.seen_tokens
                              or d.in_flight):
            self.draft.flush(seq.uid)
            d = None
        if d is None and len(history) > 1:
            self.draft.put([seq.uid], [history[:-1]], _greedy=True)

    def propose_batch(self, seqs: Sequence[Any],
                      histories: Sequence[List[int]],
                      k: int) -> List[List[int]]:
        """One draft decode for the round: sync every sequence, then
        ``decode_batch`` over all of them. A sequence the draft cannot
        serve this round (its pool is short) proposes nothing, and the
        target verifies its next token alone. Only the pool-pressure error
        is caught: a kernel that fails to build or launch surfaces."""
        ready, hist_of = [], {}
        for seq, h in zip(seqs, histories):
            self._sync(seq, h)
            if self.draft.state.get(seq.uid) is not None:
                ready.append(seq)
                hist_of[seq.uid] = h
        out: Dict[int, List[int]] = {}
        if ready:
            try:
                res = self.draft.decode_batch(
                    [s.uid for s in ready],
                    [hist_of[s.uid][-1] for s in ready], k)
                out = {u: [int(t) for t in v] for u, v in res.items()}
            except OutOfBlocksError:
                for s in ready:
                    self.draft.flush(s.uid)
                out = {}
        self._last_drafts.update(out)
        return [out.get(s.uid, []) for s in seqs]

    def observe_commit(self, seq, seen0: int, accepted: List[int],
                       drafts: List[int]) -> None:
        """Roll the draft back to the target's accepted history. After its
        propose the draft consumed ``[last, d_1..d_{k-1}]`` (seen = seen0 +
        k); the target accepted ``a = len(accepted)`` of the K+1 verified
        positions. ``a <= k``: retract the draft to seen0 + a by the same
        trim. ``a == k + 1`` (full acceptance and the bonus): the draft
        never consumed d_k -- feed it as a one-token catch-up."""
        uid = seq.uid
        d = self.draft.state.get(uid)
        drafts = self._last_drafts.pop(uid, drafts)
        if d is None:
            return
        k = len(drafts)
        a = len(accepted)
        if a <= k:
            d.seen_tokens = seen0 + a
            self.draft.state.trim_blocks(d)
            d.gen_log = d.gen_log[:max(0, len(d.gen_log) - (k - a))]
        elif k:
            self.draft.put([uid], [[drafts[-1]]], _greedy=True)

    def drop(self, uid: int) -> None:
        self._last_drafts.pop(uid, None)
        if self.draft.state.get(uid) is not None:
            self.draft.flush(uid)


def build_proposer(engine) -> Any:
    """The proposer ``engine.spec_mode`` asks for: "ngram" needs nothing
    more (no noise); "draft" needs a model paired by
    ``engine.attach_draft``."""
    mode = engine.spec_mode
    if mode == "ngram":
        return NgramProposer(
            n=engine.spec_ngram, noise=0.0, noise_seed=0,
            vocab_size=int(getattr(engine.runner.model_cfg,
                                   "vocab_size", 0)))
    if mode == "draft":
        if engine._draft_engine is None:
            raise ValueError(
                "spec_decode='draft' needs a paired draft model: call "
                "engine.attach_draft(draft_model_cfg, draft_params) "
                "before decoding")
        return DraftModelProposer(engine._draft_engine)
    raise ValueError(f"no proposer for spec mode {mode!r}")
