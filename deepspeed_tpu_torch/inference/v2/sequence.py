"""Sequence descriptors for the ragged engine (port of
``deepspeed_tpu/inference/v2/sequence.py``).

Per-sequence host state: tokens seen by the model, KV blocks owned, tokens
still waiting, and scheduling status. The prefix-cache, offload,
sampling, speculative and telemetry fields of the JAX descriptor belong to
features this port has not taken over yet.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, List


class SequenceStatus(enum.Enum):
    WAITING = "waiting"        # has pending tokens, not yet scheduled
    RUNNING = "running"        # scheduled in the current/last batch
    PAUSED = "paused"          # KV evicted to host (not ported yet)
    FINISHED = "finished"      # flushed / EOS'd by the caller


@dataclass
class SequenceDescriptor:
    uid: int
    pending_tokens: List[int] = field(default_factory=list)
    seen_tokens: int = 0                  # tokens whose KV is in cache
    kv_blocks: List[int] = field(default_factory=list)
    status: SequenceStatus = SequenceStatus.WAITING
    last_step: int = 0                    # engine step last scheduled (LRU)
    # scheduler-clock stamp (one tick per scheduler invocation): what
    # prefill aging measures waiting time against
    last_sched: int = 0
    prompt_len: int = 0
    # the replay chain: every token fed while the sequence was a fresh
    # prompt, then every committed greedy output (and caller-fed
    # continuation token not already accounted)
    prompt_log: List[int] = field(default_factory=list)
    gen_log: List[int] = field(default_factory=list)
    # per-request sampling identity (sampling.SamplingParams; None =
    # greedy), attached at admission by put(..., sampling=...)
    sampling: Any = None
    # chosen-token log-probabilities (unmodified model distribution),
    # one per committed token when sampling.logprobs is set
    logprob_log: List[float] = field(default_factory=list)
    # pipelined serving (serve_pipeline_depth > 0): placeholder tokens in
    # pending_tokens whose value is still on the device (an in-flight
    # step's token output). The scheduler takes one only while its
    # producing step is the latest dispatched; otherwise that step's
    # commit patches the real value in.
    spec_pending: int = 0

    @property
    def in_flight(self) -> int:
        return len(self.pending_tokens)

    def blocks_needed(self, new_tokens: int, block_size: int) -> int:
        """KV blocks to allocate so `seen_tokens + new_tokens` fit."""
        total = self.seen_tokens + new_tokens
        needed = -(-total // block_size)          # ceil
        return max(0, needed - len(self.kv_blocks))
