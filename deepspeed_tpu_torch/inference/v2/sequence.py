"""Sequence descriptors for the ragged engine (port of
``deepspeed_tpu/inference/v2/sequence.py``).

Per-sequence host state: tokens seen by the model, KV blocks owned, tokens
still waiting, scheduling status, the prefix-cache and pause (host
offload) fields, the deadline, the replay chain and speculative
decoding's counters, and telemetry's lifecycle stamps and fleet trace
context.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, List, Optional, Set


class SequenceStatus(enum.Enum):
    WAITING = "waiting"        # has pending tokens, not yet scheduled
    RUNNING = "running"        # scheduled in the current/last batch
    PAUSED = "paused"          # KV offloaded to host (engine.pause)
    FINISHED = "finished"      # flushed / EOS'd by the caller


@dataclass
class SequenceDescriptor:
    uid: int
    pending_tokens: List[int] = field(default_factory=list)
    seen_tokens: int = 0                  # tokens whose KV is in cache
    kv_blocks: List[int] = field(default_factory=list)
    status: SequenceStatus = SequenceStatus.WAITING
    host_kv: Any = None                   # offloaded KV (engine.pause)
    paused_blocks: int = 0                # block count captured at pause()
    last_step: int = 0                    # engine step last scheduled (LRU)
    # scheduler-clock stamp (one tick per scheduler invocation): what
    # prefill aging measures waiting time against
    last_sched: int = 0
    # prefix caching: block ids in kv_blocks co-owned by the prefix cache
    # (and maybe other sequences). Release paths decref these through the
    # cache; only cache eviction frees a shared block.
    shared: Set[int] = field(default_factory=set)
    # the initial prompt while its full blocks await registration into
    # the prefix cache; None once registered (or with caching off)
    prefix_tokens: Optional[List[int]] = None
    # prompt length including a cache-matched span: positions below it
    # count as prefill work in the skipped-chunk accounting
    prompt_len: int = 0
    # host-tier promote-ahead: scheduler ticks this sequence's first
    # prefill chunk yields to other work after its match promoted blocks
    # from host memory, so the host-to-device copies start first
    promote_defer: int = 0
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
    # draft tokens proposed for / accepted by this sequence over the
    # committable window of each verify round (decode_spec; drain
    # manifests carry them)
    spec_proposed: int = 0
    spec_accepted: int = 0
    # absolute time.monotonic() deadline (None = none), and the duration
    # it came from, which rejection records report
    deadline_at: Optional[float] = None
    deadline_s: Optional[float] = None
    # telemetry lifecycle stamps (time.monotonic; None until reached, or
    # with DSTPU_TELEMETRY=0): admission, first scheduled chunk, first
    # and latest committed output token (telemetry/serve.py)
    admitted_at: Optional[float] = None
    first_sched_at: Optional[float] = None
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    # the fleet-wide trace context (minted by ReplicaPool.put, or any
    # caller's put(..., traces=...)), carried across drain and replay;
    # None = untraced
    trace_id: Optional[str] = None

    @property
    def in_flight(self) -> int:
        return len(self.pending_tokens)

    def blocks_needed(self, new_tokens: int, block_size: int) -> int:
        """KV blocks to allocate so `seen_tokens + new_tokens` fit."""
        total = self.seen_tokens + new_tokens
        needed = -(-total // block_size)          # ceil
        return max(0, needed - len(self.kv_blocks))
