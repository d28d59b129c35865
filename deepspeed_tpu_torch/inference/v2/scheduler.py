"""Dynamic-SplitFuse token scheduler (port of
``deepspeed_tpu/inference/v2/scheduler.py``, same policy).

Long prompts are split into chunks and fused with decode tokens so every
forward consumes a near-constant token budget. Decode sequences (1 pending
token) are scheduled first — they bound per-token latency; prefill chunks
fill the remaining budget, longest first, with waiting prefills aged
ahead so none is deferred unboundedly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from .config import RaggedInferenceConfig
from .sequence import SequenceDescriptor, SequenceStatus
from .state_manager import StateManager

#: steps a prefill may wait before it jumps the longest-first queue
PREFILL_AGING_STEPS = 8


@dataclass
class ScheduledSeq:
    seq: SequenceDescriptor
    tokens: List[int]          # tokens this step (<= chunk_size)
    start_pos: int             # absolute position of tokens[0]
    is_last_chunk: bool        # True -> logits of final token are meaningful


class SplitFuseScheduler:
    def __init__(self, cfg: RaggedInferenceConfig, state: StateManager):
        self.cfg = cfg
        self.state = state

    def schedule(self, eligible: Optional[
            Callable[[SequenceDescriptor], bool]] = None
            ) -> List[ScheduledSeq]:
        """Pick up to ``max_seqs`` sequences with pending tokens."""
        cfg = self.cfg
        pending = [s for s in self.state.sequences.values()
                   if s.in_flight > 0
                   and s.status is not SequenceStatus.FINISHED]
        if eligible is not None:
            pending = [s for s in pending if eligible(s)]
        now = self.state.step
        decode = [s for s in pending if s.in_flight == 1]

        def prefill_key(s):
            if now - s.last_sched >= PREFILL_AGING_STEPS:
                return (0, s.last_sched, -s.in_flight)
            return (1, -s.in_flight, s.last_sched)

        prefill = sorted((s for s in pending if s.in_flight > 1),
                         key=prefill_key)
        out: List[ScheduledSeq] = []
        budget = cfg.max_seqs * cfg.chunk_size
        used = 0
        for seq in decode + prefill:
            if len(out) == cfg.max_seqs:
                break
            if seq.in_flight == 1:
                n = 1                          # decode rows are budget-exempt
            else:
                n = min(seq.in_flight, cfg.chunk_size,
                        max(budget - used, 0))
                if n <= 0:
                    break                      # prefill budget exhausted
            if not self.state.can_schedule(seq.uid, n):
                continue                       # KV pressure: leave waiting
            self.state.ensure_blocks(seq, n)
            tokens = seq.pending_tokens[:n]
            del seq.pending_tokens[:n]
            out.append(ScheduledSeq(
                seq=seq, tokens=tokens, start_pos=seq.seen_tokens,
                is_last_chunk=seq.in_flight == 0))
            seq.seen_tokens += n
            seq.status = SequenceStatus.RUNNING
            if n > 1:
                used += n
        return out
