"""Host half of token selection (port of the greedy part of
``deepspeed_tpu/inference/v2/sampling.py``).

Greedy is the only selection this port serves: the step programs take the
argmax on the device and hand back token ids. On-device sampled decoding
(and its random-number contract) is not ported yet, so ``SamplingParams``
with a temperature above 0 is refused by the engine.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SamplingParams:
    """One request's sampling identity; ``temperature <= 0`` is greedy."""

    temperature: float = 0.0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def host_token(result) -> int:
    """The committed token of one step result: a device-selected token id
    passes through; a row of logits takes its first-index argmax (the
    same tie-break as ``torch.argmax`` on the device)."""
    if isinstance(result, (int, np.integer)):
        return int(result)
    return int(np.argmax(np.asarray(result)))
