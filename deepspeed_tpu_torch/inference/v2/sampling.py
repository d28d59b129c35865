"""Per-sequence sampling identity and its host-side staging (port of
``deepspeed_tpu/inference/v2/sampling.py``).

A request carries a :class:`SamplingParams` for its whole life. The
device half, ``model_runner._select_tokens``, selects every token on the
card: the pipelined steps (``step_sample_fb``) and the decode loop's
``mode="sample"`` both use it.

The determinism contract: the threefry key of a sampled token is a pure
function of ``(seed, absolute position of the token)``,

    key = fold_in(PRNGKey(seed), position_of_the_new_token)

computed on the device from two staged int32 values per slot
(``utils/random.py``, bit-compatible with ``jax.random``). No key state
lives on the host or across steps, so one ``(seed, prompt)`` gives one
stream at any pipeline depth, chunking, or through the decode loop or
the per-step path, and the same stream as the JAX package's.
``temperature <= 0`` is the argmax in the same program: token-identical
to the greedy path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

#: cap on per-request top_k, and the width of the device sampler's
#: candidate set: it draws from the top-``SAMPLE_CANDIDATES`` logits
#: (top-p renormalizes within them), so its noise is [S, cand], not
#: [S, V]
SAMPLE_CANDIDATES = 256


@dataclass(frozen=True)
class SamplingParams:
    """One request's sampling identity, attached at admission
    (``engine.put(..., sampling={uid: SamplingParams(...)})``).

    ``temperature <= 0`` is greedy; ``top_k = 0`` and ``top_p = 1.0``
    turn their filters off. ``seed`` is the threefry seed the
    per-position keys derive from; ``None`` takes the request's uid.
    ``logprobs`` records the chosen token's log-probability under the
    unmodified model distribution into ``seq.logprob_log``.
    """

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    logprobs: bool = False

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed,
                "logprobs": self.logprobs}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SamplingParams":
        return cls(temperature=float(d.get("temperature", 1.0)),
                   top_k=int(d.get("top_k", 0)),
                   top_p=float(d.get("top_p", 1.0)),
                   seed=None if d.get("seed") is None else int(d["seed"]),
                   logprobs=bool(d.get("logprobs", False)))


def derive_seed(base: int, uid: int) -> int:
    """A stable per-uid seed from one base seed for a batch
    (``generate(seed=...)``), kept int32-positive."""
    return (int(base) * 1_000_003 + int(uid) * 7_919) & 0x7FFFFFFF


def seed_of(p: SamplingParams, uid: int) -> int:
    """The seed staged for ``uid``: the explicit one, or the uid."""
    s = p.seed
    return int(uid) & 0x7FFFFFFF if s is None else s


def stage_slot(bufs, i: int, seq, sample_pos: int) -> bool:
    """Fill slot ``i`` of the (seeds, spos, temps, topks, topps) staging
    arrays from ``seq``'s sampling params; a greedy slot stages
    temperature 0 (the argmax on the device). ``sample_pos`` is the
    absolute position the selected token will occupy, the ``fold_in``
    operand. Returns True when the slot samples."""
    seeds, spos, temps, topks, topps = bufs
    p = seq.sampling
    spos[i] = sample_pos
    if p is None or p.greedy:
        temps[i] = 0.0
        topps[i] = 1.0
        return False
    seeds[i] = seed_of(p, seq.uid)
    temps[i] = p.temperature
    topks[i] = min(p.top_k, SAMPLE_CANDIDATES)
    topps[i] = p.top_p
    return True


def host_token(result) -> int:
    """The committed token of one step result: a device-selected token id
    passes through; a row of logits takes its first-index argmax (the
    same tie-break as ``torch.argmax`` on the device)."""
    if isinstance(result, (int, np.integer)):
        return int(result)
    return int(np.argmax(np.asarray(result)))
