"""MoE gating and dispatch math (port of ``deepspeed_tpu/moe/sharded_moe.py``).

The capacity gating (``capacity``, ``top1gating`` with ``RSample`` /
``Jitter`` noise, ``top2gating`` with second-expert Gumbel sampling,
``topkgating`` and ``gate``) returns the JAX package's ``(l_aux,
combine [S, E, C], dispatch [S, E, C])`` for a flat token group ``[S,
M]``: the GShard formulation with cumsum queue positions. Noise comes from
explicit threefry keys (``utils/random.py``), drawn as
``jax.random.uniform`` draws them, so a key gives the JAX package's noise.
The functions take torch tensors or any array (a numpy or JAX array is
converted).

Dropless top-k MoE through the grouped expert GEMM (port of
``grouped_moe_ffn``, ``deepspeed_tpu/moe/sharded_moe.py:189-253``).

Tokens sort by their routed expert, each expert multiplies only its
contiguous run of rows (``ops/kernels/grouped_gemm.ragged_dot``: S*k rows
instead of every expert on every token), and the outputs come back to
their tokens weighted by the router. Nothing here reads a device value on
the host: the group sizes are counted with ``scatter_add_`` and turned
into offsets with ``cumsum`` on the device, where the kernel reads them
(``bincount``, ``nonzero`` and boolean indexing would each wait for the
device).

It is differentiable: ``ragged_dot`` has a backward (the grouped GEMM
over a transposed weight copy for the rows, ``grouped_wgrad_kernel`` for
the weights), the router's gradient flows through the selected weights
and ``gates.mean`` as in JAX, and the counts carry none. The
expert-parallel variants are not ported (queue item A8).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels.grouped_gemm import ragged_dot
from ..utils import random as trandom


def _tensor(x: Any) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, any other array copied."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))


def capacity(num_tokens: int, num_experts: int, capacity_factor: float,
             min_capacity: int) -> int:
    """Tokens each expert can accept (the reference's ``_capacity``)."""
    cap = int(math.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


def _gumbel(key: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """The JAX ``_gumbel``: ``-log(-log(u))`` of ``jax.random.uniform(key,
    shape, minval=1e-9, maxval=1 - 1e-9)`` (the same fp32 bits; the
    logarithms taken in fp64 and rounded once)."""
    n = int(np.prod(shape))
    u = trandom.uniform(key, n, minval=1e-9, maxval=1.0 - 1e-9)
    g = -torch.log(-torch.log(u.to(torch.float64)))
    return g.to(torch.float32).reshape(shape)


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot`` of integer-valued ``x`` in fp32: an index outside
    ``[0, n)`` gives a row of zeros."""
    idx = x.to(torch.int64)
    return (idx[..., None] == torch.arange(n, device=x.device)).float()


def _positions_in_expert(mask: torch.Tensor) -> torch.Tensor:
    """Queue position of each routed token within its expert: mask [S, E]
    one-hot -> [S]."""
    positions = torch.cumsum(mask, dim=0) - 1.0
    return (positions * mask).sum(dim=-1)


def top1gating(logits: Any, capacity_factor: float = 1.0,
               min_capacity: int = 4, rng: Optional[Any] = None,
               noisy_gate_policy: Optional[str] = None,
               used_token_mask: Optional[Any] = None,
               drop_tokens: bool = True):
    """Switch-style top-1 gating with capacity drop and random token
    selection (``RSample``: Gumbel noise on the selection; ``Jitter``:
    logits times uniform [0.98, 1.02)). logits [S, E]."""
    logits = _tensor(logits)
    S, E = logits.shape
    C = capacity(S, E, capacity_factor, min_capacity) if drop_tokens else S
    gates = torch.softmax(logits, dim=-1)
    select = logits
    if noisy_gate_policy == "RSample" and rng is not None:
        select = logits + _gumbel(trandom.as_key(rng).to(logits.device),
                                  (S, E))
    elif noisy_gate_policy == "Jitter" and rng is not None:
        select = logits * trandom.uniform(
            trandom.as_key(rng).to(logits.device), S * E, minval=0.98,
            maxval=1.02).reshape(S, E)
    mask1 = _one_hot(torch.argmax(select, dim=-1), E)
    if used_token_mask is not None:
        mask1 = mask1 * _tensor(used_token_mask).to(mask1)[:, None]
    # the load-balancing loss, before the capacity drop
    l_aux = (gates.mean(dim=0) * mask1.mean(dim=0)).sum() * E
    pos = _positions_in_expert(mask1)
    mask1 = mask1 * (pos < C).float()[:, None]
    gate_val = (gates * mask1).sum(dim=-1)
    combine = (gate_val[:, None, None] * mask1[:, :, None]
               * _one_hot(pos, C)[:, None, :])
    return l_aux, combine, combine > 0


def top2gating(logits: Any, capacity_factor: float = 1.0,
               min_capacity: int = 4, rng: Optional[Any] = None,
               top2_2nd_expert_sampling: bool = True,
               drop_tokens: bool = True, normalize_weights: bool = True):
    """GShard top-2 gating: the second expert chosen with Gumbel noise
    when ``top2_2nd_expert_sampling`` and a key are given; second choices
    queue behind every first choice of their expert. logits [S, E]."""
    logits = _tensor(logits)
    S, E = logits.shape
    C = capacity(S, E, 2 * capacity_factor, min_capacity) \
        if drop_tokens else S
    gates = torch.softmax(logits, dim=-1)
    mask1 = _one_hot(torch.argmax(logits, dim=-1), E)
    second = logits
    if top2_2nd_expert_sampling and rng is not None:
        second = logits + _gumbel(trandom.as_key(rng).to(logits.device),
                                  (S, E))
    second = second.masked_fill(mask1 > 0, float("-inf"))
    mask2 = _one_hot(torch.argmax(second, dim=-1), E)
    l_aux = (gates.mean(dim=0) * mask1.mean(dim=0)).sum() * E
    pos1 = _positions_in_expert(mask1)
    offset = mask1.sum(dim=0, keepdim=True)
    pos2 = ((torch.cumsum(mask2, dim=0) - 1.0 + offset) * mask2).sum(dim=-1)
    mask1 = mask1 * (pos1 < C).float()[:, None]
    mask2 = mask2 * (pos2 < C).float()[:, None]
    g1 = (gates * mask1).sum(dim=-1)
    g2 = (gates * mask2).sum(dim=-1)
    if normalize_weights:
        denom = torch.clamp(g1 + g2, min=1e-9)
        g1, g2 = g1 / denom, g2 / denom
    combine = (g1[:, None, None] * mask1[:, :, None]
               * _one_hot(pos1, C)[:, None, :]
               + g2[:, None, None] * mask2[:, :, None]
               * _one_hot(pos2, C)[:, None, :])
    return l_aux, combine, combine > 0


def topkgating(logits: Any, k: int, capacity_factor: float = 1.0,
               min_capacity: int = 4, drop_tokens: bool = True,
               normalize_weights: bool = True):
    """Generic top-k gating: k rounds of argmax, each queued behind the
    earlier rounds' choices. logits [S, E]."""
    logits = _tensor(logits)
    S, E = logits.shape
    C = capacity(S, E, k * capacity_factor, min_capacity) \
        if drop_tokens else S
    gates = torch.softmax(logits, dim=-1)
    masked = logits
    total_mask = logits.new_zeros((S, E))
    offset = logits.new_zeros((1, E))
    gsum = logits.new_zeros((S,))
    picks = []
    for _ in range(k):
        mask = _one_hot(torch.argmax(masked, dim=-1), E)
        pos = ((torch.cumsum(mask, dim=0) - 1.0 + offset) * mask).sum(dim=-1)
        kept = mask * (pos < C).float()[:, None]
        g = (gates * kept).sum(dim=-1)
        picks.append((kept, pos, g))
        gsum = gsum + g
        total_mask = total_mask + mask
        offset = offset + mask.sum(dim=0, keepdim=True)
        masked = masked.masked_fill(mask > 0, float("-inf"))
    l_aux = (gates.mean(dim=0) * (total_mask / k).mean(dim=0)).sum() * E
    denom = torch.clamp(gsum, min=1e-9)
    combine = logits.new_zeros((S, E, C))
    for kept, pos, g in picks:
        w = g / denom if normalize_weights else g
        combine = combine + (w[:, None, None] * kept[:, :, None]
                             * _one_hot(pos, C)[:, None, :])
    return l_aux, combine, combine > 0


def gate(logits: Any, k: int = 1, **kwargs):
    """The gating function for ``k`` (``TopKGate.forward``), with the
    JAX package's argument pruning."""
    if k == 1:
        kwargs.pop("top2_2nd_expert_sampling", None)
        kwargs.pop("normalize_weights", None)
        return top1gating(logits, **kwargs)
    if k == 2:
        kwargs.pop("noisy_gate_policy", None)
        kwargs.pop("used_token_mask", None)
        return top2gating(logits, **kwargs)
    for name in ("noisy_gate_policy", "used_token_mask", "rng",
                 "top2_2nd_expert_sampling"):
        kwargs.pop(name, None)
    return topkgating(logits, k, **kwargs)


def _grouped_aux_loss(gates: torch.Tensor, top_idx: torch.Tensor, k: int,
                      E: int) -> torch.Tensor:
    """The grouped paths' l_aux: the statistic of the capacity path they
    replace (first-choice counts at k <= 2, all k choices above),
    counted on the device."""
    S = gates.shape[0]
    idx = top_idx[:, 0] if k <= 2 else top_idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=gates.device)
    counts.scatter_add_(0, idx, torch.ones(idx.shape[0], dtype=torch.float32,
                                           device=gates.device))
    ce = counts / float(S if k <= 2 else S * k)
    return (gates.mean(dim=0) * ce).sum() * E


def group_offsets(eid: torch.Tensor, E: int) -> torch.Tensor:
    """int32 [E + 1] row offsets of each expert's run in ``eid``'s stable
    sort, counted on the device."""
    counts = torch.zeros(E, dtype=torch.int32, device=eid.device)
    counts.scatter_add_(0, eid, torch.ones_like(eid, dtype=torch.int32))
    return torch.cat([counts.new_zeros(1),
                      torch.cumsum(counts, 0, dtype=torch.int32)])


def grouped_moe_ffn(tokens: torch.Tensor, logits: torch.Tensor, k: int,
                    weights: Sequence[torch.Tensor],
                    activation: Callable[[torch.Tensor], torch.Tensor],
                    dtype: torch.dtype, normalize_weights: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [S, M]; logits [S, E]; weights (wi, wo) or gated (wi_gate,
    wi_up, wo), stacked [E, M, H] / [E, H, M]. Returns (out [S, M] in
    ``dtype``, l_aux).

    Each token's k contributions are summed in increasing expert id, in
    ``dtype``, one after the other (the JAX ``.at[tok_of].add`` in
    expert-sorted order, as XLA scatters on the CPU), not by atomics: the
    result is the same bits every run."""
    S, E = logits.shape
    lf = logits.float()
    gates = torch.softmax(lf, dim=-1)
    top_vals, top_idx = torch.topk(lf, k, dim=-1)   # descending, as top_k
    if normalize_weights:        # renormalized over the selected (Mixtral)
        w_sel = torch.softmax(top_vals, dim=-1)
    else:                        # the full softmax's weights (Qwen2-MoE)
        w_sel = torch.gather(gates, 1, top_idx)

    eid = top_idx.reshape(-1)                               # [S*k]
    order = torch.sort(eid, stable=True).indices
    tok_of = torch.div(order, k, rounding_mode="floor")
    xs = tokens.index_select(0, tok_of).to(dtype)           # sorted rows
    off = group_offsets(eid, E)

    if len(weights) == 3:
        wi_gate, wi_up, wo = (w.to(dtype) for w in weights)
        h = activation(ragged_dot(xs, wi_gate, off)) \
            * ragged_dot(xs, wi_up, off)
    else:
        wi, wo = (w.to(dtype) for w in weights)
        h = activation(ragged_dot(xs, wi, off))
    ys = ragged_dot(h, wo, off)                             # [S*k, M]
    ys = ys * w_sel.reshape(-1)[order].to(dtype)[:, None]

    # sorted position of each (token, choice); a token's positions in
    # increasing order are its choices in increasing expert id
    pos = torch.empty_like(order)
    pos.scatter_(0, order, torch.arange(S * k, device=order.device))
    pos = torch.sort(pos.reshape(S, k), dim=1).values
    out = ys[pos[:, 0]]
    for j in range(1, k):
        out = out + ys[pos[:, j]]

    return out, _grouped_aux_loss(gates, top_idx, k, E)
