"""Dropless top-k MoE through the grouped expert GEMM (port of
``grouped_moe_ffn``, ``deepspeed_tpu/moe/sharded_moe.py:189-253``).

Tokens sort by their routed expert, each expert multiplies only its
contiguous run of rows (``ops/kernels/grouped_gemm.ragged_dot``: S*k rows
instead of every expert on every token), and the outputs come back to
their tokens weighted by the router. Nothing here reads a device value on
the host: the group sizes are counted with ``scatter_add_`` and turned
into offsets with ``cumsum`` on the device, where the kernel reads them
(``bincount``, ``nonzero`` and boolean indexing would each wait for the
device).

The capacity gating of training (``top1gating`` / ``top2gating`` /
``topkgating``) and the expert-parallel variants are not ported (queue
items A7 and A8).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from ..ops.kernels.grouped_gemm import ragged_dot


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

    # the load-balance statistic of the capacity path this replaces:
    # first-choice counts at k <= 2, all k choices above
    me = gates.mean(dim=0)
    if k <= 2:
        first = torch.zeros(E, dtype=torch.float32, device=logits.device)
        first.scatter_add_(0, top_idx[:, 0],
                           torch.ones(S, dtype=torch.float32,
                                      device=logits.device))
        ce = first / float(S)
    else:
        ce = (off[1:] - off[:-1]).float() / float(S * k)
    l_aux = (me * ce).sum() * E
    return out, l_aux
