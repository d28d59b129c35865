"""Streaming fused LM-head cross-entropy (port of
``deepspeed_tpu/ops/kernels/fused_xent.py``).

Three hand-written CUDA kernels (``csrc/fused_xent.cu``) replace the three
Pallas kernels; none writes the [N, V] logits to device memory:

- ``xent_fwd`` — replaces ``_fwd_kernel``: per-token logsumexp over the
  vocabulary (online, as flash attention's softmax), the target logit and
  the sum of the real vocabulary's logits (label smoothing's term); 128 x
  256 logits tiles on wgmma, TMA-fed, the vocabulary in contiguous splits
  merged in split order (:func:`fwd_plan`);
- ``xent_bwd_dh`` — replaces ``_dh_kernel``: dh = scale * P' . E;
- ``xent_bwd_de`` — replaces ``_de_kernel``: dE = scale * P'^T . h;

with P' = d(sum of the rows' losses)/d(logits) (``_grad_p``): ``(1 +
2 z lse) P - (1 - eps) onehot - eps / V`` over the real vocabulary, zero
for a row whose target is out of range or ignored. Both backward kernels
recompute the logits instead of reading them, each tile once: a
thread-block cluster of CL blocks owns 128 output rows, block b a
W-column slab of them; each block computes one logits tile of a round,
forms P' and shares it with the cluster through distributed shared
memory, and every block multiplies the round's tiles into its slab, both
products on wgmma (:func:`bwd_plan` picks CL and W).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version (``fused_xent_fwd_plain``, ``fused_xent_dh_plain``,
``fused_xent_de_plain``) for CPU tensors. The plain versions follow the
Pallas kernels' arithmetic: logits in fp32 from operands in h's dtype
(E is cast to it, as the JAX wrapper does); the target logit read before
the vocabulary mask (0 for an id outside [0, V)); the ``1e-37`` floor
inside the log; P' cast to h's dtype before both backward products with
fp32 sums; dE cast to the embedding's dtype at the end. They walk the
tokens in chunks, so no [N, V] tensor is made at once. Only a launch
counts in :data:`LAUNCHES`.

The kernels take h in fp32, bf16 or fp16 (:data:`KERNEL_DTYPES`: every
dtype the engine trains in) and mask the ragged vocabulary and token tiles
themselves, so the [V, C] embedding is never copied to a padded shape for
V (the JAX wrapper pads it when the vocab tile does not divide V). A
hidden size C that is not a multiple of 64 is padded with zero columns in
h and E inside the wrapper (:func:`kernel_hidden`): a zero column adds an
exact zero to every fp32 logit, so lse and the target logit are unchanged,
and dh and dE are sliced back to C.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ...utils.device import sm_count

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"xent_fwd": 0, "xent_bwd_dh": 0,
                            "xent_bwd_de": 0}
#: rows of one chunk of the plain versions' token walk
PLAIN_ROWS = 1024
#: the kernels' dtype codes: every dtype ``train_batch`` computes in
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the kernels' hidden sizes are multiples of this (others are padded)
HIDDEN_MULTIPLE = 64


def kernel_hidden(C: int) -> int:
    """The hidden size the kernels run at for hidden size ``C``: the next
    multiple of :data:`HIDDEN_MULTIPLE` (the wrapper zero-pads h and E)."""
    return -(-C // HIDDEN_MULTIPLE) * HIDDEN_MULTIPLE


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions


def _logits(h: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """fp32 logits of a row chunk; h and e in the compute dtype."""
    return h.float() @ e.float().t()


def _valid(t: torch.Tensor, V: int, ignore: Optional[int]) -> torch.Tensor:
    """Rows that count: in-range target, not the ignore id."""
    ok = (t >= 0) & (t < V)
    if ignore is not None:
        ok &= t != ignore
    return ok


def fused_xent_fwd_plain(h2: torch.Tensor, emb: torch.Tensor,
                         tgt: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``xent_fwd``'s function: ``(lse, tgt_logit, lsum)``, fp32 [N] each,
    for h2 [N, C], emb [V, C] and int targets [N]."""
    e = emb.to(h2.dtype)
    V = e.shape[0]
    lse, tl, ls = [], [], []
    for a in range(0, h2.shape[0], PLAIN_ROWS):
        logits = _logits(h2[a:a + PLAIN_ROWS], e)
        t = tgt[a:a + PLAIN_ROWS].long()
        inr = (t >= 0) & (t < V)
        picked = logits.gather(1, t.clamp(0, V - 1)[:, None])[:, 0]
        tl.append(torch.where(inr, picked, torch.zeros_like(picked)))
        ls.append(logits.sum(1))
        m = logits.amax(1)
        s = torch.exp(logits - m[:, None]).sum(1)
        lse.append(m + torch.log(s.clamp_min(1e-37)))
    return torch.cat(lse), torch.cat(tl), torch.cat(ls)


def _grad_p(logits, lse, t, *, V: int, ignore: Optional[int], z: float,
            eps: float) -> torch.Tensor:
    """P' of one row chunk (``_grad_p``), fp32 [rows, V]."""
    p = torch.exp(logits - lse[:, None])
    if z:
        p = p * (1.0 + 2.0 * z * lse[:, None])
    inr = (t >= 0) & (t < V)
    p[inr, t[inr]] -= 1.0 - eps
    if eps:
        p = p - eps / V
    return torch.where(_valid(t, V, ignore)[:, None], p,
                       torch.zeros_like(p))


def fused_xent_dh_plain(scale: torch.Tensor, h2: torch.Tensor,
                        emb: torch.Tensor, tgt: torch.Tensor,
                        lse: torch.Tensor, *, ignore: Optional[int],
                        z: float, eps: float) -> torch.Tensor:
    """``xent_bwd_dh``'s function: dh [N, C] = scale * P' . E in h's
    dtype; ``scale`` a one-element fp32 tensor."""
    e = emb.to(h2.dtype)
    V = e.shape[0]
    s = scale.float().reshape(())
    out = []
    for a in range(0, h2.shape[0], PLAIN_ROWS):
        h = h2[a:a + PLAIN_ROWS]
        p = _grad_p(_logits(h, e), lse[a:a + PLAIN_ROWS].float(),
                    tgt[a:a + PLAIN_ROWS].long(), V=V, ignore=ignore, z=z,
                    eps=eps)
        out.append(((p.to(h.dtype).float() @ e.float()) * s).to(h.dtype))
    return torch.cat(out)


def fused_xent_de_plain(scale: torch.Tensor, h2: torch.Tensor,
                        emb: torch.Tensor, tgt: torch.Tensor,
                        lse: torch.Tensor, *, ignore: Optional[int],
                        z: float, eps: float) -> torch.Tensor:
    """``xent_bwd_de``'s function: dE [V, C] = scale * P'^T . h, summed in
    fp32 and cast to the embedding's dtype."""
    e = emb.to(h2.dtype)
    V = e.shape[0]
    acc = torch.zeros(e.shape, dtype=torch.float32, device=e.device)
    for a in range(0, h2.shape[0], PLAIN_ROWS):
        h = h2[a:a + PLAIN_ROWS]
        p = _grad_p(_logits(h, e), lse[a:a + PLAIN_ROWS].float(),
                    tgt[a:a + PLAIN_ROWS].long(), V=V, ignore=ignore, z=z,
                    eps=eps)
        acc += p.to(h.dtype).float().t() @ h.float()
    return (acc * scale.float().reshape(())).to(emb.dtype)


# ------------------------------------------------------------ the kernels


def _check(h2, emb, tgt, *rows):
    """``rows`` are the backward's scale (one element) and lse ([N])."""
    if h2.dim() != 2 or emb.dim() != 2 or h2.shape[1] != emb.shape[1]:
        raise ValueError(f"h2 {tuple(h2.shape)} and emb {tuple(emb.shape)} "
                         f"must be [N, C] and [V, C]")
    if tgt.shape != h2.shape[:1]:
        raise ValueError(f"targets {tuple(tgt.shape)} must be [N]")
    if rows and (rows[0].numel() != 1 or rows[1].shape != h2.shape[:1]):
        raise ValueError("scale must have one element and lse be [N]")
    if not h2.is_cuda:
        return
    for t in (emb, tgt) + rows:
        if t.device != h2.device:
            raise ValueError(f"a tensor on {t.device}, h2 on {h2.device}")
    if h2.dtype not in KERNEL_DTYPES:
        raise ValueError(f"h2 dtype {h2.dtype}: the kernels take fp32, bf16 "
                         f"or fp16")
    if tgt.dtype != torch.int32:
        raise ValueError(f"targets must be int32, got {tgt.dtype}")
    for t in rows:
        if t.dtype != torch.float32:
            raise ValueError("lse and scale must be fp32")


def _operands(h2, emb, tgt):
    """Contiguous kernel operands: E in h's dtype (a copy only when the
    dtypes differ, as the JAX wrapper's cast), h and E zero-padded to
    :func:`kernel_hidden` columns when C is not a multiple of 64."""
    h, e = h2.contiguous(), emb.to(h2.dtype).contiguous()
    pad = kernel_hidden(h.shape[1]) - h.shape[1]
    if pad:
        h = torch.nn.functional.pad(h, (0, pad))
        e = torch.nn.functional.pad(e, (0, pad))
    return h, e, tgt.contiguous()


def _launch(name: str, *args) -> None:
    from . import _build
    lib = _build.load("fused_xent")
    err = getattr(lib, f"{name}_launch")(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def xent_fwd(h2: torch.Tensor, emb: torch.Tensor, tgt: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(lse, tgt_logit, lsum)`` (CUDA kernel on a card, the plain
    version on the CPU)."""
    _check(h2, emb, tgt)
    if not h2.is_cuda:
        return fused_xent_fwd_plain(h2, emb, tgt)
    h, e, t = _operands(h2, emb, tgt)
    N, C = h.shape
    V = e.shape[0]
    splits = fwd_plan(N, V, C, sm_count(h.device))
    out = torch.empty(3, N, dtype=torch.float32, device=h.device)
    part = torch.empty(4, splits, N, dtype=torch.float32, device=h.device)
    _launch("xent_fwd", h.data_ptr(), e.data_ptr(), t.data_ptr(),
            out.data_ptr(), part.data_ptr(), N, V, C, splits,
            KERNEL_DTYPES[h.dtype], _stream(h))
    return out[0], out[1], out[2]


#: tokens and vocabulary rows of one forward tile
FWD_TOKENS = 128
FWD_VOCAB = 256
#: a block's fixed cost in tiles' worth of work (pipeline fill, partials)
FWD_BLOCK_COST = 0.5


@functools.lru_cache(maxsize=256)
def fwd_plan(N: int, V: int, C: int, sms: int) -> int:
    """The forward's vocabulary splits for N tokens, V vocabulary rows,
    hidden size C on a card of ``sms`` SMs (one block an SM): the
    ``ceil(V / 256)`` tiles split into contiguous ranges, as many as give
    the fewest waves of (token tile, split) blocks times tiles a block
    (plus :data:`FWD_BLOCK_COST`), the fewest splits among equals. Each
    split holds at least one tile. From shapes alone, so the same call
    gives the same split and the same bits."""
    if N <= 0 or V <= 0 or C <= 0 or C % 64:
        raise ValueError(f"N {N}, V {V}, C {C}: the forward takes positive "
                         f"sizes, C a multiple of 64")
    if sms <= 0:
        raise ValueError(f"sms {sms} must be positive")
    tiles_n = -(-N // FWD_TOKENS)
    tiles_v = -(-V // FWD_VOCAB)
    best = None
    for splits in range(1, min(tiles_v, 65535) + 1):
        waves = -(-tiles_n * splits // sms)
        cost = waves * (-(-tiles_v // splits) + FWD_BLOCK_COST)
        if best is None or cost < best[0]:
            best = (cost, splits)
    return best[1]


#: slab widths the backward kernels are instantiated for, widest first
BWD_WIDTHS = (256, 128, 64)
#: blocks of a backward cluster, at most (the portable cluster size)
BWD_MAX_CLUSTER = 8


def bwd_plan(C: int) -> Tuple[int, int, int]:
    """``(CL, W, G)`` of the backward kernels for hidden size ``C``: a
    cluster of CL blocks, each a W-column slab of the output, and G slab
    groups, CL * W * G == C. The fewest groups (each computes the logits
    again), then the widest slab; a C that one cluster covers (up to
    8 * 256) takes one group."""
    if C <= 0 or C % 64:
        raise ValueError(f"hidden size {C}: the kernels take a multiple of "
                         f"64")
    for G in range(1, C // 64 + 1):
        for W in BWD_WIDTHS:
            if C % (G * W) == 0 and C // (G * W) <= BWD_MAX_CLUSTER:
                return C // (G * W), W, G
    raise AssertionError("unreachable: W = 64, G = C / 64 always fits")


def _bwd(name, scale, h2, emb, tgt, lse, ignore, z, eps, out_rows,
         out_dtype):
    h, e, t = _operands(h2, emb, tgt)
    N, C = h.shape
    V = e.shape[0]
    out = torch.empty(out_rows, C, dtype=out_dtype, device=h.device)
    _launch(name, scale.contiguous().data_ptr(), h.data_ptr(), e.data_ptr(),
            t.data_ptr(), lse.contiguous().data_ptr(), out.data_ptr(), N, V,
            C, int(ignore is not None), int(ignore or 0), float(z),
            float(eps), KERNEL_DTYPES[h.dtype],
            int(out_dtype == torch.float32), *bwd_plan(C), _stream(h))
    return out[:, :h2.shape[1]]


def xent_bwd_dh(scale: torch.Tensor, h2: torch.Tensor, emb: torch.Tensor,
                tgt: torch.Tensor, lse: torch.Tensor, *,
                ignore: Optional[int], z: float, eps: float) -> torch.Tensor:
    """dh [N, C] in h's dtype (CUDA kernel on a card, plain on the CPU)."""
    _check(h2, emb, tgt, scale, lse)
    if not h2.is_cuda:
        return fused_xent_dh_plain(scale, h2, emb, tgt, lse, ignore=ignore,
                                   z=z, eps=eps)
    return _bwd("xent_bwd_dh", scale, h2, emb, tgt, lse, ignore, z, eps,
                h2.shape[0], h2.dtype)


def xent_bwd_de(scale: torch.Tensor, h2: torch.Tensor, emb: torch.Tensor,
                tgt: torch.Tensor, lse: torch.Tensor, *,
                ignore: Optional[int], z: float, eps: float) -> torch.Tensor:
    """dE [V, C] in the embedding's dtype, summed in fp32 (CUDA kernel on
    a card, plain on the CPU)."""
    _check(h2, emb, tgt, scale, lse)
    if not h2.is_cuda:
        return fused_xent_de_plain(scale, h2, emb, tgt, lse, ignore=ignore,
                                   z=z, eps=eps)
    out_dtype = torch.float32 if emb.dtype == torch.float32 else h2.dtype
    return _bwd("xent_bwd_de", scale, h2, emb, tgt, lse, ignore, z, eps,
                emb.shape[0], out_dtype).to(emb.dtype)


# ------------------------------------------------------------ the loss


def _core_total(lse, tl, lsum, V: int, tgt, ignore: Optional[int], z: float,
                eps: float) -> torch.Tensor:
    """Sum of the valid rows' losses (``_core_total``)."""
    nll = lse - (1.0 - eps) * tl
    if eps:
        nll = nll - (eps / V) * lsum
    if z:
        nll = nll + z * lse * lse
    return torch.where(_valid(tgt, V, ignore), nll,
                       torch.zeros_like(nll)).sum()


class _FusedXent(torch.autograd.Function):
    """The SUM of the rows' losses, as ``_xent_core``'s custom-VJP
    boundary: the incoming cotangent is a scalar, which the backward
    kernels take as ``scale`` (read on the device, no host sync)."""

    @staticmethod
    def forward(ctx, h2, emb, tgt, ignore, z, eps):
        lse, tl, lsum = xent_fwd(h2, emb, tgt)
        ctx.save_for_backward(h2, emb, tgt, lse)
        ctx.args = (ignore, z, eps)
        return _core_total(lse, tl, lsum, emb.shape[0], tgt, ignore, z, eps)

    @staticmethod
    def backward(ctx, g):
        h2, emb, tgt, lse = ctx.saved_tensors
        ignore, z, eps = ctx.args
        scale = g.float().reshape(1)
        kw = dict(ignore=ignore, z=z, eps=eps)
        dh = xent_bwd_dh(scale, h2, emb, tgt, lse, **kw) \
            if ctx.needs_input_grad[0] else None
        de = xent_bwd_de(scale, h2, emb, tgt, lse, **kw) \
            if ctx.needs_input_grad[1] else None
        return dh, de, None, None, None, None


def fused_lm_xent(hidden: torch.Tensor, embedding: torch.Tensor,
                  targets: torch.Tensor, *, token_block: Optional[int] = None,
                  vocab_block: Optional[int] = None,
                  ignore_index: Optional[int] = None, z_loss: float = 0.0,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean next-token NLL with the logits never written to memory.

    hidden [B, T, C] (or [N, C]) in the compute dtype, embedding [V, C]
    (the tied LM head), targets [B, T] (or [N]). Differentiable in hidden
    and embedding. ``ignore_index`` drops those positions from the loss,
    the divisor and both gradients, as do ids outside [0, V).
    ``z_loss`` adds ``z * lse^2`` per valid position; ``label_smoothing``
    mixes the target with the uniform distribution. ``token_block`` and
    ``vocab_block`` are accepted as tile hints and not used: the kernels
    pick their own tiles (the forward 128 tokens by 256 vocabulary rows,
    :func:`fwd_plan`; the backward 128 rows by 64 columns of the logits,
    its slabs from the hidden size, :func:`bwd_plan`).
    """
    for name, b in (("token_block", token_block),
                    ("vocab_block", vocab_block)):
        if b is not None and b <= 0:
            raise ValueError(f"{name} must be positive, got {b}")
    h2 = hidden.reshape(-1, hidden.shape[-1])
    t1 = targets.reshape(-1).to(torch.int32)
    total = _FusedXent.apply(h2, embedding, t1, ignore_index,
                             float(z_loss), float(label_smoothing))
    valid = _valid(t1, embedding.shape[0], ignore_index)
    return total / valid.sum().clamp_min(1)
