"""Block-sparse attention: sparsity layouts and masked attention (port of
``deepspeed_tpu/ops/sparse_attention.py``).

The ``SparsityConfig`` family (Dense, Fixed, Variable, BigBird,
BSLongformer) is the JAX package's, line for line: a layout is a
``(heads, nb, nb)`` boolean block mask over ``block``-sized tiles where
entry ``[h, i, j]`` lets query block i attend key block j, and the random
configs draw from Python's ``random.Random(seed)``, so both packages make
the same layouts bit for bit.

:func:`sparse_attention` runs one of two paths on ``[B, H, T, D]`` tensors:

- ``impl="xla"`` (the default; the name is the JAX package's, kept so
  that callers pass the same argument, though here it is plain PyTorch):
  dense scores set to the f32 minimum outside the layout, softmax over
  the allowed keys, rows with no allowed key zeroed. It is
  differentiable and not the kernel's plain version;
- ``impl="flash"``: the hand-written block-sparse CUDA kernel
  (``ops.kernels.flash_attention.flash_attention_sparse``, forward only)
  on the layout re-tiled to its 128 granularity, which must be exact.
"""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np
import torch

_NEG_INF = float(np.finfo(np.float32).min)


class SparsityConfig:
    """Base: dense unless subclass overrides (reference sparsity_config.py:10)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block:
            raise ValueError(
                f"seq_len ({seq_len}) must be divisible by block "
                f"({self.block})")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), dtype=bool)

    def propagate_first_head(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Local windows + periodic global blocks (reference :95; the GPT-3
    'fixed' pattern)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        causal = self.attention == "unidirectional"
        for h in range(self.num_layout_heads):
            # local: dense within each window of num_local_blocks
            for start in range(0, nb, self.num_local_blocks):
                end = min(start + self.num_local_blocks, nb)
                for i in range(start, end):
                    jend = (i + 1) if causal else end
                    layout[h, i, start:jend] = True
            # global: last num_global_blocks of each window attend/attended
            pattern = h % self.num_different_global_patterns
            for start in range(0, nb, self.num_local_blocks):
                end = min(start + self.num_local_blocks, nb)
                g0 = max(start, end - (pattern + 1) * self.num_global_blocks)
                g1 = min(end, g0 + self.num_global_blocks)
                # vertical: global columns visible to all rows
                # (bidirectional) or to rows at/after the window (causal)
                first = 0 if not causal else start
                layout[h, first:, g0:g1] = True
                if self.horizontal_global_attention and not causal:
                    layout[h, g0:g1, :] = True
        if causal:
            tri = np.tril(np.ones((nb, nb), dtype=bool))
            layout &= tri
        return self.propagate_first_head(layout)


class VariableSparsityConfig(SparsityConfig):
    """Random + custom local windows + leading global blocks (reference :239)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks: int = 0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False, seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        rng = random.Random(self.seed)
        causal = self.attention == "unidirectional"
        for h in range(self.num_layout_heads):
            # local windows of varying sizes, repeated cyclically
            i = 0
            w = 0
            while i < nb:
                size = self.local_window_blocks[
                    min(w, len(self.local_window_blocks) - 1)]
                end = min(i + size, nb)
                layout[h, i:end, i:end] = True
                i, w = end, w + 1
            # random blocks per row
            for i in range(nb):
                for j in rng.sample(range(nb), min(self.num_random_blocks, nb)):
                    layout[h, i, j] = True
            # globals
            ends = self.global_block_end_indices
            for gi, g in enumerate(self.global_block_indices):
                g1 = (ends[gi] if ends else g + 1)
                layout[h, :, g:g1] = True
                if self.horizontal_global_attention:
                    layout[h, g:g1, :] = True
        if causal:
            layout &= np.tril(np.ones((nb, nb), dtype=bool))
        return self.propagate_first_head(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """random + sliding window + global (reference :411)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks: int = 1, num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional", seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        rng = random.Random(self.seed)
        w = self.num_sliding_window_blocks // 2
        causal = self.attention == "unidirectional"
        for h in range(self.num_layout_heads):
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = True
                for j in rng.sample(range(nb),
                                    min(self.num_random_blocks, nb)):
                    layout[h, i, j] = True
            g = min(self.num_global_blocks, nb)
            layout[h, :, :g] = True
            layout[h, :g, :] = True
        if causal:
            layout &= np.tril(np.ones((nb, nb), dtype=bool))
        return self.propagate_first_head(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """sliding window + selected global blocks (reference Longformer)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices=None, global_block_end_indices=None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = True
            ends = self.global_block_end_indices
            for gi, g in enumerate(self.global_block_indices):
                g1 = (ends[gi] if ends else g + 1)
                layout[h, :, g:g1] = True
                layout[h, g:g1, :] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((nb, nb), dtype=bool))
        return self.propagate_first_head(layout)


# --------------------------------------------------------------------------- #
# execution
# --------------------------------------------------------------------------- #


def coarsen_layout(layout: np.ndarray, from_block: int,
                   to_block: int = 128) -> np.ndarray:
    """Re-tile a block layout to the kernel granularity.

    ``from_block > to_block`` expands by repetition (always exact);
    ``from_block < to_block`` OR-reduces — callers that need exactness must
    check with :func:`coarsening_is_exact` (adding attention silently would
    break causal layouts)."""
    if from_block >= to_block:
        if from_block % to_block:
            raise ValueError(f"{from_block} not a multiple of {to_block}")
        r = from_block // to_block
        return np.repeat(np.repeat(layout, r, axis=1), r, axis=2)
    if to_block % from_block:
        raise ValueError(f"{to_block} not a multiple of {from_block}")
    r = to_block // from_block
    h, nq, nk = layout.shape
    pad_q, pad_k = (-nq) % r, (-nk) % r
    if pad_q or pad_k:
        layout = np.pad(layout, ((0, 0), (0, pad_q), (0, pad_k)))
        nq, nk = layout.shape[1:]
    return layout.reshape(h, nq // r, r, nk // r, r).any(axis=(2, 4))


def coarsening_is_exact(layout: np.ndarray, from_block: int,
                        to_block: int = 128) -> bool:
    """True when re-tiling to ``to_block`` adds no attention (every coarse
    block is either fully allowed or fully masked in the fine layout)."""
    if from_block >= to_block:
        return True
    coarse = coarsen_layout(layout, from_block, to_block)
    back = coarsen_layout(coarse, to_block, from_block)
    h, nq, nk = layout.shape
    return bool((back[:, :nq, :nk] == layout.astype(bool)).all())


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sparsity_config: SparsityConfig, *,
                     sm_scale: Optional[float] = None,
                     layout: Optional[np.ndarray] = None,
                     layout_mask: Optional[torch.Tensor] = None,
                     impl: str = "xla") -> torch.Tensor:
    """Block-sparse attention over BHTD tensors (reference
    ``SparseSelfAttention.forward``): scores outside the layout are masked
    before softmax. Pass ``layout`` to reuse a precomputed pattern.

    ``impl="flash"`` dispatches to the block-skipping CUDA kernel
    (forward-only: inference and serving; masked blocks are never read).
    The kernel tiles at 128 and applies no intra-block masking, so the
    layout must re-tile to 128 blocks EXACTLY: a layout whose coarsening
    would add attention (e.g. a fine-grained causal pattern) raises rather
    than silently attending extra (or future) tokens. The default
    ``impl="xla"`` (the JAX package's name for it) is the masked dense
    attention in plain PyTorch: it applies the exact layout and is
    differentiable."""
    if impl == "flash":
        if layout_mask is not None:
            raise ValueError(
                "impl='flash' takes a block-level 'layout', not a token-"
                "level 'layout_mask' (the kernel skips whole 128-blocks)")
        if layout is None:
            layout = sparsity_config.make_layout(q.shape[2])
        fine = np.asarray(layout, bool)
        if not coarsening_is_exact(fine, sparsity_config.block):
            raise ValueError(
                "impl='flash': this layout does not re-tile exactly to the "
                "kernel's 128-block granularity (coarsening would ADD "
                "attention — for unidirectional layouts that breaks "
                "causality). Use a block size that divides into 128-aligned "
                "patterns, or impl='xla'")
        from .kernels.flash_attention import flash_attention_sparse
        bm = coarsen_layout(fine, sparsity_config.block)
        return flash_attention_sparse(q, k, v, bm, sm_scale=sm_scale,
                                      layout="BHTD")
    b, h, t, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if layout_mask is None:
        if layout is None:
            layout = sparsity_config.make_layout(t)
        layout_mask = token_mask(layout, sparsity_config.block, q.device)
    layout_mask = layout_mask.to(device=q.device, dtype=torch.bool)
    if layout_mask.shape[0] == 1 and h > 1:
        layout_mask = layout_mask.expand(h, t, t)

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    s = torch.where(layout_mask[None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    # rows with no allowed block (fully masked) produce uniform garbage;
    # zero them like the reference's zero-fill
    any_allowed = layout_mask.any(dim=-1)                # (H, T)
    p = torch.where(any_allowed[None, :, :, None], p, torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def token_mask(layout: np.ndarray, block: int, device=None) -> torch.Tensor:
    """A block layout at token level: ``(H, T, T)`` bool on ``device``."""
    mask = np.kron(np.asarray(layout, bool), np.ones((block, block), bool))
    return torch.from_numpy(mask).to(device)


class SparseSelfAttention:
    """Thin callable wrapper matching the reference module's surface.
    ``impl`` as in :func:`sparse_attention` (the JAX package's wrapper
    always takes the masked path); the token mask (``"xla"``) or block
    layout (``"flash"``) is cached per sequence length and device."""

    def __init__(self, sparsity_config: SparsityConfig,
                 attn_mask_mode: str = "mul", impl: str = "xla"):
        self.sparsity_config = sparsity_config
        self.impl = impl
        self._layout_cache = {}

    def __call__(self, q, k, v):
        t = q.shape[2]
        key = (t, str(q.device))
        if key not in self._layout_cache:
            layout = self.sparsity_config.make_layout(t)
            self._layout_cache[key] = (
                layout if self.impl == "flash" else
                token_mask(layout, self.sparsity_config.block, q.device))
        if self.impl == "flash":
            return sparse_attention(q, k, v, self.sparsity_config,
                                    layout=self._layout_cache[key],
                                    impl="flash")
        return sparse_attention(q, k, v, self.sparsity_config,
                                layout_mask=self._layout_cache[key])
