"""Blocked (paged) KV cache (port of ``deepspeed_tpu/inference/v2/kv_cache.py``).

A fixed device-resident pool addressed through per-sequence block tables,
stored flat as one tensor ``[layers, 2 (k/v), (num_blocks + 1) * block_size,
kv_heads * head_dim]``. The final block is the trash block: padded query
positions write into its last row, so they never touch a live sequence's
KV. ``pool[layer, 0]`` / ``pool[layer, 1]`` are contiguous ``[slots, KV*D]``
views — what the paged kernels read — and cost no copy. Unlike the JAX
package the pool is updated in place (``index_copy_``): one pool is
resident, with no functional rethreading.

bf16 and fp32 pools only; the int8 pool is not ported yet.
"""

from __future__ import annotations

from typing import Any, List

import torch

from .blocked_allocator import BlockedAllocator
from .config import RaggedInferenceConfig


class BlockedKVCache:
    def __init__(self, cfg: RaggedInferenceConfig, num_layers: int,
                 kv_heads: int, head_dim: int, dtype: Any = torch.bfloat16,
                 device: Any = "cuda"):
        if dtype not in (torch.bfloat16, torch.float32):
            raise NotImplementedError(
                f"KV pool dtype {dtype}: only bfloat16 and float32 pools "
                f"are ported")
        self.cfg = cfg
        self.num_layers = num_layers
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.allocator = BlockedAllocator(cfg.num_blocks)
        slots = (cfg.num_blocks + 1) * cfg.block_size
        self.pool = torch.zeros((num_layers, 2, slots, kv_heads * head_dim),
                                dtype=dtype, device=device)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    def reserve(self, n: int) -> List[int]:
        return self.allocator.allocate(n)

    def free(self, blocks) -> None:
        self.allocator.free(blocks)
