"""Blocked (paged) KV cache (port of ``deepspeed_tpu/inference/v2/kv_cache.py``).

A fixed device-resident pool addressed through per-sequence block tables,
stored flat as one tensor ``data`` [layers, 2 (k/v), (num_blocks + 1) *
block_size, kv_heads * head_dim]. The final block is the trash block:
padded query positions write into its last row, so they never touch a
live sequence's KV. ``data[layer, 0]`` / ``data[layer, 1]`` are contiguous
``[slots, KV*D]`` views — what the paged kernels read — and cost no copy.
Unlike the JAX package the pool is updated in place (``index_copy_``): one
pool is resident, with no functional rethreading.

The pool holds bf16, fp16 or fp32 rows, or, with
``kv_cache_dtype="int8"``, int8 rows and per-(token, KV head) f32
``scales`` [layers, 2, kv_heads, slots] (``kv_quant.py``).
"""

from __future__ import annotations

from typing import Any, List

import torch

from .blocked_allocator import BlockedAllocator
from .config import RaggedInferenceConfig
from .kv_quant import KVPool


class BlockedKVCache:
    def __init__(self, cfg: RaggedInferenceConfig, num_layers: int,
                 kv_heads: int, head_dim: int, dtype: Any = torch.bfloat16,
                 device: Any = "cuda"):
        if dtype not in (torch.bfloat16, torch.float16, torch.float32):
            raise ValueError(f"KV pool dtype {dtype}: the pool holds bf16, "
                             f"fp16 or fp32 rows (or int8 by kv_cache_dtype)")
        self.cfg = cfg
        self.num_layers = num_layers
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.allocator = BlockedAllocator(cfg.num_blocks)
        slots = (cfg.num_blocks + 1) * cfg.block_size
        self.quantized = cfg.kv_cache_dtype == "int8"
        self.dtype = torch.int8 if self.quantized else dtype
        self.data = torch.zeros((num_layers, 2, slots, kv_heads * head_dim),
                                dtype=self.dtype, device=device)
        self.scales = torch.zeros((num_layers, 2, kv_heads, slots),
                                  dtype=torch.float32, device=device) \
            if self.quantized else None

    @property
    def pool(self):
        """What the runner's step takes: a KVPool (data and scales travel
        together) when quantized, else the data tensor itself."""
        return KVPool(self.data, self.scales) if self.quantized \
            else self.data

    def memory_bytes(self) -> int:
        n = self.data.numel() * self.data.element_size()
        if self.scales is not None:
            n += self.scales.numel() * self.scales.element_size()
        return n

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    def reserve(self, n: int) -> List[int]:
        return self.allocator.allocate(n)

    def free(self, blocks) -> None:
        self.allocator.free(blocks)
