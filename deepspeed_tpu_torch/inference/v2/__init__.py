"""v2 ragged inference (port of ``deepspeed_tpu/inference/v2``): SplitFuse
scheduler, blocked paged KV cache and the continuous-batching engine."""

from .blocked_allocator import BlockedAllocator, OutOfBlocksError
from .config import RaggedInferenceConfig
from .engine_v2 import InferenceEngineV2
from .kv_cache import BlockedKVCache
from .model_runner import RaggedBatch

__all__ = ["BlockedAllocator", "BlockedKVCache", "InferenceEngineV2",
           "OutOfBlocksError", "RaggedBatch", "RaggedInferenceConfig"]
