"""v2 ragged inference (port of ``deepspeed_tpu/inference/v2``): SplitFuse
scheduler, blocked paged KV cache, the continuous-batching engine with its
pipelined serve loop and on-device sampling, and ``build_hf_engine``."""

from .blocked_allocator import BlockedAllocator, OutOfBlocksError
from .config import RaggedInferenceConfig
from .engine_factory import build_hf_engine
from .engine_v2 import InferenceEngineV2
from .kv_cache import BlockedKVCache
from .model_runner import RaggedBatch
from .sampling import SamplingParams

__all__ = ["BlockedAllocator", "BlockedKVCache", "InferenceEngineV2",
           "OutOfBlocksError", "RaggedBatch", "RaggedInferenceConfig",
           "SamplingParams", "build_hf_engine"]
