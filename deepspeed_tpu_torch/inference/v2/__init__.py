"""v2 ragged inference (port of ``deepspeed_tpu/inference/v2``): SplitFuse
scheduler, blocked paged KV cache with the two-tier prefix cache and host
offload, the continuous-batching engine with its pipelined serve loop,
on-device sampling, abort, deadlines, shedding and drain/replay, and
``build_hf_engine``."""

from .blocked_allocator import BlockedAllocator, OutOfBlocksError
from .config import RaggedInferenceConfig
from .drain import (EngineDrainingError, ReplayJournal, ServeDrainError,
                    ServeStepError, load_manifest, load_replay_state,
                    manifest_from_journal)
from .engine_factory import build_hf_engine
from .engine_v2 import InferenceEngineV2
from .kv_cache import BlockedKVCache
from .model_runner import RaggedBatch
from .prefix_cache import PrefixCache
from .sampling import SamplingParams
from .sequence import SequenceDescriptor, SequenceStatus
from .state_manager import StateManager

__all__ = ["BlockedAllocator", "BlockedKVCache", "EngineDrainingError",
           "InferenceEngineV2", "OutOfBlocksError", "PrefixCache",
           "RaggedBatch", "RaggedInferenceConfig", "ReplayJournal",
           "SamplingParams", "SequenceDescriptor", "SequenceStatus",
           "ServeDrainError", "ServeStepError", "StateManager",
           "build_hf_engine", "load_manifest", "load_replay_state",
           "manifest_from_journal"]
