from .checkpoint_engine import (AsyncCheckpointEngine, CheckpointEngine,
                                SyncCheckpointEngine, build_checkpoint_engine,
                                flush_all_pending)
from .engine_checkpoint import (FORMAT_VERSION, LATEST_FILE, META_FILE,
                                QUARANTINE_SUFFIX, STATE_FILE,
                                export_fp32_params, find_valid_tag,
                                list_tags, load_checkpoint, load_state_tree,
                                publish_latest, quarantine_checkpoint,
                                save_checkpoint, save_state_tree,
                                validate_checkpoint_dir)
from .jax_params import (family_params_from_numpy, gpt2_param_shapes,
                         gpt2_params_from_numpy, init_family_params,
                         init_gpt2_params, init_llama_params,
                         llama_param_shapes, llama_params_from_numpy,
                         init_moe_params, mixtral_param_shapes,
                         moe_param_shapes, moe_params_from_numpy,
                         param_shapes, woq_params_from_numpy)
from .zero_to_fp32 import extract_fp32_params, resolve_ckpt_dir

__all__ = ["AsyncCheckpointEngine", "CheckpointEngine", "FORMAT_VERSION",
           "LATEST_FILE", "META_FILE", "QUARANTINE_SUFFIX", "STATE_FILE",
           "SyncCheckpointEngine", "build_checkpoint_engine",
           "export_fp32_params", "extract_fp32_params",
           "family_params_from_numpy", "find_valid_tag", "flush_all_pending",
           "gpt2_param_shapes", "gpt2_params_from_numpy", "init_family_params",
           "init_gpt2_params", "init_llama_params", "init_moe_params",
           "list_tags", "llama_param_shapes", "llama_params_from_numpy",
           "load_checkpoint", "load_state_tree", "mixtral_param_shapes",
           "moe_param_shapes", "moe_params_from_numpy", "param_shapes",
           "publish_latest", "quarantine_checkpoint", "resolve_ckpt_dir",
           "save_checkpoint", "save_state_tree", "validate_checkpoint_dir",
           "woq_params_from_numpy"]
