"""The framework config tree (port of ``deepspeed_tpu/config/config.py``,
the part the single-GPU training step reads).

One ds_config JSON/dict tree -> typed sub-configs with the JAX package's
key names, the batch-size invariant ``train_batch == micro_batch x
grad_accum x dp_world`` (``dp_world = 1`` on one card) and ``"auto"``
values resolved when the engine is built.

What this slice does not serve is refused, never ignored: enabling one of
the features below raises ``NotImplementedError`` naming the ROADMAP item
that brings it. ZeRO stages 0-3 are accepted, because on one card they
compute the same step; their bucket and overlap knobs have no effect on
one card, as in the JAX package on one device. ``compile`` chooses jit or
eager in the JAX package; the port's engine is eager whatever it says (it
is not mapped to ``torch.compile``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Union

from .config_utils import ConfigModel, is_auto, logger


class ConfigError(Exception):
    pass


# --------------------------------------------------------------------------- #
# Precision
# --------------------------------------------------------------------------- #

@dataclass
class FP16Config(ConfigModel):
    """fp16 with dynamic (``loss_scale == 0``) or static loss scaling."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


@dataclass
class BF16Config(ConfigModel):
    enabled: bool = False
    accumulate_grads_in_fp32: bool = True


@dataclass
class DataTypesConfig(ConfigModel):
    grad_accum_dtype: Union[str, None] = None   # "fp32" | "bf16" | "fp16"


# --------------------------------------------------------------------------- #
# Optimizer / scheduler
# --------------------------------------------------------------------------- #

@dataclass
class OptimizerConfig(ConfigModel):
    type: str = "AdamW"
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerConfig(ConfigModel):
    type: Union[str, None] = None
    params: Dict[str, Any] = field(default_factory=dict)


# --------------------------------------------------------------------------- #
# ZeRO
# --------------------------------------------------------------------------- #

@dataclass
class OffloadConfig(ConfigModel):
    device: str = "none"             # none | cpu | nvme (not ported: A7)
    nvme_path: Union[str, None] = None
    pin_memory: bool = True
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    ratio: float = 1.0
    stream: bool = False


@dataclass
class ZeroConfig(ConfigModel):
    """zero_optimization: the stage is accepted (one card computes the same
    step at every stage); offload and ZeRO++ are refused."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: Union[int, str] = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: Union[int, str] = 500_000_000
    overlap_comm: Union[bool, None] = None
    offload_optimizer: OffloadConfig = field(default_factory=OffloadConfig)
    offload_param: OffloadConfig = field(default_factory=OffloadConfig)
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: Union[int, str] = 1_000_000_000
    stage3_max_reuse_distance: Union[int, str] = 1_000_000_000
    stage3_prefetch_bucket_size: Union[int, str] = 50_000_000
    stage3_param_persistence_threshold: Union[int, str] = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    ignore_unused_parameters: bool = True
    round_robin_gradients: bool = False

    def __post_init__(self):
        if self.stage not in (0, 1, 2, 3):
            raise ConfigError(
                f"zero_optimization.stage must be 0-3, got {self.stage}")


# --------------------------------------------------------------------------- #
# Refused sub-trees (their own slices)
# --------------------------------------------------------------------------- #

@dataclass
class HybridEngineConfig(ConfigModel):
    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8
    ragged_cache_size: int = 4


@dataclass
class PipelineConfig(ConfigModel):
    stages: Union[int, str] = "auto"
    partition_method: str = "parameters"
    activation_checkpoint_interval: int = 0
    pipe_partitioned: bool = True
    grad_partitioned: bool = True


@dataclass
class ElasticityConfig(ConfigModel):
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    version: float = 0.2
    ignore_non_elastic_batch_info: bool = False
    num_gpus_per_node: int = 1
    model_parallel_size: int = 1


@dataclass
class WatchdogConfig(ConfigModel):
    enabled: bool = False
    stall_factor: float = 5.0
    check_interval_s: float = 2.0
    min_median_samples: int = 3
    min_stall_s: float = 10.0
    action: str = "log"
    heartbeat_file: Union[str, None] = None


@dataclass
class PreemptionConfig(ConfigModel):
    enabled: bool = False
    save_dir: Union[str, None] = None
    signals: List[str] = field(default_factory=lambda: ["SIGTERM"])


@dataclass
class ResilienceConfig(ConfigModel):
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    preemption: PreemptionConfig = field(default_factory=PreemptionConfig)


#: keys of the JAX package's config that this slice does not port, with
#: the value that leaves them off and the ROADMAP item that brings them.
#: A dict value counts as off when its "enabled" is false (or, for a
#: sub-tree without that key, when it is empty).
UNPORTED_KEYS: Dict[str, Any] = {
    "activation_checkpointing": ({}, "A7 (runtime/activation_checkpointing.py)"),
    "wall_clock_breakdown": (False, "A7 (the training observatory)"),
    "memory_breakdown": (False, "A7 (the training observatory)"),
    "dump_state": (False, "A7 (the training observatory)"),
    "curriculum_learning": ({}, "A7 (data_pipeline/)"),
    "checkpoint": ({}, "A7 (checkpoint/)"),
    "prescale_gradients": (False, "A8 (multi-device)"),
    "gradient_predivide_factor": (1.0, "A8 (multi-device)"),
    "prescale_gradients_factor": (1.0, "A8 (multi-device)"),
    "sparse_gradients": (False, "A8 (multi-device)"),
    "communication_data_type": (None, "A8 (multi-device)"),
    "disable_allgather": (False, "A8 (multi-device)"),
    "zero_allow_untested_optimizer": (True, "A8 (multi-device)"),
    "comms_logger": ({}, "A8 (comm/comms_logging.py)"),
    "gradient_compression": ({}, "A8 (1-bit compressed gradients)"),
    "mesh": ({}, "A8 (parallel/topology.py)"),
    "tensorboard": ({}, "A9 (monitor/)"),
    "wandb": ({}, "A9 (monitor/)"),
    "csv_monitor": ({}, "A9 (monitor/)"),
    "comet": ({}, "A9 (monitor/)"),
    "flops_profiler": ({}, "A9 (profiling/flops_profiler.py)"),
    "autotuning": ({}, "A9 (autotuning/)"),
    "aio": ({}, "A9 (io/, nvme/)"),
}


def _unported_is_on(key: str, value: Any, off: Any) -> bool:
    if isinstance(value, dict):
        if "enabled" in value:
            return bool(value["enabled"])
        if key == "mesh":   # a one-device mesh is what the port runs
            return any(not is_auto(v) and v != 1 for k, v in value.items()
                       if k in ("data", "model", "pipe", "seq", "expert"))
        return bool(value)
    if isinstance(off, dict):       # "tensorboard": true shorthand
        return bool(value)
    return value != off


# --------------------------------------------------------------------------- #
# Top-level
# --------------------------------------------------------------------------- #

@dataclass
class Config(ConfigModel):
    """Top-level config. Key names mirror ds_config JSON."""

    train_batch_size: Union[int, str, None] = None
    train_micro_batch_size_per_gpu: Union[int, str, None] = None
    gradient_accumulation_steps: Union[int, str, None] = None

    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)

    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    data_types: DataTypesConfig = field(default_factory=DataTypesConfig)

    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    gradient_clipping: float = 0.0

    steps_per_print: int = 10
    seed: int = 1234
    compile: bool = True              # eager engine: no effect (see above)

    hybrid_engine: HybridEngineConfig = field(
        default_factory=HybridEngineConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    elasticity: ElasticityConfig = field(default_factory=ElasticityConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    compression_training: Dict[str, Any] = field(default_factory=dict)

    DEPRECATED_ALIASES = {
        "train_micro_batch_size": "train_micro_batch_size_per_gpu"}

    @classmethod
    def load(cls, config: Union[str, Dict[str, Any], "Config", None]
             ) -> "Config":
        if config is None:
            return cls()
        if isinstance(config, Config):
            return config
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise ConfigError(f"config must be a dict, JSON path, or Config; "
                              f"got {type(config)}")
        refuse_unported(config)
        cfg = cls.from_dict({k: v for k, v in config.items()
                             if k not in UNPORTED_KEYS})
        cfg.refuse_unserved()
        return cfg

    def refuse_unserved(self) -> None:
        """Raise ``NotImplementedError`` for every enabled feature of the
        served sub-trees that this slice does not port."""
        z = self.zero_optimization
        for name, off in (("offload_optimizer", z.offload_optimizer),
                          ("offload_param", z.offload_param)):
            if off.device not in ("none", None):
                raise NotImplementedError(
                    f"zero_optimization.{name}.device={off.device!r} is not "
                    f"ported (ROADMAP A7: runtime/zero/offload.py)")
        if z.zero_quantized_weights or z.zero_quantized_gradients \
                or z.zero_hpz_partition_size > 1 or z.mics_shard_size > 0:
            raise NotImplementedError(
                "ZeRO++ (quantized collectives, hpZ, MiCS) is not ported "
                "(ROADMAP A8)")
        if self.compression_training:
            raise NotImplementedError(
                "compression_training is not ported (ROADMAP A9)")
        if self.hybrid_engine.enabled:
            raise NotImplementedError(
                "hybrid_engine is not ported (ROADMAP A8)")
        stages = self.pipeline.stages
        if not is_auto(stages) and stages not in (None, 1):
            raise NotImplementedError(
                "pipeline parallelism is not ported (ROADMAP A8)")
        if self.elasticity.enabled:
            raise NotImplementedError(
                "elasticity is not ported (ROADMAP A9)")
        if self.resilience.watchdog.enabled \
                or self.resilience.preemption.enabled:
            raise NotImplementedError(
                "the step watchdog and preemption are not ported "
                "(ROADMAP A6)")

    # ------------------------------------------------------------------ #
    # batch-size resolution: train_batch = micro * gas * dp_world
    # ------------------------------------------------------------------ #

    def resolve_batch_sizes(self, dp_world_size: int = 1) -> None:
        tb = None if is_auto(self.train_batch_size) else self.train_batch_size
        mb = (None if is_auto(self.train_micro_batch_size_per_gpu)
              else self.train_micro_batch_size_per_gpu)
        gas = (None if is_auto(self.gradient_accumulation_steps)
               else self.gradient_accumulation_steps)

        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise ConfigError(
                    f"train_batch_size ({tb}) != train_micro_batch_size_per_"
                    f"gpu ({mb}) * gradient_accumulation_steps ({gas}) * "
                    f"dp_world_size ({dp_world_size})")
        elif tb is not None and mb is not None:
            gas, rem = divmod(tb, mb * dp_world_size)
            if rem:
                raise ConfigError(
                    f"train_batch_size ({tb}) not divisible by micro_batch*dp "
                    f"({mb}*{dp_world_size})")
        elif tb is not None and gas is not None:
            mb, rem = divmod(tb, gas * dp_world_size)
            if rem:
                raise ConfigError(
                    f"train_batch_size ({tb}) not divisible by gas*dp "
                    f"({gas}*{dp_world_size})")
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp_world_size
        elif tb is not None:
            gas = 1
            mb, rem = divmod(tb, dp_world_size)
            if rem:
                raise ConfigError(
                    f"train_batch_size ({tb}) not divisible by dp_world_size "
                    f"({dp_world_size})")
        elif gas is not None:
            raise ConfigError(
                "gradient_accumulation_steps alone is not enough — also set "
                "train_batch_size or train_micro_batch_size_per_gpu")
        else:
            mb, gas = 1, 1
            tb = dp_world_size
            logger.warning("No batch sizes specified; defaulting "
                           "micro_batch=1, gas=1")

        self.train_batch_size = int(tb)
        self.train_micro_batch_size_per_gpu = int(mb)
        self.gradient_accumulation_steps = int(gas)
        for name, v in (("train_batch_size", tb),
                        ("train_micro_batch_size_per_gpu", mb),
                        ("gradient_accumulation_steps", gas)):
            if int(v) <= 0:
                raise ConfigError(f"{name} must be positive, got {v}")

    @property
    def precision_dtype(self) -> str:
        if self.fp16.enabled and self.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        if self.fp16.enabled:
            return "float16"
        if self.bf16.enabled:
            return "bfloat16"
        return "float32"


def refuse_unported(config: Dict[str, Any]) -> None:
    """Raise ``NotImplementedError`` for a JAX-package key this slice does
    not port, unless its value leaves the feature off."""
    for key, value in config.items():
        if key in UNPORTED_KEYS:
            off, item = UNPORTED_KEYS[key]
            if _unported_is_on(key, value, off):
                raise NotImplementedError(
                    f"config key '{key}' is not ported (ROADMAP {item})")
