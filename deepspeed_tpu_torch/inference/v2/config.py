"""Ragged engine configuration (port of ``deepspeed_tpu/inference/v2/config.py``).

Only the fields this port reads. Features the port does not have yet are
refused here, at construction, with the knob's name:

- ``tp_size`` / ``seq_size`` / ``ep_size`` > 1 (multi-device serving);
- ``prefix_cache=True``.

``serve_pipeline_depth`` is the JAX package's: the number of steps the
serve loop plans and dispatches ahead of the oldest step's commit (2 by
default); 0 is the synchronous path, the parity oracle.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RaggedInferenceConfig:
    # scheduler shape: slots per batch x max tokens per slot per step
    max_seqs: int = 8
    chunk_size: int = 128             # Dynamic-SplitFuse token chunk per seq
    # KV pool
    block_size: int = 64
    num_blocks: int = 256             # pool size (blocks of block_size tokens)
    max_blocks_per_seq: int = 32      # width of the block table
    dtype: str = "bfloat16"           # KV pool dtype
    # "auto" = dtype; "int8": int8 rows with per-(token, KV head) f32
    # scales (kv_quant.py)
    kv_cache_dtype: str = "auto"
    # "auto": the CUDA paged kernels on a card, the dense gather-and-mask
    # path on the CPU; "paged_flash" / "dense" force one.
    attention_impl: str = "auto"
    tp_size: int = 1
    seq_size: int = 1
    ep_size: int = 1
    prefix_cache: bool = False
    # steps planned and dispatched ahead of the oldest commit; 0 plans,
    # dispatches and commits each step in turn
    serve_pipeline_depth: int = 2
    # tokens generated per decode_loop call (one host sync per call);
    # 0/1 sends every token through put()
    decode_loop_steps: int = 16

    def __post_init__(self):
        if self.max_seqs <= 0 or self.chunk_size <= 0:
            raise ValueError("max_seqs and chunk_size must be positive")
        if self.block_size <= 0 or self.num_blocks <= 0:
            raise ValueError("block_size and num_blocks must be positive")
        if self.max_blocks_per_seq <= 0:
            raise ValueError("max_blocks_per_seq must be positive")
        if self.attention_impl not in ("auto", "paged_flash", "dense"):
            raise ValueError(
                f"attention_impl must be 'auto', 'paged_flash' or 'dense', "
                f"got {self.attention_impl!r}")
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'auto' or 'int8', got "
                f"{self.kv_cache_dtype!r}")
        for knob in ("tp_size", "seq_size", "ep_size"):
            v = getattr(self, knob)
            if v < 1:
                raise ValueError(f"{knob} must be >= 1, got {v}")
            if v > 1:
                raise NotImplementedError(
                    f"{knob}={v}: multi-device serving is not ported yet "
                    f"(set {knob}=1)")
        if self.prefix_cache:
            raise NotImplementedError(
                "prefix_cache=True is not ported yet")
        if self.serve_pipeline_depth < 0:
            raise ValueError(
                f"serve_pipeline_depth must be >= 0 (0 = synchronous), "
                f"got {self.serve_pipeline_depth}")
        if self.decode_loop_steps < 0:
            raise ValueError(
                f"decode_loop_steps must be >= 0, got "
                f"{self.decode_loop_steps}")

    def validate(self, model_cfg=None) -> None:
        """Config x model checks, run at engine construction."""
        if model_cfg is None:
            return
        from ...models.llama import LlamaConfig
        if not isinstance(model_cfg, LlamaConfig):
            raise NotImplementedError(
                f"{type(model_cfg).__name__}: only the dense Llama runner "
                f"is ported")

    @property
    def max_context(self) -> int:
        return self.max_blocks_per_seq * self.block_size
