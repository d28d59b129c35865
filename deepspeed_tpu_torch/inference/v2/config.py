"""Ragged engine configuration (port of ``deepspeed_tpu/inference/v2/config.py``).

Only the fields this port reads. Features the port does not have yet are
refused here, at construction, with the knob's name: ``tp_size`` /
``seq_size`` / ``ep_size`` > 1 (multi-device serving, A8). The JAX
package's ``DSTPU_*`` environment overrides are not ported (A9).

``serve_pipeline_depth`` is the JAX package's: the number of steps the
serve loop plans and dispatches ahead of the oldest step's commit (2 by
default); 0 is the synchronous path, the parity oracle.

``prefill_chunk_cap`` and ``max_batch_tokens`` shape the SplitFuse step
as the JAX package's do: a prefill chunk is ``effective_chunk`` =
min(chunk_size, prefill_chunk_cap) tokens, and a step's prefill chunks
together take at most ``token_budget`` tokens.
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
    # cap on the SplitFuse prefill chunk scheduled (and on the step's
    # token width): min(chunk_size, cap); 0 disables the cap
    prefill_chunk_cap: int = 256
    # SplitFuse forward budget: prefill tokens a step (decode rows always
    # fit); 0 = max_seqs * chunk_size
    max_batch_tokens: int = 32768
    # automatic prefix caching (prefix_cache.py): full KV blocks indexed
    # by the token chain that wrote them, shared by refcount
    prefix_cache: bool = False
    # cap on cached device blocks (0 = bounded by the pool only)
    prefix_cache_max_blocks: int = 0
    # eviction order among refcount-0 cached blocks: "lru" or "fifo"
    prefix_cache_policy: str = "lru"
    # blocks of the host-memory tier (0 = off): reserve pressure demotes
    # refcount-0 cached blocks to host memory instead of destroying them
    prefix_cache_host_blocks: int = 0
    # per-request deadline in seconds from admission (0 = none); an
    # expired request is aborted with a rejection record
    request_deadline_s: float = 0.0
    # bounded retry of a step dispatch that raises an I/O-class error
    serve_step_retries: int = 2
    serve_retry_backoff_s: float = 0.05
    # load shedding: a starved scheduler aborts the cheapest victim with
    # a rejection record (False: raise)
    serve_shed: bool = True
    # write-ahead replay journal path ("" = off; drain.py)
    serve_journal: str = ""
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
        if self.prefill_chunk_cap < 0:
            raise ValueError(
                f"prefill_chunk_cap must be >= 0 (0 = uncapped), got "
                f"{self.prefill_chunk_cap}")
        if self.prefix_cache_policy not in ("lru", "fifo"):
            raise ValueError(
                f"prefix_cache_policy must be 'lru' or 'fifo', got "
                f"{self.prefix_cache_policy!r}")
        if self.prefix_cache_max_blocks < 0:
            raise ValueError(
                f"prefix_cache_max_blocks must be >= 0 (0 = pool-bounded), "
                f"got {self.prefix_cache_max_blocks}")
        if self.prefix_cache_host_blocks < 0:
            raise ValueError(
                f"prefix_cache_host_blocks must be >= 0 (0 = host tier "
                f"off), got {self.prefix_cache_host_blocks}")
        if self.request_deadline_s < 0:
            raise ValueError(
                f"request_deadline_s must be >= 0 (0 = no deadlines), "
                f"got {self.request_deadline_s}")
        if self.serve_step_retries < 0:
            raise ValueError(
                f"serve_step_retries must be >= 0, got "
                f"{self.serve_step_retries}")
        if self.serve_retry_backoff_s < 0:
            raise ValueError(
                f"serve_retry_backoff_s must be >= 0, got "
                f"{self.serve_retry_backoff_s}")
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

    @property
    def effective_chunk(self) -> int:
        """The prefill chunk the scheduler cuts and the width of a
        prefill step: min(chunk_size, prefill_chunk_cap)."""
        if self.prefill_chunk_cap > 0:
            return min(self.chunk_size, self.prefill_chunk_cap)
        return self.chunk_size

    @property
    def token_budget(self) -> int:
        """Prefill tokens one step may carry."""
        if self.max_batch_tokens and self.max_batch_tokens > 0:
            return min(self.max_batch_tokens,
                       self.max_seqs * self.chunk_size)
        return self.max_seqs * self.chunk_size
