"""Ragged engine configuration (port of ``deepspeed_tpu/inference/v2/config.py``).

Every field of the JAX dataclass, with its default and its validation.
Features the port does not have yet are refused here, at construction,
with the knob's name and queue item: ``tp_size`` / ``seq_size`` /
``ep_size`` > 1 and any value but the default of the multi-device comm
knobs (``tp_quantized_comm``, ``tp_comm_overlap``, ``tp_comm_chunks``,
``ep_comm_overlap``, ``ep_comm_chunks``, ``ep_capacity_factor``) raise
``NotImplementedError`` naming A8. ``greedy``, ``temperature`` and
``top_k`` are accepted and never read, as in the JAX package's v2 engine
(``generate`` takes its sampling as an argument). The JAX package's
``DSTPU_*`` environment overrides are not ported (A9).

``spec_decode`` / ``spec_k`` / ``spec_ngram`` arm speculative decoding
for greedy sequences (``speculative.py``): "ngram" self-drafts from the
sequence's own history, "draft" proposes with a small model paired by
``InferenceEngineV2.attach_draft``.

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

#: the JAX package's ``comm.TP_OVERLAP_MODES``
TP_OVERLAP_MODES = ("off", "rs_ag", "rs_ag_chunked")

#: the multi-device comm knobs and their defaults: any other value is
#: refused (A8)
_MULTI_DEVICE_DEFAULTS = {
    "ep_comm_overlap": "off", "ep_comm_chunks": 2,
    "ep_capacity_factor": 2.0, "tp_quantized_comm": False,
    "tp_comm_overlap": "off", "tp_comm_chunks": 2}


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
    # expert-parallel dispatch / combine overlap ("off" or "chunked"),
    # its chunk count and the dispatch capacity slack (A8)
    ep_comm_overlap: str = "off"
    ep_comm_chunks: int = 2
    ep_capacity_factor: float = 2.0
    # int8 TP all-reduces, decomposed TP collectives ("off", "rs_ag",
    # "rs_ag_chunked") and their chunk count (A8)
    tp_quantized_comm: bool = False
    tp_comm_overlap: str = "off"
    tp_comm_chunks: int = 2
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
    # speculative decoding of greedy sequences (speculative.py): "off",
    # "ngram" (prompt-lookup self-drafting) or "draft" (a small model
    # paired by attach_draft); drafts a sequence a round, and the n-gram
    # width the ngram proposer matches
    spec_decode: str = "off"
    spec_k: int = 4
    spec_ngram: int = 3
    # the JAX package's sampling defaults: accepted, never read (generate
    # takes its sampling as an argument)
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0
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
                    f"(queue item A8; set {knob}=1)")
        if self.ep_comm_overlap not in ("off", "chunked"):
            raise ValueError(
                f"ep_comm_overlap must be 'off' or 'chunked', got "
                f"{self.ep_comm_overlap!r}")
        if self.ep_comm_chunks < 1:
            raise ValueError(
                f"ep_comm_chunks must be >= 1, got {self.ep_comm_chunks}")
        if self.ep_capacity_factor <= 0:
            raise ValueError(
                f"ep_capacity_factor must be > 0, got "
                f"{self.ep_capacity_factor}")
        if self.tp_comm_overlap not in TP_OVERLAP_MODES:
            raise ValueError(
                f"tp_comm_overlap must be one of {TP_OVERLAP_MODES}, "
                f"got {self.tp_comm_overlap!r}")
        if self.tp_comm_chunks < 1:
            raise ValueError(
                f"tp_comm_chunks must be >= 1, got {self.tp_comm_chunks}")
        for knob, default in _MULTI_DEVICE_DEFAULTS.items():
            v = getattr(self, knob)
            if v != default:
                raise NotImplementedError(
                    f"{knob}={v!r}: multi-device serving is not ported yet "
                    f"(queue item A8; leave it at {default!r})")
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
        if self.spec_decode not in ("off", "ngram", "draft"):
            raise ValueError(
                f"spec_decode must be 'off', 'ngram' or 'draft', got "
                f"{self.spec_decode!r}")
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.spec_ngram < 1:
            raise ValueError(
                f"spec_ngram must be >= 1, got {self.spec_ngram}")
        if self.decode_loop_steps < 0:
            raise ValueError(
                f"decode_loop_steps must be >= 0, got "
                f"{self.decode_loop_steps}")

    def validate(self, model_cfg=None) -> None:
        """Config x model checks, run at engine construction: the model
        needs a ported ragged runner. Accepted: ``LlamaConfig`` (llama,
        mistral, qwen, qwen2, phi3, internlm) and its subclass
        ``MixtralConfig`` (mixtral, qwen2_moe), ``GPT2Config``,
        ``OPTConfig``, ``BloomConfig``, ``GPTNeoXConfig``, ``GPTJConfig``,
        ``FalconConfig`` and ``PhiConfig``: every config the JAX engine
        serves. Any other raises ValueError."""
        if model_cfg is None:
            return
        from ...models.bloom import BloomConfig
        from ...models.falcon import FalconConfig
        from ...models.gpt2 import GPT2Config
        from ...models.gpt_neox import GPTJConfig, GPTNeoXConfig
        from ...models.llama import LlamaConfig
        from ...models.opt import OPTConfig
        from ...models.phi import PhiConfig
        if not isinstance(model_cfg, (LlamaConfig, GPT2Config, OPTConfig,
                                      BloomConfig, GPTNeoXConfig,
                                      GPTJConfig, FalconConfig, PhiConfig)):
            raise ValueError(
                f"{type(model_cfg).__name__}: no ragged runner serves this "
                f"model config")

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
