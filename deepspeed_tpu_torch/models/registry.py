"""Architecture registry and HuggingFace config mapping (port of
``deepspeed_tpu/models/registry.py``).

Maps an architecture name, or a HuggingFace ``config.json``'s
``model_type``, to the port's model config. The port carries gpt2 (a
:class:`GPT2Config`), the entries that give a :class:`LlamaConfig`:
llama, mistral (``sliding_window``), qwen2 (``qkv_bias``), qwen (v1: its
own key names, ``intermediate_size`` counting both SwiGLU branches),
phi3, internlm and internlm2, the dense families opt, bloom, gpt_neox,
gptj, falcon and phi, and the MoE families mixtral and qwen2_moe (a
:class:`MixtralConfig`). The other architectures the JAX registry knows
(the encoders and diffusion models) raise ``NotImplementedError`` naming
the queue item that ports them, A9; an unknown name raises
``ValueError``, as the JAX registry does. Each entry's ``make_model`` is
the family's training entry point, ``(model, init_fn, loss_fn)`` for the
engine, as in the JAX registry.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

from .bloom import Bloom, BloomConfig
from .bloom import make_model as make_bloom
from .falcon import Falcon, FalconConfig
from .falcon import make_model as make_falcon
from .gpt2 import GPT2, GPT2Config
from .gpt2 import make_model as make_gpt2
from .gpt_neox import (GPTJ, GPTJConfig, GPTNeoX, GPTNeoXConfig,
                       make_model_gptj, make_model_neox)
from .llama import Llama, LlamaConfig
from .llama import make_model as make_llama
from .mixtral import Mixtral, MixtralConfig
from .mixtral import make_model as make_mixtral
from .opt import OPT, OPTConfig
from .opt import make_model as make_opt
from .phi import Phi, PhiConfig
from .phi import make_model as make_phi


class ArchEntry(NamedTuple):
    config_cls: type
    model_cls: type
    make_model: Callable
    from_hf: Callable[[Dict[str, Any]], Any]


def _hf_llama(d: Dict[str, Any], **extra) -> Dict[str, Any]:
    base = dict(
        vocab_size=d.get("vocab_size", 32000),
        max_seq_len=d.get("max_position_embeddings", 4096),
        num_layers=d.get("num_hidden_layers", 32),
        num_heads=d.get("num_attention_heads", 32),
        num_kv_heads=d.get("num_key_value_heads",
                           d.get("num_attention_heads", 32)),
        hidden_size=d.get("hidden_size", 4096),
        intermediate_size=d.get("intermediate_size", 11008),
        rope_theta=d.get("rope_theta", 10000.0),
        rms_eps=d.get("rms_norm_eps", 1e-5),
        tie_embeddings=d.get("tie_word_embeddings", False),
    )
    base.update(extra)
    return base


def _entry_gpt2(d):
    return GPT2Config(
        vocab_size=d.get("vocab_size", 50257),
        max_seq_len=d.get("n_positions", 1024),
        num_layers=d.get("n_layer", 12),
        num_heads=d.get("n_head", 12),
        hidden_size=d.get("n_embd", 768),
        layer_norm_eps=d.get("layer_norm_epsilon", 1e-5))


def _entry_llama(d):
    return LlamaConfig(**_hf_llama(d))


def _entry_mistral(d):
    return LlamaConfig(**_hf_llama(d, sliding_window=d.get("sliding_window")))


def _entry_qwen2(d):
    return LlamaConfig(**_hf_llama(d, qkv_bias=True))


def _entry_qwen(d):
    """Qwen v1 (the original Qwen-7B): llama-shaped with a biased fused
    qkv, whose ``intermediate_size`` counts both SwiGLU branches (each is
    half) and whose key names are its own (seq_length, rotary_emb_base,
    layer_norm_epsilon)."""
    return LlamaConfig(
        vocab_size=d.get("vocab_size", 151936),
        max_seq_len=d.get("seq_length", 8192),
        num_layers=d.get("num_hidden_layers", 32),
        num_heads=d.get("num_attention_heads", 32),
        num_kv_heads=d.get("num_attention_heads", 32),
        hidden_size=d.get("hidden_size", 4096),
        intermediate_size=d.get("intermediate_size", 22016) // 2,
        rope_theta=d.get("rotary_emb_base", 10000.0),
        rms_eps=d.get("layer_norm_epsilon", 1e-6),
        tie_embeddings=d.get("tie_word_embeddings", False),
        qkv_bias=True)


def _entry_phi3(d):
    # phi-3 is the llama architecture with fused qkv / gate_up tensors in
    # its checkpoint (the loader splits them)
    return LlamaConfig(**_hf_llama(d))


def _entry_internlm(d):
    """InternLM v1: llama-shaped. ``bias=True`` configs also put a bias
    on o_proj, which this model family does not carry: refused."""
    if d.get("bias", False):
        raise ValueError(
            "internlm configs with bias=True (o_proj bias) are not "
            "supported; bias=False checkpoints load as llama")
    return LlamaConfig(**_hf_llama(d))


def _entry_mixtral(d):
    return MixtralConfig(**_hf_llama(
        d,
        num_experts=d.get("num_local_experts", 8),
        experts_top_k=d.get("num_experts_per_tok", 2),
        router_aux_loss_coef=d.get("router_aux_loss_coef", 0.02)))


def _entry_qwen2_moe(d):
    """Qwen2-MoE: the Mixtral block with biased q/k/v and an always-on
    sigmoid-gated shared expert; the router's weights are the full
    softmax's unless ``norm_topk_prob``. Every layer must be sparse."""
    if int(d.get("decoder_sparse_step", 1)) != 1 or d.get("mlp_only_layers"):
        raise ValueError(
            "qwen2_moe configs with dense layers interleaved "
            "(decoder_sparse_step != 1 or mlp_only_layers) are not "
            "supported — every layer is treated as sparse MoE here")
    return MixtralConfig(**_hf_llama(
        d,
        qkv_bias=True,
        intermediate_size=d.get("moe_intermediate_size",
                                d.get("intermediate_size", 11008)),
        num_experts=d.get("num_experts", 8),
        experts_top_k=d.get("num_experts_per_tok", 2),
        shared_expert_size=d.get("shared_expert_intermediate_size", 0),
        norm_topk_prob=d.get("norm_topk_prob", False),
        router_aux_loss_coef=d.get("router_aux_loss_coef", 0.001)))


def _entry_opt(d):
    proj = d.get("word_embed_proj_dim")
    return OPTConfig(
        vocab_size=d.get("vocab_size", 50272),
        max_seq_len=d.get("max_position_embeddings", 2048),
        num_layers=d.get("num_hidden_layers", 12),
        num_heads=d.get("num_attention_heads", 12),
        hidden_size=d.get("hidden_size", 768),
        ffn_dim=d.get("ffn_dim", 3072),
        do_layer_norm_before=d.get("do_layer_norm_before", True),
        word_embed_proj_dim=(proj if proj and
                             proj != d.get("hidden_size", 768) else None),
        tie_embeddings=d.get("tie_word_embeddings", True))


def _entry_bloom(d):
    return BloomConfig(
        vocab_size=d.get("vocab_size", 250880),
        num_layers=d.get("n_layer", d.get("num_hidden_layers", 30)),
        num_heads=d.get("n_head", d.get("num_attention_heads", 32)),
        hidden_size=d.get("hidden_size", d.get("n_embed", 4096)),
        layer_norm_eps=d.get("layer_norm_epsilon", 1e-5),
        tie_embeddings=d.get("tie_word_embeddings", True))


def _entry_gpt_neox(d):
    return GPTNeoXConfig(
        vocab_size=d.get("vocab_size", 50432),
        max_seq_len=d.get("max_position_embeddings", 2048),
        num_layers=d.get("num_hidden_layers", 44),
        num_heads=d.get("num_attention_heads", 64),
        hidden_size=d.get("hidden_size", 6144),
        intermediate_size=d.get("intermediate_size", 24576),
        rotary_pct=d.get("rotary_pct", 0.25),
        rope_theta=d.get("rope_theta", d.get("rotary_emb_base", 10000.0)),
        layer_norm_eps=d.get("layer_norm_eps", 1e-5),
        use_parallel_residual=d.get("use_parallel_residual", True),
        tie_embeddings=d.get("tie_word_embeddings", False))


def _entry_gptj(d):
    return GPTJConfig(
        vocab_size=d.get("vocab_size", 50400),
        max_seq_len=d.get("n_positions", 2048),
        num_layers=d.get("n_layer", 28),
        num_heads=d.get("n_head", 16),
        hidden_size=d.get("n_embd", 4096),
        intermediate_size=d.get("n_inner") or 4 * d.get("n_embd", 4096),
        rotary_dim=d.get("rotary_dim", 64),
        layer_norm_eps=d.get("layer_norm_epsilon", 1e-5),
        tie_embeddings=d.get("tie_word_embeddings", False))


def _entry_falcon(d):
    new_arch = d.get("new_decoder_architecture", False)
    return FalconConfig(
        vocab_size=d.get("vocab_size", 65024),
        max_seq_len=d.get("max_position_embeddings", 2048),
        num_layers=d.get("num_hidden_layers", 32),
        num_heads=d.get("num_attention_heads", 71),
        num_kv_heads=(d.get("num_kv_heads", 8) if new_arch
                      else (d.get("num_attention_heads", 71)
                            if not d.get("multi_query", True) else 1)),
        hidden_size=d.get("hidden_size", 4544),
        alibi=d.get("alibi", False),
        parallel_attn=d.get("parallel_attn", True),
        new_decoder_architecture=new_arch,
        tie_embeddings=d.get("tie_word_embeddings", True))


def _entry_phi(d):
    return PhiConfig(
        vocab_size=d.get("vocab_size", 51200),
        max_seq_len=d.get("max_position_embeddings", 2048),
        num_layers=d.get("num_hidden_layers", 24),
        num_heads=d.get("num_attention_heads", 32),
        hidden_size=d.get("hidden_size", 2048),
        intermediate_size=d.get("intermediate_size", 8192),
        rotary_fraction=d.get("partial_rotary_factor", 0.5),
        rope_theta=d.get("rope_theta", 10000.0))


ARCHITECTURES: Dict[str, ArchEntry] = {
    "gpt2": ArchEntry(GPT2Config, GPT2, make_gpt2, _entry_gpt2),
    "llama": ArchEntry(LlamaConfig, Llama, make_llama, _entry_llama),
    "mistral": ArchEntry(LlamaConfig, Llama, make_llama, _entry_mistral),
    "qwen": ArchEntry(LlamaConfig, Llama, make_llama, _entry_qwen),
    "qwen2": ArchEntry(LlamaConfig, Llama, make_llama, _entry_qwen2),
    "phi3": ArchEntry(LlamaConfig, Llama, make_llama, _entry_phi3),
    "internlm": ArchEntry(LlamaConfig, Llama, make_llama, _entry_internlm),
    "internlm2": ArchEntry(LlamaConfig, Llama, make_llama, _entry_llama),
    "mixtral": ArchEntry(MixtralConfig, Mixtral, make_mixtral,
                         _entry_mixtral),
    "qwen2_moe": ArchEntry(MixtralConfig, Mixtral, make_mixtral,
                           _entry_qwen2_moe),
    "opt": ArchEntry(OPTConfig, OPT, make_opt, _entry_opt),
    "bloom": ArchEntry(BloomConfig, Bloom, make_bloom, _entry_bloom),
    "gpt_neox": ArchEntry(GPTNeoXConfig, GPTNeoX, make_model_neox,
                          _entry_gpt_neox),
    "gptj": ArchEntry(GPTJConfig, GPTJ, make_model_gptj, _entry_gptj),
    "falcon": ArchEntry(FalconConfig, Falcon, make_falcon, _entry_falcon),
    "phi": ArchEntry(PhiConfig, Phi, make_phi, _entry_phi),
}

#: the JAX registry's other architectures, each with the queue item
#: (ROADMAP.md) that ports its model: the encoders and the diffusion
#: models (A9)
NOT_PORTED: Dict[str, str] = {
    a: "A9" for a in ("bert", "distilbert", "gpt_neo",
                      "unet2dconditionmodel", "autoencoderkl")}


def get_arch(name: str) -> ArchEntry:
    key = name.lower()
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (queue item "
            f"{NOT_PORTED[key]}); ported: {sorted(ARCHITECTURES)}")
    try:
        return ARCHITECTURES[key]
    except KeyError:
        raise ValueError(f"unknown architecture {name!r}; known: "
                         f"{sorted(set(ARCHITECTURES) | set(NOT_PORTED))}")


def config_from_hf(hf_config: Dict[str, Any]):
    """The port's model config from a HuggingFace config dict (the
    ``json.load`` of a ``config.json``). Returns (arch_name, config)."""
    mt = hf_config.get("model_type")
    if mt is None:
        raise ValueError("hf config missing 'model_type'")
    entry = get_arch(mt)
    return mt.lower(), entry.from_hf(hf_config)
