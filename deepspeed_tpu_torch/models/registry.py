"""Architecture registry and HuggingFace config mapping (port of
``deepspeed_tpu/models/registry.py``).

Maps an architecture name, or a HuggingFace ``config.json``'s
``model_type``, to the port's model config. The port carries gpt2 (a
:class:`GPT2Config`) and the entries that give a :class:`LlamaConfig`:
llama, mistral (``sliding_window``), qwen2 (``qkv_bias``), qwen (v1: its
own key names, ``intermediate_size`` counting both SwiGLU branches),
phi3, internlm and internlm2. The other
architectures the JAX registry knows raise ``NotImplementedError`` naming
the queue item that ports their models; an unknown name raises
``ValueError``, as the JAX registry does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

from .gpt2 import GPT2, GPT2Config
from .llama import Llama, LlamaConfig


class ArchEntry(NamedTuple):
    config_cls: type
    model_cls: type
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


ARCHITECTURES: Dict[str, ArchEntry] = {
    "gpt2": ArchEntry(GPT2Config, GPT2, _entry_gpt2),
    "llama": ArchEntry(LlamaConfig, Llama, _entry_llama),
    "mistral": ArchEntry(LlamaConfig, Llama, _entry_mistral),
    "qwen": ArchEntry(LlamaConfig, Llama, _entry_qwen),
    "qwen2": ArchEntry(LlamaConfig, Llama, _entry_qwen2),
    "phi3": ArchEntry(LlamaConfig, Llama, _entry_phi3),
    "internlm": ArchEntry(LlamaConfig, Llama, _entry_internlm),
    "internlm2": ArchEntry(LlamaConfig, Llama, _entry_llama),
}

#: the JAX registry's other architectures, each with the queue item
#: (ROADMAP.md) that ports its model
NOT_PORTED: Dict[str, str] = {
    **{a: "A5.4" for a in ("opt", "bloom", "gpt_neox", "gptj", "falcon",
                            "phi", "mixtral", "qwen2_moe")},
    **{a: "A9" for a in ("bert", "distilbert", "gpt_neo",
                          "unet2dconditionmodel", "autoencoderkl")},
}


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
