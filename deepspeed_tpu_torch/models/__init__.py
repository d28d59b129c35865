from .llama import Llama, LlamaConfig, apply_rope, rope_frequencies

__all__ = ["Llama", "LlamaConfig", "apply_rope", "rope_frequencies"]
