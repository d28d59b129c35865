from .gpt2 import GPT2, GPT2Config
from .llama import Llama, LlamaConfig, apply_rope, rope_frequencies

__all__ = ["GPT2", "GPT2Config", "Llama", "LlamaConfig", "apply_rope",
           "rope_frequencies"]
