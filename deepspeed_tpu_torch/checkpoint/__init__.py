from .jax_params import (init_llama_params, llama_param_shapes,
                         llama_params_from_numpy)

__all__ = ["init_llama_params", "llama_param_shapes",
           "llama_params_from_numpy"]
