from .jax_params import (gpt2_param_shapes, gpt2_params_from_numpy,
                         init_gpt2_params, init_llama_params,
                         llama_param_shapes, llama_params_from_numpy,
                         woq_params_from_numpy)

__all__ = ["gpt2_param_shapes", "gpt2_params_from_numpy", "init_gpt2_params",
           "init_llama_params", "llama_param_shapes",
           "llama_params_from_numpy", "woq_params_from_numpy"]
