from .jax_params import (family_params_from_numpy, gpt2_param_shapes,
                         gpt2_params_from_numpy, init_family_params,
                         init_gpt2_params, init_llama_params,
                         llama_param_shapes, llama_params_from_numpy,
                         init_moe_params, mixtral_param_shapes,
                         moe_param_shapes, moe_params_from_numpy,
                         param_shapes, woq_params_from_numpy)

__all__ = ["family_params_from_numpy", "gpt2_param_shapes",
           "gpt2_params_from_numpy", "init_family_params", "init_gpt2_params",
           "init_llama_params", "llama_param_shapes",
           "llama_params_from_numpy", "mixtral_param_shapes",
           "init_moe_params", "moe_param_shapes", "moe_params_from_numpy",
           "param_shapes",
           "woq_params_from_numpy"]
