"""Hand-written Hopper kernels of the port, each beside its plain version.

Kernels build on first launch (``_build.py``), never at import time."""

from . import (evoformer, flash_attention, fp6_gemm, fused_optimizer,
               normalization, quantization)
from .evoformer import evoformer_flash, evoformer_flash_plain
from .flash_attention import (flash_attention_sparse,
                              flash_attention_sparse_plain)
from .fp6_gemm import (Fp6GemmWeight, fp6_gemm_pack, fp6_gemm_unpack,
                       fp6_matmul, fp6_matmul_plain)
from .paged_attention import (LAUNCHES, flash_paged_attention,
                              paged_attention_plain, paged_decode,
                              paged_prefill, reset_launch_counts)
from .fused_optimizer import (adamw_reference, fused_adamw_update,
                              fused_adamw_update_plain)
from .normalization import (fused_layer_norm, fused_rms_norm,
                            layer_norm_plain, rms_norm_plain)
from .quantization import (QuantizedTensor, dequantize_blockwise, pack_int4,
                           quant_dequant, quantize_blockwise,
                           quantize_blockwise_plain, unpack_int4)

__all__ = ["Fp6GemmWeight", "LAUNCHES", "QuantizedTensor",
           "adamw_reference", "dequantize_blockwise", "evoformer",
           "evoformer_flash", "evoformer_flash_plain", "flash_attention",
           "flash_attention_sparse", "flash_attention_sparse_plain",
           "flash_paged_attention", "fp6_gemm", "fp6_gemm_pack",
           "fp6_gemm_unpack", "fp6_matmul", "fp6_matmul_plain",
           "fused_adamw_update", "fused_adamw_update_plain",
           "fused_layer_norm", "fused_optimizer", "fused_rms_norm",
           "layer_norm_plain", "normalization", "pack_int4",
           "paged_attention_plain", "paged_decode", "paged_prefill",
           "quant_dequant", "quantization", "quantize_blockwise",
           "quantize_blockwise_plain", "reset_launch_counts",
           "rms_norm_plain", "unpack_int4"]
