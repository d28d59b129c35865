"""Hand-written Hopper kernels of the port, each beside its plain version.

Kernels build on first launch (``_build.py``), never at import time."""

from . import fp6_gemm, quantization
from .fp6_gemm import (Fp6GemmWeight, fp6_gemm_pack, fp6_gemm_unpack,
                       fp6_matmul, fp6_matmul_plain)
from .paged_attention import (LAUNCHES, flash_paged_attention,
                              paged_attention_plain, paged_decode,
                              paged_prefill, reset_launch_counts)
from .quantization import (QuantizedTensor, dequantize_blockwise, pack_int4,
                           quant_dequant, quantize_blockwise,
                           quantize_blockwise_plain, unpack_int4)

__all__ = ["Fp6GemmWeight", "LAUNCHES", "QuantizedTensor",
           "dequantize_blockwise", "flash_paged_attention", "fp6_gemm",
           "fp6_gemm_pack", "fp6_gemm_unpack", "fp6_matmul",
           "fp6_matmul_plain", "pack_int4", "paged_attention_plain",
           "paged_decode", "paged_prefill", "quant_dequant", "quantization",
           "quantize_blockwise", "quantize_blockwise_plain",
           "reset_launch_counts", "unpack_int4"]
