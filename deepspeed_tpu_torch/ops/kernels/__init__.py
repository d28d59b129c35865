"""Hand-written Hopper kernels of the port, each beside its plain version.

Kernels build on first launch (``_build.py``), never at import time."""

from .paged_attention import (LAUNCHES, flash_paged_attention,
                              paged_attention_plain, paged_decode,
                              paged_prefill, reset_launch_counts)

__all__ = ["LAUNCHES", "flash_paged_attention", "paged_attention_plain",
           "paged_decode", "paged_prefill", "reset_launch_counts"]
