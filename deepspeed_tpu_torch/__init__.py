"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package ``deepspeed_tpu`` is the reference; this package mirrors
its module paths (``deepspeed_tpu_torch/inference/v2/engine_v2.py`` is the
counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py``) and imports
neither JAX nor the JAX package. Hot-path kernels are hand-written CUDA
under ``ops/kernels/csrc/``, built with nvcc on first use — never at
import time.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back.
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
