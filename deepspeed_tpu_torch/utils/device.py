"""Device resolution (the port runs on the card unless asked otherwise),
and the per-card state the CUDA kernels' wrappers keep across calls."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Asking for ``cuda`` without a card raises —
    nothing quietly continues on the CPU; pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


_SMS: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    idx = _index(device)
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


#: per (device, stream): an fp32 workspace and zeroed int32 counters for
#: the kernels that merge their splits across blocks, grown on demand;
#: each such kernel leaves the counters at zero
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def scratch(device: torch.device, stream: int, n_floats: int,
            n_counters: int) -> Tuple[int, int]:
    """Data pointers of a workspace of ``n_floats`` fp32 and of
    ``n_counters`` zeroed int32 counters for kernels on ``stream``, which
    run one at a time, so that one buffer serves them all."""
    key = (_index(device), stream)
    ws, cnt = _SCRATCH.get(key, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(n_floats, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros(n_counters, dtype=torch.int32, device=device)
    _SCRATCH[key] = (ws, cnt)
    return ws.data_ptr(), cnt.data_ptr()
