"""Progressive layer drop (port of
``deepspeed_tpu/runtime/progressive_layer_drop.py``).

A global keep probability theta decays from 1 toward ``theta`` at rate
``gamma`` over the steps; a block is kept with the depth-scaled
probability ``1 - (1 - theta) (i + 1) / L`` (lower layers drop less) and,
when kept, scaled by its inverse. ``layer_keep_prob`` computes it in fp32,
as the JAX package does (``jnp.asarray(theta)`` with x64 off), so that
``stochastic_depth_block``'s draw, ``utils.random.bernoulli`` under the
caller's key, is ``jax.random.bernoulli``'s bit for bit. The blend is
branchless, as in the JAX package: ``h + keep * f(h) / max(p, 1e-6)``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Union

import torch

from ..utils import random as trandom


class ProgressiveLayerDrop:
    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = float(theta)
        self.gamma = float(gamma)
        self.current_theta = 1.0

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> float:
        self.current_theta = ((1.0 - self.theta)
                              * math.exp(-self.gamma * global_step)
                              + self.theta)
        return self.current_theta

    def get_state(self) -> Dict[str, float]:
        return {"progressive_layer_drop": True,
                "pld_theta": self.current_theta}


def layer_keep_prob(theta: Union[float, torch.Tensor], layer_idx: int,
                    num_layers: int) -> torch.Tensor:
    """Depth-scaled keep probability, a 0-d fp32 tensor (on ``theta``'s
    device when it is a tensor)."""
    t = torch.as_tensor(theta, dtype=torch.float32)
    return 1.0 - (1.0 - t) * float(layer_idx + 1) / float(num_layers)


def stochastic_depth_block(block_fn: Callable[[torch.Tensor], torch.Tensor],
                           h: torch.Tensor, key: torch.Tensor,
                           theta: Union[float, torch.Tensor],
                           layer_idx: int, num_layers: int,
                           deterministic: bool = False) -> torch.Tensor:
    """Residual block with PLD: ``h + keep * f(h) / p`` (the inverted
    scaling keeps the expectation, so evaluation needs no rescale);
    ``key`` is the block's threefry key (``utils/random.py``)."""
    if deterministic:
        return h + block_fn(h)
    p = layer_keep_prob(theta, layer_idx, num_layers).to(h.device)
    u = trandom.uniform(trandom.as_key(key).to(h.device), 1)[..., 0]
    keep = (u < p).to(h.dtype)
    return h + keep * block_fn(h) / torch.clamp(p, min=1e-6).to(h.dtype)
