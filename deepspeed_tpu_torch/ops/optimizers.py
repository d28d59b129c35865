"""Optimizer factory (port of ``deepspeed_tpu/ops/optimizers.py``, the
Adam/AdamW part).

The JAX package builds optax transformations. The port keeps optax's
semantics in a functional update over a list of tensors:

- ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``;
- bias correction by the optimizer's own count ``t`` (1 at the first
  update): ``mu_hat = mu / (1 - b1^t)``, ``nu_hat = nu / (1 - b2^t)``;
- ``u = mu_hat / (sqrt(nu_hat) + eps)`` (eps outside the sqrt);
- AdamW adds ``weight_decay * p`` to u for every parameter (no mask);
  classic Adam with L2 (``adam_w_mode=False``) adds it to g first;
- ``p -= lr * u`` with ``lr = schedule(count)`` read before the count
  advances.

The update runs in place (``torch._foreach_*``) on the fp32 master
params and moments, which the JAX package cannot do; it saves one copy of
each. The engine does not call it on an fp16 overflow step, so the count
does not advance there, as when the JAX engine keeps the old state.

Lamb, Lion, Adagrad, SGD, the 1-bit optimizers and ``moment_dtype`` raise
``NotImplementedError`` (ROADMAP A7).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import torch

ScalarOrSchedule = Union[float, Callable[[int], float]]

ADAM_NAMES = ("adam", "fusedadam", "muadam")
ADAMW_NAMES = ("adamw", "fusedadamw", "muadamw", "cpuadam",
               "deepspeedcpuadam")
UNPORTED_NAMES = ("lamb", "fusedlamb", "lion", "fusedlion", "adagrad", "sgd",
                  "musgd", "onebitadam", "zerooneadam", "onebitlamb")
#: tensors per foreach group: bounds the update's temporaries
GROUP = 64


class AdamState(NamedTuple):
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class Adam:
    """Adam (``decoupled=False``: L2 decay folded into the gradient) or
    AdamW (``decoupled=True``) with optax's arithmetic."""

    def __init__(self, learning_rate: ScalarOrSchedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.decoupled = decoupled

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    def update(self, grads: List[torch.Tensor], state: AdamState,
               params: List[torch.Tensor]) -> AdamState:
        """Update ``params`` and the moments in place; return the state
        with the count advanced."""
        t = state.count + 1
        lr = self.lr(state.count)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        wd = self.weight_decay
        for at in range(0, len(params), GROUP):
            sl = slice(at, at + GROUP)
            p, g, mu, nu = params[sl], grads[sl], state.mu[sl], state.nu[sl]
            if wd and not self.decoupled:
                g = torch._foreach_add(g, p, alpha=wd)
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            if wd and self.decoupled:
                torch._foreach_add_(u, p, alpha=wd)
            torch._foreach_add_(p, u, alpha=-lr)
        return AdamState(count=t, mu=state.mu, nu=state.nu)


def _betas(params: Dict[str, Any], default=(0.9, 0.999)):
    betas = params.get("betas", default)
    return float(betas[0]), float(betas[1])


def build_optimizer(opt_type: str, opt_params: Dict[str, Any],
                    learning_rate: Optional[ScalarOrSchedule] = None
                    ) -> Adam:
    """An optimizer from a ds_config ``optimizer`` block. ``learning_rate``
    (a float or a step -> lr schedule) overrides ``opt_params["lr"]``."""
    params = dict(opt_params)
    lr = learning_rate if learning_rate is not None \
        else params.get("lr", 1e-3)
    wd = float(params.get("weight_decay", 0.0))
    eps = float(params.get("eps", 1e-8))
    name = opt_type.lower()
    if name in ADAM_NAMES + ADAMW_NAMES:
        if params.get("moment_dtype"):
            raise NotImplementedError(
                "moment_dtype (compact AdamW moments) is not ported "
                "(ROADMAP A7)")
        b1, b2 = _betas(params)
        # FusedAdam defaults adam_w_mode=True; the AdamW names ignore it
        decoupled = name in ADAMW_NAMES or bool(params.get("adam_w_mode",
                                                           True))
        return Adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                    decoupled=decoupled)
    if name in UNPORTED_NAMES:
        raise NotImplementedError(
            f"optimizer '{opt_type}' is not ported (ROADMAP A7; this slice "
            f"has Adam and AdamW)")
    raise ValueError(f"Unknown optimizer type '{opt_type}'")
