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

``moment_dtype`` on an AdamW name gives :class:`CompactAdamW`, the JAX
package's ``adamw_compact``: the moments stored in that dtype (the second
as its square root), the arithmetic in fp32, the update cast to each
parameter's dtype. Lamb, Lion, Adagrad, SGD, the 1-bit optimizers and
``moment_dtype`` on an Adam name raise ``NotImplementedError`` (ROADMAP
A7).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import torch

from ..utils.dtypes import resolve_dtype

ScalarOrSchedule = Union[float, Callable[[int], float]]

ADAM_NAMES = ("adam", "fusedadam", "muadam")
ADAMW_NAMES = ("adamw", "fusedadamw", "muadamw", "cpuadam",
               "deepspeedcpuadam")
UNPORTED_NAMES = ("lamb", "fusedlamb", "lion", "fusedlion", "adagrad", "sgd",
                  "musgd", "onebitadam", "zerooneadam", "onebitlamb")
#: tensors per foreach group: bounds the update's temporaries
GROUP = 64
#: elements per foreach group of the compact AdamW (its fp32 copies)
GROUP_ELEMS = 1 << 27


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


class CompactAdamW(Adam):
    """AdamW with the moments stored in ``moment_dtype`` (port of
    ``adamw_compact``): ``mu`` as itself, ``nu`` as ``sqrt(nu)``; each
    update reads the stored moments back to fp32, advances them, stores
    them, and computes ``u = (mu / c1) / (sqrt(nu / c2) + eps) + wd * p``
    from the stored (rounded) values, with ``c1 = 1 - b1^t`` and
    ``c2 = 1 - b2^t`` in fp32 as the JAX function computes them; then
    ``p += (-lr * u)`` cast to the parameter's dtype, in place.

    The arithmetic runs as ``torch._foreach_*`` ops over fp32 copies of
    groups of same-dtype tensors (at most :data:`GROUP_ELEMS` elements a
    group, which bounds the temporaries), not tensor by tensor: a 1.3B
    GPT-2 has ~390 tensors and some 27 ops each."""

    def __init__(self, learning_rate: ScalarOrSchedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 moment_dtype: torch.dtype = torch.bfloat16):
        super().__init__(learning_rate, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, decoupled=True)
        self.moment_dtype = moment_dtype

    def init(self, params: List[torch.Tensor]) -> AdamState:
        z = [torch.zeros_like(p, dtype=self.moment_dtype) for p in params]
        return AdamState(count=0, mu=z,
                         nu=[torch.zeros_like(m) for m in z])

    def update(self, grads: List[torch.Tensor], state: AdamState,
               params: List[torch.Tensor]) -> AdamState:
        t = state.count + 1
        lr = self.lr(state.count)
        tf = torch.tensor(float(t), dtype=torch.float32)
        c1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** tf)
        c2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** tf)
        for idx in _groups(params, GROUP_ELEMS):
            g, m, s, p = ([x[i] for i in idx] for x in
                          (grads, state.mu, state.nu, params))
            m32, v32, g32 = _fp32(m), _fp32(s), _fp32(g)
            torch._foreach_mul_(m32, self.b1)                 # mu
            torch._foreach_mul_(g32, 1 - self.b1)
            torch._foreach_add_(m32, g32)
            torch._foreach_copy_(g32, g)                      # nu
            torch._foreach_mul_(g32, g32)
            torch._foreach_mul_(g32, 1 - self.b2)
            torch._foreach_mul_(v32, v32)
            torch._foreach_mul_(v32, self.b2)
            torch._foreach_add_(v32, g32)
            torch._foreach_sqrt_(v32)
            torch._foreach_copy_(m, m32)                      # store, and
            torch._foreach_copy_(s, v32)                      # read back
            torch._foreach_copy_(m32, m)
            torch._foreach_copy_(v32, s)
            torch._foreach_mul_(v32, v32)
            torch._foreach_div_(v32, c2)
            torch._foreach_sqrt_(v32)
            torch._foreach_add_(v32, self.eps)
            torch._foreach_div_(m32, c1)
            torch._foreach_div_(m32, v32)                     # u
            if self.weight_decay:
                p32 = _fp32(p)
                torch._foreach_mul_(p32, self.weight_decay)
                torch._foreach_add_(m32, p32)
            torch._foreach_mul_(m32, -lr)
            if p[0].dtype != torch.float32:      # the update rounded first
                up = [torch.empty_like(x) for x in p]
                torch._foreach_copy_(up, m32)
                m32 = up
            torch._foreach_add_(p, m32)
        return AdamState(count=t, mu=state.mu, nu=state.nu)


def _fp32(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    out = [torch.empty_like(x, dtype=torch.float32) for x in ts]
    torch._foreach_copy_(out, ts)
    return out


def _groups(ts: List[torch.Tensor], budget: int) -> List[List[int]]:
    """Indices of ``ts`` in runs of one dtype and at most ``budget``
    elements (a larger tensor alone)."""
    out: List[List[int]] = []
    open_: Dict[torch.dtype, List[int]] = {}
    size: Dict[torch.dtype, int] = {}
    for i, t in enumerate(ts):
        run = open_.get(t.dtype)
        if run and size[t.dtype] + t.numel() > budget:
            out.append(run)
            run = None
        if not run:
            run = open_[t.dtype] = []
            size[t.dtype] = 0
        run.append(i)
        size[t.dtype] += t.numel()
    return out + [r for r in open_.values() if r]


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
        b1, b2 = _betas(params)
        if params.get("moment_dtype"):
            if name not in ADAMW_NAMES:
                # the JAX package takes it on the AdamW names only
                raise NotImplementedError(
                    f"moment_dtype with optimizer '{opt_type}' is not "
                    f"ported (ROADMAP A7); the AdamW names take it")
            return CompactAdamW(lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                                moment_dtype=resolve_dtype(
                                    params["moment_dtype"]))
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
