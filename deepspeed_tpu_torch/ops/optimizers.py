"""Optimizer factory (port of ``deepspeed_tpu/ops/optimizers.py``).

The JAX package builds optax transformations (optax 0.2.6) and, for the
1-bit names, its own. The port keeps their arithmetic in a functional
update over a list of tensors, in place (``torch._foreach_*``) on the
master params and the optimizer's slots, which the JAX package cannot do;
it saves one copy of each. Every optimizer reads ``lr = schedule(count)``
before its count advances; the engine does not call it on an fp16
overflow step, so the count does not advance there, as when the JAX
engine keeps the old state.

- **Adam / AdamW** (optax ``adam`` / ``adamw``): ``mu = (1 - b1) g + b1
  mu``, ``nu = (1 - b2) g^2 + b2 nu``, ``u = (mu / (1 - b1^t)) /
  (sqrt(nu / (1 - b2^t)) + eps)``; AdamW adds ``weight_decay * p`` to u
  for every parameter (no mask); classic Adam with L2
  (``adam_w_mode=False``) adds it to g first. An Adam name ignores
  ``moment_dtype``, as the JAX package does (its Adam branch never reads
  it); on an AdamW name it gives :class:`CompactAdamW`, the JAX package's
  ``adamw_compact``: the moments stored in that dtype (the second as its
  square root), the arithmetic in fp32.
- **Lamb** (``optax.lamb``): Adam's ``u``, plus ``wd * p``, times the
  leaf's trust ratio ``|p| / |u|`` (1 where either norm is 0).
- **Lion** (``optax.lion``, b2 defaulting to 0.99): ``u = sign((1 - b1) g
  + b1 mu) + wd * p``, then ``mu = (1 - b2) g + b2 mu``.
- **Adagrad** (``optax.adagrad``): ``s = g^2 + s`` from 0.1 (optax's
  ``initial_accumulator_value``), ``u = where(s > 0, rsqrt(s + eps), 0)
  g``.
- **SGD** (``optax.sgd``): ``trace = g + momentum trace``, ``u = trace``
  or, with ``nesterov``, ``g + momentum trace``; a weight decay is optax's
  ``add_decayed_weights`` chained first (``g + wd p``).
- **OneBitAdam, ZeroOneAdam, OneBitLamb** (the JAX package's
  ``_onebit_base``): Adam's moments in fp32 whose ``nu``, and its bias
  correction, freeze after ``freeze_step`` (ZeroOneAdam refreshes ``nu``
  every ``var_update_scaler`` steps), ``u = (mu / c1) / (sqrt(nu / c2) +
  eps) + wd p``; OneBitLamb scales ``u`` by the trust ratio. On one card
  the engine runs this math with full-precision gradients, as the JAX
  engine does on one device (the compressed allreduce is ROADMAP A8).

``p += -lr * u``. Each optimizer's :meth:`Optimizer.layout` gives the
paths of its state in the JAX package's optax tree, which the checkpoint
writer follows (``checkpoint/engine_checkpoint.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, \
    Union

import torch

from ..utils.dtypes import resolve_dtype

ScalarOrSchedule = Union[float, Callable[[int], float]]

ADAM_NAMES = ("adam", "fusedadam", "muadam")
ADAMW_NAMES = ("adamw", "fusedadamw", "muadamw", "cpuadam",
               "deepspeedcpuadam")
LAMB_NAMES = ("lamb", "fusedlamb")
LION_NAMES = ("lion", "fusedlion")
SGD_NAMES = ("sgd", "musgd")
#: names whose 1-bit compressed-communication variant the JAX engine arms
#: on more than one data-parallel rank
ONEBIT_NAMES = ("onebitadam", "onebitlamb", "zerooneadam")
#: tensors per foreach group: bounds the update's temporaries
GROUP = 64
#: elements per foreach group of the compact AdamW (its fp32 copies)
GROUP_ELEMS = 1 << 27


class AdamState(NamedTuple):
    """Adam, AdamW, the compact AdamW, Lamb and the 1-bit optimizers."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class LionState(NamedTuple):
    count: int
    mu: List[torch.Tensor]


class AdagradState(NamedTuple):
    count: int
    sum_of_squares: List[torch.Tensor]


class SGDState(NamedTuple):
    count: int
    trace: List[torch.Tensor]          # empty without momentum


OptState = Union[AdamState, LionState, AdagradState, SGDState]


def subset(state: OptState, idx: List[int]) -> OptState:
    """``state`` with each slot list cut to the entries ``idx`` (the same
    tensors: an update of the subset updates the whole state)."""
    return state._replace(**{
        f: [getattr(state, f)[j] for j in idx]
        for f in state._fields[1:] if getattr(state, f)})


def _bias_correction(b: float, t: int) -> float:
    """``1 - b^t`` in fp32, as JAX computes it."""
    tf = torch.tensor(float(t), dtype=torch.float32)
    return float(1 - torch.tensor(b, dtype=torch.float32) ** tf)


def _chunks(n: int):
    for at in range(0, n, GROUP):
        yield slice(at, at + GROUP)


def _trust_scale_(u: List[torch.Tensor], p: List[torch.Tensor]) -> None:
    """``u *= |p| / |u|`` per tensor, 1 where either norm is 0 (optax's
    ``scale_by_trust_ratio``), on the device (no sync)."""
    pn = torch._foreach_norm(p)
    un = torch._foreach_norm(u)
    ratios = [torch.where((a == 0) | (b == 0), torch.ones_like(a), a / b)
              for a, b in zip(pn, un)]
    torch._foreach_mul_(u, ratios)


class Optimizer:
    """An optimizer over a list of tensors: ``init(params)`` -> state,
    ``update(grads, state, params)`` updates ``params`` and the state's
    slots in place and returns the state with its count advanced;
    ``layout()`` is its state's place in the JAX package's optax tree."""

    def __init__(self, learning_rate: ScalarOrSchedule):
        self.learning_rate = learning_rate

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def layout(self) -> List[Tuple[str, str]]:
        """``(path, field)`` of each piece of the state in the JAX leaf
        order: a field ``count`` is the one count (every optax count of
        the chain equals it), any other field a slot list written as
        ``<path>/<param path>``."""
        raise NotImplementedError


class Adam(Optimizer):
    """Adam (``decoupled=False``: L2 decay folded into the gradient) or
    AdamW (``decoupled=True``) with optax's arithmetic."""

    def __init__(self, learning_rate: ScalarOrSchedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.decoupled = decoupled

    def layout(self) -> List[Tuple[str, str]]:
        if self.decoupled:                          # optax.adamw
            adam, sched = "opt_state/0", "opt_state/2/count"
        elif self.weight_decay:         # chain(add_decayed_weights, adam)
            adam, sched = "opt_state/1/0", "opt_state/1/1/count"
        else:                                       # optax.adam
            adam, sched = "opt_state/0", "opt_state/1/count"
        return [(f"{adam}/count", "count"), (f"{adam}/mu", "mu"),
                (f"{adam}/nu", "nu"), (sched, "count")]

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
        bc1 = _bias_correction(self.b1, t)
        bc2 = _bias_correction(self.b2, t)
        wd = self.weight_decay
        for sl in _chunks(len(params)):
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

    def layout(self) -> List[Tuple[str, str]]:
        return [("opt_state/count", "count"), ("opt_state/mu", "mu"),
                ("opt_state/nu", "nu")]                 # adamw_compact

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


class Lamb(Adam):
    """``optax.lamb``: ``scale_by_adam``, ``add_decayed_weights``,
    ``scale_by_trust_ratio``, ``scale_by_learning_rate``."""

    def __init__(self, learning_rate: ScalarOrSchedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(learning_rate, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, decoupled=True)

    def layout(self) -> List[Tuple[str, str]]:
        return [("opt_state/0/count", "count"), ("opt_state/0/mu", "mu"),
                ("opt_state/0/nu", "nu"), ("opt_state/3/count", "count")]

    def update(self, grads: List[torch.Tensor], state: AdamState,
               params: List[torch.Tensor]) -> AdamState:
        t = state.count + 1
        lr = self.lr(state.count)
        bc1 = _bias_correction(self.b1, t)
        bc2 = _bias_correction(self.b2, t)
        for sl in _chunks(len(params)):
            p, g, mu, nu = params[sl], grads[sl], state.mu[sl], state.nu[sl]
            # scale_by_adam's ops, each rounded as optax rounds it
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
            torch._foreach_mul_(nu, self.b2)
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1.0 - self.b2)
            torch._foreach_add_(nu, g2)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
            _trust_scale_(u, p)
            torch._foreach_mul_(u, -lr)
            torch._foreach_add_(p, u)
        return AdamState(count=t, mu=state.mu, nu=state.nu)


class Lion(Optimizer):
    """``optax.lion``: ``scale_by_lion``, ``add_decayed_weights``,
    ``scale_by_learning_rate``."""

    def __init__(self, learning_rate: ScalarOrSchedule, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 0.0):
        super().__init__(learning_rate)
        self.b1, self.b2 = float(b1), float(b2)
        self.weight_decay = float(weight_decay)

    def layout(self) -> List[Tuple[str, str]]:
        return [("opt_state/0/count", "count"), ("opt_state/0/mu", "mu"),
                ("opt_state/2/count", "count")]

    def init(self, params: List[torch.Tensor]) -> LionState:
        return LionState(count=0, mu=[torch.zeros_like(p) for p in params])

    def update(self, grads: List[torch.Tensor], state: LionState,
               params: List[torch.Tensor]) -> LionState:
        t = state.count + 1
        lr = self.lr(state.count)
        for sl in _chunks(len(params)):
            p, g, mu = params[sl], grads[sl], state.mu[sl]
            u = torch._foreach_mul(g, 1.0 - self.b1)
            torch._foreach_add_(u, torch._foreach_mul(mu, self.b1))
            u = [torch.sign(x) for x in u]
            torch._foreach_mul_(mu, self.b2)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b2))
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
            torch._foreach_mul_(u, -lr)
            torch._foreach_add_(p, u)
        return LionState(count=t, mu=state.mu)


class Adagrad(Optimizer):
    """``optax.adagrad``: ``scale_by_rss`` (the sum of squares from
    ``initial_accumulator_value``), ``scale_by_learning_rate``."""

    def __init__(self, learning_rate: ScalarOrSchedule, eps: float = 1e-7,
                 initial_accumulator_value: float = 0.1):
        super().__init__(learning_rate)
        self.eps = float(eps)
        self.initial = float(initial_accumulator_value)

    def layout(self) -> List[Tuple[str, str]]:
        return [("opt_state/0/sum_of_squares", "sum_of_squares"),
                ("opt_state/1/count", "count")]

    def init(self, params: List[torch.Tensor]) -> AdagradState:
        return AdagradState(count=0, sum_of_squares=[
            torch.full_like(p, self.initial) for p in params])

    def update(self, grads: List[torch.Tensor], state: AdagradState,
               params: List[torch.Tensor]) -> AdagradState:
        t = state.count + 1
        lr = self.lr(state.count)
        for sl in _chunks(len(params)):
            p, g, ss = params[sl], grads[sl], state.sum_of_squares[sl]
            torch._foreach_add_(ss, torch._foreach_mul(g, g))
            inv = torch._foreach_add(ss, self.eps)
            torch._foreach_rsqrt_(inv)
            inv = [torch.where(s > 0, i, torch.zeros_like(i))
                   for s, i in zip(ss, inv)]
            torch._foreach_mul_(inv, g)
            torch._foreach_mul_(inv, -lr)
            torch._foreach_add_(p, inv)
        return AdagradState(count=t, sum_of_squares=state.sum_of_squares)


class SGD(Optimizer):
    """``optax.sgd`` (``trace`` with ``momentum``, Nesterov's form with
    ``nesterov``), after ``add_decayed_weights`` when ``weight_decay``."""

    def __init__(self, learning_rate: ScalarOrSchedule,
                 momentum: Optional[float] = None, nesterov: bool = False,
                 weight_decay: float = 0.0):
        super().__init__(learning_rate)
        self.momentum = float(momentum) if momentum else None
        self.nesterov = bool(nesterov)
        self.weight_decay = float(weight_decay)

    def layout(self) -> List[Tuple[str, str]]:
        # chain(trace | identity, scale_by_learning_rate), itself chained
        # after add_decayed_weights (no state) when there is a decay
        pre = "opt_state/1" if self.weight_decay else "opt_state"
        trace = [(f"{pre}/0/trace", "trace")] if self.momentum else []
        return trace + [(f"{pre}/1/count", "count")]

    def init(self, params: List[torch.Tensor]) -> SGDState:
        return SGDState(count=0, trace=[torch.zeros_like(p) for p in params]
                        if self.momentum else [])

    def update(self, grads: List[torch.Tensor], state: SGDState,
               params: List[torch.Tensor]) -> SGDState:
        t = state.count + 1
        lr = self.lr(state.count)
        wd, m = self.weight_decay, self.momentum
        for sl in _chunks(len(params)):
            p, g = params[sl], grads[sl]
            if wd:
                g = torch._foreach_add(g, torch._foreach_mul(p, wd))
            u = g
            if m:
                tr = state.trace[sl]
                torch._foreach_mul_(tr, m)
                torch._foreach_add_(tr, g)
                u = tr
                if self.nesterov:
                    u = torch._foreach_add(g, torch._foreach_mul(tr, m))
            torch._foreach_add_(p, torch._foreach_mul(u, -lr))
        return SGDState(count=t, trace=state.trace)


class OneBitAdam(Adam):
    """The JAX package's ``_onebit_base`` (OneBitAdam, ZeroOneAdam with
    ``var_update_interval``, OneBitLamb with ``trust_ratio``): fp32
    moments, ``nu`` and its bias correction frozen after ``freeze_step``;
    the state is the bare ``(count, mu, nu)`` (no schedule count)."""

    def __init__(self, learning_rate: ScalarOrSchedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, freeze_step: int = 100,
                 var_update_interval: int = 0, trust_ratio: bool = False):
        super().__init__(learning_rate, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, decoupled=True)
        self.freeze_step = int(freeze_step)
        self.var_update_interval = int(var_update_interval)
        self.trust_ratio = bool(trust_ratio)

    def layout(self) -> List[Tuple[str, str]]:
        return [("opt_state/count", "count"), ("opt_state/mu", "mu"),
                ("opt_state/nu", "nu")]

    def init(self, params: List[torch.Tensor]) -> AdamState:
        z = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamState(count=0, mu=z, nu=[torch.zeros_like(m) for m in z])

    def update(self, grads: List[torch.Tensor], state: AdamState,
               params: List[torch.Tensor]) -> AdamState:
        t = state.count + 1
        warm = t <= self.freeze_step or bool(
            self.var_update_interval and t % self.var_update_interval == 0)
        lr = self.lr(state.count)
        c1 = _bias_correction(self.b1, t)
        c2 = _bias_correction(self.b2, min(t, self.freeze_step))
        for sl in _chunks(len(params)):
            p, g, mu, nu = params[sl], grads[sl], state.mu[sl], state.nu[sl]
            g = [x.float() for x in g]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
            if warm:
                torch._foreach_mul_(nu, self.b2)
                g2 = torch._foreach_mul(g, g)
                torch._foreach_mul_(g2, 1.0 - self.b2)
                torch._foreach_add_(nu, g2)
            den = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(mu, c1)
            torch._foreach_div_(u, den)
            if self.weight_decay:
                torch._foreach_add_(u, torch._foreach_mul(
                    [x.float() for x in p], self.weight_decay))
            if self.trust_ratio:
                _trust_scale_(u, [x.float() for x in p])
            torch._foreach_mul_(u, -lr)
            torch._foreach_add_(p, [x.to(y.dtype) for x, y in zip(u, p)])
        return AdamState(count=t, mu=state.mu, nu=state.nu)


def _betas(params: Dict[str, Any], default=(0.9, 0.999)):
    betas = params.get("betas", default)
    return float(betas[0]), float(betas[1])


def build_optimizer(opt_type: str, opt_params: Dict[str, Any],
                    learning_rate: Optional[ScalarOrSchedule] = None
                    ) -> Optimizer:
    """An optimizer from a ds_config ``optimizer`` block. ``learning_rate``
    (a float or a step -> lr schedule) overrides ``opt_params["lr"]``."""
    params = dict(opt_params)
    lr = learning_rate if learning_rate is not None \
        else params.get("lr", 1e-3)
    wd = float(params.get("weight_decay", 0.0))
    eps = float(params.get("eps", 1e-8))
    name = opt_type.lower()
    if name in ONEBIT_NAMES:
        b1, b2 = _betas(params)
        freeze = int(params.get("freeze_step", 100))
        return OneBitAdam(
            lr, b1=b1, b2=b2, eps=eps, weight_decay=wd, freeze_step=freeze,
            var_update_interval=(int(params.get("var_update_scaler", 16))
                                 if name == "zerooneadam" else 0),
            trust_ratio=name == "onebitlamb")
    if name in ADAMW_NAMES and params.get("moment_dtype"):
        b1, b2 = _betas(params)
        return CompactAdamW(lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                            moment_dtype=resolve_dtype(
                                params["moment_dtype"]))
    if name in ADAM_NAMES + ADAMW_NAMES:
        # an Adam name ignores moment_dtype (the JAX package reads it on
        # the AdamW names only); FusedAdam defaults adam_w_mode=True and
        # the AdamW names ignore it
        b1, b2 = _betas(params)
        decoupled = name in ADAMW_NAMES or bool(params.get("adam_w_mode",
                                                           True))
        return Adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                    decoupled=decoupled)
    if name in LAMB_NAMES:
        b1, b2 = _betas(params)
        return Lamb(lr, b1=b1, b2=b2, eps=eps, weight_decay=wd)
    if name in LION_NAMES:
        b1, b2 = _betas(params, default=(0.9, 0.99))
        return Lion(lr, b1=b1, b2=b2, weight_decay=wd)
    if name == "adagrad":
        return Adagrad(lr, eps=eps)
    if name in SGD_NAMES:
        return SGD(lr, momentum=float(params.get("momentum", 0.0)) or None,
                   nesterov=bool(params.get("nesterov", False)),
                   weight_decay=wd)
    raise ValueError(f"Unknown optimizer type '{opt_type}'")
