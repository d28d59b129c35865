"""The training engine on one card (port of
``deepspeed_tpu/runtime/engine.py``: ``TrainState``, ``StepMetrics``,
``Engine.train_batch`` / ``eval_batch`` and the accessors).

The JAX engine compiles one step: cast the master params (fp32, or
``param_dtype`` with fp32 LayerNorms) to the compute dtype, take
gradients with respect to those copies for each micro-batch (cast to
``grad_accum_dtype`` and summed), average over the accumulation steps,
unscale under fp16, clip by the global norm, update with optax, keep the
old state on an fp16 overflow, update the loss scale and advance the step
counter. This engine runs the same step eagerly in
that order. The compute-dtype copies are fresh leaf tensors whose
gradients autograd returns in the compute dtype; it does not use
``torch.autocast``, which keeps fp32 leaves and yields fp32 gradients. The
optimizer updates the master params and moments in place.

Host synchronisation: none per step in bf16/fp32; under fp16 the overflow
flag is read back each step (the JAX engine reads it back too). Not in this
slice: the forward/backward/step trio, ``save_checkpoint`` /
``load_checkpoint``, the training observatory, the flops profiler and the
monitors (ROADMAP A7).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config.config import Config, ConfigError
from ..ops.optimizers import AdamState, build_optimizer
from ..utils.device import resolve_device
from ..utils.dtypes import cast_floating, resolve_dtype
from ..utils.tree import flatten, unflatten
from . import loss_scaler as ls
from .lr_schedules import build_schedule

logger = logging.getLogger("deepspeed_tpu_torch")

LossFn = Callable[..., Any]    # (params, batch, generator) -> loss | (loss, aux)


class TrainState(NamedTuple):
    """What the step reads and writes: the master params (flat, in the
    tree's order, each in its own dtype), the optimizer state, the
    loss-scale state and the step counter (advanced only by applied
    updates)."""
    step: int
    params: List[torch.Tensor]
    opt_state: AdamState
    scale_state: ls.LossScaleState


class StepMetrics(NamedTuple):
    loss: torch.Tensor           # fp32 0-d, mean over the micro-batches
    grad_norm: torch.Tensor      # fp32 0-d, before clipping
    lr: float
    loss_scale: float
    skipped: bool                # fp16 overflow: the update was not applied


def _to_device(x: Any, device: torch.device) -> Any:
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def _leading_dim(batch: Any) -> int:
    if isinstance(batch, dict):
        return _leading_dim(next(iter(batch.values())))
    return int(batch.shape[0])


def _rows(batch: Any, lo: int, hi: int) -> Any:
    if isinstance(batch, dict):
        return {k: _rows(v, lo, hi) for k, v in batch.items()}
    return batch[lo:hi]


class Engine:
    def __init__(self, loss_fn: LossFn, params: Any, config: Config,
                 device: Any = None):
        self.device = resolve_device(device)
        self.config = config
        self.loss_fn = loss_fn

        config.resolve_batch_sizes(1)
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.compute_dtype = resolve_dtype(config.precision_dtype)
        self._grad_accum_dtype = (
            resolve_dtype(config.data_types.grad_accum_dtype)
            if config.data_types.grad_accum_dtype else torch.float32)

        base_lr = config.optimizer.params.get("lr", 1e-3)
        self.lr_schedule = build_schedule(
            config.scheduler.type, config.scheduler.params, base_lr=base_lr)
        self.optimizer = build_optimizer(
            config.optimizer.type, config.optimizer.params,
            learning_rate=self.lr_schedule)

        # the engine owns its master params: copies, never the caller's
        flat = flatten(params)
        self._names = list(flat)
        master = [torch.as_tensor(v).detach().to(self.device).clone()
                  for v in flat.values()]
        self.state = TrainState(
            step=0, params=master,
            opt_state=self.optimizer.init(master),
            scale_state=ls.init_state(config.fp16))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(config.seed))
        self._last_metrics: Optional[StepMetrics] = None
        self.global_steps = 0
        self.global_samples = 0
        self.skipped_steps = 0

    # ------------------------------------------------------------------ #

    @property
    def params(self) -> Dict[str, Any]:
        """The master params as the caller's nested dict."""
        return unflatten(dict(zip(self._names, self.state.params)))

    def _compute_copies(self) -> List[torch.Tensor]:
        """Compute-dtype copies of the master params as fresh leaves."""
        out = []
        for p in self.state.params:
            c = p.detach()
            if c.is_floating_point():
                c = c.to(self.compute_dtype).requires_grad_(True)
            out.append(c)
        return out

    def _loss(self, copies: List[torch.Tensor], batch: Any):
        out = self.loss_fn(unflatten(dict(zip(self._names, copies))), batch,
                           self.generator)
        return out[0] if isinstance(out, tuple) else out

    def train_batch(self, batch: Any) -> torch.Tensor:
        """One global step over ``micro_batch x gas`` samples; returns the
        mean loss (a 0-d fp32 tensor on the engine's device)."""
        cfg = self.config
        expected = cfg.train_batch_size
        lead = _leading_dim(batch)
        if lead != expected:
            raise ConfigError(f"train_batch expects leading dim == "
                              f"train_batch_size ({expected}), got {lead}")
        batch = _to_device(batch, self.device)
        gas, mb = self.gradient_accumulation_steps, self.micro_batch_size
        fp16 = cfg.fp16.enabled
        st = self.state
        scale = st.scale_state.scale

        trainable = [i for i, p in enumerate(st.params)
                     if p.is_floating_point()]
        acc: Optional[List[torch.Tensor]] = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        # one set of compute-dtype leaves serves every micro-batch:
        # autograd.grad returns fresh gradients and accumulates nothing
        copies = self._compute_copies()
        for i in range(gas):
            micro = _rows(batch, i * mb, (i + 1) * mb)
            loss = self._loss(copies, micro)
            obj = loss * scale if fp16 else loss
            grads = torch.autograd.grad(obj, [copies[j] for j in trainable],
                                        allow_unused=True)
            grads = [torch.zeros_like(copies[j]) if g is None else g
                     for j, g in zip(trainable, grads)]
            grads = [g.to(self._grad_accum_dtype) for g in grads]
            if acc is None:
                acc = grads
            else:
                torch._foreach_add_(acc, grads)
            loss_sum += loss.detach().float()
            del grads, loss, obj
        del copies
        mean_loss = loss_sum / gas

        # average over gas (and unscale) in fp32
        grads = [g.float() for g in acc]
        torch._foreach_div_(grads, float(gas))
        if fp16:
            torch._foreach_mul_(grads, 1.0 / scale)
        finite = bool(ls.grads_finite(grads)) if fp16 else True

        grad_norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads))) if grads else \
            torch.zeros((), device=self.device)
        clip = float(cfg.gradient_clipping or 0.0)
        if clip > 0.0:
            factor = torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
            torch._foreach_mul_(grads, factor)

        lr = self.optimizer.lr(st.opt_state.count)
        opt_state = st.opt_state
        if finite:
            params = [st.params[j] for j in trainable]
            sub = AdamState(count=opt_state.count,
                            mu=[opt_state.mu[j] for j in trainable],
                            nu=[opt_state.nu[j] for j in trainable])
            new = self.optimizer.update(grads, sub, params)
            opt_state = opt_state._replace(count=new.count)
        self.state = st._replace(
            step=st.step + (1 if finite else 0), opt_state=opt_state,
            scale_state=ls.update_state(st.scale_state, finite, cfg.fp16))
        self._last_metrics = StepMetrics(
            loss=mean_loss, grad_norm=grad_norm, lr=lr, loss_scale=scale,
            skipped=not finite)
        self.global_steps += 1
        self.global_samples += expected
        if not finite:
            self.skipped_steps += 1
            logger.info(f"step={self.global_steps}: OVERFLOW — step "
                        f"skipped, loss scale now "
                        f"{self.state.scale_state.scale}")
        if self.global_steps % cfg.steps_per_print == 0:
            logger.info(
                f"step={self.global_steps} loss={mean_loss.item():.4f} "
                f"lr={lr:.3e} grad_norm={grad_norm.item():.3f} "
                f"loss_scale={scale:.1f}")
        return mean_loss

    @torch.no_grad()
    def eval_batch(self, batch: Any, generator: Optional[torch.Generator]
                   = None):
        """``loss_fn`` on the params cast to the compute dtype."""
        return self.loss_fn(
            cast_floating(self.params, self.compute_dtype),
            _to_device(batch, self.device),
            generator if generator is not None else self.generator)

    def get_lr(self) -> List[float]:
        return [float(self.lr_schedule(self.state.step))]

    def get_loss_scale(self) -> float:
        return float(self.state.scale_state.scale)

    def get_global_grad_norm(self) -> Optional[float]:
        m = self._last_metrics
        return float(m.grad_norm) if m is not None else None

