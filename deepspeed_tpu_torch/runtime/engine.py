"""The training engine on one card (port of
``deepspeed_tpu/runtime/engine.py``: ``TrainState``, ``StepMetrics``,
``Engine.train_batch`` / ``eval_batch``, the ``forward`` / ``backward`` /
``step`` trio and the accessors).

The JAX engine compiles one step: cast the master params (fp32, or
``param_dtype`` with fp32 LayerNorms) to the compute dtype, take
gradients with respect to those copies for each micro-batch (cast to
``grad_accum_dtype`` and summed), average over the accumulation steps,
unscale under fp16, clip by the global norm, update with optax, keep the
old state on an fp16 overflow, update the loss scale and advance the step
counter. This engine runs the same step eagerly in
that order, with any optimizer of ``ops/optimizers.py`` (its state, the
``opt_state``, is that optimizer's NamedTuple of a count and slot lists).
A 1-bit name (OneBitAdam, ZeroOneAdam, OneBitLamb) logs the JAX engine's
warning for one data-parallel rank and runs the 1-bit math with
full-precision gradients, as the JAX engine does on one device. With ``wall_clock_breakdown`` the ``train_batch`` timer
(``utils/timer.py``) brackets each step and stops after a synchronize on
the loss, as the JAX engine's does; a ``ThroughputTimer`` reports
samples/s every ``steps_per_print`` steps. The compute-dtype copies are fresh leaf tensors whose
gradients autograd returns in the compute dtype; it does not use
``torch.autocast``, which keeps fp32 leaves and yields fp32 gradients. The
optimizer updates the master params and moments in place.

Keys: the engine carries a threefry key (``utils/random.py``), seeded as
``jax.random.PRNGKey(config.seed)``, and each step splits it as the JAX
engine does, ``split(key, gas + 1)``: the first is the next step's key,
micro-batch ``i`` gets key ``i + 1`` as ``loss_fn(params, batch, key)``'s
third argument (an int64 ``[2]`` tensor on the engine's device), the key
the JAX engine passes. Models that draw noise (the MoE gating) derive
theirs from it, so a recompute under ``torch.utils.checkpoint`` redraws
the same noise. The trio queues micro-batches (``forward``) and runs
``train_batch`` on their concatenation at the accumulation boundary
(``step``), as the JAX engine does.

Host synchronisation: none per step in bf16/fp32 (one, on the loss, with
``wall_clock_breakdown`` or the watchdog); under fp16 the overflow flag
is read back each step (the JAX engine reads it back too).

Resume: ``save_checkpoint`` / ``load_checkpoint`` write and read the JAX
package's on-disk format (``checkpoint/engine_checkpoint.py``), so a
tag of either engine resumes in the other. ``resilience.watchdog``
brackets each ``train_batch`` (``step_start``, ``phase("compiled_step")``,
``step_end`` after a sync on the loss, ``step_abort`` when the step
raises), and ``resilience.preemption`` makes a signal, at the next step
boundary, an urgent save to ``resilience.preemption.save_dir`` (or the
last save's directory) and ``SystemExit(MEMBERSHIP_CHANGE_EXIT)`` for the
elastic agent (``elasticity/``) to restart the worker. The config's
``activation_checkpointing`` sub-tree is not read here (nor by the JAX
engine): pass it to ``runtime.activation_checkpointing.configure``. Not
in this slice: the training observatory (ROADMAP A7.6), the flops
profiler and the monitors (A9).
"""

from __future__ import annotations

import logging
import os
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config.config import Config, ConfigError
from ..ops.optimizers import ONEBIT_NAMES, OptState, build_optimizer, \
    subset
from ..resilience.fault_injection import get_fault_injector
from ..utils.device import resolve_device
from ..utils import random as trandom
from ..utils.dtypes import cast_floating, resolve_dtype
from ..utils.timer import (TRAIN_BATCH_TIMER, NoopTimer,
                           SynchronizedWallClockTimer, ThroughputTimer)
from ..utils.tree import flatten, unflatten
from . import loss_scaler as ls
from .lr_schedules import build_schedule

logger = logging.getLogger("deepspeed_tpu_torch")

LossFn = Callable[..., Any]    # (params, batch, key) -> loss | (loss, aux)


class TrainState(NamedTuple):
    """What the step reads and writes: the master params (flat, in the
    tree's order, each in its own dtype), the optimizer state, the
    loss-scale state and the step counter (advanced only by applied
    updates)."""
    step: int
    params: List[torch.Tensor]
    opt_state: OptState              # the optimizer's (ops/optimizers.py)
    scale_state: ls.LossScaleState
    rng: torch.Tensor                # threefry key [2] (int64 words)


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


def _concat(batches: List[Any]) -> Any:
    if isinstance(batches[0], dict):
        return {k: _concat([b[k] for b in batches]) for k in batches[0]}
    return torch.cat([torch.as_tensor(b) for b in batches], dim=0)


class Engine:
    def __init__(self, loss_fn: LossFn, params: Any, config: Config,
                 device: Any = None, rng: Any = None):
        self.device = resolve_device(device)
        self.config = config
        self.loss_fn = loss_fn
        elastic_ws = os.environ.get("DSTPU_ELASTIC_WORLD_SIZE")
        if elastic_ws and int(elastic_ws) > 1:
            raise NotImplementedError(
                f"DSTPU_ELASTIC_WORLD_SIZE={elastic_ws}: the engine trains "
                f"on one card; multi-device training is not ported "
                f"(ROADMAP A8)")

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
        if config.optimizer.type.lower() in ONEBIT_NAMES:
            # the JAX engine's warning on one data-parallel rank: the 1-bit
            # math runs, its compressed allreduce does not (ROADMAP A8)
            logger.warning(
                "1-bit optimizer requested but compressed allreduce needs "
                "dp>1, ZeRO stage<=1 and no seq/inner sharding; running "
                "with full-precision gradient communication")

        # the engine owns its master params: copies, never the caller's
        flat = flatten(params)
        self._names = list(flat)
        master = [torch.as_tensor(v).detach().to(self.device).clone()
                  for v in flat.values()]
        key = trandom.as_key(rng) if rng is not None \
            else trandom.PRNGKey(int(config.seed))
        self.state = TrainState(
            step=0, params=master,
            opt_state=self.optimizer.init(master),
            scale_state=ls.init_state(config.fp16),
            rng=key.to(self.device))
        self._micro_queue: List[Any] = []
        self._last_metrics: Optional[StepMetrics] = None
        self.global_steps = 0
        self.global_samples = 0
        self.skipped_steps = 0
        self.timers = SynchronizedWallClockTimer() \
            if config.wall_clock_breakdown else NoopTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=config.train_batch_size,
            steps_per_output=config.steps_per_print)

        # resilience: step watchdog, preemption grace, checkpoints
        self._last_save_dir: Optional[str] = None
        self._ckpt_engine = None
        #: split times of the last save and load
        #: (``checkpoint/engine_checkpoint.py``)
        self.checkpoint_stats: Dict[str, Dict[str, float]] = {
            "save": {}, "load": {}}
        rcfg = config.resilience
        self._watchdog = None
        if rcfg.watchdog.enabled:
            from ..resilience.watchdog import StepWatchdog
            w = rcfg.watchdog
            self._watchdog = StepWatchdog(
                stall_factor=w.stall_factor,
                check_interval_s=w.check_interval_s,
                min_median_samples=w.min_median_samples,
                min_stall_s=w.min_stall_s, action=w.action,
                heartbeat_file=w.heartbeat_file)
            # the polling thread must not outlive the engine (a stale dog
            # would keep rewriting heartbeat_file and, with action=abort,
            # could kill a process whose engine is long gone)
            weakref.finalize(self, self._watchdog.stop)
        self._preemption = None
        if rcfg.preemption.enabled:
            from ..resilience.preemption import PreemptionHandler
            self._preemption = PreemptionHandler(rcfg.preemption.signals)

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

    def _loss(self, copies: List[torch.Tensor], batch: Any,
              key: torch.Tensor):
        out = self.loss_fn(unflatten(dict(zip(self._names, copies))), batch,
                           key)
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
        self.tput_timer.start()
        self.timers(TRAIN_BATCH_TIMER).start()
        get_fault_injector().maybe_fire("step", step=self.global_steps)
        wd = self._watchdog
        if wd is not None:
            wd.step_start(self.global_steps)
            wd.phase("compiled_step")
        try:
            mean_loss = self._step(batch)
        except BaseException:
            # a dead step must not read as an eternal stall (with
            # action='abort' a stale in-flight marker would kill the
            # process after the caller recovered)
            if wd is not None:
                wd.step_abort()
            raise
        if wd is not None:
            # the recorded duration is the step's device time, not its
            # enqueue (and a hung step parks here, where the dog watches)
            try:
                float(mean_loss)
            except BaseException:
                wd.step_abort()
                raise
            wd.step_end(self.global_steps)
        self._maybe_handle_preemption()
        return mean_loss

    def _step(self, batch: Any) -> torch.Tensor:
        cfg = self.config
        expected = cfg.train_batch_size
        batch = _to_device(batch, self.device)
        gas, mb = self.gradient_accumulation_steps, self.micro_batch_size
        fp16 = cfg.fp16.enabled
        st = self.state
        scale = st.scale_state.scale
        keys = trandom.split(st.rng, gas + 1)

        trainable = [i for i, p in enumerate(st.params)
                     if p.is_floating_point()]
        acc: Optional[List[torch.Tensor]] = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        # one set of compute-dtype leaves serves every micro-batch:
        # autograd.grad returns fresh gradients and accumulates nothing
        copies = self._compute_copies()
        for i in range(gas):
            micro = _rows(batch, i * mb, (i + 1) * mb)
            loss = self._loss(copies, micro, keys[i + 1])
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
            new = self.optimizer.update(grads, subset(opt_state, trainable),
                                        params)
            opt_state = opt_state._replace(count=new.count)
        self.state = st._replace(
            step=st.step + (1 if finite else 0), opt_state=opt_state,
            scale_state=ls.update_state(st.scale_state, finite, cfg.fp16),
            rng=keys[0])
        self._last_metrics = StepMetrics(
            loss=mean_loss, grad_norm=grad_norm, lr=lr, loss_scale=scale,
            skipped=not finite)
        self.global_steps += 1
        self.global_samples += expected
        self.timers(TRAIN_BATCH_TIMER).stop(barrier_value=mean_loss)
        self.tput_timer.stop(global_step=True, report_speed=True)
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
            if cfg.wall_clock_breakdown:
                self.timers.log([TRAIN_BATCH_TIMER],
                                normalizer=cfg.steps_per_print)
        return mean_loss

    @torch.no_grad()
    def eval_batch(self, batch: Any, rng: Any = None):
        """``loss_fn`` on the params cast to the compute dtype, with the key
        ``rng`` (default ``PRNGKey(0)``, as the JAX engine's)."""
        key = trandom.as_key(rng) if rng is not None else trandom.PRNGKey(0)
        return self.loss_fn(
            cast_floating(self.params, self.compute_dtype),
            _to_device(batch, self.device), key.to(self.device))

    # the forward / backward / step trio ---------------------------------

    def forward(self, micro_batch: Any) -> torch.Tensor:
        """Queue a micro-batch. Returns the previous step's mean loss (the
        step computes the true loss at the accumulation boundary), zero
        before the first."""
        self._micro_queue.append(micro_batch)
        m = self._last_metrics
        return m.loss if m is not None else torch.zeros(
            (), device=self.device)

    def backward(self, loss: Any = None) -> Any:
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return len(self._micro_queue) >= self.gradient_accumulation_steps

    def step(self) -> Optional[torch.Tensor]:
        """``train_batch`` over the queued micro-batches once ``gas`` of
        them are queued (their concatenation, in order); else None."""
        if not self.is_gradient_accumulation_boundary():
            return None
        batch = _concat(self._micro_queue)
        self._micro_queue = []
        return self.train_batch(batch)

    def get_lr(self) -> List[float]:
        return [float(self.lr_schedule(self.state.step))]

    def get_loss_scale(self) -> float:
        return float(self.state.scale_state.scale)

    def get_global_grad_norm(self) -> Optional[float]:
        m = self._last_metrics
        return float(m.grad_norm) if m is not None else None

    # resilience ----------------------------------------------------------

    @property
    def preemption(self):
        """The PreemptionHandler (None unless resilience.preemption is
        enabled). External schedulers can call ``.request()`` on it."""
        return self._preemption

    def _maybe_handle_preemption(self) -> None:
        """At the step boundary (the only consistent point): urgent save,
        then exit with MEMBERSHIP_CHANGE_EXIT so the elastic agent
        restarts the worker."""
        if self._preemption is None or not self._preemption.preempted:
            return
        from ..checkpoint.checkpoint_engine import flush_all_pending
        from ..resilience.watchdog import MEMBERSHIP_CHANGE_EXIT
        save_dir = (self.config.resilience.preemption.save_dir
                    or self._last_save_dir)
        if save_dir:
            logger.warning(
                f"preemption: urgent checkpoint at step {self.global_steps} "
                f"-> {save_dir}")
            self.save_checkpoint(save_dir)
            # async engines: the write must be durable before the exit
            flush_all_pending()
        else:
            logger.error(
                "preemption: no save_dir configured and no prior "
                "save_checkpoint dir — exiting WITHOUT a final checkpoint")
        logger.warning(f"preemption: exiting {MEMBERSHIP_CHANGE_EXIT} "
                       f"for elastic restart")
        raise SystemExit(MEMBERSHIP_CHANGE_EXIT)

    # checkpoints (checkpoint/engine_checkpoint.py) ----------------------

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None,
                        save_latest: bool = True) -> str:
        """Write the state to ``<save_dir>/<tag>`` (default
        ``global_step<N>``) in the JAX package's format and point
        ``latest`` at it; returns the tag's directory."""
        from ..checkpoint.engine_checkpoint import save_checkpoint as _save
        return _save(self, save_dir, tag=tag, client_state=client_state,
                     save_latest=save_latest)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        load_module_only: bool = False):
        """Restore a tag (default: the newest valid one ``latest`` leads
        to); returns ``(path, client_state)``, ``(None, {})`` when there is
        nothing to load."""
        from ..checkpoint.engine_checkpoint import load_checkpoint as _load
        return _load(self, load_dir, tag=tag,
                     load_optimizer_states=load_optimizer_states,
                     load_lr_scheduler_states=load_lr_scheduler_states,
                     load_module_only=load_module_only)
