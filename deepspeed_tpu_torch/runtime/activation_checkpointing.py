"""Activation checkpointing (port of
``deepspeed_tpu/runtime/activation_checkpointing.py``).

The JAX package maps the reference's Megatron-style checkpointing onto
``jax.checkpoint`` and its named policies. The port maps them onto
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``:

==================================  =======================================
JAX policy                          the port
==================================  =======================================
``nothing_saveable`` (default)      a plain checkpoint: only the inputs are
                                    kept, the whole function is recomputed
``everything_saveable``             no checkpoint at all (nothing is
                                    recomputed)
``dots_saveable`` /                 selective checkpointing
``checkpoint_dots``                 (``create_selective_checkpoint_contexts``)
                                    keeping the outputs of ``aten.mm``,
                                    ``addmm``, ``bmm`` and ``baddbmm``
``dots_with_no_batch_dims_saveable``  ``mm`` and ``addmm`` only (a product
/ ``..._no_batch_dims``             of a ``[B, T, C]`` activation with a
                                    weight reaches the dispatcher as ``mm``)
``cpu_checkpointing``               those ``mm`` / ``addmm`` outputs, held
(``offload_dot_with_no_batch_dims   in pinned host memory between the
("device", "pinned_host")``)        forward and the recompute
==================================  =======================================

A policy is a :class:`Policy`, callable as selective checkpointing's
``policy_fn``; any other such callable is taken as one. A policy sees the
ops that reach PyTorch's dispatcher: the port's CUDA kernels run through
``ctypes`` and are always recomputed, as a Pallas call is no
``dot_general`` for the JAX policies. The module-level ``configure`` /
``checkpoint`` / ``checkpoint_sequential`` surface, the interval derived
from ``number_checkpoints`` and the RNG tracker (``CheckpointableRNG``,
whose keys are the JAX package's through ``utils/random.py`` threefry)
follow the JAX module. Randomness inside a checkpointed function comes
from explicit keys (``utils/random.py``), so a recompute draws the same
numbers. ``partition_activations`` is a sharding constraint in the JAX
package: on one card :func:`model_parallel_reshard` returns its input, and
a process group of more than one rank raises (ROADMAP A8).
"""

from __future__ import annotations

import functools
import zlib
from typing import Any, Callable, FrozenSet, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from ..config.config import ActivationCheckpointingConfig
from ..utils import random as trandom
from ..utils.logging import log_dist
from ..utils.tree import flatten, unflatten

_aten = torch.ops.aten
#: products without batch dimensions, and all of them
NO_BATCH_DOTS = frozenset((_aten.mm.default, _aten.addmm.default))
DOTS = NO_BATCH_DOTS | {_aten.bmm.default, _aten.baddbmm.default}


class Policy:
    """A named policy: the ops whose outputs it keeps (``None``: all, so
    nothing is recomputed) and whether it holds them in pinned host
    memory. Callable as selective checkpointing's ``policy_fn``."""

    def __init__(self, name: str, saves: Optional[FrozenSet[Any]],
                 offload: bool = False):
        self.name = name
        self.saves = saves
        self.offload = offload

    def __call__(self, ctx, op, *args, **kwargs) -> CheckpointPolicy:
        if self.saves is None or op in self.saves:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    def __repr__(self) -> str:
        return f"Policy({self.name})"


nothing_saveable = Policy("nothing_saveable", frozenset())
everything_saveable = Policy("everything_saveable", None)
dots_saveable = Policy("dots_saveable", DOTS)
dots_with_no_batch_dims_saveable = Policy("dots_with_no_batch_dims_saveable",
                                          NO_BATCH_DOTS)
#: ``cpu_checkpointing``: JAX's ``offload_dot_with_no_batch_dims("device",
#: "pinned_host")``
offload_dot_with_no_batch_dims = Policy("offload_dot_with_no_batch_dims",
                                        NO_BATCH_DOTS, offload=True)

_POLICIES = {
    "nothing_saveable": nothing_saveable,
    "dots_saveable": dots_saveable,
    "checkpoint_dots": dots_saveable,
    "dots_with_no_batch_dims_saveable": dots_with_no_batch_dims_saveable,
    "checkpoint_dots_with_no_batch_dims": dots_with_no_batch_dims_saveable,
    "everything_saveable": everything_saveable,
}


def resolve_policy(cfg: ActivationCheckpointingConfig) -> Policy:
    """Config -> policy: ``policy`` by name, else ``cpu_checkpointing``'s
    offloading policy, else ``nothing_saveable``."""
    if cfg.policy is not None:
        try:
            return _POLICIES[cfg.policy]
        except KeyError:
            raise ValueError(
                f"unknown activation_checkpointing.policy {cfg.policy!r}; "
                f"known: {sorted(_POLICIES)}")
    if cfg.cpu_checkpointing:
        return offload_dot_with_no_batch_dims
    return nothing_saveable


# --------------------------------------------------------------------------- #
# module-level configuration
# --------------------------------------------------------------------------- #

_CONFIG = ActivationCheckpointingConfig()
_CONFIGURED = False


def configure(config: Optional[ActivationCheckpointingConfig] = None,
              **kwargs) -> ActivationCheckpointingConfig:
    """Set the module-level checkpointing behaviour (``config``, then each
    keyword as a field of it)."""
    global _CONFIG, _CONFIGURED
    _CONFIGURED = True
    if config is not None:
        _CONFIG = config
    for k, v in kwargs.items():
        if not hasattr(_CONFIG, k):
            raise ValueError(f"unknown activation checkpointing option {k!r}")
        setattr(_CONFIG, k, v)
    if _CONFIG.profile:
        log_dist(f"activation checkpointing configured: {_CONFIG}")
    return _CONFIG


def get_config() -> ActivationCheckpointingConfig:
    return _CONFIG


def is_configured() -> bool:
    """True once ``configure()`` has been called."""
    return _CONFIGURED


# --------------------------------------------------------------------------- #
# the policies on torch.utils.checkpoint
# --------------------------------------------------------------------------- #

def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: pinned and asynchronous from a card (the copy
    is ordered on the stream before any reuse of ``t``'s memory)."""
    if not t.is_cuda:
        return t.detach().clone()
    host = torch.empty_like(t, device="cpu", pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class _OffloadSave(TorchDispatchMode):
    """The forward of an offloading policy: each kept op's output copied
    to host memory, in order."""

    def __init__(self, ops: FrozenSet[Any], store: List[torch.Tensor]):
        super().__init__()
        self.ops, self.store = ops, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.ops:
            self.store.append(_to_host(out))
        return out


class _OffloadReplay(TorchDispatchMode):
    """The recompute of an offloading policy: each kept op returns its
    saved output, brought back to the device of its first input."""

    def __init__(self, ops: FrozenSet[Any], store: List[torch.Tensor]):
        super().__init__()
        self.ops, self.store = ops, store
        self.at = 0

    def __enter__(self):
        self.at = 0                   # each recompute replays from the top
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.ops:
            return func(*args, **(kwargs or {}))
        if self.at >= len(self.store):
            raise RuntimeError(
                f"the recompute ran {func} more often than the forward: a "
                f"checkpointed function must run the same ops again")
        host = self.store[self.at]
        self.at += 1
        return host.to(args[0].device, non_blocking=True)


def _context_fn(policy: Callable) -> Callable:
    if isinstance(policy, Policy) and policy.offload:
        def offload():
            store: List[torch.Tensor] = []
            return (_OffloadSave(policy.saves, store),
                    _OffloadReplay(policy.saves, store))
        return offload
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _remat(function: Callable, policy: Callable) -> Callable:
    """``function`` run so that its backward recomputes what ``policy``
    does not keep."""
    if isinstance(policy, Policy) and policy.saves is None:
        return function                         # everything_saveable
    plain = isinstance(policy, Policy) and not policy.saves

    @functools.wraps(function)
    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return function(*args, **kwargs)
        if plain:                               # nothing_saveable
            return _torch_checkpoint(function, *args, use_reentrant=False,
                                     **kwargs)
        return _torch_checkpoint(function, *args, use_reentrant=False,
                                 context_fn=_context_fn(policy), **kwargs)
    return run


# --------------------------------------------------------------------------- #
# the checkpoint APIs
# --------------------------------------------------------------------------- #

def checkpoint(function: Callable, *args, policy: Optional[Callable] = None,
               static_argnums: Sequence[int] = (), **fn_kwargs):
    """``function(*args, **fn_kwargs)`` with its activations recomputed in
    the backward under ``policy`` (default: the configured one).
    ``static_argnums`` is accepted for the JAX signature: a non-tensor
    argument needs no marking here."""
    pol = policy if policy is not None else resolve_policy(_CONFIG)
    return _remat(function, pol)(*args, **fn_kwargs)


def checkpoint_wrapper(function: Callable, policy: Optional[Callable] = None,
                       static_argnums: Sequence[int] = ()) -> Callable:
    """A rematerialising version of ``function`` (decorator form)."""
    pol = policy if policy is not None else resolve_policy(_CONFIG)
    return _remat(function, pol)


def _layer(stacked: Any, i: Any) -> Any:
    if isinstance(stacked, dict):
        return unflatten({k: v[i] for k, v in flatten(stacked).items()})
    return stacked[i]


def _n_layers(stacked: Any) -> int:
    if isinstance(stacked, dict):
        return int(next(iter(flatten(stacked).values())).shape[0])
    return int(stacked.shape[0])


def checkpoint_sequential(block_fn: Callable, stacked_params: Any, x: Any,
                          *, interval: Optional[int] = None,
                          policy: Optional[Callable] = None) -> Any:
    """A stack of identical blocks, ``block_fn(params_i, x) -> x``, over the
    leading (layer) axis of ``stacked_params`` (a tensor or a nested dict
    of tensors), each run of ``interval`` blocks checkpointed as one unit
    (only the units' inputs kept under ``nothing_saveable``).

    Without ``interval``, the configured ``number_checkpoints`` is the
    number of units: the largest interval that divides the layers with at
    least that many units. An interval that does not divide the layers
    raises ``ValueError``, as the JAX package's scanned grouping does."""
    pol = policy if policy is not None else resolve_policy(_CONFIG)
    n_layers = _n_layers(stacked_params)
    if interval is None:
        n_regions = _CONFIG.number_checkpoints or n_layers
        interval = max(1, n_layers // n_regions)
        while n_layers % interval:
            interval -= 1
    interval = max(1, int(interval))
    if n_layers % interval != 0:
        raise ValueError(
            f"number of layers ({n_layers}) must divide by checkpoint "
            f"interval ({interval}) for the scanned remat grouping")

    def unit(h, group):
        for j in range(interval):
            h = block_fn(_layer(group, j), h)
        return h

    unit = _remat(unit, pol)
    for g in range(0, n_layers, interval):
        x = unit(x, _layer(stacked_params, slice(g, g + interval)))
    return x


def model_parallel_reshard(x: torch.Tensor, spec: Any = None) -> torch.Tensor:
    """The ``partition_activations`` semantic: a saved activation sharded
    over the model-parallel ranks. One card holds the whole activation, so
    this returns ``x``; a process group of more than one rank raises."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        raise NotImplementedError(
            "model_parallel_reshard over more than one rank is not ported "
            "(ROADMAP A8: multi-device)")
    return x


class CheckpointableRNG:
    """The JAX package's explicit-key stand-in for the reference's
    ``CudaRNGStatesTracker``: named threefry keys (``utils/random.py``);
    ``fork(name)`` splits the named key and returns the new subkey, so a
    replayed region sees the same randomness. A name it does not hold is
    seeded from ``zlib.crc32(name) ^ seed``, as in the JAX package, so
    both give the same keys."""

    def __init__(self, seed: int = 0):
        self._keys = {}
        self._seed = seed

    def add(self, name: str, seed: int) -> None:
        if name in self._keys:
            raise ValueError(f"RNG state {name!r} already present")
        self._keys[name] = trandom.PRNGKey(seed)

    def get_states(self):
        return dict(self._keys)

    def set_states(self, states) -> None:
        self._keys = dict(states)

    def fork(self, name: str = "model-parallel-rng") -> torch.Tensor:
        if name not in self._keys:
            # a stable digest, not hash(): PYTHONHASHSEED would change it
            self.add(name, (zlib.crc32(name.encode()) ^ self._seed) % (2**31))
        keys = trandom.split(self._keys[name])
        self._keys[name], sub = keys[0], keys[1]
        return sub


_MODEL_PARALLEL_RNG = CheckpointableRNG()


def get_cuda_rng_tracker() -> CheckpointableRNG:
    return _MODEL_PARALLEL_RNG


def reset() -> None:
    """Drop module-level state (tests)."""
    global _CONFIG, _CONFIGURED, _MODEL_PARALLEL_RNG
    _CONFIG = ActivationCheckpointingConfig()
    _CONFIGURED = False
    _MODEL_PARALLEL_RNG = CheckpointableRNG()
