"""MoE layer: gate, dispatch and experts (port of
``deepspeed_tpu/moe/layer.py``, the single-group routes).

``MoE.forward(params, x, train, key, path)`` is the layer's function:
tokens ``[B, T, M]`` -> ``(out, l_aux)``. The experts live as
one stacked tensor each (``wi`` / ``wo``, or gated ``wi_gate`` /
``wi_up`` / ``wo``, ``[E, in, out]``) beside the router ``gate [M, E]``.
Two routes, chosen as the JAX layer chooses them:

- the capacity route: ``sharded_moe.gate``'s ``(l_aux, combine,
  dispatch)`` and two einsums against them, ``dispatch`` [S, E, C] taking
  the tokens to ``[E, C, M]`` and ``combine`` bringing the experts'
  outputs back. Every expert runs over its C slots. With
  ``drop_tokens=False`` C is S, so the two one-hot tensors are [S, E, S]
  (134 MB in fp32 at Mixtral's S = 2048, E = 8) and each einsum costs
  2 S E S M operations, as in the JAX package;
- the grouped route (``sharded_moe.grouped_moe_ffn``, the grouped GEMM
  over the S k routed rows), taken when ``use_grouped_gemm`` is True, or
  when it is None and tokens are not dropped and the gating draws no
  noise. Asking for it with noisy gating or with ``drop_tokens`` raises
  the JAX layer's ``ValueError``.

The gating key: when the layer trains with ``noisy_gate_policy`` or with
top-2 second-expert sampling it draws noise from flax's
``make_rng("gating")`` of the scope at ``path`` (``utils.random.make_rng``
of the root key given to the model's loss), so a key gives the JAX
package's noise. PR-MoE (``use_residual``) mixes a dense residual MLP in
by a learned softmax coefficient. Expert parallelism (``ep_mesh``) and
experts-TP raise ``NotImplementedError`` (queue item A8).

:class:`MoE` and :class:`Experts` also carry flax's ``init`` / ``apply``
on a seeded tree (``checkpoint.moe_param_shapes``), so the JAX package's
own layer tests run against the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import sharded_moe
from .sharded_moe import _tensor
from ..utils import random as trandom


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh form."""
    return F.gelu(x, approximate="tanh")


def expert_weights(p: Dict[str, Any], gated: bool) -> Tuple[torch.Tensor, ...]:
    """The stacked expert weights of a layer's tree: (wi, wo) or gated
    (wi_gate, wi_up, wo)."""
    return (p["wi_gate"], p["wi_up"], p["wo"]) if gated \
        else (p["wi"], p["wo"])


def ffn(dispatched: torch.Tensor, weights: Sequence[torch.Tensor],
        activation: Callable, dtype: torch.dtype) -> torch.Tensor:
    """The experts over ``[E, T, M]``: each expert's FFN on its slots."""
    if len(weights) == 3:
        wi_gate, wi_up, wo = weights
        h = activation(torch.einsum("etm,emh->eth", dispatched,
                                    wi_gate.to(dtype))) \
            * torch.einsum("etm,emh->eth", dispatched, wi_up.to(dtype))
    else:
        wi, wo = weights
        h = activation(torch.einsum("etm,emh->eth", dispatched,
                                    wi.to(dtype)))
    return torch.einsum("eth,ehm->etm", h, wo.to(dtype))


def _tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _tensor(tree)


def _dense(x: torch.Tensor, p: Dict[str, Any], dtype) -> torch.Tensor:
    y = x.to(dtype) @ p["kernel"].to(dtype)
    return y + p["bias"].to(dtype) if "bias" in p else y


@dataclasses.dataclass(frozen=True)
class MoE:
    """``y, l_aux = MoE(...).apply({"params": tree}, x)`` with x ``[B, T,
    M]``: the JAX layer's fields and defaults."""
    d_model: int
    num_experts: int = 8
    k: int = 1
    hidden: Optional[int] = None
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None
    top2_2nd_expert_sampling: bool = True
    normalize_weights: bool = True
    drop_tokens: bool = True
    use_residual: bool = False
    ep_mesh: Any = None
    dtype: Any = torch.float32
    activation: Callable = gelu
    gated: bool = False
    expert_tensor_parallel: bool = False
    use_grouped_gemm: Optional[bool] = None
    ep_grouped_capacity_factor: float = 2.0

    @property
    def width(self) -> int:
        return self.hidden or 4 * self.d_model

    def needs_rng(self, train: bool) -> bool:
        return bool(train and (self.noisy_gate_policy or (
            self.k == 2 and self.top2_2nd_expert_sampling)))

    def route(self, train: bool) -> str:
        """"grouped" or "capacity", or the JAX layer's ``ValueError``."""
        if self.ep_mesh is not None or self.expert_tensor_parallel:
            raise NotImplementedError(
                "MoE expert parallelism (ep_mesh) and experts-TP are not "
                "ported (ROADMAP A8)")
        noisy = self.needs_rng(train)
        grouped = self.use_grouped_gemm
        if grouped is None:
            grouped = not self.drop_tokens and not noisy
        if grouped and noisy:
            raise ValueError(
                "use_grouped_gemm routes deterministically; disable "
                "noisy_gate_policy / top2_2nd_expert_sampling to use it")
        if grouped and self.drop_tokens:
            raise ValueError(
                "use_grouped_gemm is dropless (capacity_factor is ignored); "
                "set drop_tokens=False to opt in explicitly")
        return "grouped" if grouped else "capacity"

    def forward(self, p: Dict[str, Any], x: torch.Tensor, train: bool = True,
                key: Optional[torch.Tensor] = None,
                path: Tuple[str, ...] = ()) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        """The layer on the tree ``p``; ``key`` is the root ``gating`` key
        and ``path`` this layer's scope in the model (module names)."""
        B, T, M = x.shape
        E = self.num_experts
        route = self.route(train)
        rng = None
        if self.needs_rng(train):
            if key is None:
                raise ValueError("the MoE layer's gating draws noise: "
                                 "give the loss a key")
            rng = trandom.make_rng(trandom.as_key(key).to(x.device), path)
        weights = expert_weights(p, self.gated)
        wg = p["gate"]
        tokens = x.reshape(B * T, M)
        logits = tokens.float() @ wg.float()
        if route == "grouped":
            out, l_aux = sharded_moe.grouped_moe_ffn(
                tokens, logits, self.k, weights, self.activation, self.dtype,
                normalize_weights=self.normalize_weights and self.k > 1)
        else:
            cf = self.capacity_factor if train else self.eval_capacity_factor
            l_aux, combine, dispatch = sharded_moe.gate(
                logits, k=self.k, capacity_factor=cf,
                min_capacity=self.min_capacity, rng=rng,
                noisy_gate_policy=self.noisy_gate_policy,
                top2_2nd_expert_sampling=self.top2_2nd_expert_sampling,
                drop_tokens=self.drop_tokens,
                normalize_weights=self.normalize_weights)
            dispatched = torch.einsum("sec,sm->ecm",
                                      dispatch.to(tokens.dtype), tokens)
            expert_out = ffn(dispatched, weights, self.activation,
                             self.dtype)
            out = torch.einsum("sec,ecm->sm", combine.to(tokens.dtype),
                               expert_out.to(tokens.dtype))
        out = out.reshape(B, T, M)
        if self.use_residual:
            res = _dense(self.activation(
                _dense(x, p["residual_fc1"], self.dtype)),
                p["residual_fc2"], self.dtype)
            coef = torch.softmax(_dense(x.float(), p["coefficient"],
                                        torch.float32), dim=-1)
            out = out * coef[..., 0:1].to(out.dtype) \
                + res * coef[..., 1:2].to(out.dtype)
        return out, l_aux

    # flax's surface, for the JAX package's layer tests ------------------

    def init(self, key: Any, x: Any, train: bool = True) -> Dict[str, Any]:
        """``{"params": tree}`` of seeded weights (``key``'s words seed
        numpy), after one forward on ``x`` as flax's ``init`` runs it
        (the gating key falls back to ``key``, as flax's ``params``
        stream)."""
        from ..checkpoint.jax_params import init_moe_params
        x = _tensor(x)
        seed = key if isinstance(key, int) else int(trandom.as_key(key)[1])
        params = init_moe_params(self, seed, device=x.device)
        self.forward(params, x, train,
                     None if isinstance(key, int) else key)
        return {"params": params}

    def apply(self, variables: Dict[str, Any], x: Any, train: bool = True,
              rngs: Optional[Dict[str, Any]] = None):
        rngs = rngs or {}
        key = rngs.get("gating", rngs.get("params"))
        return self.forward(_tree(variables["params"]), _tensor(x), train,
                            key)


@dataclasses.dataclass(frozen=True)
class Experts:
    """Standalone stacked experts ``[E, T, M] -> [E, T, M]``."""
    num_experts: int
    hidden: int
    d_model: int
    dtype: Any = torch.float32
    activation: Callable = gelu
    gated: bool = False

    def forward(self, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        return ffn(x, expert_weights(p, self.gated), self.activation,
                   self.dtype)

    def apply(self, variables: Dict[str, Any], x: Any) -> torch.Tensor:
        return self.forward(_tree(variables["params"]), _tensor(x))
