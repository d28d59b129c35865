"""Llama-family causal transformer (port of ``deepspeed_tpu/models/llama.py``).

RMSNorm, RoPE (split-halves rotation, angles in fp32), GQA attention,
SwiGLU MLP, optional sliding window and qkv bias, untied or tied LM head.

Parameters keep the JAX package's names and layouts so one tree serves
both packages: ``embed.embedding`` ``[V, M]``, ``layer_i.attn.q_proj.kernel``
``[in, out]`` (flax Dense layout), norm ``scale`` vectors in fp32. The
nested-dict form of that tree (``params()``) is what the ragged runner
reads; the no-grad full-sequence forward of :class:`Llama` is the oracle
for prefill logits.

Training: :func:`forward` is the differentiable forward over a nested
param dict (flax's numerics with ``cfg.dtype`` as the compute dtype), and
:func:`make_model` gives the engine's ``(model, init_fn, loss_fn)``.
``attention_impl`` is ``"flash"`` (the CUDA flash kernels in the
``BTHD`` layout, GQA native: KV heads are never repeated; a
``sliding_window`` shorter than the sequence raises, as in JAX),
``"xla"`` (plain attention, KV heads repeated, the window masked) or
``"auto"`` (flash on a CUDA tensor, plain on the CPU). ``remat`` runs each
block under ``torch.utils.checkpoint``. The loss fuses the LM head into
``lm_head_xent`` (``chunked`` or ``fused``; an untied head as ``[C, V]``,
``head_layout="cv"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..utils.dtypes import resolve_dtype


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32            # < num_heads => GQA
    hidden_size: int = 4096
    intermediate_size: int = 11008
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    sliding_window: Optional[int] = None   # mistral local attention
    qkv_bias: bool = False                 # qwen2
    tie_embeddings: bool = False
    # LM-head cross-entropy knobs (models/_lm_utils.lm_head_xent)
    xent_impl: str = "chunked"
    xent_chunks: int = 8
    xent_remat: bool = True
    xent_ignore_index: Optional[int] = None
    dtype: Any = torch.bfloat16            # compute dtype
    param_dtype: Any = torch.float32
    remat: bool = False
    attention_impl: str = "auto"           # "auto", "flash" or "xla"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_kv_heads", 2)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_7b(**kw):
        """The Llama-2-7B shape (meta-llama/Llama-2-7b): the defaults."""
        return LlamaConfig(**kw)

    @staticmethod
    def tinyllama_1b(**kw):
        """The TinyLlama-1.1B shape (TinyLlama/TinyLlama-1.1B)."""
        kw.setdefault("vocab_size", 32000)
        kw.setdefault("max_seq_len", 2048)
        kw.setdefault("num_layers", 22)
        kw.setdefault("num_heads", 32)
        kw.setdefault("num_kv_heads", 4)
        kw.setdefault("hidden_size", 2048)
        kw.setdefault("intermediate_size", 5632)
        return LlamaConfig(**kw)


def rope_frequencies(head_dim: int, theta: float,
                     device: Any = None) -> torch.Tensor:
    """Inverse frequencies for rotary embedding, shape [head_dim // 2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary position embedding. x: [..., T, H, D]; positions: [..., T]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)          # [D/2]
    ang = positions[..., None].to(torch.float32) * freqs        # [..., T, D/2]
    cos = torch.cos(ang)[..., None, :]                          # [..., T, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics; returns fp32 (callers cast to the compute dtype)."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return y * scale


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Node(nn.Module):
    """A named level of the parameter tree (``attn``, ``q_proj``, ...)."""


def _tree_module(tree: Dict[str, Any]) -> nn.Module:
    node = _Node()
    for k, v in tree.items():
        if isinstance(v, dict):
            node.add_module(k, _tree_module(v))
        else:
            node.register_parameter(k, _param(v))
    return node


def _module_tree(mod: nn.Module) -> Dict[str, Any]:
    out: Dict[str, Any] = {k: p for k, p in mod.named_parameters(
        recurse=False)}
    for k, child in mod.named_children():
        out[k] = _module_tree(child)
    return out


class Llama(nn.Module):
    """The full-sequence forward over the JAX package's parameter tree
    without gradients: :func:`forward` with plain attention, the oracle of
    the engines' prefill logits. The tensors are adopted, not copied:
    ``Llama(cfg, params)`` and a ragged engine built from the same
    ``params`` share one set of weights."""

    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.tree = _tree_module(params)

    def params(self) -> Dict[str, Any]:
        """The nested-dict parameter tree (flax paths, torch tensors)."""
        return _module_tree(self.tree)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] in fp32."""
        return forward(dataclasses.replace(self.cfg, attention_impl="xla"),
                       self.params(), tokens)


# ------------------------------------------------------------ training


def resolve_attention(cfg: Any, x: torch.Tensor) -> str:
    """``cfg.attention_impl`` for tensors like ``x``: ``"auto"`` is
    ``"flash"`` on a card and ``"xla"`` on the CPU."""
    impl = cfg.attention_impl
    if impl == "auto":
        return "flash" if x.is_cuda else "xla"
    if impl not in ("flash", "xla"):
        raise ValueError(f"attention_impl must be 'auto', 'flash' or "
                         f"'xla', got {impl!r}")
    return impl


def causal_gqa_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, impl: str,
                         window: Optional[int] = None) -> torch.Tensor:
    """Causal attention of q ``[B, T, H, D]`` over k / v ``[B, T, KV, D]``
    -> ``[B, T, H, D]``: the flash kernels (GQA native) or
    ``jax.nn.dot_product_attention``'s plain path (KV heads repeated, fp32
    scores and softmax, probabilities in V's dtype, ``window`` masked)."""
    T, H, KV = q.shape[1], q.shape[2], k.shape[2]
    if impl == "flash":
        if window is not None and T > window:
            raise NotImplementedError(
                "sliding window not yet supported on the flash path")
        from ..ops.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=True, layout="BTHD")
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    mask = j <= i
    if window is not None:
        mask = mask & (j > i - window)
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def attention(cfg: Any, pa: Dict[str, Any], h: torch.Tensor) -> torch.Tensor:
    """The Llama attention block (flax ``LlamaAttention``) on ``h`` [B, T,
    M] in the compute dtype."""
    B, T, _ = h.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = h.dtype

    def dense(name):
        y = h @ pa[name]["kernel"].to(dt)
        return y + pa[name]["bias"].to(dt) if cfg.qkv_bias else y

    pos = torch.arange(T, device=h.device)[None, :]
    q = apply_rope(dense("q_proj").reshape(B, T, H, D), pos, cfg.rope_theta)
    k = apply_rope(dense("k_proj").reshape(B, T, KV, D), pos, cfg.rope_theta)
    v = dense("v_proj").reshape(B, T, KV, D)
    y = causal_gqa_attention(q, k, v, resolve_attention(cfg, h),
                             cfg.sliding_window)
    return y.reshape(B, T, H * D) @ pa["o_proj"]["kernel"].to(dt)


def mlp(pm: Dict[str, Any], h: torch.Tensor) -> torch.Tensor:
    """SwiGLU (flax ``LlamaMLP``)."""
    dt = h.dtype
    return (F.silu(h @ pm["gate_proj"]["kernel"].to(dt))
            * (h @ pm["up_proj"]["kernel"].to(dt))) \
        @ pm["down_proj"]["kernel"].to(dt)


def block(cfg: Any, lp: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """One ``LlamaBlock``: pre-norm attention and SwiGLU residuals."""
    dt = resolve_dtype(cfg.dtype)
    x = x + attention(cfg, lp["attn"],
                      rms_norm(x, lp["input_norm"]["scale"],
                               cfg.rms_eps).to(dt))
    return x + mlp(lp["mlp"], rms_norm(x, lp["post_attn_norm"]["scale"],
                                       cfg.rms_eps).to(dt))


def run_blocks(cfg: Any, params: Dict[str, Any], x: torch.Tensor,
               fn: Callable) -> Any:
    """``x`` through ``fn(cfg, layer_params, x)`` for each layer, each
    under ``torch.utils.checkpoint`` when ``cfg.remat`` (its activations
    recomputed in the backward)."""
    for li in range(cfg.num_layers):
        lp = params[f"layer_{li}"]
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(fn, cfg, lp, x, use_reentrant=False)
        else:
            x = fn(cfg, lp, x)
    return x


def forward(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            return_hidden: bool = False) -> torch.Tensor:
    """The flax ``Llama``: tokens [B, T] -> logits [B, T, V] fp32, or the
    final norm's fp32 hidden states [B, T, M] with ``return_hidden``."""
    dt = resolve_dtype(cfg.dtype)
    emb = params["embed"]["embedding"]
    x = F.embedding(tokens.long(), emb.to(dt))
    x = run_blocks(cfg, params, x, block)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
    if return_hidden:
        return x
    if "lm_head" not in params:                      # a tied tree
        return x @ emb.float().t()
    return x @ params["lm_head"]["kernel"].float()


def lm_loss(cfg: Any, params: Dict[str, Any], hidden: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """The LM-head loss of the fp32 hidden states cast to the compute
    dtype: the tied embedding as ``[V, C]`` (a tree without ``lm_head``),
    an untied head ``[C, V]``."""
    from ._lm_utils import lm_head_xent
    hidden = hidden.to(resolve_dtype(cfg.dtype))
    if "lm_head" not in params:
        return lm_head_xent(hidden, params["embed"]["embedding"], targets,
                            cfg)
    return lm_head_xent(hidden, params["lm_head"]["kernel"], targets, cfg,
                        head_layout="cv")


def make_model(cfg: LlamaConfig):
    """``(model, init_fn, loss_fn)`` with the engine's contract
    ``loss_fn(params, batch, key)``: batch = ``{"tokens": [B, T+1]}``, the
    mean next-token NLL (the key is not read). ``model(params, tokens)``
    is :func:`forward`; ``init_fn(seed=0, device=None)`` makes seeded
    weights (``checkpoint.init_llama_params``) in ``cfg.param_dtype``."""
    resolve_attention(cfg, torch.empty(0))             # validates the impl

    def model(params, tokens, return_hidden=False):
        return forward(cfg, params, tokens, return_hidden)

    def init_fn(seed: int = 0, device: Any = None):
        from ..checkpoint.jax_params import init_llama_params
        return init_llama_params(cfg, seed=seed, device=device,
                                 dtype=cfg.param_dtype)

    def loss_fn(params, batch, key=None):
        tokens = batch["tokens"]
        hidden = forward(cfg, params, tokens[:, :-1], return_hidden=True)
        return lm_loss(cfg, params, hidden, tokens[:, 1:])

    return model, init_fn, loss_fn
