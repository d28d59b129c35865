"""GPT-2-style causal transformer (port of ``deepspeed_tpu/models/gpt2.py``).

The modules keep flax's parameter names and layouts, so a flax tree maps
leaf for leaf: ``wte/embedding`` [V, C], ``wpe/embedding`` [max_seq, C],
``h_i/{ln_1,ln_2}/{scale,bias}``, ``h_i/attn/{c_attn,c_proj}/{kernel,bias}``
and ``h_i/mlp/{c_fc,c_proj}/{kernel,bias}`` with Dense kernels
``[in, out]``, and ``ln_f``. The modules hold no weights of their own
(their parameters live on the ``meta`` device); ``make_model``'s
``loss_fn`` runs them through ``torch.func.functional_call`` on a nested
param dict, the engine's contract.

Numerics follow flax with ``dtype`` as the compute dtype: Dense promotes
input, kernel and bias to it (the product rounded, then the bias added);
LayerNorm takes its statistics in fp32 (E[x^2] - E[x]^2, clipped at 0) and
returns the compute dtype; GELU is the tanh form (flax's default); the
loss reads the tied embedding cast to the compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..utils.dtypes import resolve_dtype
from ..utils.tree import flatten


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    mlp_ratio: int = 4
    dropout: float = 0.0               # > 0 not ported (needs JAX's RNG)
    dtype: Any = torch.bfloat16        # compute dtype
    param_dtype: Any = torch.float32
    remat: bool = False
    # "full", "dots", "no_mlp", "no_gelu", "qkv_out" or "save:<names>"
    # over CHECKPOINT_NAMES: what a block keeps for its backward (below)
    remat_policy: str = "full"
    use_bias: bool = True
    layer_norm_eps: float = 1e-5
    # "auto": the CUDA flash kernels for CUDA tensors, plain attention on
    # the CPU; "flash" / "xla" force one path
    attention_impl: str = "auto"
    flash_block_q: int = 512           # tile hints for flash_attention
    flash_block_k: int = 512
    xent_chunks: int = 8
    xent_remat: bool = True
    xent_impl: str = "chunked"
    xent_ignore_index: Optional[int] = None

    @staticmethod
    def tiny(**kw):
        return GPT2Config(vocab_size=512, max_seq_len=128, num_layers=2,
                          num_heads=4, hidden_size=64, **kw)

    @staticmethod
    def small(**kw):   # GPT-2 124M
        return GPT2Config(**kw)

    @staticmethod
    def xl_1p3b(**kw):  # GPT-2 1.3B class (the BASELINE.md metric model)
        return GPT2Config(num_layers=24, num_heads=32, hidden_size=2048,
                          max_seq_len=2048, **kw)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def check_ported(self) -> None:
        """Raise for what this slice does not serve."""
        if self.dropout > 0:
            raise NotImplementedError(
                "GPT-2 dropout > 0 is not ported (it needs the JAX "
                "package's RNG stream)")
        if self.remat:
            kept_stages(self.remat_policy)           # ValueError if unknown
        if self.attention_impl == "flash_sharded":
            raise NotImplementedError(
                "attention_impl='flash_sharded' is not ported (ROADMAP A8)")
        if self.attention_impl not in ("auto", "flash", "xla"):
            raise ValueError(
                f"attention_impl must be 'auto', 'flash', 'flash_sharded' "
                f"or 'xla', got {self.attention_impl!r}")


def _meta(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta"))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` [in, out], ``bias`` [out]."""

    def __init__(self, din: int, dout: int, cfg: GPT2Config):
        super().__init__()
        self.kernel = _meta(din, dout)
        self.bias = _meta(dout) if cfg.use_bias else None
        self.dtype = resolve_dtype(cfg.dtype)

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` [num, features]."""

    def __init__(self, num: int, features: int, cfg: GPT2Config):
        super().__init__()
        self.embedding = _meta(num, features)
        self.dtype = resolve_dtype(cfg.dtype)

    def forward(self, ids):
        return F.embedding(ids, self.embedding.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: fp32 statistics, compute-dtype
    output. ``F.layer_norm`` keeps the statistics, the scale and the bias
    in fp32 for a bf16 input and rounds once; the engine's compute-dtype
    scale and bias are exact in the input's dtype. It takes the variance
    in two passes where flax takes E[x^2] - E[x]^2, a difference of fp32
    rounding only."""

    def __init__(self, features: int, cfg: GPT2Config):
        super().__init__()
        self.scale = _meta(features)
        self.bias = _meta(features)
        self.eps = cfg.layer_norm_eps
        self.dtype = resolve_dtype(cfg.dtype)

    def forward(self, x):
        x = x.to(self.dtype)
        return F.layer_norm(x, x.shape[-1:], self.scale.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def dense_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """``jax.nn.dot_product_attention``'s plain path for BTHD q/k/v: fp32
    scores and softmax, probabilities in V's dtype before P.V."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_size
        self.c_attn = Dense(C, 3 * C, cfg)
        self.c_proj = Dense(C, C, cfg)

    def core(self, qkv):
        """Attention of the fused qkv projection [B, T, 3C] -> [B, T, C]."""
        cfg = self.cfg
        B, T, C = qkv.shape[0], qkv.shape[1], cfg.hidden_size
        H, D = cfg.num_heads, cfg.head_dim
        # contiguous thirds q | k | v, each [B, T, H, D] (views, no copy)
        q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(C, dim=-1))
        impl = cfg.attention_impl
        if impl == "auto":
            # the kernels on a card, plain attention on the CPU (the JAX
            # package: Pallas flash on one TPU, XLA attention elsewhere)
            impl = "flash" if qkv.is_cuda else "xla"
        if impl == "flash":
            from ..ops.kernels.flash_attention import flash_attention
            y = flash_attention(q, k, v, causal=True, layout="BTHD",
                                block_q=cfg.flash_block_q,
                                block_k=cfg.flash_block_k)
        else:
            y = dense_attention(q, k, v, causal=True)
        return y.reshape(B, T, C)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        C = cfg.hidden_size
        self.c_fc = Dense(C, cfg.mlp_ratio * C, cfg)
        self.c_proj = Dense(cfg.mlp_ratio * C, C, cfg)


#: the JAX package's ``checkpoint_name`` tags of a block's activations
CHECKPOINT_NAMES = ("qkv", "attn_out", "mlp_pre_act", "mlp_act")
#: a block as a chain of stages: each stage's name and the names it reads
#: ("x" is the block's input); "qkv", "attn_out", "mlp_pre_act" and
#: "mlp_act" are the tagged activations, "mlp_out" the MLP's last product
STAGES = (("ln_1", ("x",)), ("qkv", ("ln_1",)), ("attn", ("qkv",)),
          ("attn_out", ("attn",)), ("res", ("x", "attn_out")),
          ("ln_2", ("res",)), ("mlp_pre_act", ("ln_2",)),
          ("mlp_act", ("mlp_pre_act",)), ("mlp_out", ("mlp_act",)),
          ("out", ("res", "mlp_out")))
_READS = dict(STAGES)


def kept_stages(policy: str) -> frozenset:
    """The stages whose outputs a block keeps for its backward under a
    remat policy, as the JAX package's ``jax.checkpoint`` policies keep
    them (``deepspeed_tpu/models/gpt2.py:198-231``); the block's input is
    always kept. ``dots`` keeps the Dense products' outputs (never the
    attention kernel's inside: a Pallas call is no ``dot_general``);
    ``no_mlp`` / ``no_gelu`` keep everything but the named activations;
    ``qkv_out`` keeps qkv and the attention output; ``save:a,b`` the
    named ones; ``full`` nothing."""
    every = frozenset(name for name, _ in STAGES)
    if policy == "full":
        return frozenset()
    if policy == "dots":
        return frozenset(("qkv", "attn_out", "mlp_pre_act", "mlp_out"))
    if policy == "no_mlp":
        return every - {"mlp_pre_act", "mlp_act"}
    if policy == "no_gelu":
        return every - {"mlp_act"}
    if policy == "qkv_out":
        return frozenset(("qkv", "attn_out"))
    if policy.startswith("save:"):
        names = frozenset(n for n in policy[5:].split(",") if n)
        unknown = names - set(CHECKPOINT_NAMES)
        if unknown:
            raise ValueError(f"remat_policy {policy!r}: unknown names "
                             f"{sorted(unknown)}; known {CHECKPOINT_NAMES}")
        return names
    raise ValueError(f"unknown remat_policy {policy!r}: 'full', 'dots', "
                     f"'no_mlp', 'no_gelu', 'qkv_out' or 'save:<names>'")


def _evaluated(target: str, have) -> list:
    """The stages computing ``target`` evaluates from the names in
    ``have``, in order."""
    out: list = []

    def visit(name):
        if name in have or name in out:
            return
        for dep in _READS[name]:
            visit(dep)
        out.append(name)
    visit(target)
    return out


def remat_segments(policy: str):
    """The block's forward as segments ``(target, inputs, recompute)``:
    each computes ``target`` from the kept ``inputs``; a segment that
    evaluates a stage the policy does not keep runs under
    ``torch.utils.checkpoint`` (``recompute``), the others run plainly."""
    kept = kept_stages(policy) | {"out"}
    have = {"x"}
    segs = []
    for name, _ in STAGES:
        if name not in kept:
            continue
        ev = _evaluated(name, have)
        inputs = tuple(sorted({d for s in ev for d in _READS[s]} & have))
        segs.append((name, inputs, any(s not in kept for s in ev)))
        have.add(name)
    return segs


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.hidden_size, cfg)
        self.attn = CausalSelfAttention(cfg)
        self.ln_2 = LayerNorm(cfg.hidden_size, cfg)
        self.mlp = MLP(cfg)

    def stage(self, name: str, *a):
        if name == "ln_1":
            return self.ln_1(a[0])
        if name == "qkv":
            return self.attn.c_attn(a[0])
        if name == "attn":
            return self.attn.core(a[0])
        if name == "attn_out":
            return self.attn.c_proj(a[0])
        if name == "ln_2":
            return self.ln_2(a[0])
        if name == "mlp_pre_act":
            return self.mlp.c_fc(a[0])
        if name == "mlp_act":
            return F.gelu(a[0], approximate="tanh")
        if name == "mlp_out":
            return self.mlp.c_proj(a[0])
        return a[0] + a[1]                              # "res", "out"

    def forward(self, x, target: str = "out"):
        """The block (``x`` a tensor), or one stage ``target`` of it from a
        dict of the stages already computed."""
        env = dict(x) if isinstance(x, dict) else {"x": x}
        for name in _evaluated(target, env):
            env[name] = self.stage(name, *(env[d] for d in _READS[name]))
        return env[target]


def _run_segment(block: Block, names, target, inputs, *tensors):
    n = len(inputs)
    return functional_call(block, dict(zip(names, tensors[n:])),
                           (dict(zip(inputs, tensors[:n])), target))


class GPT2(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.hidden_size, cfg)
        self.wpe = Embed(cfg.max_seq_len, cfg.hidden_size, cfg)
        for i in range(cfg.num_layers):
            self.add_module(f"h_{i}", Block(cfg))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg)

    def forward(self, tokens, return_hidden: bool = False):
        cfg = self.cfg
        T = tokens.shape[1]
        x = self.wte(tokens) + self.wpe(
            torch.arange(T, device=tokens.device)[None, :])
        segments = remat_segments(cfg.remat_policy) if cfg.remat else None
        for i in range(cfg.num_layers):
            block = getattr(self, f"h_{i}")
            if segments is None:
                x = block(x)
                continue
            # a segment's recompute runs in the backward pass, after an
            # outer functional_call has put the meta parameters back: the
            # block's tensors pass through checkpoint explicitly
            names, tensors = zip(*block.named_parameters())
            env = {"x": x}
            for target, inputs, recompute in segments:
                given = {k: env[k] for k in inputs}
                env[target] = checkpoint(
                    _run_segment, block, names, target, inputs,
                    *given.values(), *tensors, use_reentrant=False) \
                    if recompute else block(given, target)
            x = env["out"]
        x = self.ln_f(x)
        if return_hidden:
            return x
        # tied-embedding unembed, as flax's Embed.attend in the compute dtype
        return x @ self.wte.embedding.to(x.dtype).t()


def make_model(cfg: GPT2Config):
    """``(model, init_fn, loss_fn)``. ``loss_fn(params, batch, generator)``
    is the engine's contract: batch = ``{"tokens": [B, T+1]}``, params the
    nested dict of flax's paths, the mean next-token NLL through
    ``lm_head_xent`` (chunked or fused, by ``cfg.xent_impl``).
    ``init_fn(seed=0, device=None)`` makes seeded weights
    (``checkpoint.jax_params.init_gpt2_params``)."""
    model = GPT2(cfg)

    def init_fn(seed: int = 0, device: Any = None):
        from ..checkpoint.jax_params import init_gpt2_params
        return init_gpt2_params(cfg, seed=seed, device=device)

    def loss_fn(params, batch, generator=None):
        from ._lm_utils import lm_head_xent
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        hidden = functional_call(model, flatten(params), (inputs,),
                                 {"return_hidden": True})
        return lm_head_xent(hidden, params["wte"]["embedding"], targets, cfg)

    return model, init_fn, loss_fn
