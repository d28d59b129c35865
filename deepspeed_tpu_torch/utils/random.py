"""Threefry-2x32 counter-based random numbers, bit-compatible with
``jax.random`` (0.9, ``jax_threefry_partitionable=True``, its default).

The port's sampler keys every sampled token by ``fold_in(PRNGKey(seed),
position)`` (``inference/v2/sampling.py``), as the JAX package does, so
that a seed gives the same stream in both packages. The contract:

- ``PRNGKey``, ``fold_in``, ``split`` and ``random_bits`` give the same
  uint32 words as ``jax.random.PRNGKey``, ``jax.random.fold_in``,
  ``jax.random.split`` and ``jax.random.bits`` (32-bit): keys
  ``(0, seed)``, the hash of ``(0, data)`` for ``fold_in``, the hash of
  the counter pair ``(i >> 32, i & 0xFFFFFFFF)`` for key ``i`` of a
  ``split`` (so ``split(key, n)[i] == fold_in(key, i)``), and ``x0 ^ x1``
  of that hash for element ``i`` of a ``random_bits`` draw (the
  partitionable layout);
- ``make_rng`` is flax's ``Scope.make_rng`` over an ``rngs`` stream:
  the key folded with the first four bytes (big-endian) of the SHA-1 of
  the module path's names and the scope's call counter (flax 0.12 with
  ``flax_fix_rng_separator`` off, its default: no separator bytes). The
  training engine's keys and each MoE layer's gating key come from
  these two (``runtime/engine.py``, ``moe/layer.py``);
- ``uniform`` builds its floats from those bits as JAX does,
  ``((bits >> 9) | 0x3F800000)`` read as fp32 less 1, so its values equal
  ``jax.random.uniform``'s bit for bit;
- ``gumbel`` is ``-log(-log(u))`` over ``uniform`` on ``[tiny, 1)``,
  returned in fp32. The two logarithms are taken in fp64 and the result
  rounded once, so it is the correctly rounded value; XLA's fp32 log is
  not correctly rounded, so ``jax.random.gumbel`` is held within 2 ulp
  counted at ``max(|g|, 1)`` (the noise is added to logits), not to its
  bits. Near ``g = 0`` they part by up to an ulp of 1 (1.2e-7), which is
  many ulps of a value that small: XLA's log loses accuracy near 1.

Words are int64 tensors masked to 32 bits (torch has no uint32
arithmetic), so the same code runs on the CPU and on the card. Keys are
int64 tensors of shape ``[..., 2]``; every function takes a batch of
keys.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: the smallest normal fp32, ``jnp.finfo(jnp.float32).tiny``
_TINY = 1.1754943508222875e-38


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs
    ``(x0, x1)`` under the key ``(k0, k1)``; every operand is an int64
    tensor of 32-bit words, broadcast together. Returns the pair of
    output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _words(v: Union[int, Sequence[int], torch.Tensor],
           device=None) -> torch.Tensor:
    t = torch.as_tensor(v, device=device)
    return t.to(torch.int64) & _M32


def PRNGKey(seed: Union[int, Sequence[int], torch.Tensor],
            device=None) -> torch.Tensor:
    """Keys ``[..., 2]`` of int32 seeds: ``(0, seed as uint32)``, as
    ``jax.random.PRNGKey`` makes them from an int32 seed."""
    s = _words(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor,
            data: Union[int, Sequence[int], torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of ``(0, data as uint32)`` under
    ``key``. ``key`` [..., 2]; ``data`` broadcasts against ``key[..., 0]``."""
    d = _words(data, key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` of one key ``[2]``: ``[n, 2]``."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], i >> 32, i & _M32)
    return torch.stack([y0, y1], dim=-1)


def _static_hash(data: Sequence[Union[str, int]]) -> int:
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    return int.from_bytes(m.digest()[:4], byteorder="big")


def make_rng(key: torch.Tensor, path: Sequence[str],
             counter: int = 1) -> torch.Tensor:
    """flax's ``make_rng`` of the stream whose root key is ``key``, called
    for the ``counter``-th time in the scope at ``path`` (module names from
    the root, as ``("layer_0", "moe")``)."""
    return fold_in(key, _static_hash(tuple(path) + (int(counter),)))


def as_key(key) -> torch.Tensor:
    """A key ``[2]`` as the port's int64 words, from a port key or any
    array of two uint32 words (a ``jax.random.PRNGKey``, numpy)."""
    if isinstance(key, torch.Tensor):
        return key.to(torch.int64) & _M32
    return torch.as_tensor(np.asarray(key).astype(np.int64)) & _M32


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each key of ``key``
    [..., 2]: ``[..., n]`` int64 words."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., :1], key[..., 1:], i >> 32, i & _M32)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for each
    key: ``[..., n]`` fp32, bit-identical to JAX's."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds as fp32 and their difference rounded to fp32, as JAX
    # converts them; Python scalars, so no host-to-device copy
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(f * span + lo, min=lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` for each key: ``[..., n]``
    fp32, ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)`` (module
    docstring: the logarithms in fp64)."""
    u = uniform(key, n, minval=_TINY).to(torch.float64)
    return (-torch.log(-torch.log(u))).to(torch.float32)
