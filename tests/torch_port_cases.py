"""Shared helpers of the port's CPU parity tests: the JAX package's own
test classes compiled against the port's modules, and the tiny Llama
(fp32) both packages serve."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
_CACHE = {}


def port_cases(path, names, modules, overrides=None, keep=(), subs=()):
    """The test classes (or fixtures) ``names`` of the JAX test file
    ``path``, compiled with its imports of ``deepspeed_tpu.<m>`` for each
    ``m`` in ``modules`` (and ``from deepspeed_tpu import <m>``) pointed
    at the port, but for the modules in ``keep`` (not ported: they stay
    the JAX package's). ``overrides`` replace module-level helpers of
    that file, so its cases build port engines; ``subs`` are (old, new)
    source replacements made first, each of which must match."""
    src = (ROOT / path).read_text()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"{path}: {old!r} not found")
        src = src.replace(old, new)
    for m in modules:
        src = re.sub(rf"\bdeepspeed_tpu\.{re.escape(m)}\b",
                     f"deepspeed_tpu_torch.{m}", src)
        src = re.sub(rf"\bfrom deepspeed_tpu import {re.escape(m)}\b",
                     f"from deepspeed_tpu_torch import {m}", src)
    for m in keep:
        src = src.replace(f"deepspeed_tpu_torch.{m}", f"deepspeed_tpu.{m}")
    ns = {"__name__": f"jax_cases.{Path(path).stem}",
          "__file__": str(ROOT / path)}
    exec(compile(src, str(ROOT / path), "exec"), ns)
    ns.update(overrides or {})
    return [ns[n] for n in names]


def tiny_llama():
    """(JAX config, JAX params, port config, port params) of
    ``LlamaConfig.tiny`` in fp32, built once per process."""
    if "llama" not in _CACHE:
        from deepspeed_tpu.models import llama as jllama
        from deepspeed_tpu_torch.checkpoint import llama_params_from_numpy
        from deepspeed_tpu_torch.models.llama import LlamaConfig
        jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
        _, init_fn, _ = jllama.make_model(jcfg)
        # the tree's shapes without compiling the initializer; weights
        # from a seeded numpy draw (norm scales near 1)
        shapes = jax.eval_shape(
            lambda: init_fn(jax.random.PRNGKey(0), seq_len=16))
        rng = np.random.default_rng(0)

        def draw(path, leaf):
            x = rng.normal(0.0, 0.02, leaf.shape)
            if "norm" in jax.tree_util.keystr(path):
                x = 1.0 + 5.0 * x
            return x.astype(np.float32)

        tree = jax.tree_util.tree_map_with_path(draw, shapes)
        jparams = jax.tree.map(jnp.asarray, tree)
        cfg = LlamaConfig.tiny(dtype=torch.float32)
        params = llama_params_from_numpy(tree, cfg, device="cpu",
                                         dtype=torch.float32)
        _CACHE["llama"] = (jcfg, jparams, cfg, params)
    return _CACHE["llama"]


def port_engine(base, **kw):
    """A port engine on the CPU over the tiny Llama, config ``base``
    updated by ``kw``."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig)
    _, _, cfg, params = tiny_llama()
    return InferenceEngineV2(cfg, params,
                             RaggedInferenceConfig(**{**base, **kw}),
                             device="cpu")


def jax_engine(base, **kw):
    """The JAX engine over the same tiny Llama."""
    from deepspeed_tpu.inference.v2 import (InferenceEngineV2,
                                            RaggedInferenceConfig)
    jcfg, jparams, _, _ = tiny_llama()
    return InferenceEngineV2(jcfg, jparams,
                             RaggedInferenceConfig(**{**base, **kw}))


class StagingTripwire:
    """The port's warm-path tripwire, in the place of the JAX package's
    ``RecompileTripwire`` (which counts XLA compiles, a thing the port
    does not do): the staging sets (``InferenceEngineV2._staging_bufs``,
    the per-step-shape host buffers a step is planned into, pinned on a
    card) that any engine allocates inside a ``with`` region. A warm pass
    over step shapes it has already run must allocate none."""

    available = True

    def __init__(self):
        self.fresh_allocations = 0

    @property
    def fresh_compiles(self):
        """The JAX tripwire's name for the count."""
        return self.fresh_allocations

    def __enter__(self):
        from deepspeed_tpu_torch.inference.v2.engine_v2 import \
            InferenceEngineV2
        self._cls = InferenceEngineV2
        self._orig = orig = InferenceEngineV2._staging_bufs
        tw = self

        def counted(eng, S, C):
            if (S, C) not in eng._staging:
                tw.fresh_allocations += 1
            return orig(eng, S, C)
        InferenceEngineV2._staging_bufs = counted
        return self

    def __exit__(self, *exc):
        self._cls._staging_bufs = self._orig


def seeded_tree(init, seed=0):
    """A flax initializer's tree drawn with numpy from a seed, without
    running (or compiling) the initializer: ``init()`` is traced by
    ``jax.eval_shape`` for the shapes. Matrices are normal with std
    1/sqrt(fan_in) (the second-to-last dim; embeddings std 1), biases
    normal with std 0.05, norm scales 1 plus that. Leaves are numpy
    arrays in each leaf's dtype."""
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name or leaf.ndim == 1:
            x = rng.normal(0.0, 0.05, leaf.shape) + (
                1.0 if "scale" in name else 0.0)
        elif "embedding" in name:
            x = rng.normal(0.0, 1.0, leaf.shape)
        else:
            x = rng.normal(0.0, 1.0, leaf.shape) / np.sqrt(leaf.shape[-2])
        return x.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)
