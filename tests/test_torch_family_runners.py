"""Port parity for the dense runners of A5.4 (OPT, BLOOM, GPT-NeoX, GPT-J,
Falcon, Phi) and K1/K2 at head dim 256, against the JAX package on the
CPU.

Each variant the JAX package's own tests cover (OPT pre-LN and opt-350m;
Falcon multi-query rotary, ALiBi, the new decoder architecture and a
serial block; Phi; BLOOM tied, untied and at 12 heads, no power of two;
NeoX with a parallel and a sequential residual; GPT-J) is built once from
a seeded flax ``init`` (fp32, every leaf moved off its init value so that
biases and LayerNorm affines show) and carried over to the port with
``family_params_from_numpy``:

- the port's full-sequence forward against flax ``apply``, within 1e-5;
- one prefill's and the next decode step's last-token logits against the
  JAX runner's, within 1e-5, over dense attention and over ``paged_flash``
  (the port's plain paged function against the Pallas kernels in
  interpret mode);
- greedy streams: the port engine's at pipeline depths 0 (``put`` and
  ``decode_pipelined``) and 2 (``generate`` through the decode loop) equal
  the JAX engine's and the flax model's greedy continuation (the JAX
  tests' own criterion);
- BLOOM over an int8 KV pool (ALiBi, the decode loop's ring), token for
  token the JAX int8 engine's.

And the plain K1/K2 (what the CUDA kernels compute, run by the wrappers on
CPU tensors) at head dim 256 against the JAX ``flash_paged_attention`` in
Pallas interpret mode: GQA 1 and 2, ALiBi, an int8 pool, within 1e-5
(fp32 summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.inference.v2 import kv_quant as jkq
from deepspeed_tpu.models import _lm_utils as jlm
from deepspeed_tpu.models import bloom as jbloom
from deepspeed_tpu.models import falcon as jfalcon
from deepspeed_tpu.models import gpt_neox as jneox
from deepspeed_tpu.models import opt as jopt
from deepspeed_tpu.models import phi as jphi
from deepspeed_tpu.ops.kernels.paged_attention import \
    flash_paged_attention as jax_flash_paged_attention
from deepspeed_tpu_torch.checkpoint import (family_params_from_numpy,
                                            init_family_params)
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceConfig)
from deepspeed_tpu_torch.inference.v2.bloom_gptj_neox_runner import (
    BloomRaggedRunner, GPTJRaggedRunner, GPTNeoXRaggedRunner)
from deepspeed_tpu_torch.inference.v2.falcon_phi_runner import (
    FalconRaggedRunner, PhiRaggedRunner)
from deepspeed_tpu_torch.inference.v2.opt_runner import OPTRaggedRunner
from deepspeed_tpu_torch.models import bloom as tbloom
from deepspeed_tpu_torch.models import falcon as tfalcon
from deepspeed_tpu_torch.models import gpt_neox as tneox
from deepspeed_tpu_torch.models import opt as topt
from deepspeed_tpu_torch.models import phi as tphi
from deepspeed_tpu_torch.ops.kernels import paged_attention as port

#: family -> (JAX model, JAX config, port model, port config, runner)
FAMILIES = {
    "opt": (jopt.OPT, jopt.OPTConfig, topt.OPT, topt.OPTConfig,
            OPTRaggedRunner),
    "falcon": (jfalcon.Falcon, jfalcon.FalconConfig, tfalcon.Falcon,
               tfalcon.FalconConfig, FalconRaggedRunner),
    "phi": (jphi.Phi, jphi.PhiConfig, tphi.Phi, tphi.PhiConfig,
            PhiRaggedRunner),
    "bloom": (jbloom.Bloom, jbloom.BloomConfig, tbloom.Bloom,
              tbloom.BloomConfig, BloomRaggedRunner),
    "gpt_neox": (jneox.GPTNeoX, jneox.GPTNeoXConfig, tneox.GPTNeoX,
                 tneox.GPTNeoXConfig, GPTNeoXRaggedRunner),
    "gptj": (jneox.GPTJ, jneox.GPTJConfig, tneox.GPTJ, tneox.GPTJConfig,
             GPTJRaggedRunner),
}
#: variant -> (family, config overrides of the family's ``tiny``); OPT's
#: positions run out at 30, so the longest prompt's decode clamps them
VARIANTS = {
    "opt_pre_ln": ("opt", {"max_seq_len": 30}),
    "opt_350m": ("opt", {"max_seq_len": 30, "do_layer_norm_before": False,
                         "word_embed_proj_dim": 24}),
    "falcon_mqa_rotary": ("falcon", {}),
    "falcon_alibi": ("falcon", {"alibi": True}),
    "falcon_new_arch": ("falcon", {"new_decoder_architecture": True,
                                   "num_kv_heads": 2}),
    "falcon_serial": ("falcon", {"parallel_attn": False}),
    "phi": ("phi", {}),
    "bloom_tied": ("bloom", {}),
    "bloom_untied": ("bloom", {"tie_embeddings": False}),
    "bloom_12_heads": ("bloom", {"num_heads": 12, "hidden_size": 96}),
    "neox_parallel": ("gpt_neox", {}),
    "neox_sequential": ("gpt_neox", {"use_parallel_residual": False}),
    "gptj": ("gptj", {}),
}
TOL = dict(atol=1e-5, rtol=1e-5)
UIDS = [0, 1, 2]
_rng = np.random.default_rng(17)
#: lengths that straddle the chunk (8) and block (4) edges
PROMPTS = [_rng.integers(1, 500, n).tolist() for n in (5, 13, 22)]
GEN = 8


def _kw(**kw):
    base = dict(max_seqs=4, chunk_size=8, block_size=4, num_blocks=64,
                max_blocks_per_seq=8, dtype="float32",
                attention_impl="dense", decode_loop_steps=0,
                serve_pipeline_depth=0)
    base.update(kw)
    return base


class _Variant:
    """One variant in both packages, with the JAX engines and reference
    streams made on first use and kept."""

    def __init__(self, name):
        fam, over = VARIANTS[name]
        JM, JC, TM, TC, self.runner_cls = FAMILIES[fam]
        self.jmodel = JM(JC.tiny(dtype=jnp.float32, **over))
        params = jax.jit(self.jmodel.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        leaves, tdef = jax.tree.flatten(params)
        keys = jax.random.split(jax.random.PRNGKey(2), len(leaves))
        self.jparams = jax.tree.unflatten(tdef, [
            x + 0.05 * jax.random.normal(k, x.shape, x.dtype)
            for x, k in zip(leaves, keys)])
        self.cfg = TC.tiny(dtype=torch.float32, **over)
        self.params = family_params_from_numpy(
            jax.tree.map(np.asarray, self.jparams), self.cfg, device="cpu")
        self.tmodel = TM(self.cfg, self.params)
        self.apply = jax.jit(self.jmodel.apply)
        self._jax_engines = {}
        self._want = None

    def jax_engine(self, **kw):
        key = tuple(sorted(_kw(**kw).items()))
        if key not in self._jax_engines:
            self._jax_engines[key] = JaxEngine(self.jmodel.cfg, self.jparams,
                                               JaxRagged(**_kw(**kw)))
        return self._jax_engines[key]

    def engine(self, **kw):
        return InferenceEngineV2(self.cfg, self.params,
                                 RaggedInferenceConfig(**_kw(**kw)),
                                 device="cpu")

    def want(self):
        """(the JAX engine's greedy streams, the flax model's greedy
        continuations), GEN tokens a prompt."""
        if self._want is None:
            eng = self.jax_engine()
            streams = eng.generate(PROMPTS, max_new_tokens=GEN)
            # the prompts right-padded in one batch of fixed width: a
            # causal model's logits at a prompt's last token ignore the
            # padding after it
            lens = [len(p) for p in PROMPTS]
            toks = np.zeros((len(PROMPTS), max(lens) + GEN), np.int32)
            for i, p in enumerate(PROMPTS):
                toks[i, :len(p)] = p
            for _ in range(GEN):
                logits = np.asarray(self.apply({"params": self.jparams},
                                               jnp.asarray(toks)))
                for i in range(len(PROMPTS)):
                    toks[i, lens[i]] = int(np.argmax(logits[i, lens[i] - 1]))
                    lens[i] += 1
            full = [toks[i, len(p):len(p) + GEN].tolist()
                    for i, p in enumerate(PROMPTS)]
            self._want = (streams, full)
        return self._want


@pytest.fixture(scope="module")
def variants():
    """Variants built so far, by name (each built on first use)."""
    return {}


def _get(variants, name):
    if name not in variants:
        variants[name] = _Variant(name)
    return variants[name]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_equals_flax(variants, name):
    """The port's full-sequence forward on the carried-over tree: flax
    ``apply``'s logits within 1e-5 (fp32), at the reference streams'
    batch shape."""
    v = _get(variants, name)
    toks = np.random.default_rng(3).integers(
        0, v.cfg.vocab_size, (len(PROMPTS), max(map(len, PROMPTS)) + GEN))
    ref = np.asarray(v.apply({"params": v.jparams},
                             jnp.asarray(toks, jnp.int32)))
    got = v.tmodel(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("impl", ["dense", "paged_flash"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_step_logits_equal_jax(variants, name, impl):
    """Last-token logits of a prefill (chunked: 22 tokens in chunks of 8)
    and of the next decode step, against the JAX runner's on the same
    attention path (``paged_flash``: the port's plain paged function
    against the Pallas kernels in interpret mode)."""
    v = _get(variants, name)
    jeng = v.jax_engine(attention_impl=impl)
    eng = v.engine(attention_impl=impl)
    assert type(eng.runner) is v.runner_cls
    assert not eng.runner.supports_fused_woq
    for e in (jeng, eng):
        e.got = [e.put(UIDS, [list(p) for p in PROMPTS])]
        e.got.append(e.put(UIDS, [[3], [5], [7]]))
        for u in UIDS:
            e.flush(u)
    for a, b in zip(jeng.got, eng.got):
        for u in UIDS:
            np.testing.assert_allclose(b[u], np.asarray(a[u]), **TOL)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_streams_equal_jax_and_the_full_forward(variants, name, depth):
    """Greedy streams: depth 0 through ``put`` and ``decode_pipelined``,
    depth 2 through ``generate`` (the decode loop in calls of 4 tokens,
    then the pipelined tail); both equal the JAX engine's, which equal
    the flax model's greedy continuation."""
    v = _get(variants, name)
    streams, full = v.want()
    assert streams == full
    if depth == 0:
        eng = v.engine()
        first = eng.put(UIDS, [list(p) for p in PROMPTS], _greedy=True)
        out = eng.decode_pipelined(UIDS, [first[u] for u in UIDS], GEN - 1)
        got = [[int(first[u])] + [int(t) for t in out[u]] for u in UIDS]
        for u in UIDS:
            eng.flush(u)
    else:
        eng = v.engine(serve_pipeline_depth=2, decode_loop_steps=4,
                       attention_impl="paged_flash")
        got = eng.generate(PROMPTS, max_new_tokens=GEN)
    assert got == streams
    assert eng.free_blocks == eng.config.num_blocks


def test_bloom_int8_kv_pool_equals_jax(variants):
    """BLOOM over an int8 KV pool: ALiBi in the plain paged function with
    the pool's scales, the decode loop's compute-dtype ring (flushed into
    the pool when the loop ends) -- the JAX int8 engine's tokens."""
    v = _get(variants, "bloom_12_heads")
    want = v.jax_engine(kv_cache_dtype="int8",
                        decode_loop_steps=4).generate(
        PROMPTS, max_new_tokens=GEN)
    for impl in ("dense", "paged_flash"):
        eng = v.engine(kv_cache_dtype="int8", decode_loop_steps=4,
                       attention_impl=impl)
        assert eng.generate(PROMPTS, max_new_tokens=GEN) == want, impl
        assert eng.free_blocks == eng.config.num_blocks


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_init_family_params_serve(fam):
    """The seeded tree of each family (what the card's tests and the
    Falcon phase serve) has the shapes of ``*_param_shapes`` and fp32
    LayerNorm leaves, and an engine over it in bf16 makes tokens."""
    cfg = FAMILIES[fam][3].tiny()
    params = init_family_params(cfg, seed=0, device="cpu",
                                dtype=torch.bfloat16)
    again = init_family_params(cfg, seed=0, device="cpu",
                               dtype=torch.bfloat16)
    leaves = jax.tree.leaves(params)
    assert all(torch.equal(a, b) for a, b in
               zip(leaves, jax.tree.leaves(again)))
    norm = params[{"bloom": "ln_f", "opt": "final_layer_norm",
                   "falcon": "ln_f", "phi": "final_layernorm",
                   "gpt_neox": "final_layer_norm", "gptj": "ln_f"}[fam]]
    assert norm["scale"].dtype == norm["bias"].dtype == torch.float32
    assert any(t.dtype == torch.bfloat16 for t in leaves)
    eng = InferenceEngineV2(cfg, params, RaggedInferenceConfig(
        **_kw(dtype="bfloat16")), device="cpu")
    out = eng.generate(PROMPTS[:2], max_new_tokens=3)
    assert [len(o) for o in out] == [3, 3]


# ----------------------------------------- K1 and K2 at head dim 256


def _run_both(q, kp, vp, tables, start, lens, *, bs, KV, scales=None,
              slopes=None, window=None):
    """(JAX interpret-mode output, port output) of one call."""
    jkw, tkw = {}, {}
    if scales is not None:
        jkw.update(k_scales=jnp.asarray(scales[0]),
                   v_scales=jnp.asarray(scales[1]))
        tkw.update(k_scales=torch.from_numpy(scales[0].copy()),
                   v_scales=torch.from_numpy(scales[1].copy()))
    if slopes is not None:
        jkw["alibi_slopes"] = jnp.asarray(slopes)
        tkw["alibi_slopes"] = torch.from_numpy(slopes.copy())
    ref = jax_flash_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(start), jnp.asarray(lens),
        block_size=bs, sliding_window=window, num_kv_heads=KV,
        interpret=True, **jkw)
    got = port.flash_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(start),
        torch.from_numpy(lens), block_size=bs, sliding_window=window,
        num_kv_heads=KV, **tkw)
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("C,maxb,group,alibi,quant,window", [
    (6, 3, 1, False, False, None),     # K1 (Pallas _paged_kernel)
    (6, 3, 2, True, False, 5),         # K1, GQA 2, ALiBi, a window
    (6, 3, 2, False, True, None),      # K1 over an int8 pool
    (1, 1, 2, False, False, None),     # K2 (the grouped kernel)
    (1, 3, 1, True, True, None),       # K2, several blocks, int8, ALiBi
    (1, 1, 2, True, True, None),       # K2 grouped, int8, ALiBi
])
def test_d256_plain_matches_jax_kernels(C, maxb, group, alibi, quant,
                                        window):
    """The port's K1/K2 function at GPT-J-6B's head dim (256) against the
    Pallas kernels in interpret mode: three slots (one idle) over
    shuffled block tables, within 1e-5; the check the card's D 256
    instances are held to is this plain function (their own test)."""
    rng = np.random.default_rng(256 + C + maxb + group)
    S, KV, D = 3, 2, 256
    H = KV * group
    bs = 8 if maxb == 1 else 4
    nb = S * maxb
    tables = rng.permutation(nb).astype(np.int32).reshape(S, maxb)
    lens = np.asarray([C, maxb * bs - 1, 0], np.int32)
    start = np.maximum(lens - C, 0).astype(np.int32)
    slots = (nb + 1) * bs
    kp = rng.standard_normal((slots, KV * D)).astype(np.float32)
    vp = rng.standard_normal((slots, KV * D)).astype(np.float32)
    scales = None
    if quant:
        kq, ks = jkq.quantize_rows(jnp.asarray(kp * 3), KV)
        vq, vs = jkq.quantize_rows(jnp.asarray(vp * 3), KV)
        kp, vp = np.asarray(kq), np.asarray(vq)
        scales = (np.asarray(ks), np.asarray(vs))
    q = rng.standard_normal((S, C, H, D)).astype(np.float32)
    slopes = np.asarray(jlm.alibi_slopes(H)) if alibi else None
    ref, got = _run_both(q, kp, vp, tables, start, lens, bs=bs, KV=KV,
                         scales=scales, slopes=slopes, window=window)
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[2].any()
