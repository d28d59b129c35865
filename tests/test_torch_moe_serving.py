"""Port parity for the MoE families' serving path (Mixtral, Qwen2-MoE)
against the JAX package on the CPU, all in fp32.

Each variant (Mixtral's top-2 over renormalized weights; its ungated
experts; Qwen2-MoE's top-4 over the full softmax with a shared expert
and biased q/k/v; Qwen2-MoE with ``norm_topk_prob``) is built once from a
seeded flax ``init`` (every leaf moved off its init value) and carried
over with ``family_params_from_numpy``:

- the port's ``Mixtral`` forward against flax ``apply``, within 1e-5;
- one prefill's and the next decode step's last-token logits against the
  JAX runner's within 3e-4 (``tests/unit/test_models.py::
  test_mixtral_prefill_parity``'s limit), over dense attention and over
  ``paged_flash`` (the plain paged function against the Pallas kernels in
  interpret mode);
- greedy streams at pipeline depths 0 and 2 (the decode loop) equal the
  JAX engine's and the flax model's greedy continuation;
- a one-expert top-1 MoE emits the dense Llama runner's stream from the
  same weights (the ep = 1 twin of the JAX ``TestEPParity::
  test_one_expert_moe_matches_dense_runner``);
- weight-only quantization (int8; fused fp6, whose router weight is an
  fp6 GEMM leaf that ``_moe_mlp`` unpacks and whose 3-D expert stacks
  take the generic packed form): the port's quantized tree is the JAX
  quantizer's bit for bit and the streams agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantization as jwoq
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRagged
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu_torch.checkpoint import (family_params_from_numpy,
                                            init_family_params,
                                            mixtral_param_shapes,
                                            woq_params_from_numpy)
from deepspeed_tpu_torch.inference import quantization as woq
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceConfig)
from deepspeed_tpu_torch.inference.v2.llama_runner import LlamaRaggedRunner
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.models.mixtral import Mixtral, MixtralConfig
from deepspeed_tpu_torch.ops.kernels import (Fp6GemmWeight, QuantizedTensor,
                                             grouped_gemm)
from deepspeed_tpu_torch.ops.fp_quantizer import FPQuantizedTensor

#: variant -> MixtralConfig.tiny overrides (the same in both packages)
VARIANTS = {
    "mixtral": {},
    "mixtral_ungated": {"gated_experts": False},
    "qwen2_moe": {"num_experts": 8, "experts_top_k": 4,
                  "shared_expert_size": 48, "qkv_bias": True,
                  "norm_topk_prob": False},
    "qwen2_moe_norm": {"num_experts": 6, "shared_expert_size": 48,
                       "qkv_bias": True, "norm_topk_prob": True},
}
TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=3e-4, rtol=3e-4)
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


def _flax_params(jmodel, seed=0):
    params = jax.jit(lambda r, x: jmodel.init(
        {"params": r, "gating": r}, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    leaves, tdef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 2), len(leaves))
    return jax.tree.unflatten(tdef, [
        x + 0.05 * jax.random.normal(k, x.shape, x.dtype)
        for x, k in zip(leaves, keys)])


class _Variant:
    """One variant in both packages, the JAX engines and reference streams
    made on first use and kept."""

    def __init__(self, name):
        over = VARIANTS[name]
        self.jmodel = jmixtral.Mixtral(jmixtral.MixtralConfig.tiny(
            dtype=jnp.float32, **over))
        self.jparams = _flax_params(self.jmodel)
        self.cfg = MixtralConfig.tiny(dtype=torch.float32, **over)
        self.params = family_params_from_numpy(
            jax.tree.map(np.asarray, self.jparams), self.cfg, device="cpu")
        self.tmodel = Mixtral(self.cfg, self.params)
        self.apply = jax.jit(lambda p, t: self.jmodel.apply(
            {"params": p}, t, train=False))
        self._jax_engines = {}
        self._want = None

    def jax_engine(self, params=None, **kw):
        key = (id(params),) + tuple(sorted(_kw(**kw).items()))
        if key not in self._jax_engines:
            self._jax_engines[key] = JaxEngine(
                self.jmodel.cfg, self.jparams if params is None else params,
                JaxRagged(**_kw(**kw)))
        return self._jax_engines[key]

    def engine(self, params=None, **kw):
        return InferenceEngineV2(self.cfg,
                                 self.params if params is None else params,
                                 RaggedInferenceConfig(**_kw(**kw)),
                                 device="cpu")

    def want(self):
        """(the JAX engine's greedy streams, the flax model's greedy
        continuations), GEN tokens a prompt."""
        if self._want is None:
            streams = self.jax_engine().generate(PROMPTS, max_new_tokens=GEN)
            full = []
            for p in PROMPTS:
                toks = list(p)
                for _ in range(GEN):
                    logits = np.asarray(self.apply(
                        self.jparams, jnp.asarray([toks], jnp.int32)))
                    toks.append(int(np.argmax(logits[0, -1])))
                full.append(toks[len(p):])
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
    """The port's eval forward on the carried-over tree: flax ``apply``'s
    logits within 1e-5."""
    v = _get(variants, name)
    toks = np.random.default_rng(3).integers(0, v.cfg.vocab_size, (3, 21))
    ref = np.asarray(v.apply(v.jparams, jnp.asarray(toks, jnp.int32)))
    got = v.tmodel(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("impl", ["dense", "paged_flash"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_step_logits_equal_jax(variants, name, impl):
    """Last-token logits of a prefill (22 tokens in chunks of 8) and of
    the next decode step against the JAX runner's within 3e-4; the
    prefill's also against flax ``apply`` at the prompt's last token."""
    v = _get(variants, name)
    jeng = v.jax_engine(attention_impl=impl)
    eng = v.engine(attention_impl=impl)
    assert type(eng.runner) is LlamaRaggedRunner
    for e in (jeng, eng):
        e.got = [e.put(UIDS, [list(p) for p in PROMPTS])]
        e.got.append(e.put(UIDS, [[3], [5], [7]]))
        for u in UIDS:
            e.flush(u)
    for a, b in zip(jeng.got, eng.got):
        for u in UIDS:
            np.testing.assert_allclose(b[u], np.asarray(a[u]), **STEP_TOL)
    full = np.asarray(v.apply(v.jparams, jnp.asarray([PROMPTS[2]],
                                                     jnp.int32)))
    np.testing.assert_allclose(eng.got[0][2], full[0, -1], **STEP_TOL)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_streams_equal_jax_and_the_full_forward(variants, name, depth):
    """Greedy streams: depth 0 through ``put`` and ``decode_pipelined``,
    depth 2 through ``generate`` (the decode loop in calls of 4 over
    ``paged_flash``); both equal the JAX engine's, which equal the flax
    model's greedy continuation."""
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
    assert grouped_gemm.LAUNCHES["grouped_gemm"] == 0


def test_one_expert_moe_matches_dense_runner():
    """E = 1, k = 1 sends every token to the one expert with weight
    softmax([v]) = 1: the MoE runner's stream is the dense Llama
    runner's on the same weights (moe.wi_gate[0] = mlp.gate_proj, ...)."""
    cfg = MixtralConfig.tiny(dtype=torch.float32, num_experts=1,
                             experts_top_k=1)
    params = init_family_params(cfg, seed=3, device="cpu")
    dense = {}
    for k, v in params.items():
        if not k.startswith("layer_"):
            dense[k] = v
            continue
        lyr = dict(v)
        moe = lyr.pop("moe")
        lyr["mlp"] = {"gate_proj": {"kernel": moe["wi_gate"][0]},
                      "up_proj": {"kernel": moe["wi_up"][0]},
                      "down_proj": {"kernel": moe["wo"][0]}}
        dense[k] = lyr
    dcfg = LlamaConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(LlamaConfig)})
    ref = InferenceEngineV2(dcfg, dense, RaggedInferenceConfig(**_kw()),
                            device="cpu").generate(PROMPTS, max_new_tokens=5)
    got = InferenceEngineV2(cfg, params, RaggedInferenceConfig(**_kw()),
                            device="cpu").generate(PROMPTS, max_new_tokens=5)
    assert got == ref


def test_init_family_params_serves_in_bf16():
    """The seeded MoE tree (what the card's phase serves): the shapes of
    ``mixtral_param_shapes``, fp32 norm scales and router gates, the
    same bits from the same seed, and a bf16 engine that makes tokens."""
    cfg = MixtralConfig.tiny(shared_expert_size=32, qkv_bias=True)
    params = init_family_params(cfg, seed=0, device="cpu",
                                dtype=torch.bfloat16)
    again = init_family_params(cfg, seed=0, device="cpu",
                               dtype=torch.bfloat16)
    assert jax.tree.map(lambda t: tuple(t.shape), params) \
        == jax.tree.map(tuple, mixtral_param_shapes(cfg),
                        is_leaf=lambda x: isinstance(x, tuple))
    assert all(torch.equal(a, b) for a, b in
               zip(jax.tree.leaves(params), jax.tree.leaves(again)))
    lyr = params["layer_1"]
    assert lyr["moe"]["gate"].dtype == torch.float32
    assert lyr["post_attn_norm"]["scale"].dtype == torch.float32
    assert lyr["moe"]["wi_gate"].dtype == torch.bfloat16
    eng = InferenceEngineV2(cfg, params, RaggedInferenceConfig(
        **_kw(dtype="bfloat16")), device="cpu")
    out = eng.generate(PROMPTS[:2], max_new_tokens=3)
    assert [len(o) for o in out] == [3, 3]


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "_fields"))[0]


#: WOQ mode -> (config block, the packed type of each MoE leaf)
WOQ_MODES = {
    "int8": ({"num_bits": 8},
             {"gate": QuantizedTensor, "wi_gate": QuantizedTensor,
              "shared_gate_proj": QuantizedTensor}),
    "fp6_fused": ({"dtype": "fp6", "fused_gemm": True},
                  {"gate": Fp6GemmWeight, "wi_gate": FPQuantizedTensor,
                   "shared_gate_proj": Fp6GemmWeight,
                   "shared_expert_gate": FPQuantizedTensor}),
}


@pytest.mark.parametrize("mode", sorted(WOQ_MODES))
def test_woq_tree_and_streams_equal_jax(variants, mode):
    """Qwen2-MoE quantized by both packages' ``quantize_model_params``
    (group 64; embed, norm and lm_head excluded): every leaf of the port's
    tree the JAX tree's bit for bit (bridged with
    ``woq_params_from_numpy``), and greedy streams through the decode
    loop equal the JAX engine's."""
    v = _get(variants, "qwen2_moe")
    block, kinds = WOQ_MODES[mode]
    qcfg = {"quantized_weights": {**block, "group_size": 64,
                                  "excluded_modules": ["embed", "norm",
                                                       "lm_head"]}}
    jtree = jwoq.quantize_model_params(v.jparams, qcfg)
    tree = woq.quantize_model_params(v.params, qcfg)
    bridged = dict((jax.tree_util.keystr(k), x) for k, x in _leaves(
        woq_params_from_numpy(jax.tree.map(np.asarray, jtree), v.cfg,
                              device="cpu")))
    for k, got in _leaves(tree):
        want = bridged[jax.tree_util.keystr(k)]
        assert type(got) is type(want), k
        if hasattr(got, "_fields"):
            for a, b in zip(got, want):
                assert torch.equal(a, b) if isinstance(a, torch.Tensor) \
                    else a == b, k
        else:
            assert torch.equal(got, want), k
    lyr = tree["layer_0"]
    packed = {"gate": lyr["moe"]["gate"], "wi_gate": lyr["moe"]["wi_gate"],
              "shared_gate_proj": lyr["shared_gate_proj"]["kernel"],
              "shared_expert_gate": lyr["shared_expert_gate"]["kernel"]}
    for leaf, kind in kinds.items():
        assert isinstance(packed[leaf], kind), leaf
    kw = dict(decode_loop_steps=4)
    want = v.jax_engine(params=jtree, **kw).generate(PROMPTS,
                                                     max_new_tokens=GEN)
    assert v.engine(params=tree, **kw).generate(
        PROMPTS, max_new_tokens=GEN) == want
