"""Every shape the port serves or trains lies in its kernels' accepted
sets, so ``"auto"`` on a card never reaches a kernel that refuses it
(faults C1 and C2), and the fused-xent backward's cluster plans.

CPU only: the checks are the ones the wrappers make for CUDA tensors
(``check_kernel_shape``, ``kernel_head_dim``, ``bwd_plan``, the kernels'
dtype sets), called on each configuration's heads, head dim and dtype;
the fused-xent wrapper's hidden-size padding through the plain versions
against the JAX package's loss and gradients (fp32 within 1e-5); the
group quantizer in fp16 against the JAX package's bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels import fused_xent as jax_fx
from deepspeed_tpu.ops.kernels import quantization as jq
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.ops.kernels import quantization as qz
from deepspeed_tpu_torch.utils.dtypes import resolve_dtype

from deepspeed_tpu_torch.inference.v2 import RaggedInferenceConfig
from deepspeed_tpu_torch.inference.v2.model_runner import \
    resolve_attention_impl
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.ops.kernels import evoformer as ev
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels import fused_xent as fx
from deepspeed_tpu_torch.ops.kernels import paged_attention as pa


def _phi3_width():
    """Phi-3-mini's attention and MLP widths (hidden 3072, 32 heads of 96,
    no GQA), which the JAX registry serves through its Llama runner."""
    return LlamaConfig(vocab_size=32064, hidden_size=3072, num_heads=32,
                       num_kv_heads=32, intermediate_size=8192,
                       num_layers=32)


LLAMA_CONFIGS = {"tiny": LlamaConfig.tiny(),
                 "tinyllama_1b": LlamaConfig.tinyllama_1b(),
                 "llama2_7b": LlamaConfig.llama2_7b(),
                 "phi3_width": _phi3_width()}


@pytest.mark.parametrize("name", sorted(LLAMA_CONFIGS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_llama_configs_lie_in_the_paged_kernels_accepted_set(name, dtype):
    """Every served config in every compute dtype an engine takes (fp16:
    fault C4, closed by the kernels' fp16 instances)."""
    cfg = LLAMA_CONFIGS[name]
    assert resolve_attention_impl(RaggedInferenceConfig(),
                                  torch.device("cuda")) == "paged_flash"
    pa.check_kernel_shape(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                          dtype)


@pytest.mark.parametrize("group", [1, 8, 16, 32, 64])
def test_paged_kernels_take_any_gqa_group(group):
    pa.check_kernel_shape(group * 2, 2, 64, torch.bfloat16)


def test_paged_kernels_refuse_what_they_do_not_take():
    with pytest.raises(NotImplementedError, match="head_dim 40"):
        pa.check_kernel_shape(4, 2, 40, torch.bfloat16)
    with pytest.raises(ValueError, match="GQA"):
        pa.check_kernel_shape(4, 3, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        pa.check_kernel_shape(4, 2, 64, torch.float64)


GPT2_CONFIGS = {"tiny": GPT2Config.tiny(), "xl_1p3b": GPT2Config.xl_1p3b(),
                # bench.py gpt1p3b: 16 heads of 128
                "gpt1p3b": GPT2Config(num_layers=24, num_heads=16,
                                      hidden_size=2048, vocab_size=50304)}


@pytest.mark.parametrize("name", sorted(GPT2_CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32])
def test_gpt2_configs_lie_in_the_flash_kernels_accepted_set(name, dtype):
    cfg = GPT2_CONFIGS[name]
    assert cfg.attention_impl == "auto"
    fa.check_kernel_shape(cfg.head_dim, dtype)


def test_flash_kernels_refuse_what_they_do_not_take():
    with pytest.raises(NotImplementedError, match="head_dim 48"):
        fa.check_kernel_shape(48, torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        fa.check_kernel_shape(64, torch.float64)


@pytest.mark.parametrize("D,native", [(16, 16), (32, 32), (48, 64),
                                      (64, 64), (8, 16), (24, 32)])
def test_evoformer_head_dims_up_to_64_reach_the_kernel(D, native):
    """D = 16, 32 and 64 run natively; any other D up to 64 is zero-padded
    to the next of them."""
    assert ev.kernel_head_dim(D) == native


def test_evoformer_head_dims_over_64_are_not_ported():
    with pytest.raises(NotImplementedError, match="head_dim 128"):
        ev.kernel_head_dim(128)


@pytest.mark.parametrize("C,plan", [
    (64, (1, 64, 1)),         # a cluster of one block
    (192, (3, 64, 1)),        # an odd cluster
    (768, (3, 256, 1)),
    (2048, (8, 256, 1)),      # the gpt1p3b and GPT-2-1.3B hidden size
    (4096, (8, 256, 2)),      # two slab groups
    (1600, (5, 64, 5)),       # GPT-2 XL: no 128- or 256-wide slab divides
])
def test_xent_backward_cluster_plan(C, plan):
    CL, W, G = fx.bwd_plan(C)
    assert (CL, W, G) == plan
    assert CL * W * G == C and CL <= fx.BWD_MAX_CLUSTER
    assert W in fx.BWD_WIDTHS


def test_xent_backward_plan_covers_every_hidden_size():
    for C in range(64, 8192 + 1, 64):
        CL, W, G = fx.bwd_plan(C)
        assert CL * W * G == C and 1 <= CL <= fx.BWD_MAX_CLUSTER, C
        assert W in fx.BWD_WIDTHS, C


def test_xent_backward_plan_refuses_a_ragged_hidden_size():
    with pytest.raises(ValueError, match="multiple of 64"):
        fx.bwd_plan(100)


# ------------------------------------------------ fault C2: dtypes, padding


def _engine_dtype(prec):
    """The compute dtype ``train_batch`` runs in under a ds_config with
    ``prec`` enabled (or neither), as the engine resolves it."""
    base = {"train_micro_batch_size_per_gpu": 1}
    if prec:
        base[prec] = {"enabled": True}
    return resolve_dtype(Config.load(base).precision_dtype)


@pytest.mark.parametrize("prec", [None, "bf16", "fp16"])
def test_engine_dtypes_lie_in_the_fused_xent_flash_and_evoformer_sets(prec):
    """Every dtype the engine trains in (fp32, bf16, fp16) is one the
    fused-xent, flash and Evoformer kernels take on a card (fault C2:
    fp16 reached the first and the last, and raised there)."""
    dtype = _engine_dtype(prec)
    assert dtype in fx.KERNEL_DTYPES
    assert dtype in ev.KERNEL_DTYPES
    assert dtype in fa.KERNEL_DTYPES
    fa.check_kernel_shape(64, dtype)
    assert dtype in qz.KERNEL_DTYPES


@pytest.mark.parametrize("C", [1, 63, 64, 100, 1600, 2047, 2048])
def test_xent_kernel_hidden_pads_to_64(C):
    """The kernels run at the next multiple of 64 (zero columns), and the
    backward's cluster plan exists there."""
    Cp = fx.kernel_hidden(C)
    assert Cp % 64 == 0 and C <= Cp < C + 64
    CL, W, G = fx.bwd_plan(Cp)
    assert CL * W * G == Cp


@pytest.mark.parametrize("C", [100, 72])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_xent_hidden_padding_gives_the_unpadded_loss_and_grads(C, dtype):
    """Fault C2: at C = 100 the wrapper pads h and E with zero columns
    (``_operands``) and slices dh and dE back. Through the plain versions
    on the padded operands: lse, the target logit and the logit sum equal
    the unpadded ones (a zero column adds an exact 0 to every f32 logit),
    dh and dE sliced back equal the unpadded plain versions' (fp32 within
    1e-6 relative: the products' blocking may change with K), and the
    padded columns of both are zero; in fp32 the loss and both gradients
    also match JAX ``fused_lm_xent`` (interpret mode) within 1e-5."""
    rng = np.random.default_rng(C)
    N, V = 40, 300
    h = (rng.standard_normal((N, C)) * 0.5).astype(np.float32)
    e = (rng.standard_normal((V, C)) * 0.2).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    t[::7] = -100
    th, te = torch.from_numpy(h).to(dtype), torch.from_numpy(e).to(dtype)
    tt = torch.from_numpy(t)
    hp, ep, _ = fx._operands(th, te, tt)
    assert hp.shape[1] == ep.shape[1] == fx.kernel_hidden(C)
    assert not hp[:, C:].any() and not ep[:, C:].any()
    got = fx.fused_xent_fwd_plain(hp, ep, tt)
    ref = fx.fused_xent_fwd_plain(th, te, tt)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)
    scale = torch.tensor([0.5])
    kw = dict(ignore=-100, z=1e-4, eps=0.1)
    for fn in (fx.fused_xent_dh_plain, fx.fused_xent_de_plain):
        gp = fn(scale, hp, ep, tt, ref[0], **kw)
        r = fn(scale, th, te, tt, ref[0], **kw)
        assert not gp[:, C:].any()
        torch.testing.assert_close(gp[:, :C].float(), r.float(), rtol=1e-6,
                                   atol=1e-6)
    if dtype is not torch.float32:
        return
    f = lambda a, b: jax_fx.fused_lm_xent(   # noqa: E731
        a, b, jnp.asarray(t), ignore_index=-100, interpret=True)
    jl, (jdh, jde) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(e))
    ah, ae = (x.clone().requires_grad_(True) for x in (th, te))
    loss = fx.fused_lm_xent(ah, ae, tt, ignore_index=-100)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    for g, want in ((ah.grad, jdh), (ae.grad, jde)):
        want = np.asarray(want)
        assert np.abs(g.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("group", [128, 100])
def test_fp16_quantize_identical_to_jax(bits, symmetric, group):
    """Fault C2's fourth case: an fp16 weight through the port's group
    quantizer (the plain version on the CPU, the kernels' function) and
    JAX ``quantize_blockwise`` (Pallas in interpret mode, which casts any
    float dtype to f32): codes, scales and zeros the same bits."""
    rng = np.random.default_rng(group + bits)
    x = rng.standard_normal((300, 517)).astype(np.float16)
    x.reshape(-1)[:128] = 0
    x.reshape(-1)[1000:3000] *= np.float16(40)
    want = jq.quantize_blockwise(jnp.asarray(x), bits=bits,
                                 group_size=group, symmetric=symmetric,
                                 interpret=True)
    got = qz.quantize_blockwise(torch.from_numpy(x), bits=bits,
                                group_size=group, symmetric=symmetric)
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    if not symmetric:
        np.testing.assert_array_equal(got.zero.numpy(),
                                      np.asarray(want.zero))


# ---------------------------------------- fault C3: the block-sparse kernel

#: head dims of the models whose attention the block-sparse path serves
#: (BERT-large's 64 at phase 20, the GPT-2 and Llama widths, Phi-2's 80,
#: Phi-3's 96) and some without an instance
SPARSE_MODEL_HEAD_DIMS = sorted(
    {c.head_dim for c in GPT2_CONFIGS.values()}
    | {c.head_dim for c in LLAMA_CONFIGS.values()} | {64, 80, 96, 48, 100})


@pytest.mark.parametrize("D", SPARSE_MODEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("block", [64, 128, 256])
def test_sparse_shapes_lie_in_the_kernels_accepted_set(D, dtype, block):
    """Fault C3: every dtype the engine runs and every model head dim up to
    128 reaches a block-sparse kernel on a card (natively or zero-padded to
    ``sparse_head_dim``), at the blocks the public entry passes (multiples
    of 128 after its clamp) and at 64; bf16 / fp16 at kernel head dims 64
    and 128 with 128-multiple blocks take the wgmma kernel."""
    route = fa.sparse_route(dtype, D, block, block)
    dk = fa.sparse_head_dim(D)
    assert dk in fa.SPARSE_HEAD_DIMS and dk >= D
    want = "f32" if dtype == torch.float32 else (
        "wgmma" if dk in (64, 128) and block % 128 == 0 else "mma")
    assert route == want


def test_sparse_kernels_refuse_what_they_do_not_take():
    with pytest.raises(NotImplementedError, match="head_dim 160"):
        fa.sparse_route(torch.bfloat16, 160, 128, 128)
    with pytest.raises(NotImplementedError, match="block_q 96"):
        fa.sparse_route(torch.float16, 64, 96, 96)
    with pytest.raises(ValueError, match="dtype"):
        fa.sparse_route(torch.float64, 64, 128, 128)
