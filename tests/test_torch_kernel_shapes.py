"""Every shape the port serves or trains lies in its kernels' accepted
sets, so ``"auto"`` on a card never reaches a kernel that refuses it
(fault C1), and the fused-xent backward's cluster plans.

CPU only: the checks are the ones the wrappers make for CUDA tensors
(``check_kernel_shape``, ``kernel_head_dim``, ``bwd_plan``), called on
each configuration's heads, head dim and dtype."""

import pytest
import torch

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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_llama_configs_lie_in_the_paged_kernels_accepted_set(name, dtype):
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
        pa.check_kernel_shape(4, 2, 64, torch.float16)


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
