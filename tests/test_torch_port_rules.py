"""Rules the port keeps: it stands alone (no JAX, nothing of the JAX
package), it never falls back to the CPU when the card was asked for, and
importing it builds no kernel."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+deepspeed_tpu[. ]|"
    r"import\s+deepspeed_tpu$|from\s+deepspeed_tpu[. ])", re.M)


def _port_files():
    files = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    # the pattern itself: catches the JAX package, spares the port
    assert FORBIDDEN.search("from deepspeed_tpu.models import x")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from deepspeed_tpu_torch import x")


def test_cuda_requested_without_a_card_raises(monkeypatch, tmp_path):
    from deepspeed_tpu_torch import resolve_device
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  build_hf_engine)
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngineV2(LlamaConfig.tiny(), {})
    (tmp_path / "config.json").write_text('{"model_type": "llama"}')
    with pytest.raises(RuntimeError, match="CUDA"):
        build_hf_engine(str(tmp_path))
    from deepspeed_tpu_torch.checkpoint import init_llama_params
    with pytest.raises(RuntimeError, match="CUDA"):
        init_llama_params(LlamaConfig.tiny(), seed=0)
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.checkpoint import init_gpt2_params
    from deepspeed_tpu_torch.config.config import Config
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, make_model
    from deepspeed_tpu_torch.runtime.engine import Engine
    cfg = GPT2Config.tiny()
    _, init_fn, loss_fn = make_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_gpt2_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_fn(seed=0)
    params = init_gpt2_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize(loss_fn=loss_fn, params=params,
                   config={"train_batch_size": 2})
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(loss_fn, params, Config.load({"train_batch_size": 2}))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_checkout(tmp_path, alone):
    """Without a card (here), and from a directory holding nothing of the
    repository but the script, chip_smoke.py exits non-zero and prints no
    result line."""
    if not alone and torch.cuda.is_available():
        pytest.skip("a card is present: the script would run")
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_import_builds_no_kernel():
    """Import every module of the port with process spawning disabled;
    no library may be loaded and no nvcc started. The walk reaches the
    training slice's modules too (config, runtime, ops, models), the WOQ
    slice's (the quantizers and the fp6 GEMM), the ops slice's (norms,
    AdamW, sparse and Evoformer attention), the KV block lifecycle's
    (the prefix cache, drain/replay), the dense families' (their
    models and ragged runners), the MoE families' (Mixtral, the
    grouped MoE layer and the grouped GEMM) and serving telemetry's and
    the fleet's (telemetry, serving, resilience, logging), the
    training slice of the families' (the MoE layer, the keys),
    resumable training's (checkpoints, the elastic agent) and the training
    options' (activation checkpointing, progressive layer drop, the
    dropout kernel)."""
    code = (
        "import subprocess, sys, pkgutil, importlib\n"
        "def _no(*a, **k): raise AssertionError('spawned at import')\n"
        "subprocess.Popen = _no\n"
        "import deepspeed_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "need = {'config.config', 'runtime.engine', 'runtime.lr_schedules',\n"
        "        'runtime.loss_scaler', 'ops.optimizers', 'models.gpt2',\n"
        "        'models._lm_utils', 'ops.kernels.flash_attention',\n"
        "        'ops.kernels.fp6_gemm', 'ops.kernels.quantization',\n"
        "        'ops.fp_quantizer', 'inference.quantization',\n"
        "        'ops.kernels.normalization', 'ops.kernels.fused_optimizer',\n"
        "        'ops.kernels.evoformer', 'ops.sparse_attention',\n"
        "        'ops.evoformer_attn', 'models.registry',\n"
        "        'checkpoint.hf_loader', 'inference.v2.engine_factory',\n"
        "        'utils.random', 'inference.v2.sampling',\n"
        "        'inference.v2.prefix_cache', 'inference.v2.drain',\n"
        "        'models.opt', 'models.bloom', 'models.gpt_neox',\n"
        "        'models.falcon', 'models.phi', 'models._dense',\n"
        "        'inference.v2.opt_runner', 'inference.v2.falcon_phi_runner',\n"
        "        'inference.v2.bloom_gptj_neox_runner', 'models.mixtral',\n"
        "        'moe.sharded_moe', 'ops.kernels.grouped_gemm',\n"
        "        'moe.layer', 'utils.random',\n"
        "        'utils.logging', 'telemetry.registry', 'telemetry.serve',\n"
        "        'telemetry.trace', 'telemetry.attribution',\n"
        "        'telemetry.flight_recorder', 'serving.pool',\n"
        "        'serving.router', 'serving.admission',\n"
        "        'resilience.fault_injection', 'resilience.watchdog',\n"
        "        'resilience.preemption', 'resilience.ledger',\n"
        "        'checkpoint.engine_checkpoint', 'checkpoint.checkpoint_engine',\n"
        "        'checkpoint.zero_to_fp32', 'checkpoint.ds_to_universal',\n"
        "        'elasticity.elasticity', 'elasticity.elastic_agent',\n"
        "        'runtime.activation_checkpointing',\n"
        "        'runtime.progressive_layer_drop', 'ops.kernels.dropout'}\n"
        "assert {p.__name__ + '.' + n for n in need} <= set(names), names\n"
        "from deepspeed_tpu_torch.ops.kernels import _build\n"
        "assert not _build._libs and not _build.build_logs\n"
        "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_registry_carries_every_jax_training_entry_point():
    """Each architecture the JAX registry gives a ``make_model`` either has
    one in the port's registry (the same function's name, callable) or is
    one the port has not ported, which raises naming A9."""
    import ast
    src = (ROOT / "deepspeed_tpu" / "models" / "registry.py").read_text()
    jax_makes = {}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and isinstance(v, ast.Call) \
                        and getattr(v.func, "id", "") == "ArchEntry":
                    make = v.args[2]
                    jax_makes[k.value] = None if isinstance(
                        make, ast.Constant) else make.id
    assert len(jax_makes) >= 20
    from deepspeed_tpu_torch.models import registry as reg
    for arch, make in jax_makes.items():
        if arch in reg.NOT_PORTED:
            with pytest.raises(NotImplementedError, match="A9"):
                reg.get_arch(arch)
            continue
        entry = reg.get_arch(arch)
        assert make is not None and callable(entry.make_model), arch
        # the JAX module's alias (make_llama, make_model_neox, ...) names
        # the same entry point: its family's make_model
        assert entry.make_model.__name__ in (make, "make_model"), arch
        assert entry.make_model.__module__.startswith(
            "deepspeed_tpu_torch.models."), arch
