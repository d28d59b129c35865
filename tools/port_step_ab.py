#!/usr/bin/env python3
"""Step, serving and op times of the PyTorch port in two checkouts, on one
card.

    python3 tools/port_step_ab.py OLD_CHECKOUT NEW_CHECKOUT [--rounds N]
                                  [--trace | --serve | --evo | --ops |
                                   --grouped | --b18]

Runs the same work in each checkout, in turns old, new, new, old
(``--rounds`` such pairs, 1 by default), each run in a process of its own
from the checkout's root, its kernels built there first. Two versions are
only comparable within one card and one call, so both run here side by
side. Prints one line a run and, last, one JSON object of the per-run
readings. Needs a CUDA card; exits non-zero if a run fails.

- By default: ``chip_smoke.py``'s two training phases -- phase 7
  (GPT-2-1.3B, ``GPT2Config.xl_1p3b``, micro batch 4 x gas 2) and phase 11
  (the gpt1p3b bench configuration, fused and chunked loss): step times
  (ms per ``train_batch``, CUDA events) and MFU. With ``--trace`` each run
  also profiles one phase-7 ``train_batch`` (torch.profiler) and reports
  its device busy time, idle share and the device ms of each flash kernel
  (``flash_ms``) in that step.
- ``--serve``: phase 3 (TinyLlama, 16 x 512-token prompts: prefill s,
  decode tok/s) and phase 15's bf16 mode alone (Llama-2-7B, 64 x 512:
  prefill s, decode tok/s).
- ``--evo``: ``DS4Sci_EvoformerAttention``'s kernel at phase 21's MSA and
  triangle shapes with both biases, the mask bias only and neither, and
  ``F.scaled_dot_product_attention`` with mask + pair bias as its
  ``attn_mask`` beside them, each in a CUDA graph (ms a call).
- ``--ops``: the norm kernels and the group quantizer at phase 18's and
  phase 17's shapes through their entry points -- ``fused_rms_norm`` on
  [32768, 4096] bf16, ``fused_layer_norm`` on [8192, C] bf16 for C 2048,
  4096 and 8192, ``quantize_blockwise`` sym and asym on the [4096, 11008]
  bf16 leaf at 8 bits / groups of 128, 4 bits / 128 and 8 bits / 256 --
  and ``F.rms_norm`` / ``F.layer_norm`` beside the norms; phase 20's
  block-sparse forward (``flash_attention_sparse`` on BSLongformer and
  BigBird at B 4, T 4096, 16 heads of 64 in bf16 and fp16, and
  BSLongformer at head dim 128) with ``F.scaled_dot_product_attention``
  on the boolean mask beside it (an input a tree's kernel refuses is
  recorded as refused): each by torch.profiler's device time and in a
  CUDA graph (ms a call); then phase 15's load-time quantize seconds of
  Llama-2-7B's int8 and int4 modes (``quantize_model_params`` on the
  seeded weights); then the grouped shapes below.
- ``--grouped``: the grouped expert GEMM alone (``ragged_dot``, its
  library built alone) at phase 29's shapes -- Qwen1.5-MoE-A2.7B (16 x
  256 prompt tokens top-4 over 60 experts, 3 never picked; 2048 -> 1408
  and back) and Mixtral-8x7B (top-2 over 8, 1 never picked; 4096 ->
  14336 and back) at prefill, and both at a 16-token decode step -- with
  ``torch._grouped_mm`` on the same inputs beside each, by torch.profiler
  and in a CUDA graph (ms a call).
- ``--b18``: the grouped GEMM's backward alone (``ragged_dot_dgrad`` and
  ``ragged_dot_wgrad``, and the forward ``ragged_dot`` on the same
  inputs; the library built alone) at phase 32 (b)'s shapes
  -- Qwen1.5-MoE-A2.7B's gate / up and down (2 x 1024 tokens top-4 over
  60 experts, 3 never picked; 2048 <-> 1408) -- and at Mixtral-8x7B's
  expert product (2048 tokens top-2 over 8, 1 never picked; 4096 <->
  14336), with ``torch._grouped_mm`` computing the same products beside
  each, by torch.profiler and in a CUDA graph (ms a call).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN_TRAIN = r"""
import json, sys, torch, chip_smoke as c
trace = sys.argv[1] == "1"
c.phase_build()
t = c.phase_training(torch, trace)
b = c.phase_gpt1p3b(torch, False)
ms = lambda r: sum(r["step_ms"]) / len(r["step_ms"])
print("AB " + json.dumps({
    "phase7_ms": ms(t), "phase7_mfu": t["mfu"],
    "gpt1p3b_fused_ms": ms(b["fused"]), "gpt1p3b_fused_mfu": b["fused"]["mfu"],
    "gpt1p3b_chunked_ms": ms(b["chunked"]),
    "gpt1p3b_chunked_mfu": b["chunked"]["mfu"],
    **({"phase7_trace": t["trace"]} if trace else {})}))
"""

RUN_SERVE = r"""
import json, torch, chip_smoke as c
c.phase_build()
s, eng, _ = c.phase_serving(torch)
del eng
torch.cuda.empty_cache()
c.WOQ_MODES = {"bf16": None}
w = c.phase_woq_serving(torch)["bf16"]
print("AB " + json.dumps({
    "tinyllama_prefill_s": s["prefill_s"],
    "tinyllama_decode_tok_s": s["decode_tokens"] / s["decode_s"],
    "llama7b_prefill_s": w["prefill_s"],
    "llama7b_decode_tok_s": w["decode_tok_s"]}))
"""

RUN_EVO = r"""
import json, torch, chip_smoke as c
import torch.nn.functional as F
from deepspeed_tpu_torch.ops.kernels import evoformer as ek
c.phase_build()
g = torch.Generator(device="cuda").manual_seed(21)
out = {}
for name, shape in (("msa", c.EVO_MSA), ("triangle", c.EVO_TRI)):
    q, k, v, mask, pair = c._evo_inputs(torch, g, shape)
    mb, pb = mask[:, :, 0, 0], pair[:, 0]
    r = {lab: c._graph_ms(torch, [
        lambda a=a, b=b: ek.evoformer_flash(q, k, v, a, b)])
        for lab, a, b in (("both", mb, pb), ("mask", mb, None),
                          ("none", None, None))}
    B, N, S, Hh, Dh = shape
    qs, ks, vs = (t.reshape(B * N, S, Hh, Dh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    am = (mask + pair).reshape(B * N, Hh, S, S).to(q.dtype)
    r["sdpa"] = c._graph_ms(torch, [
        lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am)])
    out[name] = r
    del q, k, v, mask, pair, qs, ks, vs, am
    torch.cuda.empty_cache()
print("AB " + json.dumps(out))
"""


RUN_OPS = r"""
import json, torch, chip_smoke as c
import torch.nn.functional as F
from deepspeed_tpu_torch.ops.kernels import normalization as nm
from deepspeed_tpu_torch.ops.kernels import quantization as qz
c.phase_build()
g = torch.Generator(device="cuda").manual_seed(18)
rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
out = {}
def both(name, fn):
    out[name] = {"device_ms": c._device_ms(torch, fn, 20),
                 "graph_ms": c._graph_ms(torch, [fn])}
x = rnd(32768, 4096).bfloat16()
w = (1 + 0.1 * rnd(4096)).bfloat16()
both("rms_norm [32768, 4096]", lambda: nm.fused_rms_norm(x, w, eps=1e-5))
both("F.rms_norm [32768, 4096]", lambda: F.rms_norm(x, (4096,), w, 1e-5))
del x
for C in (2048, 4096, 8192):
    x = rnd(8192, C).bfloat16()
    w, b = 1 + 0.1 * rnd(C), 0.1 * rnd(C)
    w16, b16 = w.bfloat16(), b.bfloat16()
    both(f"layer_norm [8192, {C}]",
         lambda: nm.fused_layer_norm(x, w, b, eps=1e-5))
    both(f"F.layer_norm [8192, {C}]",
         lambda: F.layer_norm(x, (C,), w16, b16, 1e-5))
    del x
leaf = (rnd(4096, 11008) / 64.0).bfloat16()
for sym in (True, False):
    for bits, gs in ((8, 128), (4, 128), (8, 256)):
        both(f"quantize_{'sym' if sym else 'asym'} {bits} bits g{gs}",
             lambda: qz.quantize_blockwise(leaf, bits=bits, group_size=gs,
                                           symmetric=sym))
del leaf
# phase 20's block-sparse forward (BERT-large's 16 heads of 64 over 4 x
# 4096 tokens) on both layouts, fp16 and head dim 128 beside it, and SDPA
# on the token-level boolean mask; a kernel that refuses an input (fp16 on
# a tree before fault C3) is recorded as refused
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
H, T = c.SPARSE_H, c.SPARSE_T
lays = {"bslongformer": sa.BSLongformerSparsityConfig(
            H, block=128, num_sliding_window_blocks=3,
            global_block_indices=[0]).make_layout(T),
        "bigbird": sa.BigBirdSparsityConfig(
            H, block=128, num_random_blocks=1, num_sliding_window_blocks=3,
            num_global_blocks=1, different_layout_per_head=True
            ).make_layout(T)}
for D, dt in ((64, torch.bfloat16), (64, torch.float16),
              (128, torch.bfloat16)):
    q, k, v = (rnd(c.SPARSE_B, H, T, D).to(dt) for _ in range(3))
    for name, lay in lays.items():
        if D == 128 and name == "bigbird":
            continue
        label = f"flash_sparse_fwd {name} {str(dt)[6:]} D{D}"
        try:
            both(label, lambda: fa.flash_attention_sparse(
                q, k, v, lay, layout="BHTD"))
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[label] = {"refused": str(e)[:100]}
        if dt == torch.bfloat16:
            mask = sa.token_mask(lay, 128, "cuda")[None]
            both(f"sdpa on the mask {name} D{D}",
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        attn_mask=mask))
            del mask
    del q, k, v
    torch.cuda.empty_cache()
# phase 15's load-time quantize seconds: Llama-2-7B's seeded weights on
# the card, then quantize_model_params for its int8 and int4 modes
import time
from deepspeed_tpu_torch.checkpoint import init_llama_params
from deepspeed_tpu_torch.inference.quantization import quantize_model_params
from deepspeed_tpu_torch.models.llama import LlamaConfig
for mode in ("int8", "int4"):
    params = init_llama_params(LlamaConfig.llama2_7b(), seed=0,
                               device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = quantize_model_params(params, c._woq_config(mode))
    torch.cuda.synchronize()
    out[f"llama2_7b {mode} quantize s"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
"""


GROUPED = r"""
from deepspeed_tpu_torch.moe import sharded_moe
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
# (name, tokens, k, E, K, N, experts never picked), inputs as
# chip_smoke.time_grouped makes them
for name, tokens, k, E, K, N, dead in (
        ("qwen1p5_moe_prefill", 4096, 4, 60, 2048, 1408, 3),
        ("qwen1p5_moe_prefill_down", 4096, 4, 60, 1408, 2048, 3),
        ("mixtral_8x7b_prefill", 4096, 2, 8, 4096, 14336, 1),
        ("mixtral_8x7b_prefill_down", 4096, 2, 8, 14336, 4096, 1),
        ("qwen1p5_moe_decode", 16, 4, 60, 2048, 1408, 0),
        ("mixtral_8x7b_decode", 16, 2, 8, 4096, 14336, 0)):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(sum(map(ord, name)))
    logits = torch.randn(tokens, E, generator=gen, device="cuda")
    if dead:
        logits[:, E - dead:] = -1e4
    top = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    off = sharded_moe.group_offsets(top, E)
    x = torch.randn(tokens * k, K, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(E, K, N, generator=gen, device="cuda")
         * K ** -0.5).bfloat16()
    both(f"grouped {name}", lambda: gg.ragged_dot(x, w, off))
    if hasattr(torch, "_grouped_mm"):
        ends = off[1:].contiguous()
        both(f"_grouped_mm {name}",
             lambda: torch._grouped_mm(x, w, offs=ends))
    del x, w
    torch.cuda.empty_cache()
"""

RUN_GROUPED = r"""
import json, torch, chip_smoke as c
from deepspeed_tpu_torch.ops.kernels import _build
_build.build(["grouped_gemm"])
out = {}
def both(name, fn):
    out[name] = {"device_ms": c._device_ms(torch, fn, 20),
                 "graph_ms": c._graph_ms(torch, [fn])}
""" + GROUPED + 'print("AB " + json.dumps(out))\n'

RUN_OPS += GROUPED + 'print("AB " + json.dumps(out))\n'

RUN_B18 = RUN_GROUPED.split("from deepspeed_tpu_torch.moe")[0] + r"""
from deepspeed_tpu_torch.moe import sharded_moe
from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
for name, tokens, k, E, K, N, dead in (
        ("qwen1p5_moe_train_gate_up", 2048, 4, 60, 2048, 1408, 3),
        ("qwen1p5_moe_train_down", 2048, 4, 60, 1408, 2048, 3),
        ("mixtral_8x7b_expert", 2048, 2, 8, 4096, 14336, 1)):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(sum(map(ord, name)))
    logits = torch.randn(tokens, E, generator=gen, device="cuda")
    logits[:, E - dead:] = -1e4
    top = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    off = sharded_moe.group_offsets(top, E)
    x = torch.randn(tokens * k, K, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(E, K, N, generator=gen, device="cuda")
         * K ** -0.5).bfloat16()
    dy = torch.randn(tokens * k, N, generator=gen, device="cuda").bfloat16()
    both(f"fwd {name}", lambda: gg.ragged_dot(x, w, off))
    both(f"dX {name}", lambda: gg.ragged_dot_dgrad(dy, w, off))
    both(f"dW {name}", lambda: gg.ragged_dot_wgrad(x, dy, off))
    if hasattr(torch, "_grouped_mm"):
        ends = off[1:].contiguous()
        both(f"_grouped_mm dX {name}",
             lambda: torch._grouped_mm(dy, w.transpose(1, 2), offs=ends))
        both(f"_grouped_mm dW {name}",
             lambda: torch._grouped_mm(x.t(), dy, offs=ends))
    del x, w, dy
    torch.cuda.empty_cache()
print("AB " + json.dumps(out))
"""


def run(checkout: Path, script: str, trace: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c", script, str(int(trace))],
                          cwd=checkout, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{checkout}: exit {proc.returncode}")
    return json.loads(lines[-1][len("AB "):])


def describe(name: str, r: dict, mode: str) -> str:
    if mode == "serve":
        return (f"[serve ab] {name}: TinyLlama prefill "
                f"{r['tinyllama_prefill_s']:.4f} s, decode "
                f"{r['tinyllama_decode_tok_s']:.1f} tok/s; Llama-2-7B bf16 "
                f"prefill {r['llama7b_prefill_s']:.4f} s, decode "
                f"{r['llama7b_decode_tok_s']:.1f} tok/s")
    if mode in ("ops", "grouped", "b18"):
        return f"[{mode} ab] {name}: " + "; ".join(
            f"{op} {t:.4f}" if isinstance(t, float) else
            f"{op} refused ({t['refused']})" if "refused" in t else
            f"{op} device {t['device_ms']} graph {t['graph_ms']:.4f}"
            for op, t in r.items())
    if mode == "evo":
        return f"[evo ab] {name}: " + "; ".join(
            f"{case} " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
            for case, ms in r.items())
    text = (f"[step ab] {name}: phase 7 {r['phase7_ms']:.1f} ms "
            f"(MFU {r['phase7_mfu']:.4f}); gpt1p3b fused "
            f"{r['gpt1p3b_fused_ms']:.1f} ms (MFU "
            f"{r['gpt1p3b_fused_mfu']:.4f}), chunked "
            f"{r['gpt1p3b_chunked_ms']:.1f} ms")
    if "phase7_trace" in r:
        tr = r["phase7_trace"]
        text += (f"\n[step ab] {name} phase 7 trace: busy "
                 f"{tr.get('busy_s')} of {tr.get('wall_s')} s; flash "
                 f"{json.dumps(tr.get('flash_ms'))}")
    return text


def main(argv) -> int:
    args = [a for a in argv if not a.startswith("--")]
    rounds = 1
    if "--rounds" in argv:
        rounds = int(argv[argv.index("--rounds") + 1])
        args.remove(str(rounds))
    modes = [m for m in ("serve", "evo", "ops", "grouped", "b18")
             if f"--{m}" in argv]
    if len(args) != 2 or len(modes) > 1 or (modes and "--trace" in argv):
        print(__doc__, file=sys.stderr)
        return 2
    mode = modes[0] if modes else "train"
    script = {"train": RUN_TRAIN, "serve": RUN_SERVE, "evo": RUN_EVO,
              "ops": RUN_OPS, "grouped": RUN_GROUPED, "b18": RUN_B18}[mode]
    old, new = (Path(a).resolve() for a in args)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"[ab] {card}", flush=True)
    results = {"old": [], "new": [], "card": card}
    for _ in range(rounds):
        for name, path in (("old", old), ("new", new), ("new", new),
                           ("old", old)):
            r = run(path, script, "--trace" in argv)
            results[name].append(r)
            print(describe(name, r, mode), flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
