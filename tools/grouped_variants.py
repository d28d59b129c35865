#!/usr/bin/env python3
"""What bounds the grouped GEMM's wgmma route: variants of
``csrc/grouped_gemm.cu`` timed at ``chip_smoke.py`` phase 29's prefill
shapes on one card.

    python3 tools/grouped_variants.py

Builds each variant of the source (nvcc, plain C interface, as
``ops/kernels/_build.py`` does) into ``build/grouped_variants/`` and
times each at Qwen1.5-MoE-A2.7B's and Mixtral-8x7B's prefill shapes
(gate / up and down, the inputs ``chip_smoke.time_grouped`` makes) in a
CUDA graph (ms a call):

- ``base``: the kernel as it is, at column tiles of 128 and 256 (the
  plan picks one); its output must equal ``ragged_dot``'s bit for bit;
- ``no_epilogue``: the stores skipped;
- ``no_products``: the K loop waits for each stage and frees it, with no
  wgmma (the loads and the handshakes alone);
- ``no_loads``: no TMA, the consumers run their wgmma on whatever the
  ring holds (the products and the epilogue alone).

Each variant is a text patch of the source; a patch that no longer
matches the source stops the script. Needs a CUDA card and nvcc. Prints
a line a shape and, last, one JSON object with the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "deepspeed_tpu_torch" / "ops" / "kernels" / "csrc"
OUT = ROOT / "build" / "grouped_variants"

# variant -> [(text of the source, its replacement)]
PATCHES = {
    "base": [],
    "no_epilogue": [
        ("        if (r >= t.r1) continue;\n        T* yr",
         "        if (r >= t.r1 || r >= 0) continue;\n        T* yr")],
    "no_products": [
        ("#pragma unroll\n        for (int kk = 0; kk < WK / 16; ++kk)\n"
         "          wgmma_ss",
         "#pragma unroll\n        for (int kk = 0; kk < WK / 16 && K < 0; "
         "++kk)\n          wgmma_ss")],
    "no_loads": [
        ("            mbar_wait(empty + s, ((g / ST) & 1) ^ 1);\n",
         "            continue;\n"),
        ("        mbar_wait(full + s, (g / ST) & 1);\n        fence_regs",
         "        fence_regs")],
}

# (name, tokens, top-k, experts, K, N, experts never picked)
SHAPES = (("qwen1p5_moe_prefill", 4096, 4, 60, 2048, 1408, 3),
          ("qwen1p5_moe_prefill_down", 4096, 4, 60, 1408, 2048, 3),
          ("mixtral_8x7b_prefill", 4096, 2, 8, 4096, 14336, 1),
          ("mixtral_8x7b_prefill_down", 4096, 2, 8, 14336, 4096, 1))


def build(name: str) -> subprocess.Popen:
    src = (CSRC / "grouped_gemm.cu").read_text()
    for old, new in PATCHES[name]:
        if old not in src:
            raise SystemExit(f"{name}: the patch no longer matches the "
                             f"source: {old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    from deepspeed_tpu_torch.ops.kernels import _build
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o",
         str(OUT / f"lib{name}.so"), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as c
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops.kernels import _build
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    if not torch.cuda.is_available():
        print("grouped_variants: no CUDA device", file=sys.stderr)
        return 2
    procs = {n: build(n) for n in PATCHES}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{n}: nvcc exit {p.returncode}\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{n}.so"))
        fn = lib.grouped_gemm_launch
        fn.argtypes = _build.SIGNATURES["grouped_gemm"]["grouped_gemm_launch"]
        fn.restype = ctypes.c_int
        libs[n] = fn
    card = c.card_line()
    print(card, flush=True)
    out = {"card": card}
    for name, tokens, k, E, K, N, dead in SHAPES:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(sum(map(ord, name)))
        logits = torch.randn(tokens, E, generator=gen, device="cuda")
        logits[:, E - dead:] = -1e4
        top = torch.topk(logits, k, dim=-1).indices.reshape(-1)
        off = sharded_moe.group_offsets(top, E)
        R = tokens * k
        x = torch.randn(R, K, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(E, K, N, generator=gen, device="cuda")
             * K ** -0.5).bfloat16()
        y = torch.empty(R, N, device="cuda", dtype=torch.bfloat16)
        ref = gg.ragged_dot(x, w, off)
        plan = gg.grouped_plan(R, E, N, torch.bfloat16, 132)
        row = out[name] = {"plan_bn": plan.bn}
        for n, launch in libs.items():
            for bn in ((128, 256) if n == "base" else (plan.bn,)):
                slots = plan.tiles * -(-N // bn)
                grid = min(132, slots + slots % 2)

                def call(launch=launch, bn=bn, grid=grid):
                    err = launch(
                        x.data_ptr(), w.data_ptr(), off.data_ptr(),
                        y.data_ptr(), R, E, K, N, plan.bm, plan.tiles,
                        gg.ROUTE_CODES["wgmma"], bn, grid,
                        gg.DTYPE_CODES[torch.bfloat16],
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{n}/{bn}: cudaError {err}")
                call()
                torch.cuda.synchronize()
                if n == "base" and not torch.equal(y, ref):
                    raise AssertionError(f"{name}: base/{bn} differs from "
                                         f"ragged_dot")
                row[f"{n}/{bn}"] = c._graph_ms(torch, [call])
        print(name + ": " + "; ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k != "plan_bn")
            + f" (plan: {plan.bn})", flush=True)
        del x, w, y, ref
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
