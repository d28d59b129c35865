#!/usr/bin/env python3
"""Step, serving and op times of the PyTorch port in two checkouts, on one
card.

    python3 tools/port_step_ab.py OLD_CHECKOUT NEW_CHECKOUT [--rounds N]
                                  [--trace | --serve | --evo]

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
    modes = [m for m in ("serve", "evo") if f"--{m}" in argv]
    if len(args) != 2 or len(modes) > 1 or (modes and "--trace" in argv):
        print(__doc__, file=sys.stderr)
        return 2
    mode = modes[0] if modes else "train"
    script = {"train": RUN_TRAIN, "serve": RUN_SERVE, "evo": RUN_EVO}[mode]
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
