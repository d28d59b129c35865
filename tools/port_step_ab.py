#!/usr/bin/env python3
"""Training step times of the PyTorch port in two checkouts, on one card.

    python3 tools/port_step_ab.py OLD_CHECKOUT NEW_CHECKOUT [--rounds N]
                                  [--trace]

Runs ``chip_smoke.py``'s two training phases -- phase 7 (GPT-2-1.3B,
``GPT2Config.xl_1p3b``, micro batch 4 x gas 2) and phase 11 (the gpt1p3b
bench configuration, fused and chunked loss) -- in each checkout, in turns
old, new, new, old (``--rounds`` such pairs, 1 by default), each run in a
process of its own from the checkout's root, its kernels built there first.
Two versions are only comparable within one card and one call, so both
run here side by side. Prints one line a run and, last, one JSON object
of the per-run step times (ms per ``train_batch``, CUDA events) and MFU.
With ``--trace`` each run also profiles one phase-7 ``train_batch``
(torch.profiler) and reports its device busy time, idle share and the
device ms of each flash kernel (``flash_ms``) in that step.
Needs a CUDA card; exits non-zero if a run fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, sys, torch, chip_smoke as c
trace = sys.argv[1] == "1"
c.phase_build()
t = c.phase_training(torch, trace)
b = c.phase_gpt1p3b(torch, False)
ms = lambda r: sum(r["step_ms"]) / len(r["step_ms"])
print("STEP_AB " + json.dumps({
    "phase7_ms": ms(t), "phase7_mfu": t["mfu"],
    "gpt1p3b_fused_ms": ms(b["fused"]), "gpt1p3b_fused_mfu": b["fused"]["mfu"],
    "gpt1p3b_chunked_ms": ms(b["chunked"]),
    "gpt1p3b_chunked_mfu": b["chunked"]["mfu"],
    **({"phase7_trace": t["trace"]} if trace else {})}))
"""


def run(checkout: Path, trace: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, str(int(trace))],
                          cwd=checkout, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("STEP_AB ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{checkout}: exit {proc.returncode}")
    return json.loads(lines[-1][len("STEP_AB "):])


def main(argv) -> int:
    args = [a for a in argv if not a.startswith("--")]
    rounds = 1
    if "--rounds" in argv:
        rounds = int(argv[argv.index("--rounds") + 1])
        args.remove(str(rounds))
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (Path(a).resolve() for a in args)
    results = {"old": [], "new": []}
    for _ in range(rounds):
        for name, path in (("old", old), ("new", new), ("new", new),
                           ("old", old)):
            r = run(path, "--trace" in argv)
            results[name].append(r)
            print(f"[step ab] {name}: phase 7 {r['phase7_ms']:.1f} ms "
                  f"(MFU {r['phase7_mfu']:.4f}); gpt1p3b fused "
                  f"{r['gpt1p3b_fused_ms']:.1f} ms (MFU "
                  f"{r['gpt1p3b_fused_mfu']:.4f}), chunked "
                  f"{r['gpt1p3b_chunked_ms']:.1f} ms", flush=True)
            if "phase7_trace" in r:
                tr = r["phase7_trace"]
                print(f"[step ab] {name} phase 7 trace: busy "
                      f"{tr.get('busy_s')} of {tr.get('wall_s')} s; flash "
                      f"{json.dumps(tr.get('flash_ms'))}", flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
