"""Offline checkpoint consolidation (port of
``deepspeed_tpu/checkpoint/zero_to_fp32.py``): the param leaves of a saved
tag, by their recorded paths, as fp32 — no engine and no device needed:

    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out.npz>

``<ckpt_dir>`` is either a ``<save_dir>`` holding a ``latest`` file or a
``<save_dir>/<tag>`` directory. The output npz maps param paths (e.g.
``h_0/attn/c_attn/kernel``) to fp32 arrays. A bf16 leaf (stored as raw
2-byte void, ``meta["dtypes"]`` naming it) is widened exactly.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np

from .engine_checkpoint import BF16, LATEST_FILE, META_FILE, STATE_FILE

#: leaf-path prefix of the params field within the saved TrainState
_PARAMS_PREFIXES = ("params/", "1/")


def resolve_ckpt_dir(path: str) -> str:
    """Accept either a save_dir (with a ``latest`` file) or a tag dir."""
    if os.path.exists(os.path.join(path, META_FILE)):
        return path
    latest = os.path.join(path, LATEST_FILE)
    if os.path.exists(latest):
        with open(latest) as f:
            return os.path.join(path, f.read().strip())
    raise FileNotFoundError(
        f"{path} is neither a checkpoint dir (no {META_FILE}) nor a save dir "
        f"(no {LATEST_FILE})")


def _bf16_to_fp32(arr: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.uint32)
    return (bits << 16).view(np.float32)


def extract_fp32_params(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """Read a saved checkpoint and return {param_path: fp32 array}."""
    ckpt_dir = resolve_ckpt_dir(ckpt_dir)
    with open(os.path.join(ckpt_dir, META_FILE)) as f:
        meta = json.load(f)
    paths = meta.get("paths")
    if paths is None:
        raise ValueError(
            f"{ckpt_dir} was written before leaf paths were recorded "
            "(format_version < 1 with paths); re-save the checkpoint")
    dtypes = meta.get("dtypes") or [None] * len(paths)
    out = {}
    with np.load(os.path.join(ckpt_dir, STATE_FILE)) as data:
        for i, p in enumerate(paths):
            for prefix in _PARAMS_PREFIXES:
                if p.startswith(prefix):
                    arr = data[f"leaf_{i:05d}"]
                    if dtypes[i] == BF16:
                        arr = _bf16_to_fp32(arr)
                    elif np.issubdtype(arr.dtype, np.floating):
                        arr = arr.astype(np.float32)
                    out[p[len(prefix):]] = arr
                    break
    if not out:
        raise ValueError(f"no param leaves found in {ckpt_dir}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32",
        description="Consolidate a checkpoint into one fp32 npz (the "
                    "zero_to_fp32 analogue; the format holds whole "
                    "arrays, so no shard merging is needed).")
    ap.add_argument("ckpt_dir", help="save dir (with 'latest') or tag dir")
    ap.add_argument("output", help="output .npz path")
    args = ap.parse_args(argv)
    params = extract_fp32_params(args.ckpt_dir)
    np.savez(args.output, **params)
    total = sum(a.size for a in params.values())
    print(f"wrote {len(params)} tensors / {total / 1e6:.1f}M params "
          f"-> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
