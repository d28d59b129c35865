"""Build and load the port's CUDA kernels (nvcc + ctypes, no torch headers).

Each ``csrc/*.cu`` source compiles on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/`` at the repository root (listed in ``.gitignore``). The
library's name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited source or header rebuilds and a stale
library is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

#: ptxas summaries (``-Xptxas -v``) of the builds this process ran
build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C signatures of each library's entry points
SIGNATURES = {
    "paged_attention": {
        # q, k_pool, v_pool, tables, start_pos, seq_lens, out, k_scales,
        # v_scales, alibi, S, C, H, KV, D, maxb, bs, scale, window, slots,
        # route, grid, dtype code (0 fp32, 1 bf16, 2 fp16), int8 pool,
        # stream
        "paged_prefill_launch": [_P] * 10 + [_I] * 7 + [_F] + [_I] * 6
        + [_P],
        # q, ..., alibi, part, counters, ring_k, ring_v, S, H, KV, D, maxb,
        # bs, scale, window, slots, dtype code, int8 pool, splits, keys per
        # split, ring row stride, ring count, stream
        "paged_decode_launch": [_P] * 14 + [_I] * 6 + [_F] + [_I] * 6
        + [_L, _I, _P],
    },
    # pointers, a host pointer to the int64 strides, B, H, Hk, Tq, Tk, D,
    # scale, causal, dtype code (0 fp32, 1 bf16, 2 fp16), stream
    "flash_attention": {
        "flash_fwd_launch": [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P],
        "flash_bwd_dq_launch": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P],
        "flash_bwd_dkv_launch": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P],
        # q, k, v, dout, o, lse, dlse, dq, dk, dv, dQ workspace, rows, ...
        "flash_bwd_launch": [_P] * 13 + [_I] * 6 + [_F, _I, _I, _P],
    },
    # h, e, targets, out, partials, N, V, C, splits, dtype code (0 fp32,
    # 1 bf16, 2 fp16), stream
    "fused_xent": {
        "xent_fwd_launch": [_P] * 5 + [_I] * 5 + [_P],
        # scale, h, e, targets, lse, out, N, V, C, has_ignore, ignore, z,
        # eps, dtype code, out_f32, cluster size, slab width, slab groups,
        # stream
        "xent_bwd_dh_launch": [_P] * 6 + [_I] * 5 + [_F, _F] + [_I] * 5
        + [_P],
        "xent_bwd_de_launch": [_P] * 6 + [_I] * 5 + [_F, _F] + [_I] * 5
        + [_P],
    },
    # x, values, scale, zero, n, group_size, bits, symmetric, recip,
    # dtype code, route, lanes a group, vectors a lane
    # (quantization.quant_plan), SMs, stream
    "quantization": {
        "quantize_launch": [_P] * 4 + [_L, _I, _I, _I, _F] + [_I] * 5
        + [_P],
    },
    # x, bytes3, scale, out, workspace, counters, M, K, J, is_bf16, route,
    # row tiles, K splits, depth of a split, stream
    "fp6_gemm": {
        "fp6_matmul_launch": [_P] * 6 + [_I] * 8 + [_P],
    },
    # x, w, b, out, rows, hidden, eps, layer_norm, dtype code, route,
    # warps a row, vectors a lane, rows a block (normalization.norm_plan),
    # SMs, stream
    "normalization": {
        "norm_fwd_launch": [_P] * 4 + [_L, _I, _F] + [_I] * 7 + [_P],
    },
    # p, g, m, v, hyper, n, g_is_bf16, stream
    "fused_optimizer": {
        "adamw_launch": [_P] * 5 + [_L, _I, _P],
    },
    # q, k, v, o, row_ptr, tiles, the plan's block_ptr and items, host
    # strides, B, H, Hk, Tq, Tk, D, nq, block_q, scale, dtype code, route
    # code (flash_attention.SPARSE_ROUTE_CODES), grid, stream
    "sparse_attention": {
        "sparse_fwd_launch": [_P] * 9 + [_I] * 8 + [_F, _I, _I, _I, _P],
    },
    # x, w, offsets, y, R, E, K, N, and grouped_gemm.grouped_plan's row
    # tile, row-tile slots, route code, column tile and grid; dtype code,
    # stream
    "grouped_gemm": {
        "grouped_gemm_launch": [_P] * 4 + [_I] * 10 + [_P],
        # x, dy, offsets, dw, R, E, K, N, dtype code, stream
        "grouped_wgrad_launch": [_P] * 4 + [_I] * 5 + [_P],
        # dy, w, offsets, dx, R, E, K, N, dgrad_plan's row tile and
        # row-tile slots, dtype code, stream
        "grouped_dgrad_launch": [_P] * 4 + [_I] * 7 + [_P],
    },
    # q, k, v, o, mask bias, pair bias, host strides, B, N, H, Sq, Sk, D,
    # scale, dtype code, MSA rows a block (evoformer.evo_plan), stream
    "evoformer": {
        "evoformer_fwd_launch": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
    },
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fixed = Path("/usr/local/cuda/bin/nvcc")
    if fixed.exists():
        return str(fixed)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _compile_cmd(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together. Returns name -> library path."""
    names = list(names or SIGNATURES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            _compile_cmd(n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib
