"""Grouped expert GEMM: ``ragged_dot(x, w, group_offsets)``, named after its
JAX counterpart ``jax.lax.ragged_dot`` (``deepspeed_tpu/moe/sharded_moe.py
:230-236``), which runs outside any Pallas kernel. It is the counterpart
of the reference's CUTLASS ``moe_gemm``.

Rows ``x [R, K]`` come sorted by expert; expert ``e`` owns rows
``[offsets[e], offsets[e + 1])`` and multiplies them by ``w[e]`` (``w
[E, K, N]``, the flax ``[E, in, out]`` layout). The offsets are an int32
``[E + 1]`` tensor on the rows' device (``offsets[0] == 0``,
``offsets[E] == R``, non-decreasing): the CUDA kernel
(``csrc/grouped_gemm.cu``) reads them there, so no group size crosses
to the host. Each tile's expert and rows are found from the offsets on
the card; an expert with no rows is never read. The row-tile height and
the route come from :func:`grouped_plan`, from shapes and dtype alone:
16-row tiles at decode on ``mma`` (mma.sync), 128-row tiles at prefill
on ``wgmma`` (a persistent, warp-specialised wgmma + TMA kernel walking
its tiles expert by expert), fp32 on ``f32``.

:func:`ragged_dot` launches the kernel for CUDA tensors (bf16 / fp16 on
the tensor cores with fp32 sums, fp32 on the CUDA cores; another dtype
raises) and runs :func:`ragged_dot_plain`, a per-expert loop of
``x[o_e:o_{e+1}] @ w[e]``, for CPU tensors. Only a launch counts in
:data:`LAUNCHES`: every launch under ``grouped_gemm``, the wgmma route's
also under ``grouped_wgmma``.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import torch

from ...utils.device import sm_count

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"grouped_gemm": 0, "grouped_wgmma": 0}

#: the kernel's row-tile heights
ROW_TILES = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: routes by code: mma.sync, the persistent wgmma kernel, fp32
ROUTE_CODES = {"mma": 0, "wgmma": 1, "f32": 2}
#: the wgmma route's column tiles, widest first
WGMMA_COL_TILES = (256, 128)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class GroupedPlan(NamedTuple):
    bm: int                        # rows of a row tile
    tiles: int                     # row-tile slots (an upper bound)
    route: str                     # "mma", "wgmma" or "f32"
    bn: int                        # columns of a column tile
    col_tiles: int                 # ceil(N / bn)
    grid: int                      # blocks of the launch


@functools.lru_cache(maxsize=1024)
def grouped_plan(R: int, E: int, N: int = 128,
                 dtype: torch.dtype = torch.bfloat16,
                 sms: int = 132) -> GroupedPlan:
    """The launch plan of R rows over E experts into N columns, from
    shapes and dtype alone. The row tile is the smallest that holds the
    mean rows an expert (R / E; 128 past 64); the row-tile slots bound the
    experts' tiles for any split, sum(ceil(n_e / bm)) <= (R + min(E, R)
    (bm - 1)) / bm. The route: fp32 on ``f32`` (64-column tiles); 16-bit
    row tiles of 16 and 32 (decode) on ``mma`` (128-column tiles; a block
    a (row tile, column tile), blocks past the last real tile exit at
    once); 16-bit row tiles of 64 and 128 (prefill) on ``wgmma``, whose
    column tile (256 or 128) moves the fewest bytes a K step over all
    column tiles, ceil(N / bn) (bm + bn) rows of x and columns of w (the
    route is bound by its loads; 256 on a tie), and whose grid is
    persistent, in clusters of two: an even count
    of at most ``sms`` blocks and at most the slots (tiles x col_tiles)
    rounded up to even, block b walking tiles b, b + grid, ... (the
    launch lowers it to twice the clusters the device holds at once)."""
    if R < 1 or E < 1 or N < 1:
        raise ValueError(f"grouped_plan({R}, {E}, {N})")
    mean = R / E
    bm = next((t for t in ROW_TILES if mean <= t), ROW_TILES[-1])
    tiles = (R + min(E, R) * (bm - 1)) // bm
    if dtype == torch.float32:
        route, bn = "f32", 64
    elif bm <= 32:
        route, bn = "mma", 128
    else:
        route = "wgmma"
        bn = min(WGMMA_COL_TILES, key=lambda b: -(-N // b) * (bm + b))
    col_tiles = -(-N // bn)
    slots = tiles * col_tiles
    grid = min(sms - sms % 2, slots + slots % 2) if route == "wgmma" \
        else slots
    return GroupedPlan(bm, tiles, route, bn, col_tiles, grid)


def ragged_dot_plain(x: torch.Tensor, w: torch.Tensor,
                     group_offsets: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each expert's rows times its
    weight, summed in fp32 and cast to x's dtype. Reads the offsets on the
    host: the tests and the card's comparisons use it, the card's main
    path does not."""
    _check(x, w, group_offsets)
    off = group_offsets.tolist()
    if off[0] != 0 or off[-1] != x.shape[0] or any(
            b < a for a, b in zip(off, off[1:])):
        raise ValueError(f"offsets must rise from 0 to {x.shape[0]}: {off}")
    y = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype,
                    device=x.device)
    for e in range(w.shape[0]):
        lo, hi = off[e], off[e + 1]
        if hi > lo:
            y[lo:hi] = (x[lo:hi].float() @ w[e].float()).to(x.dtype)
    return y


def _check(x: torch.Tensor, w: torch.Tensor, off: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"ragged_dot: x {tuple(x.shape)} against w "
                         f"{tuple(w.shape)}; want x [R, K], w [E, K, N]")
    if off.dim() != 1 or off.shape[0] != w.shape[0] + 1:
        raise ValueError(f"group_offsets {tuple(off.shape)}: want "
                         f"[{w.shape[0] + 1}]")
    if w.dtype != x.dtype:
        raise ValueError(f"w dtype {w.dtype} != x dtype {x.dtype}")
    for name, t in (("w", w), ("group_offsets", off)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if not x.is_cuda:
        return
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype}: the kernel takes bf16, fp16 "
                         f"or fp32")
    if off.dtype != torch.int32:
        raise ValueError(f"group_offsets must be int32, got {off.dtype}")
    K, N = w.shape[1], w.shape[2]
    if x.dtype != torch.float32 and (K % 8 or N % 8):
        raise ValueError(f"K ({K}) and N ({N}) must be multiples of 8 for "
                         f"the 16-bit kernel's 16-byte copies")
    for name, t in (("x", x), ("w", w), ("group_offsets", off)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


_LIB = None                        # the loaded kernel library


def ragged_dot(x: torch.Tensor, w: torch.Tensor,
               group_offsets: torch.Tensor) -> torch.Tensor:
    """``y[o_e:o_{e+1}] = x[o_e:o_{e+1}] @ w[e]`` for each expert e. x [R,
    K] sorted by expert, w [E, K, N] in x's dtype, group_offsets int32
    [E + 1] from 0 to R on x's device. Returns [R, N] in x's dtype (the
    CUDA kernel on a card, the plain version on the CPU)."""
    _check(x, w, group_offsets)
    if not x.is_cuda:
        return ragged_dot_plain(x, w, group_offsets)
    global _LIB
    R, (E, K, N) = x.shape[0], w.shape
    y = torch.empty((R, N), dtype=x.dtype, device=x.device)
    if R == 0:
        return y
    plan = grouped_plan(R, E, N, x.dtype, sm_count(x.device))
    if _LIB is None:
        from . import _build
        _LIB = _build.load("grouped_gemm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _LIB.grouped_gemm_launch(
        x.data_ptr(), w.data_ptr(), group_offsets.data_ptr(), y.data_ptr(),
        R, E, K, N, plan.bm, plan.tiles, ROUTE_CODES[plan.route], plan.bn,
        plan.grid, DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"grouped_gemm ({plan.route}) failed: cudaError "
                           f"{err}")
    LAUNCHES["grouped_gemm"] += 1
    if plan.route == "wgmma":
        LAUNCHES["grouped_wgmma"] += 1
    return y
