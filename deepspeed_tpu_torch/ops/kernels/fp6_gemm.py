"""Fused FP6 (e3m2) weight-only GEMM (port of
``deepspeed_tpu/ops/kernels/fp6_gemm.py``).

Weights cross device memory at 6 bits a value and are decoded to the
compute dtype tile by tile inside the GEMM. ``fp6_matmul`` replaces the
Pallas kernel ``_fp6_kernel`` with hand-written CUDA (``csrc/fp6_gemm.cu``)
on routes that :func:`fp6_plan` picks from the shapes alone. x and the
byte planes arrive by TMA, every thread of a block decodes each 64-deep
weight slab once into a bf16 tile, and ``wgmma`` multiplies it while the
block decodes the next:

- decode (M <= ``FP6_DECODE_MAX_M``): a block holds every row (one or two
  64-row tiles) and 32 packed columns (128 output columns);
- prefill: 64-, 128- or 256-row tiles, so each weight is decoded once per
  tile of x, whichever the plan's model of the card's time ranks first
  (256 rows as a rule).

Where the tiles alone leave SMs idle, K splits into up to 8 ranges: each
block writes its fp32 partial tile to a workspace, waits for the tile's
other blocks (a cooperative launch: all resident at once) and sums its
slice of the tile over the partials in K order (the same bits every
call). A shape without 16-byte rows (K % 8 or N/4 % 16) runs an
``mma.sync`` kernel with plain loads, its K split summed over a
thread-block cluster in distributed shared memory.

Storage layout (:func:`fp6_gemm_pack`): a [K, N] weight (N % 4 == 0)
becomes

- ``bytes3`` [3, K, N/4] uint8 — the byte planes of the 24-bit word packing
  the 4 codes of columns (j, j + N/4, j + N/2, j + 3N/4);
- ``scale`` [4, N/4] f32 — per-column scales, plane-major;

so output column ``p * N/4 + j`` comes from plane ``p`` of packed column
``j`` and the kernel writes row-major [M, N] directly.

:func:`fp6_matmul` launches the kernel for a CUDA tensor (bf16 on the
tensor cores, fp32 on a CUDA-core parity kernel; another dtype raises) and
runs :func:`fp6_matmul_plain` for a CPU tensor. Both decode each weight,
scale it in f32 and cast it to x's dtype before the product (f32 sums).
Only a launch counts in :data:`LAUNCHES`. Packing and unpacking are plain
PyTorch, as they are jnp in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from ..fp_quantizer import _minifloat_decode, _minifloat_encode
from ...utils.device import scratch, sm_count

_E, _M = 3, 2                      # e3m2
_BIAS = 2 ** (_E - 1) - 1          # 3
_MAX = 2.0 ** _BIAS * (2.0 - 2.0 ** (-_M))      # 14.0

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"fp6_matmul": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: the largest M that takes the decode route (M rows fit one block);
#: larger M takes the prefill route, where 256-row tiles also compete
FP6_DECODE_MAX_M = 128
#: the most K ranges a split takes (the split's merge holds them in
#: registers; the mma.sync kernel's cluster, at its portable size)
SK_MAX_CLUSTER = 8
#: rows of a row tile (x mt), packed columns of a block, depth of a K-step
SK_BM, SK_JT, SK_BK = 64, 32, 64
#: CUDA's grid limit on the y and z axes
GRID_YZ_MAX = 65535
#: the kernel each route runs, as the entry point numbers them: the wgmma
#: kernel, or the mma.sync kernel for shapes without 16-byte rows
ROUTES = {"decode": 0, "prefill": 0, "mma": 1}
#: the wgmma kernel's time for one 64-deep K-step of a block of 1, 2 or 4
#: row tiles, in microseconds, on SMs that hold as many such blocks as fit
#: (two at one row tile, one otherwise), and the device memory rate its
#: split's workspace moves at: an H100's readings (``chip_smoke.py
#: --fp6-sweep``), by which :func:`fp6_plan` ranks its candidates
STEP_US = {1: 1.09, 2: 0.82, 4: 1.11}
WS_BYTES_PER_US = 3.0e6


class Fp6Plan(NamedTuple):
    route: str                     # a key of ROUTES
    mt: int                        # 64-row tiles a block holds
    ks: int                        # K ranges
    kps: int                       # depth of a K range (a multiple of 64)
    grid: Tuple[int, int, int]     # (ks, column tiles, row tiles)
    block: int                     # threads


@functools.lru_cache(maxsize=1024)
def fp6_plan(M: int, K: int, J: int, sms: int) -> Fp6Plan:
    """The bf16 kernel's launch plan for x [M, K] against J packed columns
    on a card of ``sms`` SMs, from shapes alone.

    Rows of 16 bytes (K % 8 == 0, J % 16 == 0) take the wgmma kernel,
    route decode (M <= FP6_DECODE_MAX_M) or prefill. Its candidates are
    1, 2 or 4 row tiles a block (none more than half empty) with K split
    into 1-8 ranges of at least two steps, a split (its blocks wait for
    each other) held to one wave; the plan is the one that
    :func:`plan_us` ranks first. Other shapes take the mma.sync kernel
    with plain loads (route ``"mma"``), K split over a cluster until the
    blocks fill a wave."""
    if min(M, K, J, sms) < 1:
        raise ValueError(f"fp6_plan({M}, {K}, {J}, {sms})")
    slabs = -(-K // SK_BK)
    if K % 8 or J % 16:
        mt = 1 if M <= SK_BM else 2
        tiles = -(-J // SK_JT) * -(-M // (SK_BM * mt))
        ks = min((2 if mt == 1 else 1) * sms // tiles, SK_MAX_CLUSTER,
                 slabs // 2)
        return make_plan("mma", M, K, J, mt, max(1, ks))
    route = "decode" if M <= FP6_DECODE_MAX_M else "prefill"
    best, best_us = None, 0.0
    for mt in (1, 2, 4):
        if mt > 1 and SK_BM * mt // 2 >= M:
            continue
        for ks in range(1, min(SK_MAX_CLUSTER, max(1, slabs // 2)) + 1):
            plan = make_plan(route, M, K, J, mt, ks)
            gx, gy, gz = plan.grid
            if plan.ks < ks or (plan.ks > 1 and gx * gy * gz
                                > (2 if mt == 1 else 1) * sms):
                continue
            us = plan_us(plan, M, J, sms)
            if best is None or us < best_us:
                best, best_us = plan, us
    return best


def make_plan(route: str, M: int, K: int, J: int, mt: int,
              ks: int) -> Fp6Plan:
    """``mt`` 64-row tiles a block and K in at most ``ks`` ranges of
    ``kps`` (a multiple of the 64-deep step, the last ragged; fewer ranges
    where ``ks`` does not divide the steps)."""
    slabs = -(-K // SK_BK)
    kps = -(-slabs // ks) * SK_BK
    ks = -(-K // kps)
    grid = (ks, -(-J // SK_JT), -(-M // (SK_BM * mt)))
    return Fp6Plan(route, mt, ks, kps, grid,
                   256 if route == "mma" or mt == 1 else 512)


def plan_us(plan: Fp6Plan, M: int, J: int, sms: int) -> float:
    """The wgmma kernel's time along ``plan`` as the H100's readings model
    it: waves of blocks x K-steps a block x ``STEP_US``, plus a split's
    workspace traffic (each fp32 partial written once and read once)."""
    gx, gy, gz = plan.grid
    waves = -(-gx * gy * gz // ((2 if plan.mt == 1 else 1) * sms))
    ws = 2 * plan.ks * M * 4 * J * 4 if plan.ks > 1 else 0
    return (waves * plan.kps // SK_BK * STEP_US[plan.mt]
            + ws / WS_BYTES_PER_US)


class Fp6GemmWeight(NamedTuple):
    bytes3: torch.Tensor           # [3, K, N/4] uint8
    scale: torch.Tensor            # [4, N/4] f32
    shape: Tuple[int, int]         # (K, N)


def fp6_gemm_pack(w: torch.Tensor) -> Fp6GemmWeight:
    """Quantize a [K, N] weight (N % 4 == 0) to the GEMM layout with
    per-column scales (a true division by 14, as the JAX package)."""
    K, N = w.shape
    if N % 4:
        raise ValueError(f"N ({N}) must be divisible by 4")
    J = N // 4
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=0), min=1e-12) / _MAX      # [N]
    codes = _minifloat_encode(wf / scale[None, :], _E, _M).to(torch.int32)
    word = (codes[:, :J] | (codes[:, J:2 * J] << 6)
            | (codes[:, 2 * J:3 * J] << 12) | (codes[:, 3 * J:] << 18))
    bytes3 = torch.stack([word & 0xFF, (word >> 8) & 0xFF,
                          (word >> 16) & 0xFF]).to(torch.uint8)
    return Fp6GemmWeight(bytes3=bytes3, scale=scale.reshape(4, J),
                         shape=(K, N))


def _words(fw: Fp6GemmWeight) -> torch.Tensor:
    b = fw.bytes3.to(torch.int32)
    return b[0] | (b[1] << 8) | (b[2] << 16)                         # [K, J]


def fp6_gemm_unpack(fw: Fp6GemmWeight) -> torch.Tensor:
    """Full f32 decode of the GEMM layout: [K, N]."""
    word = _words(fw)
    return torch.cat([_minifloat_decode((word >> (6 * p)) & 0x3F, _E, _M)
                      * fw.scale[p][None, :] for p in range(4)], dim=1)


def fp6_matmul_plain(x: torch.Tensor, fw: Fp6GemmWeight) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the weight decoded, scaled
    in f32 and cast to x's dtype, the product summed in f32, the result
    in x's dtype."""
    K, N = fw.shape
    w = fp6_gemm_unpack(fw).to(x.dtype).to(torch.float32)
    return (x.reshape(-1, K).to(torch.float32) @ w).to(x.dtype).reshape(
        *x.shape[:-1], N)


def _check(x: torch.Tensor, fw: Fp6GemmWeight) -> None:
    K, N = fw.shape
    J = N // 4
    if N % 4 or fw.bytes3.shape != (3, K, J) or fw.scale.shape != (4, J):
        raise ValueError(f"malformed Fp6GemmWeight: shape {fw.shape}, "
                         f"bytes3 {tuple(fw.bytes3.shape)}, scale "
                         f"{tuple(fw.scale.shape)}")
    if x.shape[-1] != K:
        raise ValueError(f"x [..., {x.shape[-1]}] @ fp6 weight {fw.shape}")
    if not x.is_cuda:
        return
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x dtype {x.dtype}: the kernel takes bf16 or fp32")
    for name, t, dt in (("bytes3", fw.bytes3, torch.uint8),
                        ("scale", fw.scale, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fp6_matmul(x: torch.Tensor, fw: Fp6GemmWeight) -> torch.Tensor:
    """``x @ W`` with W stored fp6-packed. x: [..., K] bf16/fp32; returns
    [..., N] in x's dtype (the CUDA kernel on a card, the plain version on
    the CPU). Every K and N % 4 == 0 runs the kernel: there is no
    unpacked fallback."""
    _check(x, fw)
    if not x.is_cuda:
        return fp6_matmul_plain(x, fw)
    K, N = fw.shape
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*x.shape[:-1], N)
    plan = fp6_plan(M, K, N // 4, sm_count(x.device))
    _launch(x2, fw, out, plan)
    return out.reshape(*x.shape[:-1], N)


_LIB = None                        # the loaded kernel library

def _launch(x2: torch.Tensor, fw: Fp6GemmWeight, out: torch.Tensor,
            plan: Fp6Plan) -> None:
    """Launch the kernel on x2 [M, K] (CUDA, contiguous) into out [M, N]
    along ``plan``; bf16 takes the plan's route, fp32 the CUDA-core
    kernel."""
    global _LIB
    if _LIB is None:
        from . import _build
        _LIB = _build.load("fp6_gemm")
    lib = _LIB
    M, K = x2.shape
    J = fw.shape[1] // 4
    b3 = fw.bytes3
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    ws = cnt = 0
    if x2.dtype == torch.bfloat16:
        # TMA needs 16-byte aligned bases (a view may start anywhere;
        # torch's own allocations are aligned)
        if x2.data_ptr() % 16:
            x2 = x2.clone()
        if b3.data_ptr() % 16:
            b3 = b3.clone()
        if plan.route != "mma" and plan.ks > 1:
            ws, cnt = scratch(x2.device, stream, plan.ks * M * 4 * J,
                              2 * plan.grid[1] * plan.grid[2])
    err = lib.fp6_matmul_launch(
        x2.data_ptr(), b3.data_ptr(), fw.scale.data_ptr(), out.data_ptr(),
        ws, cnt, M, K, J, int(x2.dtype == torch.bfloat16),
        ROUTES[plan.route], plan.mt, plan.ks, plan.kps, stream)
    if err != 0:
        raise RuntimeError(f"fp6_matmul failed: cudaError {err}")
    LAUNCHES["fp6_matmul"] += 1
