// RMSNorm and LayerNorm forward for Hopper (sm_90a), f32 statistics under
// any input dtype.
//
// rms_norm replaces the Pallas kernel `_rms_kernel`
//   (deepspeed_tpu/ops/kernels/normalization.py:34, launched at :44):
//   y = x * rsqrt(mean(x^2) + eps) * w.
// layer_norm replaces `_ln_kernel` (:96, launched at :109):
//   y = (x - mean) * rsqrt(mean((x - mean)^2) + eps) * w + b, the variance
//   taken in a second pass over the centred row, as the Pallas kernel does.
// Both compute in f32 and cast the output to x's dtype.
//
// Bound on the H100: bytes. Each element is read once and written once
// (an [8192, 2048] bf16 x is 67 MB in and out: 0.020 ms at 3.35 TB/s);
// the arithmetic is a few operations an element.
//
// The rows route (norm_rows_kernel; `normalization.norm_plan` picks it and
// its shape for every hidden size of 16-byte rows whose weights fit in
// shared memory). A first port gave each row a block that read the row
// three times (from L1 after the first) with two block-wide reductions
// between the passes, so a phase's loads never overlapped another phase's
// reductions, 8192 short blocks paid their launch and retire, and w and b
// came in by one 4-byte load an element: LayerNorm read 40% of its bound
// at [8192, 2048] bf16, 1.45x F.layer_norm (H100 80GB HBM3, 700 W). Here:
// - a team of WPR warps owns a row and holds it in registers: each lane
//   reads VPL 16-byte vectors (columns lane + 32 WPR j), all loads of the
//   row issued together, so x crosses device memory once and L1 never;
// - the mean and then the centred sum of squares come from those
//   registers, reduced by warp shuffles; a team of several warps adds its
//   warps' sums through shared memory in warp order after a named
//   barrier of the team alone (double-buffered, one barrier a sum);
// - w (and b) are staged once a block in shared memory, as float4 planes
//   laid out so that a warp's 16-byte reads of one vector's weights are
//   conflict-free, and read back as float4;
// - blocks are persistent (at most the card's SMs times the blocks an SM
//   holds) and their teams walk the rows by grid stride, so the other
//   teams' loads on an SM run under one team's reductions and stores;
//   stores are 16-byte vectors.
// The scalar route (norm_fwd_kernel: a block a row, elements read again
// for each pass) takes hidden sizes without 16-byte rows and rows whose
// weights exceed the rows route's shared memory; a misaligned x is copied
// by the wrapper. Any hidden size runs.
//
// Numerics: sums in f32 (each lane its columns in order, squares by fmaf,
// then the shuffle tree, then the team's warps in order; the scalar
// route's block tree differs), the mean and variance as a division by
// hidden, rsqrtf (2 ulp), and the epilogue's products and sum as separate
// IEEE operations (__fmul_rn, __fadd_rn: no FMA contraction), as the
// plain version's separate PyTorch ops round them.
//
// Layout: x and out [rows, hidden] contiguous (bf16, fp16 or fp32); w and
// b [hidden] contiguous fp32 (the wrapper casts them). Kernels launch on
// the caller's stream, do not synchronise and allocate nothing; the C
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_THREADS = 512;   // the scalar route's block
constexpr int ROWS_THREADS = 512;  // the rows route's block, at most
constexpr int MAX_TEAM_WARPS = 16; // warps of a team, at most

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// ------------------------------------------------------------ rows route

// The sum of v over a team of `wpr` warps (team `team`, this thread's
// warp `warp` of the block); every thread of the team gets it. `red`
// holds two slots of a float a warp, used in turns (`slot`), so one named
// barrier a sum suffices: a warp writes slot s again only after the next
// sum's barrier, which its team's warps reach after reading slot s.
__device__ __forceinline__ float team_sum(float v, int wpr, int team,
                                          int warp, float (*red)[32],
                                          int slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (wpr == 1) return v;
  if ((threadIdx.x & 31) == 0) red[slot][warp] = v;
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(32 * wpr)
               : "memory");
  float s = 0.f;
  for (int k = 0; k < wpr; ++k) s += red[slot][team * wpr + k];
  return s;
}

// One row a team of WPR warps, VPL 16-byte vectors a lane; `teams` teams
// a block (blockDim.x = 32 WPR teams). Dynamic shared memory: w as N / 4
// float4 planes of nv vectors (plane p holds elements 4p..4p+3 of each
// vector), then b alike.
template <typename T, bool LN, int VPL>
__global__ void __launch_bounds__(ROWS_THREADS)
norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, T* __restrict__ out,
                 long long rows, int hidden, float eps, int wpr) {
  constexpr int N = Vec<T>::N, P = N / 4;
  extern __shared__ float4 wsm[];
  __shared__ float red[2][32];
  const int nv = hidden / N;
  for (int i = threadIdx.x; i < nv * P; i += blockDim.x) {
    const int c = i / P, p = i % P;
    wsm[p * nv + c] = reinterpret_cast<const float4*>(w)[i];
    if (LN) wsm[(P + p) * nv + c] = reinterpret_cast<const float4*>(b)[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int team = warp / wpr, teams = blockDim.x / 32 / wpr;
  const int L = (warp % wpr) * 32 + lane, stride = 32 * wpr;
  int slot = 0;
  for (long long row = (long long)blockIdx.x * teams + team; row < rows;
       row += (long long)gridDim.x * teams) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * hidden);
    uint4 u[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = L + stride * j;
      u[j] = c < nv ? __ldcs(xv + c) : make_uint4(0u, 0u, 0u, 0u);
    }
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const T* e = reinterpret_cast<const T*>(&u[j]);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float v = to_f(e[k]);
        acc = LN ? acc + v : fmaf(v, v, acc);
      }
    }
    float mu = 0.f;
    if (LN) {
      mu = team_sum(acc, wpr, team, warp, red, slot) / (float)hidden;
      slot ^= 1;
      acc = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (L + stride * j >= nv) continue;
        const T* e = reinterpret_cast<const T*>(&u[j]);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float c = to_f(e[k]) - mu;
          acc = fmaf(c, c, acc);
        }
      }
    }
    const float var = team_sum(acc, wpr, team, warp, red, slot) /
                      (float)hidden;
    slot ^= 1;
    const float rstd = rsqrtf(var + eps);
    uint4* ov = reinterpret_cast<uint4*>(out + row * hidden);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = L + stride * j;
      if (c >= nv) continue;
      const T* e = reinterpret_cast<const T*>(&u[j]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 w4 = wsm[p * nv + c];
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
        float bv[4] = {0.f, 0.f, 0.f, 0.f};
        if (LN) {
          const float4 b4 = wsm[(P + p) * nv + c];
          bv[0] = b4.x;
          bv[1] = b4.y;
          bv[2] = b4.z;
          bv[3] = b4.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = to_f(e[4 * p + q]);
          const float xn = __fmul_rn(LN ? __fsub_rn(v, mu) : v, rstd);
          const float t = __fmul_rn(xn, wv[q]);
          oe[4 * p + q] = from_f<T>(LN ? __fadd_rn(t, bv[q]) : t);
        }
      }
      ov[c] = o;
    }
  }
}

// ---------------------------------------------------------- scalar route

// The sum of v over the block; every thread gets it. `sh` holds one float
// a warp; the leading barrier lets a second call reuse it.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = lane < nw ? sh[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block a row, one element a thread a step, the row read again (from
// L1) for each pass.
template <typename T, bool LN>
__global__ void __launch_bounds__(MAX_THREADS)
norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ out,
                int hidden, float eps) {
  __shared__ float sh[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * hidden;
  T* orow = out + row * hidden;

  float mu = 0.f, acc = 0.f;
  if (LN) {
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) acc += to_f(xr[i]);
    mu = block_sum(acc, sh) / (float)hidden;
    acc = 0.f;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float c = to_f(xr[i]) - mu;
      acc += c * c;
    }
  } else {
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float v = to_f(xr[i]);
      acc += v * v;
    }
  }
  const float var = block_sum(acc, sh) / (float)hidden;
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float v = to_f(xr[i]);
    const float xn = __fmul_rn(LN ? __fsub_rn(v, mu) : v, rstd);
    const float t = __fmul_rn(xn, w[i]);
    orow[i] = from_f<T>(LN ? __fadd_rn(t, b[i]) : t);
  }
}

// ------------------------------------------------------------ dispatch

template <typename T, bool LN, int VPL>
cudaError_t rows_launch(const void* x, const void* w, const void* b,
                        void* out, long long rows, int hidden, float eps,
                        int wpr, int teams, int sms, cudaStream_t s) {
  const unsigned threads = 32u * wpr * teams;
  const size_t smem = (size_t)hidden * sizeof(float) * (LN ? 2 : 1);
  auto kernel = norm_rows_kernel<T, LN, VPL>;
  int per_sm = 0;
  cudaError_t err = blocks_per_sm(reinterpret_cast<const void*>(kernel),
                                  threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = (rows + teams - 1) / teams;
  const long long most = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(want < most ? want : most);
  kernel<<<grid, threads, smem, s>>>((const T*)x, (const float*)w,
                                     (const float*)b, (T*)out, rows, hidden,
                                     eps, wpr);
  return cudaGetLastError();
}

template <typename T, bool LN>
cudaError_t rows_vpl(const void* x, const void* w, const void* b, void* out,
                     long long rows, int hidden, float eps, int wpr,
                     int vpl, int teams, int sms, cudaStream_t s) {
  switch (vpl) {
    case 1:
      return rows_launch<T, LN, 1>(x, w, b, out, rows, hidden, eps, wpr,
                                   teams, sms, s);
    case 2:
      return rows_launch<T, LN, 2>(x, w, b, out, rows, hidden, eps, wpr,
                                   teams, sms, s);
    case 4:
      return rows_launch<T, LN, 4>(x, w, b, out, rows, hidden, eps, wpr,
                                   teams, sms, s);
    case 8:
      return rows_launch<T, LN, 8>(x, w, b, out, rows, hidden, eps, wpr,
                                   teams, sms, s);
    case 16:
      return rows_launch<T, LN, 16>(x, w, b, out, rows, hidden, eps, wpr,
                                    teams, sms, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// route 0: rows (wpr, vpl, teams from norm_plan); 1: scalar
template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   long long rows, int hidden, float eps, int ln, int route,
                   int wpr, int vpl, int teams, int sms, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  if (route == 0) {
    const long long nv = hidden / N;
    if (hidden % N || wpr < 1 || wpr > MAX_TEAM_WARPS || teams < 1 ||
        32 * wpr * teams > ROWS_THREADS || (wpr > 1 && teams > 15) ||
        32LL * wpr * vpl < nv || sms < 1 ||
        reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16 ||
        reinterpret_cast<uintptr_t>(w) % 16 ||
        (ln && reinterpret_cast<uintptr_t>(b) % 16))
      return cudaErrorInvalidValue;
    return ln ? rows_vpl<T, true>(x, w, b, out, rows, hidden, eps, wpr, vpl,
                                  teams, sms, s)
              : rows_vpl<T, false>(x, w, b, out, rows, hidden, eps, wpr, vpl,
                                   teams, sms, s);
  }
  if (route != 1 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  int threads = ((hidden + 31) / 32) * 32;
  threads = threads > MAX_THREADS ? MAX_THREADS : threads;
  if (ln)
    norm_fwd_kernel<T, true><<<(unsigned)rows, threads, 0, s>>>(
        (const T*)x, (const float*)w, (const float*)b, (T*)out, hidden, eps);
  else
    norm_fwd_kernel<T, false><<<(unsigned)rows, threads, 0, s>>>(
        (const T*)x, (const float*)w, nullptr, (T*)out, hidden, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out [rows, hidden] contiguous; w (and b for LayerNorm) [hidden]
// contiguous fp32. dtype: 0 fp32, 1 bf16, 2 fp16. route 0 (rows: wpr warps
// a row, vpl vectors a lane, teams rows a block, at most sms times the
// blocks an SM holds) or 1 (scalar), from `normalization.norm_plan`.
int norm_fwd_launch(const void* x, const void* w, const void* b, void* out,
                    long long rows, int hidden, float eps, int layer_norm,
                    int dtype, int route, int wpr, int vpl, int teams,
                    int sms, void* stream) {
  if (rows <= 0 || hidden <= 0 || (layer_norm && b == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, w, b, out, rows, hidden, eps, layer_norm,
                                route, wpr, vpl, teams, sms, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, w, b, out, rows, hidden, eps,
                                        layer_norm, route, wpr, vpl, teams,
                                        sms, s);
    case 2:
      return (int)launch<__half>(x, w, b, out, rows, hidden, eps,
                                 layer_norm, route, wpr, vpl, teams, sms,
                                 s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
