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
// (a [32768, 4096] bf16 x is 537 MB in and out: 0.160 ms at 3.35 TB/s);
// the arithmetic is a few operations an element. One block owns one row:
// its threads read neighbouring 16-byte vectors (coalesced), reduce with
// warp shuffles and one shared-memory step, and read the row again for
// the next pass and the store. A row is at most a few tens of KB, so the
// re-reads come from L1 and the row crosses device memory once. Any
// hidden size runs: the vector path needs hidden * sizeof(T) % 16 == 0
// and 16-byte aligned x and out; otherwise a scalar path runs.
// The Pallas wrapper's "all rows in one block" fallback for row counts
// without an 8-multiple divisor is a VMEM artefact and has no counterpart.
//
// Numerics: sums in f32 (a tree order, not the plain version's), rsqrtf
// (2 ulp), and the epilogue's products and sum as separate IEEE
// operations (__fmul_rn, __fadd_rn: no FMA contraction), as the plain
// version's separate PyTorch ops round them.
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

namespace {

constexpr int MAX_THREADS = 512;

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

// Call f(i, value) for every element of the row in the order this thread
// owns them: 16-byte vectors when `vec`, else single elements.
template <typename T, typename F>
__device__ __forceinline__ void for_row(const T* xr, int hidden, bool vec,
                                        F f) {
  if (vec) {
    constexpr int N = Vec<T>::N;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int c = threadIdx.x; c < hidden / N; c += blockDim.x) {
      const uint4 u = xv[c];
      const T* ue = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < N; ++e) f(c * N + e, to_f(ue[e]));
    }
  } else {
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) f(i, to_f(xr[i]));
  }
}

template <typename T, bool LN>
__global__ void __launch_bounds__(MAX_THREADS)
norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ out, int hidden,
                float eps, int vec_ok) {
  __shared__ float sh[32];
  const bool vec = vec_ok != 0;
  const long long row = blockIdx.x;
  const T* xr = x + row * hidden;
  T* orow = out + row * hidden;

  float mu = 0.f, acc = 0.f;
  if (LN) {
    for_row(xr, hidden, vec, [&](int, float v) { acc += v; });
    mu = block_sum(acc, sh) / (float)hidden;
    acc = 0.f;
    for_row(xr, hidden, vec, [&](int, float v) {
      const float c = v - mu;
      acc += c * c;
    });
  } else {
    for_row(xr, hidden, vec, [&](int, float v) { acc += v * v; });
  }
  const float var = block_sum(acc, sh) / (float)hidden;
  const float rstd = rsqrtf(var + eps);

  auto y = [&](int i, float v) {
    const float xn = __fmul_rn(LN ? __fsub_rn(v, mu) : v, rstd);
    const float t = __fmul_rn(xn, w[i]);
    return LN ? __fadd_rn(t, b[i]) : t;
  };
  if (vec) {
    constexpr int N = Vec<T>::N;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    for (int c = threadIdx.x; c < hidden / N; c += blockDim.x) {
      const uint4 u = xv[c];
      const T* ue = reinterpret_cast<const T*>(&u);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < N; ++e) oe[e] = from_f<T>(y(c * N + e, to_f(ue[e])));
      ov[c] = o;
    }
  } else {
    for (int i = threadIdx.x; i < hidden; i += blockDim.x)
      orow[i] = from_f<T>(y(i, to_f(xr[i])));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int rows, int hidden, float eps, int ln,
                   cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  const bool vec = hidden % N == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int work = vec ? hidden / N : hidden;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS
                                                       : threads);
  if (ln)
    norm_fwd_kernel<T, true><<<rows, threads, 0, s>>>(
        (const T*)x, (const float*)w, (const float*)b, (T*)out, hidden, eps,
        vec);
  else
    norm_fwd_kernel<T, false><<<rows, threads, 0, s>>>(
        (const T*)x, (const float*)w, nullptr, (T*)out, hidden, eps, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out [rows, hidden] contiguous; w (and b for LayerNorm) [hidden]
// contiguous fp32. dtype: 0 fp32, 1 bf16, 2 fp16.
int norm_fwd_launch(const void* x, const void* w, const void* b, void* out,
                    int rows, int hidden, float eps, int layer_norm,
                    int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || (layer_norm && b == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, w, b, out, rows, hidden, eps, layer_norm,
                                s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, w, b, out, rows, hidden, eps,
                                        layer_norm, s);
    case 2:
      return (int)launch<__half>(x, w, b, out, rows, hidden, eps,
                                 layer_norm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
