// Dropout with JAX's mask for Hopper (sm_90a): the mask and the scale,
// fused, over a flat contiguous tensor of bf16, fp16 or fp32.
//
// dropout replaces no Pallas kernel: the JAX package applies flax's
// nn.Dropout (deepspeed_tpu/models/gpt2.py:140-141, 162-163), which XLA
// runs as jax.random.bernoulli over threefry bits and a select. This
// kernel computes the same function, bit for bit:
//
//   y[i] = keep(i) ? T(f32(x[i]) / divisor) : 0
//   keep(i) = uniform(bits(i)) < keep_prob
//   uniform(b) = as_float((b >> 9) | 0x3F800000) - 1
//   bits(i) = y0 ^ y1 of threefry2x32 (20 rounds) of the counter pair
//             (i >> 32, i & 0xFFFFFFFF) under the site's key
//
// with keep_prob = f32(1 - rate) and divisor = f32(T(keep_prob)), both
// from the wrapper. That is jax.random.bernoulli under
// jax_threefry_partitionable (each element hashes its own row-major flat
// index) and flax's select(mask, x / keep_prob, 0), whose division by the
// weakly typed keep_prob runs in T: f32 division rounded once to T is the
// correctly rounded T quotient (f32 has more than twice T's bits). The
// backward is the same kernel on dy (the VJP of select(mask, x / kp, 0) is
// select(mask, dy, 0) / kp): the mask is never stored, only the key.
//
// The key stays on the device: the kernel reads its two words (int64
// tensor [2], values below 2^32) through a pointer, so a key that the
// model derived on the device (flax's make_rng, a fold_in) costs no sync.
//
// Bound on the H100: integer operations. Each element reads 2 bytes and
// writes 2 (bf16) against ~60 integer-pipe instructions on the 16-byte
// path (cuobjdump -sass of the sm_90a build: 20 rounds of IADD3, SHF.L.W
// and LOP3, the key injections folded into 3-input adds, the bits' xor,
// shift and or; IMAD and the division's FFMA go to the fp32 pipe). At
// GPT-2 1.3B's dropout site ([2, 2048, 2048] bf16) that is 33.6 MB
// (0.010 ms at 3.35 TB/s) against ~0.50 G integer instructions (~0.030 ms
// at 132 SMs x 64 INT32 lanes x 1.98 GHz).
// So the design spends nothing beyond the hash: one 16-byte load and
// store a thread and iteration (8 bf16 / fp16 or 4 fp32 elements), a
// grid-stride loop over enough blocks to fill every SM, the key words in
// registers, and the key schedule's sums hoisted out of the loop. The
// ragged tail and unaligned buffers take the scalar path of the same
// kernel.
//
// Kernels launch on the caller's stream, do not synchronise and allocate
// nothing; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

struct Key {
  // the key schedule: k0, k1, k2 = k0 ^ k1 ^ parity, and the five
  // injections' second words with the round counts added
  uint32_t k0, k1, k2, i1, i2, i3, i4, i5;
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

#define TF_ROUND(r)  \
  x0 += x1;          \
  x1 = rotl(x1, r) ^ x0;

__device__ __forceinline__ uint32_t threefry_bits(const Key& k, uint32_t x0,
                                                  uint32_t x1) {
  x0 += k.k0;
  x1 += k.k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k.k1;
  x1 += k.i1;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k.k2;
  x1 += k.i2;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k.k0;
  x1 += k.i3;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k.k1;
  x1 += k.i4;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k.k2;
  x1 += k.i5;
  return x0 ^ x1;
}

#undef TF_ROUND

__device__ __forceinline__ bool keep_at(const Key& k, long long i,
                                        float keep_prob) {
  const uint32_t b = threefry_bits(k, (uint32_t)((unsigned long long)i >> 32),
                                   (uint32_t)(i & 0xFFFFFFFFll));
  const float u = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.f);
  return u < keep_prob;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ T drop_one(const Key& k, long long i, T x,
                                      float keep_prob, float divisor) {
  return keep_at(k, i, keep_prob)
             ? from_f32<T>(__fdiv_rn(to_f32(x), divisor))
             : from_f32<T>(0.f);
}

template <typename T>
__global__ void __launch_bounds__(NT)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
               const long long* __restrict__ key, long long n,
               float keep_prob, float divisor, int vec) {
  constexpr int V = 16 / sizeof(T);
  Key k;
  k.k0 = (uint32_t)key[0];
  k.k1 = (uint32_t)key[1];
  k.k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  k.i1 = k.k2 + 1u;
  k.i2 = k.k0 + 2u;
  k.i3 = k.k1 + 3u;
  k.i4 = k.k2 + 4u;
  k.i5 = k.k0 + 5u;
  const long long stride = (long long)gridDim.x * NT * V;
  for (long long i = ((long long)blockIdx.x * NT + threadIdx.x) * V; i < n;
       i += stride) {
    if (vec && i + V <= n) {
      const uint4 in = *reinterpret_cast<const uint4*>(x + i);
      uint4 out;
      const T* xe = reinterpret_cast<const T*>(&in);
      T* ye = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        ye[j] = drop_one<T>(k, i + j, xe[j], keep_prob, divisor);
      *reinterpret_cast<uint4*>(y + i) = out;
    } else {
      for (long long j = i; j < i + V && j < n; ++j)
        y[j] = drop_one<T>(k, j, x[j], keep_prob, divisor);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const void* key, long long n,
                   float keep_prob, float divisor, int sms, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long long vecs = (n + V - 1) / V;
  long long blocks = (vecs + NT - 1) / NT;
  // eight resident blocks of 256 threads fill an SM; past that a thread
  // takes more vectors in the grid-stride loop
  const long long cap = (long long)(sms > 0 ? sms : 132) * 8;
  if (blocks > cap) blocks = cap;
  dropout_kernel<T><<<(unsigned)blocks, NT, 0, s>>>(
      (const T*)x, (T*)y, (const long long*)key, n, keep_prob, divisor,
      vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y flat [n] contiguous of one dtype (0 fp32, 1 bf16, 2 fp16); key an
// int64 [2] device tensor of two 32-bit words; keep_prob = f32(1 - rate),
// divisor = f32(T(keep_prob)); sms the device's SM count (the grid cap).
int dropout_launch(const void* x, void* y, const void* key, long long n,
                   float keep_prob, float divisor, int dtype, int sms,
                   void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, y, key, n, keep_prob, divisor, sms, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, y, key, n, keep_prob, divisor,
                                        sms, s);
    case 2:
      return (int)launch<__half>(x, y, key, n, keep_prob, divisor, sms, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
