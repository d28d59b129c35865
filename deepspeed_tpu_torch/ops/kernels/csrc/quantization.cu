// Group quantization for Hopper (sm_90a): int8 / int4 codes with f32
// per-group statistics, symmetric or asymmetric.
//
// quantize_sym replaces the Pallas kernel `_quant_kernel`
//   (deepspeed_tpu/ops/kernels/quantization.py:86, launched at :127):
//   scale = max(absmax, 1e-12) / qmax, codes = clip(rint(x / scale)).
// quantize_asym replaces `_quant_asym_kernel` (:94, launched at :136):
//   zero = min, scale = max(max - min, 1e-12) / (2 qmax),
//   codes = clip(rint((x - zero) / scale) - qmax).
// Both behind `quantize_blockwise` (:105). For bits = 4 the kernel packs
// two codes per byte itself (low nibble the even index), as the JAX
// wrapper does after its kernel (:144-148).
//
// Bound on the H100: bytes. Each input element is read once, each code
// written once (137 MB for a [4096, 11008] bf16 weight: 41 us at
// 3.35 TB/s); the arithmetic is a few operations an element. One warp
// owns one group: its lanes read neighbouring elements (coalesced), reduce
// the statistic with shuffles, and write the codes in a second pass over
// the group (from L1). Eight groups a block.
//
// Numerics are the JAX package's to the bit: f32 statistics; the division
// by the constant qmax (2 qmax) is a multiply by its f32 reciprocal, as
// XLA compiles it (the caller passes it); x / scale is an IEEE division
// (__fdiv_rn) and rounding is half to even (rintf); no fast math. The
// flattened input is not padded: positions past n read as 0, count in the
// group's statistics (an asymmetric tail group's min or max may be 0) and
// have their codes stored, as the JAX wrapper's zero padding does.
//
// Layout: x flat [n] (bf16 or fp32, contiguous); values int8 [ng, gs]
// (or [ng, gs / 2] packed for 4 bits); scale and zero f32 [ng]. Kernels
// launch on the caller's stream, do not synchronise and allocate nothing;
// the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;           // groups (warps) a block

__device__ __forceinline__ float load(const float* x, long long i) {
  return x[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}

template <typename T>
__device__ __forceinline__ float elem(const T* x, long long i, long long n) {
  return i < n ? load(x, i) : 0.f;
}

template <bool SYM>
__device__ __forceinline__ int code(float v, float scale, float zero,
                                    float qmax) {
  const float r = SYM ? rintf(__fdiv_rn(v, scale))
                      : rintf(__fdiv_rn(v - zero, scale)) - qmax;
  return (int)fminf(fmaxf(r, -qmax), qmax);
}

template <typename T, bool SYM>
__global__ void __launch_bounds__(WARPS * 32)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ values,
                    float* __restrict__ scale, float* __restrict__ zero,
                    long long n, int gs, long long ng, int bits, float qmax,
                    float recip) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= ng) return;
  const long long base = g * gs;
  float a = SYM ? 0.f : INFINITY, b = -INFINITY;   // absmax, or min / max
  for (int i = lane; i < gs; i += 32) {
    const float v = elem(x, base + i, n);
    if (SYM) {
      a = fmaxf(a, fabsf(v));
    } else {
      a = fminf(a, v);
      b = fmaxf(b, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (SYM) {
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    } else {
      a = fminf(a, __shfl_xor_sync(0xffffffffu, a, off));
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, off));
    }
  }
  const float s = SYM ? fmaxf(a, 1e-12f) * recip : fmaxf(b - a, 1e-12f) * recip;
  const float z = SYM ? 0.f : a;
  if (lane == 0) {
    scale[g] = s;
    if (!SYM) zero[g] = z;
  }
  if (bits == 8) {
    for (int i = lane; i < gs; i += 32)
      values[base + i] = (int8_t)code<SYM>(elem(x, base + i, n), s, z, qmax);
  } else {
    const int half = gs / 2;
    int8_t* out = values + g * half;
    for (int i = lane; i < half; i += 32) {
      const int lo = code<SYM>(elem(x, base + 2 * i, n), s, z, qmax);
      const int hi = code<SYM>(elem(x, base + 2 * i + 1, n), s, z, qmax);
      out[i] = (int8_t)((lo & 0xF) | ((hi & 0xF) << 4));
    }
  }
}

template <typename T>
void launch(const void* x, void* values, void* scale, void* zero,
            long long n, int gs, long long ng, int bits, int symmetric,
            float recip, cudaStream_t s) {
  const float qmax = (float)((1 << (bits - 1)) - 1);
  const unsigned blocks = (unsigned)((ng + WARPS - 1) / WARPS);
  if (symmetric)
    quantize_kernel<T, true><<<blocks, WARPS * 32, 0, s>>>(
        (const T*)x, (int8_t*)values, (float*)scale, nullptr, n, gs, ng,
        bits, qmax, recip);
  else
    quantize_kernel<T, false><<<blocks, WARPS * 32, 0, s>>>(
        (const T*)x, (int8_t*)values, (float*)scale, (float*)zero, n, gs,
        ng, bits, qmax, recip);
}

}  // namespace

extern "C" {

// x flat [n] -> values int8 [ng, gs] ([ng, gs / 2] for 4 bits), scale f32
// [ng], zero f32 [ng] (asymmetric only; may be null when symmetric);
// recip = f32(1 / qmax) (symmetric) or f32(1 / (2 qmax)).
int quantize_launch(const void* x, void* values, void* scale, void* zero,
                    long long n, int gs, int bits, int symmetric,
                    float recip, int is_bf16, void* stream) {
  if (n <= 0 || gs <= 0 || (bits != 8 && bits != 4) ||
      (bits == 4 && gs % 2) || (!symmetric && zero == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long ng = (n + gs - 1) / gs;
  if ((ng + WARPS - 1) / WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, values, scale, zero, n, gs, ng, bits,
                          symmetric, recip, s);
  else
    launch<float>(x, values, scale, zero, n, gs, ng, bits, symmetric, recip,
                  s);
  return (int)cudaGetLastError();
}

}  // extern "C"
