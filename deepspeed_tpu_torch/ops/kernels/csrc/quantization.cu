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
// written once (137 MB for a [4096, 11008] bf16 weight, 8 bits, groups of
// 128: 41 us at 3.35 TB/s); the arithmetic is a few operations an element.
//
// The vector route (quant_vec_kernel; `quantization.quant_plan` picks it
// where a group is a power-of-two count G of 16-byte vectors, G <= 256).
// A first port gave a group a warp (a [4096, 11008] leaf: 44,032 blocks of
// eight), each lane reading 2-byte elements (64 bytes a warp load), the
// group read again for the codes and the codes stored a byte a lane; it
// read 37-42% of its bound (H100 80GB HBM3, 700 W). Here:
// - a segment of S = min(G, 32) lanes owns a group and holds it in
//   registers, VPL = G / S 16-byte vectors a lane (a bf16 group of 128:
//   16 lanes, two groups a warp), so a warp's load is 512 contiguous
//   bytes and the group crosses device memory once;
// - the statistic is reduced by shuffles within the segment and the codes
//   come from the registers;
// - each lane stores its vectors' codes at once: 8 int8 codes as one
//   8-byte store, or 8 int4 codes packed into 4 bytes (fp32: 4 and 2);
//   the segment's first lane writes scale and zero;
// - blocks are persistent (at most the card's SMs times the blocks an SM
//   holds); a warp takes tiles of 32 / S groups by grid stride, U of them
//   a step (U VPL = 4 vectors a lane, at least one tile), the next step's
//   loads issued before this step's arithmetic;
// - the codes come from a product with the reciprocal (a multiply and a
//   rounding by addition, where the division, rint and the float-to-int
//   conversion issue at a fraction of the FMA rate), with the IEEE
//   division only near a half-integer.
// The scalar route (quantize_kernel: a warp a group, elements read twice)
// takes the other group sizes (e.g. 100). The tail past n reads as zeros
// in both.
//
// Numerics are the JAX package's to the bit: f32 statistics; the division
// by the constant qmax (2 qmax) is a multiply by its f32 reciprocal, as
// XLA compiles it (the caller passes it); x / scale rounds as the IEEE
// division (__fdiv_rn), which the vector route takes only where a product
// by the reciprocal could round otherwise, and rounding is half to even;
// no fast math. The flattened input is not padded: positions past n read
// as 0, count in the group's statistics (an asymmetric tail group's min or
// max may be 0) and have their codes stored, as the JAX wrapper's zero
// padding does.
//
// Layout: x flat [n] (bf16, fp16 or fp32, contiguous); values int8 [ng,
// gs] (or [ng, gs / 2] packed for 4 bits); scale and zero f32 [ng].
// Kernels launch on the caller's stream, do not synchronise and allocate
// nothing; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8;           // scalar route: groups (warps) a block
constexpr int VEC_THREADS = 256;   // vector route: threads a block
constexpr int IN_FLIGHT = 4;       // vector route: vectors a lane a step

__device__ __forceinline__ float load(const float* x, long long i) {
  return x[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ float load(const __half* x, long long i) {
  return __half2float(x[i]);
}

template <typename T>
__device__ __forceinline__ float elem(const T* x, long long i, long long n) {
  return i < n ? load(x, i) : 0.f;
}

// clip(rint(v / scale)) (symmetric) or clip(rint((v - zero) / scale) -
// qmax) as the Pallas kernels compute it: the IEEE quotient, rint half to
// even, the float clip.
template <bool SYM>
__device__ __forceinline__ int code(float v, float scale, float zero,
                                    float qmax) {
  const float q = rintf(__fdiv_rn(SYM ? v : __fsub_rn(v, zero), scale));
  const float r = SYM ? q : q - qmax;
  return (int)fminf(fmaxf(r, -qmax), qmax);
}

// 1.5 * 2^23: adding it rounds a float below 2^22 in magnitude to an
// integer, half to even, and leaves that integer in the low mantissa bits
constexpr float ROUNDER = 12582912.f;
constexpr int ROUNDER_BITS = 0x4B400000;

// ---------------------------------------------------------- vector route

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// The N elements of a vector as f32 from its 16-byte load `u`.
template <typename T>
__device__ __forceinline__ void to_f32(float (&v)[Vec<T>::N], const uint4& u) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < Vec<T>::N; ++k) v[k] = load(e, k);
}

// A segment of `S` lanes a group (S a power of two <= 32, a template
// parameter so that the segment's shuffles unroll), VPL vectors a lane:
// lane l holds vectors (l % S) + S v of group tile (32 / S) + l / S. A
// warp walks tiles wid, wid + W, ... (W warps in the grid), U tiles a
// step.
template <typename T, bool SYM, int VPL, int S>
__global__ void __launch_bounds__(VEC_THREADS)
quant_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ values,
                 float* __restrict__ scale, float* __restrict__ zero,
                 long long n, int gs, long long ng, int bits, float qmax,
                 float recip) {
  constexpr int N = Vec<T>::N;
  constexpr int U = IN_FLIGHT / VPL > 0 ? IN_FLIGHT / VPL : 1;
  constexpr int gpw = 32 / S;
  const int lane = threadIdx.x & 31;
  const int seg = lane / S, sl = lane % S;
  const long long tiles = (ng + gpw - 1) / gpw;
  const long long whole = n / gs;     // groups wholly inside [0, n)
  const long long W = (long long)gridDim.x * (blockDim.x / 32);
  const long long wid = (long long)blockIdx.x * (blockDim.x / 32) +
                        threadIdx.x / 32;
  // a step's U VPL loads a lane, predicated with no branch between them,
  // all in flight at once; the next step's are issued before this step's
  // codes are computed, so a warp's loads overlap its own arithmetic
  auto load_step = [&](uint4 (&raw)[U][VPL], long long t0) {
#pragma unroll
    for (int uu = 0; uu < U; ++uu) {
      const long long g = (t0 + uu * W) * gpw + seg;
      const uint4* p = reinterpret_cast<const uint4*>(x + g * gs) + sl;
      if (g < whole) {
#pragma unroll
        for (int j = 0; j < VPL; ++j) raw[uu][j] = __ldcs(p + S * j);
      } else {
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const long long i = g * gs + (long long)(sl + S * j) * N;
          raw[uu][j] = g < ng && i + N <= n ? __ldcs(p + S * j)
                                            : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  };
  uint4 raw[U][VPL], next[U][VPL];
  load_step(raw, wid);
  for (long long t0 = wid; t0 < tiles; t0 += W * U) {
    load_step(next, t0 + W * U);
#pragma unroll
    for (int uu = 0; uu < U; ++uu) {
      const long long g = (t0 + uu * W) * gpw + seg;
      float v[VPL][N];
#pragma unroll
      for (int j = 0; j < VPL; ++j) to_f32<T>(v[j], raw[uu][j]);
      if (g >= whole && g < ng) {    // the tail group: its vector that
#pragma unroll                        // straddles n, element by element
        for (int j = 0; j < VPL; ++j) {
          const long long i = g * gs + (long long)(sl + S * j) * N;
          if (i < n && i + N > n) {
#pragma unroll
            for (int k = 0; k < N; ++k) v[j][k] = elem(x, i + k, n);
          }
        }
      }
      float a = SYM ? 0.f : INFINITY, b = -INFINITY;   // absmax, or min/max
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int k = 0; k < N; ++k) {
          if (SYM) {
            a = fmaxf(a, fabsf(v[j][k]));
          } else {
            a = fminf(a, v[j][k]);
            b = fmaxf(b, v[j][k]);
          }
        }
#pragma unroll
      for (int off = S / 2; off > 0; off >>= 1) {   // within the segment
        if (SYM) {
          a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
        } else {
          a = fminf(a, __shfl_xor_sync(0xffffffffu, a, off));
          b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, off));
        }
      }
      if (g >= ng) continue;
      const float s = SYM ? fmaxf(a, 1e-12f) * recip
                          : fmaxf(b - a, 1e-12f) * recip;
      const float z = SYM ? 0.f : a;
      float rcp;                          // 1 / s within 1 ulp (MUFU)
      asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rcp) : "f"(s));
      if (sl == 0) {
        scale[g] = s;
        if (!SYM) zero[g] = z;
      }
      // the code of an element: its quotient d rcp rounded half to even
      // by a fused d rcp + ROUNDER, the integer read from the sum's low
      // mantissa bits, and the residual d rcp - that integer by a second
      // fused product. d rcp lies within 4 ulp of the IEEE quotient (under
      // 1e-4: |quotient| <= 2 qmax + 1 < 256), so where it is more than
      // 1e-3 from a half-integer both round alike; a vector with an
      // element nearer one (about one in 500 elements, and NaN or inf) is
      // coded again by `code`, the IEEE division. No clip is needed on
      // the fast path: |d rcp| stays below qmax + 1/2 (symmetric) and d
      // rcp in [0, 2 qmax + 1/2) (asymmetric), since |v| <= absmax and v -
      // zero <= max - min round monotonically.
      const int bias = ROUNDER_BITS + (SYM ? 0 : (int)qmax);
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const long long e0 = g * gs + (long long)(sl + S * j) * N;
        int c[N];
        bool near = false;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float d = SYM ? v[j][k] : __fsub_rn(v[j][k], z);
          const float m = __fmaf_rn(d, rcp, ROUNDER);
          const float e = __fmaf_rn(d, rcp, -__fsub_rn(m, ROUNDER));
          near |= !(fabsf(e) < 0.499f);
          c[k] = __float_as_int(m) - bias;
        }
        if (near) {
#pragma unroll
          for (int k = 0; k < N; ++k) c[k] = code<SYM>(v[j][k], s, z, qmax);
        }
        if (bits == 8) {
          // bytes 0 of c[0..3] into one word: two byte permutes and a
          // third to join them
          const uint32_t w0 = __byte_perm(__byte_perm(c[0], c[1], 0x0040),
                                          __byte_perm(c[2], c[3], 0x0040),
                                          0x5410);
          if constexpr (N == 8) {
            const uint32_t w1 =
                __byte_perm(__byte_perm(c[4], c[5], 0x0040),
                            __byte_perm(c[6], c[7], 0x0040), 0x5410);
            *reinterpret_cast<uint2*>(values + e0) = make_uint2(w0, w1);
          } else {
            *reinterpret_cast<uint32_t*>(values + e0) = w0;
          }
        } else {
          // a byte a pair (low nibble the even index), then the bytes
          // joined by permutes as for 8 bits
          uint32_t p[N / 2];
#pragma unroll
          for (int k = 0; k < N / 2; ++k)
            p[k] = ((uint32_t)c[2 * k] & 0xFu) |
                   (((uint32_t)c[2 * k + 1] << 4) & 0xF0u);
          const uint32_t w = __byte_perm(p[0], p[1], 0x0040);
          if constexpr (N == 8)
            *reinterpret_cast<uint32_t*>(values + e0 / 2) =
                __byte_perm(w, __byte_perm(p[2], p[3], 0x0040), 0x5410);
          else
            *reinterpret_cast<uint16_t*>(values + e0 / 2) = (uint16_t)w;
        }
      }
    }
#pragma unroll
    for (int uu = 0; uu < U; ++uu)
#pragma unroll
      for (int j = 0; j < VPL; ++j) raw[uu][j] = next[uu][j];
  }
}

// ---------------------------------------------------------- scalar route

// One warp a group, eight groups a block; the codes' pass reads the
// group again (from L1).
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

// ------------------------------------------------------------ dispatch

template <typename T, bool SYM, int VPL, int S>
cudaError_t vec_launch(const void* x, void* values, void* scale, void* zero,
                       long long n, int gs, long long ng, int bits,
                       float qmax, float recip, int sms, cudaStream_t s) {
  constexpr int U = IN_FLIGHT / VPL > 0 ? IN_FLIGHT / VPL : 1;
  auto kernel = quant_vec_kernel<T, SYM, VPL, S>;
  int per_sm = 0;
  cudaError_t err = blocks_per_sm(reinterpret_cast<const void*>(kernel),
                                  VEC_THREADS, 0, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long gpw = 32 / S, warps = VEC_THREADS / 32;
  const long long tiles = (ng + gpw - 1) / gpw;
  const long long want = (tiles + warps * U - 1) / (warps * U);
  const long long most = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(want < most ? want : most);
  kernel<<<grid, VEC_THREADS, 0, s>>>(
      (const T*)x, (int8_t*)values, (float*)scale, (float*)zero, n, gs, ng,
      bits, qmax, recip);
  return cudaGetLastError();
}

// the instance for (lanes S, vectors a lane vpl): vpl > 1 only at S = 32
template <typename T, bool SYM>
cudaError_t vec_vpl(const void* x, void* values, void* scale, void* zero,
                    long long n, int gs, long long ng, int bits, float qmax,
                    float recip, int S, int vpl, int sms, cudaStream_t s) {
#define PORT_VEC(V, L)                                                    \
  if (vpl == V && S == L)                                                 \
    return vec_launch<T, SYM, V, L>(x, values, scale, zero, n, gs, ng,    \
                                    bits, qmax, recip, sms, s);
  PORT_VEC(1, 1)
  PORT_VEC(1, 2)
  PORT_VEC(1, 4)
  PORT_VEC(1, 8)
  PORT_VEC(1, 16)
  PORT_VEC(1, 32)
  PORT_VEC(2, 32)
  PORT_VEC(4, 32)
  PORT_VEC(8, 32)
#undef PORT_VEC
  return cudaErrorInvalidValue;
}

// route 0: vector (S lanes a group, vpl vectors a lane, from quant_plan);
// 1: scalar
template <typename T>
cudaError_t launch(const void* x, void* values, void* scale, void* zero,
                   long long n, int gs, long long ng, int bits, int symmetric,
                   float recip, int route, int S, int vpl, int sms,
                   cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  if (route == 0) {
    if (S < 1 || S > 32 || (S & (S - 1)) || (S < 32 && vpl != 1) ||
        (long long)S * vpl * N != gs || sms < 1 ||
        reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(values) % 8)
      return cudaErrorInvalidValue;
    return symmetric
               ? vec_vpl<T, true>(x, values, scale, zero, n, gs, ng, bits,
                                  qmax, recip, S, vpl, sms, s)
               : vec_vpl<T, false>(x, values, scale, zero, n, gs, ng, bits,
                                   qmax, recip, S, vpl, sms, s);
  }
  if (route != 1 || (ng + WARPS - 1) / WARPS > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((ng + WARPS - 1) / WARPS);
  if (symmetric)
    quantize_kernel<T, true><<<blocks, WARPS * 32, 0, s>>>(
        (const T*)x, (int8_t*)values, (float*)scale, nullptr, n, gs, ng,
        bits, qmax, recip);
  else
    quantize_kernel<T, false><<<blocks, WARPS * 32, 0, s>>>(
        (const T*)x, (int8_t*)values, (float*)scale, (float*)zero, n, gs,
        ng, bits, qmax, recip);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x flat [n] -> values int8 [ng, gs] ([ng, gs / 2] for 4 bits), scale f32
// [ng], zero f32 [ng] (asymmetric only; may be null when symmetric);
// recip = f32(1 / qmax) (symmetric) or f32(1 / (2 qmax)). dtype: 0 fp32,
// 1 bf16, 2 fp16. route 0 (vector: `lanes` lanes a group, `vpl` vectors a
// lane, at most sms times the blocks an SM holds) or 1 (scalar), from
// `quantization.quant_plan`.
int quantize_launch(const void* x, void* values, void* scale, void* zero,
                    long long n, int gs, int bits, int symmetric,
                    float recip, int dtype, int route, int lanes, int vpl,
                    int sms, void* stream) {
  if (n <= 0 || gs <= 0 || (bits != 8 && bits != 4) ||
      (bits == 4 && gs % 2) || (!symmetric && zero == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long ng = (n + gs - 1) / gs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, values, scale, zero, n, gs, ng, bits,
                                symmetric, recip, route, lanes, vpl, sms, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, values, scale, zero, n, gs, ng,
                                        bits, symmetric, recip, route, lanes,
                                        vpl, sms, s);
    case 2:
      return (int)launch<__half>(x, values, scale, zero, n, gs, ng, bits,
                                 symmetric, recip, route, lanes, vpl, sms,
                                 s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
