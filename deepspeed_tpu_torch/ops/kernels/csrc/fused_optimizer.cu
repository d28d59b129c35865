// Fused AdamW update for Hopper (sm_90a): one pass over flat f32 p, m, v
// and a gradient g (f32 or bf16), updating p, m and v in place.
//
// adamw replaces the Pallas kernel `_adamw_kernel`
//   (deepspeed_tpu/ops/kernels/fused_optimizer.py:27, launched at :91 with
//   input_output_aliases={1: 0, 3: 1, 4: 2}):
//     m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
//     p = p - lr ((m c1) / (sqrt(v c2) + eps) + wd p)
//   with c1 = 1 / (1 - b1^t) and c2 = 1 / (1 - b2^t).
//
// Bound on the H100: bytes. Each element reads p, g, m, v and writes p, m,
// v: 28 bytes for an f32 g (24 for bf16); GPT-2-1.3B's 1.316e9 parameters
// move 36.8 GB a step, 11.0 ms at 3.35 TB/s, against ~15 operations an
// element. Each thread updates four neighbouring elements with 16-byte
// loads and stores (8-byte for a bf16 g) in a grid-stride loop; the ragged
// tail and unaligned buffers take the scalar path in the same kernel, so
// nothing is padded or copied (the Pallas wrapper pads to 1024 and slices).
//
// Numerics: the eight hyper-parameters (lr, b1, b2, eps, wd, c1, c2) are
// computed once in f32 on the device by the wrapper, and every thread
// reads the same f32 values, so no thread evaluates powf of the step.
// Each product, sum, quotient and square root is a separate IEEE operation
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: nvcc contracts
// a * b + c into an FMA otherwise), in the plain version's order, so that
// p, m and v come out bit-identical to the plain PyTorch version's
// separate elementwise ops on the same hyper-parameters.
//
// Kernels launch on the caller's stream, do not synchronise and allocate
// nothing; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

struct Hyper {
  float lr, b1, b2, eps, wd, c1, c2, omb1, omb2;
};

__device__ __forceinline__ void adamw_elem(const Hyper& h, float& p, float g,
                                           float& m, float& v) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float upd = __fdiv_rn(__fmul_rn(m, h.c1),
                              __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.c2)),
                                        h.eps));
  p = __fsub_rn(p, __fmul_rn(h.lr, __fadd_rn(upd, __fmul_rn(h.wd, p))));
}

__device__ __forceinline__ float g_at(const float* g, long long i) {
  return g[i];
}
__device__ __forceinline__ float g_at(const __nv_bfloat16* g, long long i) {
  return __bfloat162float(g[i]);
}

__device__ __forceinline__ void load4(const float* g, long long i,
                                      float (&out)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(g + i);
  out[0] = u.x, out[1] = u.y, out[2] = u.z, out[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* g, long long i,
                                      float (&out)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(g + i);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = __bfloat162float(e[j]);
}

template <typename G>
__global__ void __launch_bounds__(NT)
adamw_kernel(float* __restrict__ p, const G* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v,
             const float* __restrict__ hyper, long long n, int vec) {
  Hyper h;
  h.lr = hyper[0], h.b1 = hyper[1], h.b2 = hyper[2], h.eps = hyper[3];
  h.wd = hyper[4], h.c1 = hyper[5], h.c2 = hyper[6];
  h.omb1 = __fsub_rn(1.f, h.b1);
  h.omb2 = __fsub_rn(1.f, h.b2);
  const long long stride = (long long)gridDim.x * NT * 4;
  for (long long i = ((long long)blockIdx.x * NT + threadIdx.x) * 4; i < n;
       i += stride) {
    if (vec && i + 4 <= n) {
      float4 pv = *reinterpret_cast<float4*>(p + i);
      float4 mv = *reinterpret_cast<float4*>(m + i);
      float4 vv = *reinterpret_cast<float4*>(v + i);
      float gv[4];
      load4(g, i, gv);
      adamw_elem(h, pv.x, gv[0], mv.x, vv.x);
      adamw_elem(h, pv.y, gv[1], mv.y, vv.y);
      adamw_elem(h, pv.z, gv[2], mv.z, vv.z);
      adamw_elem(h, pv.w, gv[3], mv.w, vv.w);
      *reinterpret_cast<float4*>(p + i) = pv;
      *reinterpret_cast<float4*>(m + i) = mv;
      *reinterpret_cast<float4*>(v + i) = vv;
    } else {
      for (long long j = i; j < i + 4 && j < n; ++j) {
        float pj = p[j], mj = m[j], vj = v[j];
        adamw_elem(h, pj, g_at(g, j), mj, vj);
        p[j] = pj, m[j] = mj, v[j] = vj;
      }
    }
  }
}

template <typename G>
cudaError_t launch(void* p, const void* g, void* m, void* v,
                   const void* hyper, long long n, cudaStream_t s) {
  const bool vec = reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(m) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % (4 * sizeof(G)) == 0;
  const long long quads = (n + 3) / 4;
  long long blocks = (quads + NT - 1) / NT;
  // a grid-stride loop past ~16 blocks an SM
  if (blocks > 132 * 16) blocks = 132 * 16;
  adamw_kernel<G><<<(unsigned)blocks, NT, 0, s>>>(
      (float*)p, (const G*)g, (float*)m, (float*)v, (const float*)hyper, n,
      vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p, m, v flat fp32 [n]; g flat [n] fp32 or bf16; hyper fp32 [8] on the
// device: lr, b1, b2, eps, wd, c1, c2, (unused).
int adamw_launch(void* p, const void* g, void* m, void* v, const void* hyper,
                 long long n, int g_is_bf16, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(g_is_bf16
                   ? launch<__nv_bfloat16>(p, g, m, v, hyper, n, s)
                   : launch<float>(p, g, m, v, hyper, n, s));
}

}  // extern "C"
