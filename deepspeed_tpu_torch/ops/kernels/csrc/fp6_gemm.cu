// Weight-only GEMM with fp6 (e3m2) weights for Hopper (sm_90a).
//
// fp6_matmul replaces the Pallas kernel `_fp6_kernel`
//   (deepspeed_tpu/ops/kernels/fp6_gemm.py:80, launched at :134):
//   out[M, N] = x[M, K] . W[K, N], W stored as `fp6_gemm_pack` lays it out:
//   bytes3 [3, K, J] uint8 (J = N / 4) are the byte planes of a 24-bit word
//   holding the 6-bit codes of columns j, J + j, 2J + j, 3J + j (plane p in
//   bits 6p..6p+5), and scale [4, J] f32 the per-column scales, plane-major.
//   Output column p J + j comes from plane p of packed column j, so the
//   kernel writes straight into row-major [M, N].
//
// Each weight is decoded to f32, multiplied by its column's scale in f32,
// and only then cast to x's dtype (`fp6_gemm.py:94-96`); scaling the
// accumulated output instead would round differently. Sums are f32; the
// output is cast to x's dtype at the end.
//
// Bound on the H100: bytes for skinny x (decode: at M = 64 and
// [4096, 11008], 33.8 MB of 6-bit weights, 11 us at 3.35 TB/s), operations
// for tall x (prefill: 2 M K N FLOP, 3.0 ms at M = 32768 at 989 TFLOP/s).
// The weights cross device memory at 6 bits a value; a block owns a
// 64-row x 128-column output tile (32 packed columns, 4 planes) and walks
// K in 32-deep slabs: cp.async brings the x slab and the three byte planes
// of the weight slab into shared memory (double-buffered), the block
// decodes the slab into four bf16 [32, 32] tiles, and 4 warps of 16 rows
// run mma.sync m16n8k16 (bf16, f32 accumulate) on ldmatrix fragments.
// The decode is repeated by every row tile of x, which at large M makes
// the CUDA-core decode, not the tensor cores, the limit; wgmma, TMA, a
// larger row tile and a split-K for skinny M are later work.
//
// There is no fallback to an unpacked weight: every K >= 1 and J >= 1 is
// served, ragged row, depth and column tiles zero-filled in shared memory
// (the JAX wrapper unpacks when K or J has no 128-multiple tile, which
// Llama-2-7B's gate/up projections hit: J = 2752). cp.async needs 16-byte
// chunks, so it is used when K % 8 == 0 and J % 16 == 0 (every Llama-2-7B
// projection); other shapes stage the same tiles with plain loads.
//
// fp32 x runs a simple CUDA-core kernel (256 threads, a 64 x 64 output
// tile, 4 rows x 4 planes a thread), a parity oracle, not meant to be fast.
//
// Layout: x [M, K] row-major, contiguous, bf16 or fp32; out [M, 4 J] in
// x's dtype. Kernels launch on the caller's stream, do not synchronise and
// allocate nothing; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 128;            // threads of the mma kernel (4 warps)
constexpr int BM = 64;             // rows of x a block owns
constexpr int JT = 32;             // packed columns a block owns (x 4 planes)
constexpr int BK = 32;             // depth of one staged slab
constexpr int LDX = BK + 8;        // padded x slab row (conflict-free ldmatrix)
constexpr int LDW = JT + 8;        // padded decoded weight row
constexpr int NTILE = 4 * JT / 8;  // n-tiles of 8 columns a warp accumulates
constexpr int F_NT = 256;          // threads of the fp32 kernel
constexpr int FBM = 64;            // rows of its tile
constexpr int FJT = 16;            // packed columns of its tile
constexpr int FK = 16;             // depth of its shared tiles

// e3m2 with bias 3: exponent field e > 0 -> 2^(e-3) (1 + m / 4); e == 0 ->
// the subnormal m / 16; bit 5 the sign. Exact in f32, the values of
// `_minifloat_decode(code, 3, 2)`.
__device__ __forceinline__ float fp6_value(uint32_t c) {
  const uint32_t e = (c >> 2) & 7u, m = c & 3u;
  const float mag = e ? __uint_as_float(((e + 124u) << 23) | (m << 21))
                      : (float)m * 0.0625f;
  return (c & 32u) ? -mag : mag;
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without waiting, or zeros when `live` is false
// (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Plain: lane t gets row t / 4, columns
// 2 (t % 4), +1 of each; .trans: column t / 4, rows 2 (t % 4), +1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Start staging slab k0 of x rows [m0, m0 + BM) into xs [BM][LDX] and of
// the byte planes' packed columns [j0, j0 + JT) into bs [3][BK][JT]; out
// of range is zeros. VEC: cp.async 16-byte chunks (K % 8 == 0, J % 16 ==
// 0, 16-byte aligned bases); otherwise plain loads.
template <bool VEC>
__device__ __forceinline__ void stage(bf16* xs, uint8_t* bs, const bf16* x,
                                      const uint8_t* b3, int M, int K, int J,
                                      int m0, int j0, int k0) {
  const int tid = threadIdx.x;
  if (VEC) {
    for (int i = tid; i < BM * (BK / 8); i += NT) {
      const int r = i / (BK / 8), ch = i % (BK / 8);
      const int k = k0 + ch * 8;
      const bool live = m0 + r < M && k < K;
      cp_async16(xs + r * LDX + ch * 8,
                 x + (live ? (long long)(m0 + r) * K + k : 0), live);
    }
    for (int i = tid; i < 3 * BK * (JT / 16); i += NT) {
      const int row = i / (JT / 16), ch = i % (JT / 16);
      const int c = row / BK, k = k0 + row % BK, j = j0 + ch * 16;
      const bool live = k < K && j < J;
      cp_async16(bs + row * JT + ch * 16,
                 b3 + (live ? ((long long)c * K + k) * J + j : 0), live);
    }
  } else {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, k = k0 + i % BK;
      xs[r * LDX + i % BK] = m0 + r < M && k < K
                                 ? x[(long long)(m0 + r) * K + k]
                                 : __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < 3 * BK * JT; i += NT) {
      const int row = i / JT, jj = i % JT;
      const int c = row / BK, k = k0 + row % BK, j = j0 + jj;
      bs[i] = k < K && j < J ? b3[((long long)c * K + k) * J + j] : 0;
    }
  }
  cp_async_commit();
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
    fp6_mma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ b3,
                   const float* __restrict__ scale, bf16* __restrict__ out,
                   int M, int K, int J) {
  __shared__ __align__(16) bf16 xs[2][BM * LDX];
  __shared__ __align__(16) uint8_t bs[2][3 * BK * JT];
  __shared__ __align__(16) bf16 ws[4][BK * LDW];
  __shared__ float ss[4][JT];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * JT, m0 = blockIdx.y * BM;
  {
    const int p = tid / JT, jj = tid % JT;      // NT == 4 * JT
    ss[p][jj] = j0 + jj < J ? scale[(long long)p * J + j0 + jj] : 0.f;
  }
  float acc[NTILE][4];
#pragma unroll
  for (int t = 0; t < NTILE; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  const int nk = (K + BK - 1) / BK;
  stage<VEC>(xs[0], bs[0], x, b3, M, K, J, m0, j0, 0);
  for (int s = 0; s < nk; ++s) {
    const int buf = s & 1;
    if (s + 1 < nk) {
      stage<VEC>(xs[buf ^ 1], bs[buf ^ 1], x, b3, M, K, J, m0, j0,
                 (s + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // decode: word -> 4 codes -> f32 value x column scale -> bf16
    for (int i = tid; i < BK * JT; i += NT) {
      const int kk = i / JT, jj = i % JT;
      const uint8_t* b = bs[buf] + kk * JT + jj;
      const uint32_t word = (uint32_t)b[0] | ((uint32_t)b[BK * JT] << 8) |
                            ((uint32_t)b[2 * BK * JT] << 16);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        ws[p][kk * LDW + jj] = __float2bfloat16_rn(
            fp6_value((word >> (6 * p)) & 63u) * ss[p][jj]);
    }
    __syncthreads();
    const bf16* arow =
        xs[buf] + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
        (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, arow + kk * 16);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const bf16* wb = ws[p] + (kk * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * LDW +
                         (lane >> 4) * 8;
#pragma unroll
        for (int dn = 0; dn < JT / 8; dn += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, wb + dn * 8);
          mma_16816(acc[p * (JT / 8) + dn], af, b[0], b[1]);
          mma_16816(acc[p * (JT / 8) + dn + 1], af, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // C fragment: rows quad / quad + 8, columns 2 qi, 2 qi + 1 of an n-tile
  const int quad = lane >> 2, qi = lane & 3;
  const long long N = 4LL * J;
#pragma unroll
  for (int t = 0; t < NTILE; ++t) {
    const int p = t / (JT / 8);
    const int j = j0 + (t % (JT / 8)) * 8 + 2 * qi;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + warp * 16 + quad + h * 8;
      if (r >= M) continue;
      bf16* o = out + r * N + (long long)p * J;
      if (j < J) o[j] = __float2bfloat16_rn(acc[t][2 * h]);
      if (j + 1 < J) o[j + 1] = __float2bfloat16_rn(acc[t][2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(F_NT)
    fp6_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ b3,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int K, int J) {
  __shared__ float xs[FBM][FK + 1];
  __shared__ float ws[4][FK][FJT];
  const int tid = threadIdx.x, tx = tid % FJT, ty = tid / FJT;
  const int m0 = blockIdx.y * FBM, j = blockIdx.x * FJT + tx;
  float sc[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    sc[p] = j < J ? scale[(long long)p * J + j] : 0.f;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int i = tid; i < FBM * FK; i += F_NT) {
      const int r = i / FK, k = k0 + i % FK;
      xs[r][i % FK] = m0 + r < M && k < K ? x[(long long)(m0 + r) * K + k]
                                          : 0.f;
    }
    {  // thread (ty, tx) decodes depth ty of its own column
      const int k = k0 + ty;
      uint32_t word = 0;
      if (k < K && j < J) {
        const long long at = (long long)k * J + j, plane = (long long)K * J;
        word = (uint32_t)b3[at] | ((uint32_t)b3[at + plane] << 8) |
               ((uint32_t)b3[at + 2 * plane] << 16);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
        ws[p][ty][tx] = fp6_value((word >> (6 * p)) & 63u) * sc[p];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float xv = xs[ty * 4 + r][kk];
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[r][p] += xv * ws[p][kk][tx];
      }
    }
    __syncthreads();
  }
  if (j >= J) return;
  const long long N = 4LL * J;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty * 4 + r;
    if (row >= M) continue;
#pragma unroll
    for (int p = 0; p < 4; ++p) out[row * N + (long long)p * J + j] = acc[r][p];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// x [M, K] (bf16 or fp32, contiguous), bytes3 uint8 [3, K, J], scale f32
// [4, J] -> out [M, 4 J] in x's dtype.
int fp6_matmul_launch(const void* x, const void* b3, const void* scale,
                      void* out, int M, int K, int J, int is_bf16,
                      void* stream) {
  if (M < 1 || K < 1 || J < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((J + JT - 1) / JT, (M + BM - 1) / BM);
    const bool vec = K % 8 == 0 && J % 16 == 0 && aligned16(x) &&
                     aligned16(b3);
    if (vec)
      fp6_mma_kernel<true><<<grid, NT, 0, s>>>(
          (const bf16*)x, (const uint8_t*)b3, (const float*)scale, (bf16*)out,
          M, K, J);
    else
      fp6_mma_kernel<false><<<grid, NT, 0, s>>>(
          (const bf16*)x, (const uint8_t*)b3, (const float*)scale, (bf16*)out,
          M, K, J);
  } else {
    if ((M + FBM - 1) / FBM > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((J + FJT - 1) / FJT, (M + FBM - 1) / FBM);
    fp6_f32_kernel<<<grid, F_NT, 0, s>>>((const float*)x, (const uint8_t*)b3,
                                         (const float*)scale, (float*)out, M,
                                         K, J);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
