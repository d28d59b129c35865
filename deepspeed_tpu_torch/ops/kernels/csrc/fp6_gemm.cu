// Weight-only GEMM with fp6 (e3m2) weights for Hopper (sm_90a).
//
// fp6_matmul replaces the Pallas kernel `_fp6_kernel`
//   (deepspeed_tpu/ops/kernels/fp6_gemm.py:80, launched at :134):
//   out[M, N] = x[M, K] . W[K, N], W stored as `fp6_gemm_pack` lays it out:
//   bytes3 [3, K, J] uint8 (J = N / 4) are the byte planes of a 24-bit word
//   holding the 6-bit codes of columns j, J + j, 2J + j, 3J + j (plane p in
//   bits 6p..6p+5), and scale [4, J] f32 the per-column scales, plane-major.
//   Output column p J + j comes from plane p of packed column j, so a tile
//   of packed columns [j0, j0 + JT) lands in four strips of the row-major
//   [M, N] output, which each epilogue scatters to.
//
// Each weight is decoded to f32, multiplied by its column's scale in f32,
// and only then cast to x's dtype (`fp6_gemm.py:94-96`); scaling the
// accumulated output instead would round differently. Sums are f32; the
// output is cast to x's dtype at the end.
//
// Two bounds, two routes on one kernel (the plan is `fp6_plan` in
// ops/kernels/fp6_gemm.py: the route's threshold is M = 128, and of the
// launches the kernel takes it picks the one a model fitted to the
// card's readings ranks first). fp6_wgmma_kernel: a
// block owns 32 packed columns (128 output columns, the four strips), MW
// 64-row tiles of x and one K range. One thread keeps TMA loads of the x
// slab (64 MW x 64, 128-byte swizzled) and of the three byte planes (a
// 3-D box) three or five steps ahead in a ring on mbarriers. Every thread
// of the block decodes each 64-deep slab once into a bf16 [64 K x 128 N]
// B tile, MN-major and 128-byte swizzled as the wgmma descriptor reads it
// (ordinary stores, then fence.proxy.async before the barrier that hands
// it over), and MW warpgroups run m64n128k16 wgmma with A and B from
// shared memory and fp32 accumulators in registers: slab k's products run
// on the tensor cores while the block decodes slab k + 1. The decode is
// a few integer operations and one or two exact multiplies a weight
// (fp6_bits / fp6_plane, the scale and 2^124 folded when exact), on the
// CUDA cores; it is what bounds both routes in practice.
//
// Where the column and row tiles alone leave SMs idle, K splits into up
// to 8 ranges, all the blocks within one wave. Each block of a split
// writes its fp32 partial tile to a workspace; on a cooperative launch
// (all blocks resident at once) it then waits for its tile's other blocks
// and sums its slice of the tile over the partials in rank order, so
// every call gives the same bits. The workspace adds 2 x 4 bytes an
// output element a range to the traffic (written once, read once).
//
// Decode (M <= 128): bytes. At M = 64 the 6-bit weights are nearly all
//   the traffic: 12.6 MB at [4096, 4096] (0.0041 ms at 3.35 TB/s) and
//   33.8 MB at [4096, 11008] / [11008, 4096] (0.0107 ms), before the
//   workspace. A block holds every row (MW = 1 or 2), so each weight is
//   decoded once a call, and K splits so that a narrow weight still fills
//   one wave (two blocks an SM at MW = 1).
// Prefill (M > 128): operations, 2 M K N FLOP (0.139 ms at M = 4096 on
//   [4096, 4096], 0.374 ms on the two others, at 989 TFLOP/s). MW = 4 as
//   a rule (256 rows, four warpgroups that all decode and all multiply),
//   so each weight is decoded once per 256 rows of x; K splits while the
//   tiles leave SMs idle (M up to about 512 on Llama-2-7B's shapes), and
//   MW = 1 or 2 where fewer waves of blocks make up for more decodes.
//
// There is no fallback to an unpacked weight: every K >= 1 and J >= 1 is
// served, ragged row, depth and column tiles zero-filled in shared memory
// (the JAX wrapper unpacks when K or J has no 128-multiple tile, which
// Llama-2-7B's gate/up projections hit: J = 2752). TMA needs 16-byte
// rows, K % 8 == 0 and J % 16 == 0 (every Llama-2-7B projection); other
// shapes take fp6_splitk_kernel (route 1), mma.sync m16n8k16 on plain
// loads of the same slabs, with its K split summed over a cluster.
//
// fp32 x runs a simple CUDA-core kernel (256 threads, a 64 x 64 output
// tile, 4 rows x 4 planes a thread), a parity oracle, not meant to be fast.
//
// Layout: x [M, K] row-major, contiguous, bf16 or fp32; out [M, 4 J] in
// x's dtype. Kernels launch on the caller's stream, do not synchronise and
// allocate nothing; each C entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

// shapes without 16-byte rows (fp6_splitk_kernel)
constexpr int SK_NT = 256;         // threads (8 warps)
constexpr int SK_BM = 64;          // rows of a row tile
constexpr int SK_JT = 32;          // packed columns a block owns (x 4 planes)
constexpr int SK_BK = 64;          // depth of one staged slab
constexpr int SK_ST = 4;           // stages of the ring
constexpr int SK_LDX = SK_BK + 8;  // padded x slab row (conflict-free ldmatrix)
constexpr int SK_LDW = SK_JT + 8;  // padded decoded weight row
constexpr int SK_RLD = 4 * SK_JT + 8;   // padded row of the fp32 partial tile
constexpr int SK_MAX_CLUSTER = 8;  // portable cluster size
// the wgmma kernel (fp6_wgmma_kernel<MW, NWG>): NWG warpgroups, the last
// MW of them consumers of 64 rows each
constexpr int WG_JT = 32;          // packed columns (x 4 planes = N 128)
constexpr int WG_BK = 64;          // depth of a K-step
constexpr int WG_BST = 2;          // decoded B tiles
constexpr int WG_PB = 3 * WG_BK * WG_JT;        // bytes of a byte-plane slab
constexpr int WG_BB = WG_BK * 4 * WG_JT * 2;    // bytes of a decoded B tile
// TMA ring stages: 2 blocks an SM fit at MW = 1
template <int MW>
__host__ __device__ constexpr int wg_stages() { return MW == 2 ? 6 : 4; }
template <int MW>
__host__ __device__ constexpr int wg_xbytes() { return 64 * MW * WG_BK * 2; }
template <int MW>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return (size_t)wg_stages<MW>() * (wg_xbytes<MW>() + WG_PB) +
         WG_BST * WG_BB + 4 * WG_JT * sizeof(float) +
         wg_stages<MW>() * sizeof(uint64_t) + 16;
}
// fp32 oracle
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

// The same value for the code in bits 6P..6P+5 of a 24-bit word, without
// branches: code bits 0-4 placed at f32 bits 21-25 and bit 5 at the sign
// (fp6_bits) give 2^(e - 127) (1 + m / 4) for e > 0 and the f32 subnormal
// m 2^-128 for e == 0, so one exact multiply by 2^124 gives the value (the
// build keeps f32 subnormals: no flush to zero).
template <int P>
__device__ __forceinline__ float fp6_bits(uint32_t w) {
  const uint32_t t = w << (21 - 6 * P);
  return __uint_as_float((t & 0x03E00000u) | ((t << 5) & 0x80000000u));
}
template <int P>
__device__ __forceinline__ float fp6_plane(uint32_t w) {
  return fp6_bits<P>(w) * 0x1p124f;
}

// the 24-bit word of packed column e (0..3) from the three byte planes'
// 4-byte groups c0, c1, c2 (byte 3 of the result is don't-care)
__device__ __forceinline__ uint32_t fp6_word(uint32_t c0, uint32_t c1,
                                             uint32_t c2, int e) {
  const uint32_t lo = __byte_perm(c0, c1, e | ((4 + e) << 4));
  return __byte_perm(lo, c2, 0x10 | ((4 + e) << 8));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// ------------------------------------------- shapes without 16-byte rows

template <int MT>
__host__ __device__ constexpr int sk_stage_bytes() {
  return MT * SK_BM * SK_LDX * 2 + 3 * SK_BK * SK_JT;
}
// the ring and two decoded slabs [4][SK_BK][SK_LDW] bf16; the fp32
// partial tile of the cluster reduction reuses the ring's bytes after the
// K loop
template <int MT>
__host__ __device__ constexpr size_t sk_smem_bytes() {
  return (size_t)SK_ST * sk_stage_bytes<MT>() + 2 * 4 * SK_BK * SK_LDW * 2;
}
static_assert(SK_ST * sk_stage_bytes<1>() >= SK_BM * SK_RLD * 4, "ring");
static_assert(SK_ST * sk_stage_bytes<2>() >= 2 * SK_BM * SK_RLD * 4, "ring");

// Stage slab [k0, k0 + SK_BK) (cut at k_hi) of x rows [m0, m0 + 64 MT)
// into xs [64 MT][SK_LDX] and of the byte planes' packed columns [j0, j0 +
// SK_JT) into bs [3][SK_BK][SK_JT] with plain loads; out of range is zeros.
template <int MT>
__device__ __forceinline__ void sk_stage(bf16* xs, uint8_t* bs, const bf16* x,
                                         const uint8_t* b3, int M, int K,
                                         int J, int m0, int j0, int k0,
                                         int k_hi) {
  constexpr int NT = SK_NT, BM = SK_BM * MT;
  const int tid = threadIdx.x;
  for (int i = tid; i < BM * SK_BK; i += NT) {
    const int r = i / SK_BK, k = k0 + i % SK_BK;
    xs[r * SK_LDX + i % SK_BK] = m0 + r < M && k < k_hi
                                     ? x[(long long)(m0 + r) * K + k]
                                     : __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < 3 * SK_BK * SK_JT; i += NT) {
    const int row = i / SK_JT, jj = i % SK_JT;
    const int c = row / SK_BK, k = k0 + row % SK_BK, j = j0 + jj;
    bs[i] = k < k_hi && j < J ? b3[((long long)c * K + k) * J + j] : 0;
  }
}

// grid (KS, ceil(J / 32), ceil(M / (64 MT))) on clusters of KS blocks
// along x: block (r, jt, mt) sums K range [r kps, (r + 1) kps) of rows
// [64 MT mt, +64 MT) and packed columns [32 jt, +32); rank r then reduces
// slice r of the cluster's partial tiles and stores it. 8 warps: warp w
// multiplies rows 16 (w % (4 MT)) of the tile against planes
// [(w / (4 MT)) 4 / (2 / MT), +4 / (2 / MT)); every thread decodes 4
// packed columns of two slab rows. Slab s + 1 is decoded while slab s is
// multiplied (two decoded buffers), one __syncthreads a slab: after it,
// the slab staged SK_ST - 1 steps earlier is in place and slab s - 1's
// stage is free.
template <int MT>
__global__ void __launch_bounds__(SK_NT)
    fp6_splitk_kernel(const bf16* __restrict__ x,
                      const uint8_t* __restrict__ b3,
                      const float* __restrict__ scale, bf16* __restrict__ out,
                      int M, int K, int J, int kps) {
  constexpr int BM = SK_BM * MT;
  constexpr int STB = sk_stage_bytes<MT>();
  constexpr int WR = 4 * MT;             // warp rows of 16
  constexpr int PW = 4 / (8 / WR);       // planes a warp multiplies
  constexpr int NTW = PW * SK_JT / 8;    // its n-tiles of 8 columns
  constexpr int WSB = 4 * SK_BK * SK_LDW;    // elements of a decoded slab
  extern __shared__ __align__(16) unsigned char sk_smem[];
  bf16* ws = reinterpret_cast<bf16*>(sk_smem + SK_ST * STB);   // [2][WSB]
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp % WR, wc = warp / WR;
  const int rank = blockIdx.x, KS = gridDim.x;
  const int j0 = blockIdx.y * SK_JT, m0 = blockIdx.z * BM;
  const int k_lo = rank * kps, k_hi = min(K, k_lo + kps);
  const int nk = k_hi > k_lo ? (k_hi - k_lo + SK_BK - 1) / SK_BK : 0;
  // this thread's decode: packed columns 4 jq .. +3 of slab rows tid / 8
  // and tid / 8 + 32, and their column scales
  const int jq = tid % 8;
  float sc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 4 * jq + e;
      sc[p][e] = j < J ? scale[(long long)p * J + j] : 0.f;
    }
  float acc[NTW][4];
#pragma unroll
  for (int t = 0; t < NTW; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  auto prefetch = [&](int s) {
    if (s < nk) {
      unsigned char* st = sk_smem + (s % SK_ST) * STB;
      sk_stage<MT>(reinterpret_cast<bf16*>(st), st + BM * SK_LDX * 2, x,
                   b3, M, K, J, m0, j0, k_lo + s * SK_BK, k_hi);
    }
  };
  // slab s's byte planes -> bf16 [4][SK_BK][SK_LDW]: word -> 4 codes ->
  // f32 value x column scale -> bf16
  auto decode = [&](int s, bf16* wsb) {
    const uint8_t* bs = sk_smem + (s % SK_ST) * STB + BM * SK_LDX * 2;
#pragma unroll
    for (int r = 0; r < SK_BK / 32; ++r) {
      const int kk = tid / 8 + 32 * r;
      const uint8_t* b = bs + kk * SK_JT + 4 * jq;
      const uint32_t c0 = *reinterpret_cast<const uint32_t*>(b);
      const uint32_t c1 =
          *reinterpret_cast<const uint32_t*>(b + SK_BK * SK_JT);
      const uint32_t c2 =
          *reinterpret_cast<const uint32_t*>(b + 2 * SK_BK * SK_JT);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = fp6_word(c0, c1, c2, e);
      float v[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[0][e] = fp6_plane<0>(w[e]) * sc[0][e];
        v[1][e] = fp6_plane<1>(w[e]) * sc[1][e];
        v[2][e] = fp6_plane<2>(w[e]) * sc[2][e];
        v[3][e] = fp6_plane<3>(w[e]) * sc[3][e];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[p][0], v[p][1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[p][2], v[p][3]);
        *reinterpret_cast<uint2*>(wsb + p * SK_BK * SK_LDW + kk * SK_LDW +
                                  4 * jq) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  };

#pragma unroll
  for (int s = 0; s < SK_ST - 1; ++s) prefetch(s);
  if (nk > 0) {
    __syncthreads();
    decode(0, ws);
  }
  for (int s = 0; s < nk; ++s) {
    __syncthreads();     // slab s decoded, slab s + 1 staged, s - 1 used
    prefetch(s + SK_ST - 1);
    if (s + 1 < nk) decode(s + 1, ws + ((s + 1) & 1) * WSB);
    const bf16* xs =
        reinterpret_cast<const bf16*>(sk_smem + (s % SK_ST) * STB);
    const bf16* wsb = ws + (s & 1) * WSB;
    const bf16* arow =
        xs + (wr * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SK_LDX +
        (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < SK_BK / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, arow + kk * 16);
#pragma unroll
      for (int pp = 0; pp < PW; ++pp) {
        const bf16* wb = wsb + (wc * PW + pp) * SK_BK * SK_LDW +
                         (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             SK_LDW +
                         (lane >> 4) * 8;
#pragma unroll
        for (int dn = 0; dn < SK_JT / 8; dn += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, wb + dn * 8);
          mma_16816(acc[pp * (SK_JT / 8) + dn], af, b[0], b[1]);
          mma_16816(acc[pp * (SK_JT / 8) + dn + 1], af, b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();               // every warp is past the ring

  // this block's fp32 partial tile [BM][128] (C fragment: rows quad /
  // quad + 8, columns 2 qi, 2 qi + 1 of n-tile t, which is column 8 t of
  // the warp's planes: plane t / 4, packed column 8 (t % 4))
  const int quad = lane >> 2, qi = lane & 3;
  const long long N = 4LL * J;
  float* red = reinterpret_cast<float*>(sk_smem);
#pragma unroll
  for (int t = 0; t < NTW; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(red + (wr * 16 + quad + h * 8) * SK_RLD +
                                 wc * PW * SK_JT + t * 8 + qi * 2) =
          make_float2(acc[t][2 * h], acc[t][2 * h + 1]);
  cluster.sync();                // every rank's partial tile is in place
  // rank r sums float4 columns [e0, e1) of the tile over ranks 0..KS-1 in
  // order, casts once and stores
  constexpr int E4 = BM * SK_JT;             // float4s of a tile
  const int e0 = (int)((long long)rank * E4 / KS);
  const int e1 = (int)((long long)(rank + 1) * E4 / KS);
  for (int e = e0 + tid; e < e1; e += SK_NT) {
    const int r = e / SK_JT, c = (e % SK_JT) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < KS; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red + r * SK_RLD + c, q));
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    if (m0 + r >= M) continue;
    const int p = c / SK_JT, j = j0 + c % SK_JT;
    bf16* o = out + (long long)(m0 + r) * N + (long long)p * J + j;
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j + u < J) o[u] = __float2bfloat16_rn(vv[u]);
  }
  cluster.sync();                // no block leaves while a peer reads it
}

// ----------------------------------------------------- prefill route

// Decode K-step slab `pl` ([3][64][32] byte planes) into the B tile `bd`:
// bf16 [64 K][128 N] MN-major, as two 64-column halves 8 KB apart, each
// 128-byte swizzled (`swizzled`). Thread t of NT owns packed columns
// 4 (t % 8) .. +4 of K rows t / 8 + (NT / 8) i; `ss` holds the tile's 128
// column scales (plane p, packed column jj at 32 p + jj), times 2^124 when
// FOLD: then fp6_plane's exact multiply by 2^124 and the multiply by the
// scale are one multiply of the same exact product, rounded once, so the
// result is the same (the caller folds only scales below 16, for which
// scale x 2^124 is finite).
template <int NT, bool FOLD>
__device__ __forceinline__ void wg_decode(unsigned char* bd,
                                          const uint8_t* pl,
                                          const float* ss, int t) {
  const int jg = t % 8;
  float sc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float4 v = *reinterpret_cast<const float4*>(ss + p * WG_JT +
                                                      jg * 4);
    sc[p][0] = v.x;
    sc[p][1] = v.y;
    sc[p][2] = v.z;
    sc[p][3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < 8 * WG_BK / NT; ++i) {
    const int kr = t / 8 + (NT / 8) * i;
    const uint8_t* pp = pl + kr * WG_JT + jg * 4;
    const uint32_t c0 = *reinterpret_cast<const uint32_t*>(pp);
    const uint32_t c1 =
        *reinterpret_cast<const uint32_t*>(pp + WG_BK * WG_JT);
    const uint32_t c2 =
        *reinterpret_cast<const uint32_t*>(pp + 2 * WG_BK * WG_JT);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = fp6_word(c0, c1, c2, e);
    float v[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (FOLD) {
        v[0][e] = fp6_bits<0>(w[e]) * sc[0][e];
        v[1][e] = fp6_bits<1>(w[e]) * sc[1][e];
        v[2][e] = fp6_bits<2>(w[e]) * sc[2][e];
        v[3][e] = fp6_bits<3>(w[e]) * sc[3][e];
      } else {
        v[0][e] = fp6_plane<0>(w[e]) * sc[0][e];
        v[1][e] = fp6_plane<1>(w[e]) * sc[1][e];
        v[2][e] = fp6_plane<2>(w[e]) * sc[2][e];
        v[3][e] = fp6_plane<3>(w[e]) * sc[3][e];
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[p][0], v[p][1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[p][2], v[p][3]);
      const int n0 = p * WG_JT + jg * 4;        // first of 4 output columns
      *reinterpret_cast<uint2*>(bd + (n0 / 64) * 8192 +
                                swizzled(kr, n0 % 64)) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

// grid (KS, ceil(J / 32), ceil(M / (64 MW))), 128 NWG threads; the KS
// blocks along x split K (ranges of kps, a multiple of 64). Every thread
// decodes; the last MW warpgroups also multiply rows [m0 + 64 c, +64),
// their wgmma running while the block decodes the next slab. Thread 0
// keeps the TMA loads ST - 1 steps ahead (full[s]: the bytes of ring
// stage s landed). One __syncthreads a K-step: after it, slab k + 1's B
// tile is written and visible to wgmma, and K-step k's products are done,
// so its ring stage and B tile may be refilled. KS == 1 stores from the
// accumulators. Otherwise (a cooperative launch: every block resident)
// each block writes its fp32 partial tile to `ws` [KS][M][4 J], counts
// itself in the tile's counter and waits for the tile's other blocks; then
// rank r sums slice r of the tile over the KS partials in rank order,
// casts once and stores, and the last block past the wait resets the
// tile's two counters for the next call.
template <int MW, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
    fp6_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_b,
                     const float* __restrict__ scale, bf16* __restrict__ out,
                     float* __restrict__ ws, int* __restrict__ cnt, int M,
                     int K, int J, int kps) {
  constexpr int NT = 128 * NWG, BM = 64 * MW, ST = wg_stages<MW>();
  constexpr int XB = wg_xbytes<MW>();
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* xs = wg_smem;                          // [ST][BM x 64]
  unsigned char* bd = xs + ST * XB;                     // [BST][64 x 128]
  uint8_t* pl = bd + WG_BST * WG_BB;                    // [ST][3][64][32]
  float* ss = reinterpret_cast<float*>(pl + ST * WG_PB);   // [4][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(ss + 4 * WG_JT);
  int* last_s = reinterpret_cast<int*>(full + ST);
  const int tid = threadIdx.x;
  // the warpgroup, uniform across each warp as the compiler can see (a
  // branch on it that it cannot prove uniform serializes every wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int rank = blockIdx.x, KS = gridDim.x;
  const int j0 = blockIdx.y * WG_JT, m0 = blockIdx.z * BM;
  const int k0 = rank * kps;                 // this block's K range
  const int nk = (min(K, k0 + kps) - k0 + WG_BK - 1) / WG_BK;
  // K-step k into ring stage k % ST, whose last reader (K-step k - ST)
  // finished before an earlier __syncthreads
  auto load = [&](int k) {
    const int s = k % ST;
    mbar_expect(full + s, XB + WG_PB);
    tma_box(xs + s * XB, &tm_x, k0 + k * WG_BK, m0, full + s);
    tma_box3(pl + s * WG_PB, &tm_b, j0, k0 + k * WG_BK, 0, full + s);
  };
  // thread 0 starts the first loads at once; the scales load meanwhile
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(ST - 1, nk); ++k) load(k);
  }
  float sv = 0.f;
  if (tid < 4 * WG_JT) {
    const int p = tid / WG_JT, jj = tid % WG_JT;
    sv = j0 + jj < J ? scale[(long long)p * J + j0 + jj] : 0.f;
  }
  // fold 2^124 into the scales when every one of the tile is below 16
  const bool fold = __syncthreads_and(sv < 16.f);
  if (tid < 4 * WG_JT) ss[tid] = fold ? sv * 0x1p124f : sv;
  __syncthreads();
  auto decode = [&](unsigned char* b, const uint8_t* p) {
    if (fold)
      wg_decode<NT, true>(b, p, ss, tid);
    else
      wg_decode<NT, false>(b, p, ss, tid);
  };
  mbar_wait(full, 0);
  decode(bd, pl);
  fence_async_smem();                // the stores, visible to wgmma
  __syncthreads();

  const bool mma = wg >= NWG - MW;
  const int c = wg - (NWG - MW), warp = (tid / 32) % 4, lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int s = k % ST;
    if (mma) {
      const unsigned char* a = xs + s * XB + c * (64 * WG_BK * 2);
      const unsigned char* bb = bd + (k % WG_BST) * WG_BB;
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma_ss<1>(acc, wg_desc(a + kk * 32, 16, 1024),
                    wg_desc(bb + kk * 2048, 8192, 1024), 1,
                    std::integral_constant<int, 128>());
      wg_commit();
    }
    if (tid == 0 && k + ST - 1 < nk) load(k + ST - 1);
    if (k + 1 < nk) {
      const int s1 = (k + 1) % ST;
      mbar_wait(full + s1, ((k + 1) / ST) & 1);
      decode(bd + ((k + 1) % WG_BST) * WG_BB, pl + s1 * WG_PB);
      fence_async_smem();
    }
    if (mma) {
      wg_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();
  }

  // accumulator (n, x): row 16 warp + lane / 4 (+8 for x >= 2), column 8 n
  // + 2 (lane % 4) + (x & 1): plane n / 4, packed column 8 (n % 4) + ...
  const long long N = 4LL * J;
  const int quad = lane / 4, qi = lane % 4;
  if (mma) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + c * 64 + warp * 16 + quad + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int j = j0 + (n % 4) * 8 + 2 * qi;
        if (j >= J) continue;
        const long long at = (long long)r * N + (long long)(n / 4) * J + j;
        if (KS == 1) {
          *reinterpret_cast<__nv_bfloat162*>(out + at) =
              __floats2bfloat162_rn(acc[4 * n + 2 * h],
                                    acc[4 * n + 2 * h + 1]);
        } else {
          *reinterpret_cast<float2*>(ws + (long long)rank * M * N + at) =
              make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
        }
      }
    }
  }
  if (KS == 1) return;
  // every block of the tile waits for the others (the launch is
  // cooperative, so all of them are resident), then sums its slice
  int* arrived = cnt + 2 * (blockIdx.z * gridDim.y + blockIdx.y);
  __threadfence();             // this block's partial, visible to all
  __syncthreads();
  if (tid == 0) {
    atomicAdd(arrived, 1);
    while (atomicAdd(arrived, 0) < KS) __nanosleep(64);
  }
  __syncthreads();
  __threadfence();             // the other blocks' partials, seen here
  // float4 columns [e0, e1) of the tile, each summed over the partials
  // in rank order (all loaded before any is added)
  constexpr int E4 = BM * WG_JT;
  const int e0 = (int)((long long)rank * E4 / KS);
  const int e1 = (int)((long long)(rank + 1) * E4 / KS);
  for (int e = e0 + tid; e < e1; e += NT) {
    const int r = e / WG_JT, col = (e % WG_JT) * 4;
    const int j = j0 + col % WG_JT;
    if (m0 + r >= M || j >= J) continue;  // J % 16 == 0: four or none
    const long long at =
        (long long)(m0 + r) * N + (long long)(col / WG_JT) * J + j;
    float4 u[SK_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < SK_MAX_CLUSTER; ++q)
      if (q < KS)
        u[q] = __ldcg(reinterpret_cast<const float4*>(
            ws + (long long)q * M * N + at));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < SK_MAX_CLUSTER; ++q)
      if (q < KS) {
        v.x += u[q].x;
        v.y += u[q].y;
        v.z += u[q].z;
        v.w += u[q].w;
      }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(out + at) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
  // the last block past the wait resets the tile's two counters
  __syncthreads();
  if (tid == 0 && atomicAdd(arrived + 1, 1) == KS - 1) {
    arrived[0] = 0;
    arrived[1] = 0;
  }
}

// ------------------------------------------------- fp32 (parity oracle)

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

cudaError_t launch_splitk(const void* x, const void* b3, const void* scale,
                          void* out, int M, int K, int J, int mt, int ks,
                          int kps, cudaStream_t s) {
  const int BM = SK_BM * mt;
  const dim3 grid(ks, (J + SK_JT - 1) / SK_JT, (M + BM - 1) / BM);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const uint8_t* bp = static_cast<const uint8_t*>(b3);
  const float* sp = static_cast<const float*>(scale);
  bf16* op = static_cast<bf16*>(out);
  if (mt == 1)
    return cluster_launch(fp6_splitk_kernel<1>, grid, dim3(SK_NT),
                          sk_smem_bytes<1>(), ks, s, xp, bp, sp, op, M, K, J,
                          kps);
  return cluster_launch(fp6_splitk_kernel<2>, grid, dim3(SK_NT),
                        sk_smem_bytes<2>(), ks, s, xp, bp, sp, op, M, K, J,
                        kps);
}

template <int MW, int NWG>
cudaError_t launch_wgmma_mw(const CUtensorMap& tm_x, const CUtensorMap& tm_b,
                            const void* scale, void* out, float* ws, int* cnt,
                            int M, int K, int J, int ks, int kps,
                            cudaStream_t s) {
  const dim3 grid(ks, (J + WG_JT - 1) / WG_JT, (M + 64 * MW - 1) / (64 * MW));
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = wg_smem_bytes<MW>();
  const float* sp = static_cast<const float*>(scale);
  bf16* op = static_cast<bf16*>(out);
  auto kern = fp6_wgmma_kernel<MW, NWG>;
  // the shared memory attribute and the blocks an SM, per device (the
  // attribute is a device's), asked once each
  int resident = 0;
  cudaError_t err = blocks_per_sm(reinterpret_cast<const void*>(kern),
                                  128 * NWG, smem, &resident);
  if (err != cudaSuccess) return err;
  if (ks == 1) {
    kern<<<grid, 128 * NWG, smem, s>>>(tm_x, tm_b, sp, op, ws, cnt, M, K, J,
                                       kps);
    return cudaGetLastError();
  }
  // the split waits across blocks: all of them must be resident at once
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((long long)grid.x * grid.y * grid.z > (long long)resident * sms)
    return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(128 * NWG);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, tm_x, tm_b, sp, op, ws, cnt, M, K, J,
                           kps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const void* x, const void* b3, const void* scale,
                         void* out, float* ws, int* cnt, int M, int K, int J,
                         int mt, int ks, int kps, cudaStream_t s) {
  CUtensorMap tm_x, tm_b;
  {  // x [M, K] bf16 in 64 x 64 mt boxes, 128-byte swizzled
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {WG_BK, (cuuint32_t)(64 * mt)};
    cudaError_t err = encode_tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                        2, x, dims, strides, box,
                                        CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  {  // bytes3 [3, K, J] uint8 in 32 x 64 x 3 boxes, unswizzled
    const cuuint64_t dims[3] = {(cuuint64_t)J, (cuuint64_t)K, 3};
    const cuuint64_t strides[2] = {(cuuint64_t)J, (cuuint64_t)K * J};
    const cuuint32_t box[3] = {WG_JT, WG_BK, 3};
    cudaError_t err = encode_tensor_map(&tm_b, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                        3, b3, dims, strides, box,
                                        CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  // one row tile: a decoding and a multiplying warpgroup; two: two of
  // each; four (prefill): four that both decode and multiply
  if (mt == 1)
    return launch_wgmma_mw<1, 2>(tm_x, tm_b, scale, out, ws, cnt, M, K, J,
                                 ks, kps, s);
  if (mt == 2)
    return launch_wgmma_mw<2, 4>(tm_x, tm_b, scale, out, ws, cnt, M, K, J,
                                 ks, kps, s);
  return launch_wgmma_mw<4, 4>(tm_x, tm_b, scale, out, ws, cnt, M, K, J, ks,
                               kps, s);
}

}  // namespace

extern "C" {

// x [M, K] (bf16 or fp32, contiguous), bytes3 uint8 [3, K, J], scale f32
// [4, J] -> out [M, 4 J] in x's dtype. bf16 follows the plan of
// ops/kernels/fp6_gemm.py `fp6_plan`: `mt` 64-row tiles a block (1, 2, or
// 4 for the wgmma kernel) and a K split of `ks` ranges of `kps` (a
// multiple of 64; ks kps >= K > (ks - 1) kps). Route 0 runs the wgmma
// kernel and needs K % 8 == 0, J % 16 == 0 and 16-byte aligned x and
// bytes3; it sums a split (ks > 1) through the fp32 workspace `ws` [ks, M,
// 4 J] and the zeroed int counters `cnt` (two a tile: ceil(J / 32) x
// ceil(M / (64 mt)) tiles; left zeroed) on a cooperative launch, which
// the device must hold at once. Route 1 runs the mma.sync kernel (mt 1 or
// 2), any shape, split over a cluster. fp32 ignores the six.
int fp6_matmul_launch(const void* x, const void* b3, const void* scale,
                      void* out, void* ws, void* cnt, int M, int K, int J,
                      int is_bf16, int route, int mt, int ks, int kps,
                      void* stream) {
  if (M < 1 || K < 1 || J < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if ((M + FBM - 1) / FBM > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((J + FJT - 1) / FJT, (M + FBM - 1) / FBM);
    fp6_f32_kernel<<<grid, F_NT, 0, s>>>((const float*)x, (const uint8_t*)b3,
                                         (const float*)scale, (float*)out, M,
                                         K, J);
    return (int)cudaGetLastError();
  }
  const bool split_ws = route == 0 && ks > 1;
  if (route < 0 || route > 1 || split_ws != (ws != nullptr) ||
      split_ws != (cnt != nullptr) || (mt != 1 && mt != 2 && mt != 4) ||
      (mt == 4 && route == 1) ||
      ks < 1 || ks > SK_MAX_CLUSTER || kps < SK_BK || kps % SK_BK ||
      (long long)ks * kps < K || (long long)(ks - 1) * kps >= K)
    return (int)cudaErrorInvalidValue;
  if (route == 1)
    return (int)launch_splitk(x, b3, scale, out, M, K, J, mt, ks, kps, s);
  if (K % 8 || J % 16 || !aligned16(x) || !aligned16(b3))
    return (int)cudaErrorMisalignedAddress;
  return (int)launch_wgmma(x, b3, scale, out, static_cast<float*>(ws),
                           static_cast<int*>(cnt), M, K, J, mt, ks, kps, s);
}

}  // extern "C"
