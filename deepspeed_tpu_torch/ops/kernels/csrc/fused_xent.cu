// Fused LM-head cross-entropy for Hopper (sm_90a): the three kernels of
// the streaming xent, none of which writes the [N, V] logits to memory.
//
// xent_fwd replaces the Pallas kernel `_fwd_kernel`
//   (deepspeed_tpu/ops/kernels/fused_xent.py:57, launched at :118): per
//   token, the online logsumexp over the vocabulary, the target logit and
//   the sum of the real vocabulary's logits. A block owns 128 tokens and
//   one split (a contiguous range of 256-row vocabulary tiles) and writes
//   partial (max, sum, target, total) rows; a second small kernel combines
//   the splits in split order (the Pallas grid walks the whole vocabulary
//   in order on one core, a GPU block cannot).
// xent_bwd_dh replaces `_dh_kernel` (:165, launched at :280):
//   dh = scale * P' . E over the vocabulary walk.
// xent_bwd_de replaces `_de_kernel` (:192, launched at :299):
//   dE = scale * P'^T . h over the token walk.
// P' is `_grad_p` (:144): (1 + 2 z lse) P - (1 - eps) onehot - eps / V over
// the real vocabulary, zero for a token whose target is out of range or
// the ignore id, and for tokens past N.
//
// Bound on the H100: operations. One logits product is 2 N V C FLOP
// (8.44e11 at N = 4096, V = 50304, C = 2048: 0.853 ms at 989 TFLOP/s)
// against ~0.2 GB of operands. The forward does one; each backward kernel
// does two, the logits and its output product: 1.7067 ms each at that
// shape.
//
// The forward's design. A GEMM with a cheap epilogue: what bounds it
// besides the tensor cores is the operands' traffic from L2 into shared
// memory, since every block reads its h tile again for each vocabulary
// tile. 128 x 256 output tiles (two consumer warpgroups on m64n256k16
// wgmma, the accumulators in registers, raised to 232 a thread with
// setmaxnreg) cut that traffic per FLOP by 2.7 against 64 x 64 ones; one
// producer warp keeps TMA boxes in a 4-deep ring on mbarriers, so the
// consumers never wait on a __syncthreads. A split's vocabulary range is
// contiguous, so the token tiles working on it at once (all of them at the
// training shape: fwd_plan fills the card in one wave) read each E tile
// from device memory about once, through L2. Sharing each E box between
// two token tiles of a cluster by TMA multicast was built and timed
// slower on the card than these independent blocks, and was taken out.
//
// The backward's design. The Pallas kernels keep a whole [Tb, C] (dh) or
// [Vb, C] (dE) fp32 accumulator in VMEM; at C = 2048 that is more than an
// SM's shared memory and registers, so the output's C axis has to be split
// across blocks, and each split needs every logits tile. Rather than
// recompute a tile once per split (17 products at C = 2048), a
// thread-block cluster of CL blocks owns a 128-row output tile
// (tokens for dh, vocabulary rows for dE), block b the W-column slab b of
// it (CL W = C; at C = 2048 CL = 8 and W = 256; `bwd_plan` in
// ops/kernels/fused_xent.py picks them). The cluster walks the other axis
// in rounds of CL 64-wide tiles. Block b computes the logits of tile round
// CL + b over the full C, forms P' in registers, casts it to h's dtype (where
// the Pallas kernels cast) and leaves the 16 KB tile in its shared memory;
// after a cluster barrier every block copies each of the round's CL tiles
// from its owner (distributed shared memory) and multiplies it into its
// [128, W] fp32 accumulator. So each logits tile is computed once and each
// kernel does its two products; a C over 8 x 256 splits into G slab groups
// (blockIdx.z) that each compute the logits again (G + 1 products).
// Both products run on wgmma (two consumer warpgroups of 64 rows, fp32
// accumulators in registers, m64n64k16 for the logits, m64nWk16 for the
// output with the Q slab MN-major), every operand in shared memory in the
// 128-byte-swizzled layout that TMA writes: the logits' K-steps through a
// 4-deep ring (one step's products left in flight), the output's Q slabs
// double-buffered, one thread issuing the TMA boxes on mbarriers. The
// sums run over 64-wide K-steps and over the tiles in order.
//
// Numerics follow the Pallas kernels: logits in fp32 from 16-bit operands
// (bf16 or fp16: each kernel is instantiated for both, T); the target
// logit taken before the vocabulary mask (rows of E past V are staged as
// zeros, so an id in the padded tile reads 0, as with the JAX wrapper's
// zero padding); the 1e-37 floor inside the log; P' cast to T before its
// product, sums in fp32, the loss scale applied in fp32 after the product
// (as the Pallas kernels do), so a large fp16 loss scale never reaches an
// fp16 operand. The shared-memory buffers are typed bf16 as 16-bit
// storage; wgmma reads them as T.
//
// fp32 inputs run simple CUDA-core kernels (256 threads, 4 x 4 outputs a
// thread from 64 x 16 shared tiles), a parity oracle for the indexing and
// masking at a tight tolerance; they are not meant to be fast.
//
// The Hopper machinery (wgmma descriptors and products, mbarriers, TMA
// boxes and maps, the cluster launch) lives in hopper.cuh, shared with
// fp6_gemm.cu.
//
// Layout: h [N, C], E [V, C] row-major and contiguous, targets int32 [N],
// lse fp32 [N], scale a one-element fp32 device array (the loss's
// cotangent, read on the device: no host sync). C is a multiple of 64
// (the wrapper pads another hidden size with zero columns).
// Ragged token and vocabulary tiles are masked in the kernels (no padded
// copies). Kernels launch on the caller's stream, do not synchronise and
// allocate nothing; each C entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;             // rows of a 64 x 64 box
constexpr int BN = 64;             // columns of a backward logits tile
constexpr int BK = 64;             // depth of one staged slab of C
constexpr int F_NT = 256;          // threads of the fp32 kernels
constexpr int FK = 16;             // depth of an fp32 shared tile
constexpr int FB = 64;             // fp32 output slab width

// two floats rounded to T (bf16 or fp16), lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

struct Grad {                        // P' parameters
  int V, has_ignore, ignore;
  float z, eps;
};

// One element of P' for a logit `x` at vocabulary id `v` of a token with
// lse `ls` and target `t`, `live` false for a token past N; FAST takes the
// ex2-based exponential (the tensor-core kernels), else the accurate one.
template <bool FAST>
__device__ __forceinline__ float grad_p(float x, int v, float ls, int t,
                                        bool live, const Grad& g) {
  const bool valid = live && t >= 0 && t < g.V &&
                     !(g.has_ignore && t == g.ignore);
  if (!valid || v >= g.V) return 0.f;
  float p = FAST ? __expf(x - ls) : expf(x - ls);
  if (g.z != 0.f) p *= 1.f + 2.f * g.z * ls;
  if (v == t) p -= 1.f - g.eps;
  if (g.eps != 0.f) p -= g.eps / g.V;
  return p;
}

// ---------------------------------------------------------------- forward

// A forward block: 128 tokens (rows r0..) against the vocabulary tiles
// [jt0, jt1) of its split, 256 rows each, over the full C. Warpgroup 0 is
// the producer: after giving back its registers, one thread issues the
// TMA boxes of each 64-deep K-step (h [128 x 64], E [256 x 64] in two
// 128-row halves, 128-byte swizzled) into a FW_STAGES-deep ring, each
// buffer waiting on its `empty` barrier for the consumers to free it.
// Warpgroups 1 and 2 are the consumers, 64 tokens each: m64n256k16 wgmma
// with both operands in shared memory, one K-step's products left in
// flight while the next is issued, the [64 x 256] fp32 logits in
// registers (128 a thread).
//
// After a tile's C walk the consumers fold it into their running (m, l,
// g, s) in registers: target and sum gathers before the vocabulary mask
// (E's rows past V arrive as TMA's zeros, so their logits are exactly 0:
// an id in the padded range reads 0 and the sum is unchanged), the row
// max over the real columns, a rescale and the exp-sum. Only the last
// tile of the vocabulary can hold columns past V.
constexpr int FW_CONS = 2;                   // consumer warpgroups
constexpr int FW_NT = 128 * (FW_CONS + 1);   // + the producer warpgroup
constexpr int FW_M = 64 * FW_CONS;           // tokens of a block
constexpr int FW_N = 256;                    // vocabulary rows of a tile
constexpr int FW_HALF = 128;                 // rows of one E box
constexpr int FW_STAGES = 4;
constexpr int FW_STAGE = (FW_M + FW_N) * BK; // elements of a ring buffer

__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return FW_STAGES * FW_STAGE * sizeof(bf16) +
         2 * FW_STAGES * sizeof(uint64_t);
}

// Fold one [64 x 256] logits tile at vocabulary column c0 into this
// thread's two rows' running max m, sum l (of exp(x - m), this thread's
// columns only), target logit g and logit sum s. RAGGED: the tile holds
// columns past V.
template <bool RAGGED>
__device__ __forceinline__ void fold_tile(const float (&acc)[128], int c0,
                                          int V, const int (&t)[2],
                                          float (&m)[2], float (&l)[2],
                                          float (&g)[2], float (&s)[2],
                                          int qi) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 32; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = x / 2, col = c0 + n * 8 + qi * 2 + (x & 1);
      const float v = acc[4 * n + x];
      if (col == t[i]) g[i] += v;
      s[i] += v;
      if (!RAGGED || col < V) mx[i] = fmaxf(mx[i], v);
    }
  float m_neg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    l[i] *= ex2((m[i] - m_safe) * LOG2E);
    m[i] = m_new;
    m_neg[i] = -m_safe * LOG2E;
  }
#pragma unroll
  for (int n = 0; n < 32; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = x / 2, col = c0 + n * 8 + qi * 2 + (x & 1);
      const float p = ex2(fmaf(acc[4 * n + x], LOG2E, m_neg[i]));
      if (!RAGGED || col < V) l[i] += p;
    }
}

template <typename T>
__global__ void __launch_bounds__(FW_NT, 1)
xent_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_h,
                      const __grid_constant__ CUtensorMap tm_e,
                      const int* __restrict__ tgt, float* __restrict__ part,
                      int N, int V, int C, int splits) {
  extern __shared__ __align__(1024) unsigned char fw_smem[];
  bf16* ring = reinterpret_cast<bf16*>(fw_smem);    // [stage][h 128, E 256]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + FW_STAGES * FW_STAGE);
  uint64_t* empty = full + FW_STAGES;
  const int r0 = blockIdx.x * FW_M, sp = blockIdx.y;
  const int nvt = (V + FW_N - 1) / FW_N;
  const int jt0 = (int)((long long)sp * nvt / splits);
  const int jt1 = (int)((long long)(sp + 1) * nvt / splits);
  const int nk = C / BK;
  // warp-uniform for ptxas (C7518)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, FW_CONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    set_max_regs<40, false>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int j = jt0; j < jt1; ++j)
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int st = it % FW_STAGES;
          mbar_wait(empty + st, ((it / FW_STAGES) & 1) ^ 1);
          bf16* buf = ring + st * FW_STAGE;
          mbar_expect(full + st, FW_STAGE * sizeof(bf16));
          tma_box(buf, &tm_h, ks * BK, r0, full + st);
          tma_box(buf + FW_M * BK, &tm_e, ks * BK, j * FW_N, full + st);
          tma_box(buf + (FW_M + FW_HALF) * BK, &tm_e, ks * BK,
                  j * FW_N + FW_HALF, full + st);
        }
    }
  } else {
    set_max_regs<232, true>();
    const int cw = wg - 1;                        // rows 64 cw of the block
    const int lane = threadIdx.x % 32, qi = lane % 4;
    const int row0 = r0 + cw * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
    const int row[2] = {row0, row0 + 8};
    const bool signal = threadIdx.x % 128 == 0;
    int t[2];
    float m[2], l[2], g[2], s[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      t[i] = row[i] < N ? tgt[row[i]] : -1;
      m[i] = -INFINITY;
      l[i] = g[i] = s[i] = 0.f;
    }
    auto release = [&](int st) {             // ring buffer `st` is free
      if (signal) mbar_arrive(empty + st);
    };
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int it = 0;
    for (int j = jt0; j < jt1; ++j) {
      fence_regs(acc);
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int st = it % FW_STAGES;
        mbar_wait(full + st, (it / FW_STAGES) & 1);
        const bf16* a = ring + st * FW_STAGE + cw * 64 * BK;
        const bf16* b = ring + st * FW_STAGE + FW_M * BK;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<0, T>(acc, wg_desc(a + kk * 16, 16, 1024),
                         wg_desc(b + kk * 16, 16, 1024), ks > 0 || kk > 0,
                      std::integral_constant<int, FW_N>());
        wg_commit();
        wg_wait<1>();
        if (ks > 0) release((it - 1) % FW_STAGES);
      }
      wg_wait<0>();
      fence_regs(acc);
      release((it - 1) % FW_STAGES);
      if ((j + 1) * FW_N > V)
        fold_tile<true>(acc, j * FW_N, V, t, m, l, g, s, qi);
      else
        fold_tile<false>(acc, j * FW_N, V, t, m, l, g, s, qi);
    }
    const long long plane = (long long)splits * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
        g[i] += __shfl_xor_sync(0xffffffffu, g[i], o);
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
      }
      if (qi == 0 && row[i] < N) {
        const long long at = (long long)sp * N + row[i];
        part[at] = m[i];
        part[plane + at] = l[i];
        part[2 * plane + at] = g[i];
        part[3 * plane + at] = s[i];
      }
    }
  }
}

// lse, target logit and logit sum of each token from the splits' partials
__global__ void xent_combine_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int N,
                                    int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const long long plane = (long long)splits * N;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part[(long long)s * N + r]);
  const float m_safe = mx == -INFINITY ? 0.f : mx;
  float l = 0.f, g = 0.f, t = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long at = (long long)s * N + r;
    l += part[plane + at] * expf(part[at] - m_safe);
    g += part[2 * plane + at];
    t += part[3 * plane + at];
  }
  out[r] = mx + logf(fmaxf(l, 1e-37f));
  out[N + r] = g;
  out[2 * N + r] = t;
}

// -------------------------------------------------------------- backward
//
// A cluster of CL blocks owns a 128-row output tile; block b (its rank)
// owns the W-column slab (z CL + b) W of it (z: the slab group,
// blockIdx.z), two warpgroups of 64 rows each. Rounds of CL column tiles:
// block b computes the logits of tile round CL + b over the full C (wgmma,
// operands K-major in shared memory, the Q operand shared by the two
// warpgroups), forms P' in registers and leaves it as T in its shared
// memory, where every block of the cluster reads it (distributed shared
// memory, copied into a local staging buffer) to multiply the round's CL
// tiles into its slab (wgmma, P' K-major and the Q slab MN-major in shared
// memory). Operands arrive by TMA in 64 x 64 boxes (8 KB, rows of 128
// bytes) with the 128-byte swizzle that wgmma reads without bank
// conflicts, completing on an mbarrier a buffer.

constexpr int BW_NT = 256;             // threads: two warpgroups
constexpr int BW_M = 128;              // output rows of a cluster
constexpr int BW_STAGES = 4;           // logits ring: buffers ...
constexpr int BW_AHEAD = BW_STAGES - 2;  // ... and K-steps loaded ahead
constexpr int BW_SLABS = 2;            // Q slabs of the output product
constexpr int TILE = BM * BK;          // elements of one 64 x 64 box
constexpr int STAGE = (BW_M + BN) * BK;  // elements of one ring buffer
constexpr int PTILE = BW_M * BN;       // elements of one [128 x 64] P' tile

// Shared memory of a backward block: the logits ring [stage][R [128 x
// 64], Q [64 x 64]], BW_SLABS [64 x W] Q slabs of the output product, this
// block's P' tile, two P' tiles staged for the output product, (dE) the
// logits tile's lse and targets, and an mbarrier for each ring buffer and
// slab. P' tiles are K-major and 128-byte swizzled, as TMA would write
// them, so that wgmma reads them as its A operand.
__host__ __device__ constexpr size_t bwd_smem_bytes(int W) {
  return (BW_STAGES * STAGE + BW_SLABS * BN * W + 3 * PTILE) * sizeof(bf16) +
         2 * BN * sizeof(float) + (BW_STAGES + BW_SLABS) * sizeof(uint64_t);
}

// Load K-step `s` of the logits of rows [r0, +128) of R against rows [j0,
// +64) of Q into ring buffer `buf`: one box of each, K-major. Called by
// thread 0.
__device__ __forceinline__ void logits_load(bf16* ring, uint64_t* full,
                                            const CUtensorMap* tmR,
                                            const CUtensorMap* tmQ, int r0,
                                            int j0, int s, int buf) {
  mbar_expect(full + buf, STAGE * sizeof(bf16));
  tma_box(ring + buf * STAGE, tmR, s * BK, r0, full + buf);
  tma_box(ring + buf * STAGE + BW_M * BK, tmQ, s * BK, j0, full + buf);
}

// Load the output product's Q slab of column tile `j` (rows [64 j, +64),
// columns [c0, c0 + W)) into slab buffer `buf`: W / 64 boxes of 64
// columns, MN-major (K = the 64 rows) with the boxes 8 KB apart along N.
// Called by thread 0.
template <int W>
__device__ __forceinline__ void slab_load(bf16* slabs, uint64_t* bar,
                                          const CUtensorMap* tmQ, int j,
                                          int c0, int buf) {
  mbar_expect(bar + buf, BN * W * sizeof(bf16));
#pragma unroll
  for (int nb = 0; nb < W / 64; ++nb)
    tma_box(slabs + buf * BN * W + nb * TILE, tmQ, c0 + nb * 64, j * BN,
            bar + buf);
}

// The TMA loads of one backward block, issued by thread 0 in the order the
// block consumes them, and the consumers' view of them: running counts of
// logits K-steps and Q slabs issued and used, whose buffer and mbarrier
// phase follow from the count.
struct BwdPipe {
  bf16 *ring, *slabs;
  uint64_t *full, *slab_full;
  const CUtensorMap *tmR, *tmQ;
  int r0, c0, nk;
  int lg_issued = 0, lg_used = 0, sl_issued = 0, sl_used = 0;

  // logits K-steps [s0, s1) of column tile `jt`
  __device__ void issue_logits(int jt, int s0, int s1) {
    for (int s = s0; s < min(s1, nk); ++s, ++lg_issued)
      if (threadIdx.x == 0)
        logits_load(ring, full, tmR, tmQ, r0, jt * BN, s,
                    lg_issued % BW_STAGES);
  }
  // the next logits K-step has landed; its ring buffer
  __device__ const bf16* use_logits() {
    const int buf = lg_used % BW_STAGES;
    mbar_wait(full + buf, (lg_used / BW_STAGES) & 1);
    ++lg_used;
    return ring + buf * STAGE;
  }
  template <int W>
  __device__ void issue_slab(int j) {
    if (threadIdx.x == 0)
      slab_load<W>(slabs, slab_full, tmQ, j, c0, sl_issued % BW_SLABS);
    ++sl_issued;
  }
  template <int W>
  __device__ const bf16* use_slab() {
    const int buf = sl_used % BW_SLABS;
    mbar_wait(slab_full + buf, (sl_used / BW_SLABS) & 1);
    ++sl_used;
    return slabs + buf * BN * W;
  }
};

// sc = R[r0 + 64 wg, +64) . Q[64 jt, +64)^T over the full C for
// warpgroup wg: 64-wide K-steps through the ring, BW_AHEAD of them in
// flight (the first BW_AHEAD issued before the call), four m64n64k16 wgmma
// a step with one step's products left in flight. sc holds the 64 x 64
// fp32 tile in the accumulator layout (warp w of the warpgroup: rows 16 w
// + lane / 4 (+8); element 4 n + x at column 8 n + 2 (lane % 4) + (x & 1),
// row +8 for x >= 2), the m16n8 C-fragment layout of mma.sync.
template <typename T>
__device__ __forceinline__ void logits_tile(float (&sc)[32], BwdPipe& pipe,
                                            int jt, int wg) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  fence_regs(sc);
  for (int ks = 0; ks < pipe.nk; ++ks) {
    const bf16* a = pipe.use_logits();
    __syncthreads();               // step ks - 2's products are done
    pipe.issue_logits(jt, ks + BW_AHEAD, ks + BW_AHEAD + 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<0, T>(sc, wg_desc(a + wg * TILE + kk * 16, 16, 1024),
                     wg_desc(a + BW_M * BK + kk * 16, 16, 1024), 1,
                  std::integral_constant<int, 64>());
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  fence_regs(sc);
}

// Copy block `rank`'s P' tile into `dst` (16 bytes a thread a step) and
// make the copy visible to wgmma.
__device__ __forceinline__ void stage_ptile(bf16* dst, bf16* own,
                                            cg::cluster_group& cluster,
                                            int rank) {
  const uint4* src =
      reinterpret_cast<const uint4*>(cluster.map_shared_rank(own, rank));
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < PTILE / 8 / BW_NT; ++i)
    d[threadIdx.x + i * BW_NT] = src[threadIdx.x + i * BW_NT];
  fence_async_smem();
}

template <bool DE, int W, typename T, typename OutT>
__global__ void __launch_bounds__(BW_NT, 1)
xent_bwd_cluster_kernel(const __grid_constant__ CUtensorMap tm_r,
                        const __grid_constant__ CUtensorMap tm_q,
                        const float* __restrict__ scale,
                        const int* __restrict__ tgt,
                        const float* __restrict__ lse,
                        OutT* __restrict__ out, int N, int C, int CL,
                        Grad gp) {
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  bf16* ring = reinterpret_cast<bf16*>(bwd_smem);
  bf16* slabs = ring + BW_STAGES * STAGE;              // [BW_SLABS][64 x W]
  bf16* pown = slabs + BW_SLABS * BN * W;              // this block's P'
  bf16* pstage = pown + PTILE;                         // [2] staged P'
  float* lse_s = reinterpret_cast<float*>(pstage + 2 * PTILE);
  int* tgt_s = reinterpret_cast<int*>(lse_s + BN);
  uint64_t* bars = reinterpret_cast<uint64_t*>(tgt_s + BN);
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank();
  const int V = gp.V;
  const int nrows = DE ? V : N, ncols = DE ? N : V;
  const int r0 = blockIdx.y * BW_M, c0 = (blockIdx.z * CL + b) * W;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, quad = lane / 4, qi = lane % 4;
  const int row[2] = {r0 + warp * 16 + quad, r0 + warp * 16 + quad + 8};
  float ls_r[2] = {0.f, 0.f};
  int t_r[2] = {-1, -1};
  if (!DE) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < N) {
        ls_r[i] = lse[row[i]];
        t_r[i] = tgt[row[i]];
      }
  }
  if (threadIdx.x < BW_STAGES + BW_SLABS) mbar_init(bars + threadIdx.x);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  BwdPipe pipe{ring, slabs, bars, bars + BW_STAGES, &tm_r, &tm_q, r0, c0,
               C / BK};
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  const int ntiles = (ncols + BN - 1) / BN;
  const int rounds = (ntiles + CL - 1) / CL;

  cluster_arrive();              // every block has started before a read
  if (b < ntiles) pipe.issue_logits(b, 0, BW_AHEAD);   // round 0's first
  for (int rd = 0; rd < rounds; ++rd) {
    const int j0 = rd * CL, jend = min(j0 + CL, ntiles);
    const int jt = j0 + b;                             // this block's tile
    uint32_t pk[16];             // P' as T pairs: rows quad, quad + 8
    if (jt < ntiles) {
      if (DE && threadIdx.x < BN) {
        const int tok = jt * BN + threadIdx.x;
        lse_s[threadIdx.x] = tok < N ? lse[tok] : 0.f;
        tgt_s[threadIdx.x] = tok < N ? tgt[tok] : -1;
      }
      float sc[32];
      logits_tile<T>(sc, pipe, jt, wg);
      float p[32];
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        const int i = (n % 4) / 2, c = (n / 4) * 8 + qi * 2 + (n & 1);
        const int col = jt * BN + c;
        p[n] = DE ? grad_p<true>(sc[n], row[i], lse_s[c], tgt_s[c],
                                 col < N, gp)
                  : grad_p<true>(sc[n], col, ls_r[i], t_r[i], row[i] < N,
                                 gp);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) pk[i] = pack2<T>(p[2 * i], p[2 * i + 1]);
    }
    __syncthreads();                     // the ring is free (dE: lse_s too)
    // keep the copies flowing through the cluster barriers: the next
    // round's first logits steps and this round's first Q slabs
    if (jt + CL < ntiles) pipe.issue_logits(jt + CL, 0, BW_AHEAD);
    for (int j = j0; j < min(j0 + BW_SLABS - 1, jend); ++j)
      pipe.issue_slab<W>(j);
    cluster_wait();              // peers are done reading the last round's
    if (jt < ntiles) {
      const int r = warp * 16 + quad;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        char* base = reinterpret_cast<char*>(pown);
        const int c = nt * 8 + qi * 2;
        *reinterpret_cast<uint32_t*>(base + swizzled(r, c)) = pk[2 * nt];
        *reinterpret_cast<uint32_t*>(base + swizzled(r + 8, c)) =
            pk[2 * nt + 1];
      }
    }
    cluster_arrive();
    cluster_wait();                        // the round's tiles are in place
    // each round tile's P' is staged from its block into local shared
    // memory one tile ahead of its product
    stage_ptile(pstage, pown, cluster, 0);
    __syncthreads();
    for (int j = j0; j < jend; ++j) {
      const int t = j - j0;
      if (j + BW_SLABS - 1 < jend) pipe.issue_slab<W>(j + BW_SLABS - 1);
      const bf16* qs = pipe.use_slab<W>();
      const bf16* pa = pstage + (t % 2) * PTILE + wg * TILE;
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_ss<1, T>(acc, wg_desc(pa + kk * 16, 16, 1024),
                       wg_desc(qs + kk * 1024, TILE * sizeof(bf16), 1024), 1,
                    std::integral_constant<int, W>());
      wg_commit();
      if (j + 1 < jend)
        stage_ptile(pstage + ((t + 1) % 2) * PTILE, pown, cluster, t + 1);
      wg_wait<0>();
      fence_regs(acc);
      __syncthreads();     // the slab's and P' buffers may be refilled
    }
    cluster_arrive();                      // done reading the round's tiles
  }
  cluster_wait();
  const float sf = scale[0];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= nrows) continue;
    OutT* p = out + (long long)row[i] * C + c0 + qi * 2;
#pragma unroll
    for (int dn = 0; dn < W / 8; ++dn) {
      const float a = acc[dn * 4 + 2 * i] * sf;
      const float b2 = acc[dn * 4 + 2 * i + 1] * sf;
      if constexpr (sizeof(OutT) == 2) {
        *reinterpret_cast<uint32_t*>(p + dn * 8) = pack2<OutT>(a, b2);
      } else {
        *reinterpret_cast<float2*>(p + dn * 8) = make_float2(a, b2);
      }
    }
  }
}

// ------------------------------------------------- fp32 (parity oracle)

// s[4][4] = A[rows ar0.., C] . B[rows br0.., C]^T for this thread's rows
// ty + 16 i and columns tx + 16 j of the 64 x 64 tile; rows past the
// operands' ends read zeros.
__device__ __forceinline__ void f32_logits(float (&s)[4][4],
                                           const float* __restrict__ A,
                                           int arows, int ar0,
                                           const float* __restrict__ B,
                                           int brows, int br0, int C,
                                           float* As, float* Bs) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += FK) {
    for (int x = threadIdx.x; x < 64 * FK; x += F_NT) {
      const int r = x / FK, k = x % FK;
      As[r * (FK + 1) + k] =
          ar0 + r < arows ? A[(long long)(ar0 + r) * C + k0 + k] : 0.f;
      Bs[r * (FK + 1) + k] =
          br0 + r < brows ? B[(long long)(br0 + r) * C + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[(ty + 16 * i) * (FK + 1) + k];
        b[i] = Bs[(tx + 16 * i) * (FK + 1) + k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    __syncthreads();
  }
}

// the 16 threads of a half-warp that share a row
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(F_NT)
xent_fwd_f32_kernel(const float* __restrict__ h, const float* __restrict__ e,
                    const int* __restrict__ tgt, float* __restrict__ part,
                    int N, int V, int C, int splits) {
  __shared__ float As[64 * (FK + 1)], Bs[64 * (FK + 1)];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = blockIdx.x * 64, sp = blockIdx.y;
  const int nvt = (V + BN - 1) / BN;
  const int jt0 = (int)((long long)sp * nvt / splits);
  const int jt1 = (int)((long long)(sp + 1) * nvt / splits);
  int t[4];
  float m[4], l[4], g[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    t[i] = r < N ? tgt[r] : -1;
    m[i] = -INFINITY;
    l[i] = g[i] = s[i] = 0.f;
  }
  for (int j = jt0; j < jt1; ++j) {
    float x[4][4];
    f32_logits(x, h, N, r0, e, V, j * BN, C, As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j * BN + tx + 16 * c;
        if (col == t[i]) g[i] += x[i][c];
        if (col < V) s[i] += x[i][c];
        x[i][c] = col < V ? x[i][c] : -INFINITY;
        mx = fmaxf(mx, x[i][c]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) rs += expf(x[i][c] - m_safe);
      l[i] = l[i] * expf(m[i] - m_safe) + rs;
      m[i] = m_new;
    }
  }
  const long long plane = (long long)splits * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = half_sum(l[i]), gt = half_sum(g[i]), st = half_sum(s[i]);
    const int r = r0 + ty + 16 * i;
    if (tx == 0 && r < N) {
      const long long at = (long long)sp * N + r;
      part[at] = m[i];
      part[plane + at] = lt;
      part[2 * plane + at] = gt;
      part[3 * plane + at] = st;
    }
  }
}

template <bool DE>
__global__ void __launch_bounds__(F_NT)
xent_bwd_f32_kernel(const float* __restrict__ scale,
                    const float* __restrict__ h, const float* __restrict__ e,
                    const int* __restrict__ tgt,
                    const float* __restrict__ lse, float* __restrict__ out,
                    int N, int C, Grad gp) {
  __shared__ float As[64 * (FK + 1)], Bs[64 * (FK + 1)];
  __shared__ float Ps[64 * 65], Qs[64 * 65];
  const int V = gp.V;
  const float* R = DE ? e : h;
  const float* Q = DE ? h : e;
  const int nrows = DE ? V : N, ncols = DE ? N : V;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = blockIdx.x * 64, c0 = blockIdx.y * FB;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int j0 = 0; j0 < ncols; j0 += BN) {
    float x[4][4];
    f32_logits(x, R, nrows, r0, Q, ncols, j0, C, As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + ty + 16 * i, col = j0 + tx + 16 * c;
        const int tok = DE ? col : r, voc = DE ? r : col;
        const bool live = tok < N;
        const float p = grad_p<false>(x[i][c], voc, live ? lse[tok] : 0.f,
                               live ? tgt[tok] : -1, live, gp);
        Ps[(ty + 16 * i) * 65 + tx + 16 * c] = p;
      }
    for (int y = threadIdx.x; y < 64 * FB; y += F_NT) {
      const int r = y / FB, c = y % FB;
      Qs[r * 65 + c] = j0 + r < ncols ? Q[(long long)(j0 + r) * C + c0 + c]
                                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BN; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Ps[(ty + 16 * i) * 65 + k];
        b[i] = Qs[k * 65 + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    __syncthreads();
  }
  const float sf = scale[0];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= nrows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[(long long)r * C + c0 + tx + 16 * c] = acc[i][c] * sf;
  }
}

// ------------------------------------------------------------ dispatch

bool aligned16(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

bool dims_ok(int N, int V, int C) {
  return N > 0 && V > 0 && C > 0 && C % BK == 0;
}

// A 2-D TMA map of a row-major [rows, C] matrix of T (bf16 or fp16),
// boxes of 64 columns by `box_rows` rows with the 128-byte swizzle.
template <typename T>
cudaError_t row_major_map(CUtensorMap* map, const void* base, int rows,
                          int C, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)C * sizeof(T)};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  return encode_tensor_map(map,
                           std::is_same<T, __half>::value
                               ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                           2, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// One backward launch on a cluster of CL blocks (W-column slabs, G slab
// groups: CL W G = C). Refused before launch when no cluster of this size
// and shared memory fits on the device.
template <bool DE, int W, typename T, typename OutT>
cudaError_t bwd_cluster(const void* scale, const void* h, const void* e,
                        const void* tgt, const void* lse, void* out, int N,
                        int C, int CL, int G, const Grad& gp,
                        cudaStream_t stream) {
  const int nrows = DE ? gp.V : N;
  CUtensorMap tm_r, tm_q;                // R in 128-row boxes, Q in 64
  cudaError_t err = row_major_map<T>(&tm_r, DE ? e : h, nrows, C, BW_M);
  if (err == cudaSuccess)
    err = row_major_map<T>(&tm_q, DE ? h : e, DE ? N : gp.V, C, BN);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = bwd_smem_bytes(W);
  auto kernel = xent_bwd_cluster_kernel<DE, W, T, OutT>;
  return cluster_launch(kernel, dim3(CL, (nrows + BW_M - 1) / BW_M, G),
                        dim3(BW_NT), smem, CL, stream, tm_r, tm_q,
                        (const float*)scale, (const int*)tgt,
                        (const float*)lse, (OutT*)out, N, C, CL, gp);
}

template <bool DE, typename T, typename OutT>
cudaError_t bwd_plan(const void* scale, const void* h, const void* e,
                     const void* tgt, const void* lse, void* out, int N,
                     int C, int CL, int W, int G, const Grad& gp,
                     cudaStream_t s) {
  if (W == 256)
    return bwd_cluster<DE, 256, T, OutT>(scale, h, e, tgt, lse, out, N, C,
                                         CL, G, gp, s);
  if (W == 128)
    return bwd_cluster<DE, 128, T, OutT>(scale, h, e, tgt, lse, out, N, C,
                                         CL, G, gp, s);
  return bwd_cluster<DE, 64, T, OutT>(scale, h, e, tgt, lse, out, N, C, CL,
                                      G, gp, s);
}

// the 16-bit route in T: dh / dE out in T, or fp32 when out_f32
template <bool DE, typename T>
cudaError_t bwd_route(const void* scale, const void* h, const void* e,
                      const void* tgt, const void* lse, void* out, int N,
                      int C, int CL, int W, int G, int out_f32,
                      const Grad& gp, cudaStream_t s) {
  return out_f32 ? bwd_plan<DE, T, float>(scale, h, e, tgt, lse, out, N, C,
                                          CL, W, G, gp, s)
                 : bwd_plan<DE, T, T>(scale, h, e, tgt, lse, out, N, C, CL,
                                      W, G, gp, s);
}

template <bool DE>
cudaError_t bwd(const void* scale, const void* h, const void* e,
                const void* tgt, const void* lse, void* out, int N, int V,
                int C, int has_ignore, int ignore, float z, float eps,
                int dtype, int out_f32, int CL, int W, int G,
                void* stream) {
  if (!dims_ok(N, V, C) || dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  const void* ptrs[3] = {h, e, out};
  const Grad gp{V, has_ignore, ignore, z, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nrows = DE ? V : N;
  if (dtype == 0) {
    dim3 grid((nrows + 63) / 64, C / FB);
    xent_bwd_f32_kernel<DE><<<grid, F_NT, 0, s>>>(
        (const float*)scale, (const float*)h, (const float*)e,
        (const int*)tgt, (const float*)lse, (float*)out, N, C, gp);
    return cudaGetLastError();
  }
  if (!aligned16(ptrs, 3)) return cudaErrorMisalignedAddress;
  if (CL < 1 || CL > 8 || G < 1 || (W != 64 && W != 128 && W != 256) ||
      (long long)CL * W * G != C || (nrows + BW_M - 1) / BW_M > 65535)
    return cudaErrorInvalidValue;
  return dtype == 1
             ? bwd_route<DE, bf16>(scale, h, e, tgt, lse, out, N, C, CL, W,
                                   G, out_f32, gp, s)
             : bwd_route<DE, __half>(scale, h, e, tgt, lse, out, N, C, CL, W,
                                     G, out_f32, gp, s);
}

// The 16-bit forward in T (bf16 or fp16): one launch of
// xent_fwd_wgmma_kernel<T> over (token tiles, splits).
template <typename T>
cudaError_t fwd_wgmma(const void* h, const void* e, const void* tgt,
                      void* part, int N, int V, int C, int splits,
                      cudaStream_t s) {
  const void* ptrs[2] = {h, e};
  if (!aligned16(ptrs, 2)) return cudaErrorMisalignedAddress;
  CUtensorMap tm_h, tm_e;                // boxes of 128 rows x 64 columns
  cudaError_t err = row_major_map<T>(&tm_h, h, N, C, FW_M);
  if (err == cudaSuccess) err = row_major_map<T>(&tm_e, e, V, C, FW_HALF);
  if (err != cudaSuccess) return err;
  auto kernel = xent_fwd_wgmma_kernel<T>;
  int per_sm = 0;
  err = blocks_per_sm(reinterpret_cast<const void*>(kernel), FW_NT,
                      fwd_smem_bytes(), &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  kernel<<<dim3((N + FW_M - 1) / FW_M, splits), FW_NT, fwd_smem_bytes(),
           s>>>(tm_h, tm_e, (const int*)tgt, (float*)part, N, V, C,
                splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h [N, C], e [V, C] (contiguous; dtype 0 fp32, 1 bf16, 2 fp16), tgt int32
// [N] -> out fp32 [3, N] (lse, target logit, logit sum); part fp32 [4,
// splits, N] scratch. bf16 and fp16 split the vocabulary into `splits`
// contiguous ranges of 256-row tiles (the plan of
// ops/kernels/fused_xent.py `fwd_plan`); fp32 walks 64-row tiles in the
// same number of ranges.
int xent_fwd_launch(const void* h, const void* e, const void* tgt, void* out,
                    void* part, int N, int V, int C, int splits, int dtype,
                    void* stream) {
  if (!dims_ok(N, V, C) || splits < 1 || splits > (V + FW_N - 1) / FW_N ||
      splits > 65535 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = fwd_wgmma<bf16>(h, e, tgt, part, N, V, C, splits, s);
  } else if (dtype == 2) {
    err = fwd_wgmma<__half>(h, e, tgt, part, N, V, C, splits, s);
  } else {
    xent_fwd_f32_kernel<<<dim3((N + 63) / 64, splits), F_NT, 0, s>>>(
        (const float*)h, (const float*)e, (const int*)tgt, (float*)part, N,
        V, C, splits);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  xent_combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)out, N, splits);
  return (int)cudaGetLastError();
}

// scale fp32 [1], h, e, tgt as above, lse fp32 [N] -> out [N, C] (dh) in
// h's dtype, or fp32 when out_f32. bf16 and fp16 run on clusters of `cl`
// blocks, each a `w`-column slab, `groups` slab groups (cl w groups = C;
// the plan of ops/kernels/fused_xent.py `bwd_plan`); fp32 ignores the
// three.
int xent_bwd_dh_launch(const void* scale, const void* h, const void* e,
                       const void* tgt, const void* lse, void* out, int N,
                       int V, int C, int has_ignore, int ignore, float z,
                       float eps, int dtype, int out_f32, int cl, int w,
                       int groups, void* stream) {
  return (int)bwd<false>(scale, h, e, tgt, lse, out, N, V, C, has_ignore,
                         ignore, z, eps, dtype, out_f32, cl, w, groups,
                         stream);
}

// as above -> out [V, C] (dE) in h's dtype, or fp32 when out_f32
int xent_bwd_de_launch(const void* scale, const void* h, const void* e,
                       const void* tgt, const void* lse, void* out, int N,
                       int V, int C, int has_ignore, int ignore, float z,
                       float eps, int dtype, int out_f32, int cl, int w,
                       int groups, void* stream) {
  return (int)bwd<true>(scale, h, e, tgt, lse, out, N, V, C, has_ignore,
                        ignore, z, eps, dtype, out_f32, cl, w, groups,
                        stream);
}

}  // extern "C"
