// Grouped expert GEMM for Hopper (sm_90a): y[o_e:o_{e+1}] = x[o_e:o_{e+1}]
// @ w[e] for every expert e, with the row offsets o read on the device.
//
// grouped_gemm replaces no Pallas kernel: the JAX package's dropless MoE
// multiplies each expert's rows with `jax.lax.ragged_dot`
//   (deepspeed_tpu/moe/sharded_moe.py:230-236, grouped_moe_ffn), which XLA
//   lowers outside any pallas_call. It is the counterpart of the
//   reference's CUTLASS grouped GEMM (inference/v2/kernels/cutlass_ops/
//   moe_gemm/). A per-expert loop of torch.matmul needs the group sizes on
//   the host (one device-to-host sync a layer), and multiplying every
//   expert densely does E/k times the work; this kernel does neither.
//
// Layout: x [R, K] rows sorted by expert; w [E, K, N] (the flax [E, in,
// out] layout); offsets [E + 1] int32 on the device, offsets[0] = 0,
// offsets[E] = R, non-decreasing; y [R, N] in x's dtype. Every route sums
// in fp32 in one fixed K order and rounds once, so a call's bits repeat.
//
// Tiles: expert e owns ceil(n_e / BM) row tiles of BM rows (the last one
// ragged); the row tiles are laid out expert after expert, and their
// count is bounded from shapes alone (sum over experts of ceil(n_e / BM)
// <= (R + min(E, R) (BM - 1)) / BM, grouped_gemm.grouped_plan). A warp
// finds the expert of row tile t by a prefix sum of the experts' tile
// counts, 32 experts a step (find_expert), so no group size reaches the
// host. An expert with no rows owns no tile, so its weights are never
// read: at decode only the routed experts' weights move. The row-tile
// height BM (16, 32, 64 or 128) follows the rows an expert, so a decode
// tile is not mostly empty rows; the plan also picks the route.
//
// Bound on the H100: at decode (a few rows an expert) bytes, the routed
// experts' weights; at prefill (hundreds of rows an expert) operations
// (Mixtral-8x7B: 8192 rows over 8 experts, 4096 -> 14336, 0.97 ms at 989
// TFLOP/s) or bytes where the experts are many and narrow
// (Qwen1.5-MoE-A2.7B: 16384 rows over 57 routed of 60, 2048 -> 1408,
// 0.13 ms at 3.35 TB/s for the routed weights and the rows).
//
// Route "mma" (row tiles of 16 and 32: decode), grouped_mma_kernel: one
// block a (row tile, 128-column tile), mma.sync m16n8k16 with fp32
// accumulators (flash_tile.cuh), 4 warps, a 32-deep K step staged by
// cp.async through three shared-memory stages (rows padded by 8 elements
// so that ldmatrix rows fall on distinct banks); A fragments by ldmatrix,
// B fragments by transposing ldmatrix from the [K][N] weight tile. Rows
// past the expert's end and K past the end are zero-filled, never stored.
// At decode it runs at 74-86% of its bytes bound.
//
// Route "wgmma" (row tiles of 64 and 128: prefill), grouped_wgmma_kernel.
// The mma route lost 2-3x to a library grouped GEMM there, for three
// reasons, and this kernel answers each:
//   1. mma.sync feeds the tensor cores from warps; here two consumer
//      warpgroups (64 rows each; one at 64-row tiles) run m64nBNk16
//      wgmma with A (K-major) and B (MN-major) from 128-byte-swizzled
//      shared memory and fp32 accumulators in registers.
//   2. cp.async spent every thread's instructions on addresses and a
//      block-wide barrier every 32 elements of K; here one producer
//      thread keeps TMA loads of 64-deep K steps in a ring of stages
//      (4 at 256 columns, 6 at 128) on full / empty mbarriers, and no
//      barrier of the whole block runs in the main loop. setmaxnreg
//      gives the producer warpgroup's registers to the consumers.
//   3. The mma route's grid runs row tiles fastest, so its resident blocks
//      cover every expert's rows for a few column tiles at a time and x
//      (67 MB at both prefill shapes, more than the 50 MB L2) comes back
//      once per wave of column tiles. Here the grid is persistent (a
//      block an SM) and block b walks tiles b, b + grid, ... in the order
//      expert -> column tile -> row tile within the expert: the blocks in
//      flight share one expert's rows (Mixtral: ~1024 rows, 8 MB) and a
//      few column slabs of its weight, each fetched from device memory
//      about once. Device-memory bytes by this model (x, w, y; the mma
//      route at two resident blocks an SM, x refetched each wave):
//      Mixtral gate/up 3.2 GB before (x 30 times), 1.24 GB now;
//      Qwen1.5-MoE gate/up 0.85 GB before (x 7 times), 0.44 GB now.
// With 1-3 in place the route was bound by its loads from L2 into shared
// memory: before clusters, the loads alone took 1.43 ms of Mixtral
// gate/up's 1.53 (tools/grouped_variants.py, H100 80GB HBM3). So blocks
// run in clusters of two over neighbouring tiles of the walk; where the
// two are row tiles of one (expert, column tile), each loads half the
// weight boxes and multicasts them into both, and the pair reads that
// slab from L2 once (97% of Mixtral's prefill steps, 67% of Qwen's, in
// tests/test_torch_moe_grouped.py's emulation of the walk). Now (same
// tool) the loads alone take 1.25 ms there, the products and the stores
// alone 1.33, the whole 1.53: the two overlap only in part, and the
// stores, which do not overlap the products, cost 0.2 ms (0.04 of
// Qwen's 0.23). The column tile (256 or 128) is the one whose tiles move
// the fewest bytes a K step, ceil(N / bn) (bm + bn): 256 for Qwen's N =
// 1408 too (6 tiles, the last half past N; 0.232 ms against 0.248 at
// 128).
// A: a 2-D box of x [R, K] at (k0, r0), BM rows x 64: rows past the
// expert's end are the next expert's rows, loaded and never stored; rows
// past R and K past its end are zeros from TMA. B: 64-column boxes of a
// 3-D map over w [E, K, N] at (n0, k0, e), so a K step past K reads zeros
// and never the next expert's first rows; boxes wholly past N are not
// loaded (their columns are never stored). The producer walks the same
// tiles as the consumers and runs ahead across tiles, so one tile's
// epilogue (the accumulators rounded to x's dtype and stored, masked by
// row r < r1 and column c < N) overlaps the next tile's loads. No
// split-K, no atomics. The two tensor maps are encoded on the host each
// call (grid constants).
//
// Route "f32": a plain CUDA-core kernel (tiles of BM x 64, 256 threads)
// for the parity runs. K % 8 == 0 and N % 8 == 0 for the 16-bit routes
// (16-byte copies and TMA rows).
//
// Kernels launch on the caller's stream, do not synchronise and allocate
// nothing; the C entry point returns cudaGetLastError().

#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

constexpr int GBN = 128;           // output columns a block (16-bit kernel)
constexpr int GBK = 32;            // K depth a stage
constexpr int GSTAGES = 3;         // cp.async stages
constexpr int ALD = GBK + 8;       // A tile row (elements)
constexpr int BLD = GBN + 8;       // B tile row (elements)
constexpr int BLDT = GBK + 8;      // B tile row, transposed (elements)
constexpr unsigned FULL = 0xffffffffu;

// One warp finds the expert that owns row tile t of the tiles laid out
// expert after expert (ceil(n_e / BM) each): e, its first row lo, its rows
// n and its first tile's index, the same in every lane; e = -1 past the
// last tile.
struct Expert {
  int e, lo, n, first;
};
template <int BM>
__device__ __forceinline__ Expert find_expert(const int* off, int E, int t) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    int lo = 0, n = 0;
    if (e < E) {
      lo = off[e];
      n = off[e + 1] - lo;
    }
    const int tiles = n > 0 ? (n + BM - 1) / BM : 0;
    int inc = tiles;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += v;
    }
    const int first = base + inc - tiles;
    const unsigned hit =
        __ballot_sync(FULL, tiles > 0 && t >= first && t < first + tiles);
    if (hit) {
      const int src = __ffs(hit) - 1;
      return {e0 + src, __shfl_sync(FULL, lo, src),
              __shfl_sync(FULL, n, src), __shfl_sync(FULL, first, src)};
    }
    base += __shfl_sync(FULL, inc, 31);
  }
  return {-1, 0, 0, 0};
}

// Warp 0 finds this block's expert and rows: tile t. Writes (e, first
// row, end row) to `found`; e = -1 past the last tile.
template <int BM>
__device__ __forceinline__ void find_tile(const int* __restrict__ off, int E,
                                          int t, int* found) {
  const Expert x = find_expert<BM>(off, E, t);
  if ((threadIdx.x & 31) == 0) {
    found[0] = x.e;
    found[1] = x.lo + (t - x.first) * BM;
    found[2] = x.lo + x.n;
  }
}

// Stage K columns [k0, k0 + 32) of rows [r0, r0 + BM) of x (rows past
// r1 and columns past K are zeros) and rows [k0, k0 + 32) of columns
// [n0, n0 + 128) of w_e (past K or N zeros). TB: w_e is [N][K] (the data
// gradient's w_e^T, read in place), staged as its rows [n0, n0 + 128),
// columns [k0, k0 + 32).
template <int BM, int NTH, bool TB, typename T>
__device__ __forceinline__ void stage(T* As, T* Bs, const T* __restrict__ x,
                                      const T* __restrict__ we, int r0, int r1,
                                      int k0, int n0, int K, int N) {
  for (int i = threadIdx.x; i < BM * (GBK / 8); i += NTH) {
    const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
    const bool live = r0 + r < r1 && k0 + c < K;
    cp_async16(As + r * ALD + c,
               x + (live ? (long long)(r0 + r) * K + k0 + c : 0), live);
  }
  if (TB) {
    for (int i = threadIdx.x; i < GBN * (GBK / 8); i += NTH) {
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      const bool live = n0 + r < N && k0 + c < K;
      cp_async16(Bs + r * BLDT + c,
                 we + (live ? (long long)(n0 + r) * K + k0 + c : 0), live);
    }
    return;
  }
  for (int i = threadIdx.x; i < GBK * (GBN / 8); i += NTH) {
    const int r = i / (GBN / 8), c = (i % (GBN / 8)) * 8;
    const bool live = k0 + r < K && n0 + c < N;
    cp_async16(Bs + r * BLD + c,
               we + (live ? (long long)(k0 + r) * N + n0 + c : 0), live);
  }
}

// BM rows x 128 columns a block; WM x WN warps, each (BM / WM) rows x
// (128 / WN) columns: MT 16-row and NTL 8-column mma tiles. TB: w is
// [E, N, K] (the data gradient's w^T), its B fragments by plain
// ldmatrix from [n][k] rows.
template <typename T, int BM, int WM, int WN, bool TB = false>
__global__ void __launch_bounds__(32 * WM * WN)
    grouped_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const int* __restrict__ off, T* __restrict__ y, int E,
                       int K, int N) {
  constexpr int NTH = 32 * WM * WN;
  constexpr int MT = BM / WM / 16, NTL = GBN / WN / 8;
  static_assert(MT >= 1 && NTL % 2 == 0, "warp tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int BST = TB ? GBN * BLDT : GBK * BLD;   // B stage (elements)
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + GSTAGES * BM * ALD;
  __shared__ int found[3];

  if (threadIdx.x < 32) find_tile<BM>(off, E, blockIdx.x, found);
  __syncthreads();
  const int e = found[0];
  if (e < 0) return;
  const int r0 = found[1], r1 = found[2];
  const int n0 = blockIdx.y * GBN;
  const T* we = w + (long long)e * K * N;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int row_w = wm * (BM / WM), col_w = wn * (GBN / WN);

  float acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int steps = (K + GBK - 1) / GBK;
#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < steps)
      stage<BM, NTH, TB>(As + s * BM * ALD, Bs + s * BST, x, we, r0, r1,
                         s * GBK, n0, K, N);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();
    // the stage read GSTAGES - 1 steps ago is free: refill it
    const int nxt = s + GSTAGES - 1;
    if (nxt < steps) {
      const int b = nxt % GSTAGES;
      stage<BM, NTH, TB>(As + b * BM * ALD, Bs + b * BST, x, we, r0, r1,
                         nxt * GBK, n0, K, N);
    }
    cp_async_commit();
    const T* A = As + (s % GSTAGES) * BM * ALD;
    const T* B = Bs + (s % GSTAGES) * BST;
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], A + (row_w + i * 16 + (lane & 15)) * ALD + kk * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NTL; j += 2) {
        uint32_t b[4];
        if (TB)   // matrix l / 8: columns + 8 (l / 16), K + 8 (l / 8 & 1)
          ldsm_x4(b, B + (col_w + j * 8 + (lane & 7) + (lane >> 4) * 8) *
                             BLDT +
                         kk * 16 + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_t(b, B + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               BLD +
                           col_w + j * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_16816<T>(acc[i][j], a[i], b[0], b[1]);
          mma_16816<T>(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int quad = lane >> 2, qi = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + row_w + i * 16 + quad + h * 8;
      if (r >= r1) continue;
      T* yr = y + (long long)r * N;
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const int c = n0 + col_w + j * 8 + qi * 2;
        if (c < N)
          *reinterpret_cast<uint32_t*>(yr + c) =
              pack2<T>(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ wgmma

constexpr int WK = 64;             // K depth a stage (128 bytes of 16-bit)
constexpr int W_OFFS = 1024;       // offsets staged in shared memory up to
constexpr int W_RING = 200 * 1024; // ring bytes at most

// stage bytes: A (BM rows x 64) and B (64 K rows x BN columns, BN / 64
// boxes of 64 x 64), each 128-byte swizzled
template <int BN, int NC>
__host__ __device__ constexpr int w_stage_bytes() {
  return (64 * NC + BN) * WK * 2;
}
template <int BN, int NC>
__host__ __device__ constexpr int w_stages() {
  return W_RING / w_stage_bytes<BN, NC>() < 8 ? W_RING / w_stage_bytes<BN, NC>()
                                              : 8;
}
template <int BN, int NC>
__host__ __device__ constexpr size_t w_smem_bytes() {
  return (size_t)w_stages<BN, NC>() * w_stage_bytes<BN, NC>() +
         2 * w_stages<BN, NC>() * sizeof(uint64_t) + W_OFFS * sizeof(int);
}

// This tile's place: expert e (-1 past the last tile), rows [r0, r1) to
// store (r0 + BM may pass r1), columns from n0. Tile L of the walk is
// column tile ct, row tile rt of expert e, where the experts' tiles come
// one expert after another and, within one, column tile by column tile.
struct WTile {
  int e, r0, r1, n0;
};
template <int BM, int BN>
__device__ __forceinline__ WTile w_tile(const int* off, int E, int L,
                                        int NT) {
  const Expert x = find_expert<BM>(off, E, L / NT);
  if (x.e < 0) return {-1, 0, 0, 0};
  const int tiles = (x.n + BM - 1) / BM, local = L - x.first * NT;
  return {x.e, x.lo + (local % tiles) * BM, x.lo + x.n, (local / tiles) * BN};
}

// A block of a producer warpgroup and NC consumer warpgroups (64 rows of
// the BM = 64 NC row tile each), persistent, in clusters of two. The pair
// walks pairs of consecutive tiles L, L + 1 (L = its rank-0 block's index
// + i gridDim.x) while L is real; rank r takes tile L + r, and a rank with
// no tile (past the last) steps through the pair's stages idle. When both
// tiles are row tiles of one (expert, column tile) they need the same
// weight boxes: each rank loads half of them and multicasts them into
// both blocks, so the pair reads its weight slab from L2 once. Otherwise
// each block loads its own. K steps are counted over the whole walk (g),
// which picks each one's ring stage and phase, so the ring never drains
// between tiles. full[s]: the bytes of stage s (its own x box, its weight
// boxes from either rank) landed; empty[s]: the consumers of both blocks
// are done with stage s, which a multicast into either may then refill.
template <typename T, int BN, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    grouped_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w,
                         const int* __restrict__ off, T* __restrict__ y,
                         int E, int K, int N, int slots) {
  constexpr int BM = 64 * NC, ST = w_stages<BN, NC>();
  constexpr int SB = w_stage_bytes<BN, NC>(), AB = BM * WK * 2;
  constexpr int BB = 64 * WK * 2;  // one 64-column weight box
  extern __shared__ __align__(1024) unsigned char w_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(w_smem + ST * SB);
  uint64_t* empty = full + ST;
  int* s_off = reinterpret_cast<int*>(empty + ST);
  const int NT = (N + BN - 1) / BN, nk = (K + WK - 1) / WK;
  const int rank = (int)cluster_rank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s);
      mbar_init(empty + s, 2 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const bool staged = E < W_OFFS;
  if (staged)
    for (int i = threadIdx.x; i <= E; i += blockDim.x) s_off[i] = off[i];
  // both blocks' barriers initialised before either signals the other's
  cluster_arrive();
  cluster_wait();
  const int* offs = staged ? s_off : off;
  // the warpgroup, uniform across each warp as the compiler can see (a
  // branch on it that it cannot prove uniform serializes every wgmma)
  const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;

  if (wg == 0) {
    // 384 threads start at 168 registers each; the producer hands its
    // warpgroup's share to the consumers (at 256 threads every warp has
    // enough as it is)
    if constexpr (NC > 1) set_max_regs<40, false>();
    // warp 0 walks the tiles; its lane 0 keeps the ring full
    if (threadIdx.x < 32) {
      int g = 0;
      for (int L = blockIdx.x - rank; L < slots; L += gridDim.x) {
        const WTile t0 = w_tile<BM, BN>(offs, E, L, NT);
        if (t0.e < 0) break;
        const WTile t1 = w_tile<BM, BN>(offs, E, L + 1, NT);
        const WTile t = rank ? t1 : t0;
        const bool pair = t1.e == t0.e && t1.n0 == t0.n0;
        int boxes = 0;
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) boxes += t.n0 + 64 * j < N;
        if (lane == 0)
          for (int k = 0; k < nk; ++k, ++g) {
            const int s = g % ST;
            unsigned char* st = w_smem + s * SB;
            mbar_wait(empty + s, ((g / ST) & 1) ^ 1);
            if (t.e < 0) {             // idle: the stage's phase, no bytes
              mbar_arrive(full + s);
              continue;
            }
            mbar_expect(full + s, AB + boxes * BB);
            tma_box(st, &tm_x, k * WK, t.r0, full + s);
            // loops the compiler keeps: unrolled, with each box under its
            // own branch, the boxes all took column 0 (256-column tiles)
            // or faulted (128; H100, CUDA 12.8)
            if (pair) {
#pragma unroll 1
              for (int j = rank; j < boxes; j += 2)
                tma_box3_mc(st + AB + j * BB, &tm_w, t.n0 + 64 * j, k * WK,
                            t.e, full + s, 3);
            } else {
#pragma unroll 1
              for (int j = 0; j < boxes; ++j)
                tma_box3(st + AB + j * BB, &tm_w, t.n0 + 64 * j, k * WK,
                         t.e, full + s);
            }
          }
        __syncwarp();
      }
    }
  } else {
    if constexpr (NC > 1) set_max_regs<232, true>();
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4;
    const int quad = lane / 4, qi = lane % 4;
    // stage s is free in this block: counted in both blocks' empty[s],
    // by lane 0 of the warpgroup's first warp here and of its second
    // there
    const int signal = threadIdx.x % 128;
    const uint32_t peer_empty = peer_addr(empty, rank ^ 1);
    auto release = [&](int s) {
      if (signal == 0) mbar_arrive(empty + s);
      if (signal == 32) mbar_arrive_remote(peer_empty + 8 * s);
    };
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int g = 0;
    for (int L = blockIdx.x - rank; L < slots; L += gridDim.x) {
      const WTile t0 = w_tile<BM, BN>(offs, E, L, NT);
      if (t0.e < 0) break;
      const WTile t = rank ? w_tile<BM, BN>(offs, E, L + 1, NT) : t0;
      if (t.e < 0) {
        for (int k = 0; k < nk; ++k, ++g) {
          mbar_wait(full + g % ST, (g / ST) & 1);
          release(g % ST);
        }
        continue;
      }
      for (int k = 0; k < nk; ++k, ++g) {
        const int s = g % ST;
        const unsigned char* a = w_smem + s * SB + cw * 64 * WK * 2;
        const unsigned char* b = w_smem + s * SB + AB;
        mbar_wait(full + s, (g / ST) & 1);
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk)
          wgmma_ss<1, T>(acc, wg_desc(a + kk * 32, 16, 1024),
                         wg_desc(b + kk * 2048, BB, 1024), k > 0 || kk > 0,
                         std::integral_constant<int, BN>());
        wg_commit();
        // the step before this one is done: its stage may be refilled
        wg_wait<1>();
        fence_regs(acc);
        if (k > 0) release((g - 1) % ST);
      }
      wg_wait<0>();
      fence_regs(acc);
      release((g - 1) % ST);
      // accumulator (n, x): row 16 warp + lane / 4 (+8 for x >= 2),
      // column 8 n + 2 (lane % 4) + (x & 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = t.r0 + cw * 64 + warp * 16 + quad + 8 * h;
        if (r >= t.r1) continue;
        T* yr = y + (long long)r * N;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          const int c = t.n0 + n * 8 + qi * 2;
          if (c < N)
            *reinterpret_cast<uint32_t*>(yr + c) =
                pack2<T>(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
        }
      }
    }
  }
  // neither block leaves while the other may still arrive on its barriers
  cluster_arrive();
  cluster_wait();
}

// fp32 on the CUDA cores: BM rows x 64 columns a block of 256 threads
// (16 x 16), each thread BM / 16 rows (strided by 16) x 4 columns; K in
// steps of 16 through shared memory.
template <int BM, bool TB = false>
__global__ void __launch_bounds__(256)
    grouped_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const int* __restrict__ off, float* __restrict__ y,
                       int E, int K, int N) {
  constexpr int FK = 16, FN = 64, RPT = BM / 16;
  __shared__ float As[FK][BM];
  __shared__ float Bs[FK][FN];
  __shared__ int found[3];
  if (threadIdx.x < 32) find_tile<BM>(off, E, blockIdx.x, found);
  __syncthreads();
  const int e = found[0];
  if (e < 0) return;
  const int r0 = found[1], r1 = found[2];
  const int n0 = blockIdx.y * FN;
  const float* we = w + (long long)e * K * N;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int i = threadIdx.x; i < BM * FK; i += 256) {
      const int r = i / FK, c = i % FK;
      As[c][r] = (r0 + r < r1 && k0 + c < K)
                     ? x[(long long)(r0 + r) * K + k0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < FK * FN; i += 256) {
      const int r = i / FN, c = i % FN;
      Bs[r][c] = (k0 + r < K && n0 + c < N)
                     ? (TB ? we[(long long)(n0 + c) * K + k0 + r]
                           : we[(long long)(k0 + r) * N + n0 + c])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= r1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < N) y[(long long)r * N + c] = acc[i][j];
    }
  }
}

template <typename T, int BM, int WM, int WN, bool TB = false>
cudaError_t launch_mma(const void* x, const void* w, const int* off, void* y,
                       int E, int K, int N, int tiles, cudaStream_t st) {
  auto kern = grouped_mma_kernel<T, BM, WM, WN, TB>;
  const size_t smem =
      (size_t)GSTAGES * (BM * ALD + (TB ? GBN * BLDT : GBK * BLD)) *
      sizeof(T);
  cudaError_t err = smem_opt_in(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, (N + GBN - 1) / GBN);
  kern<<<grid, 32 * WM * WN, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), off,
      static_cast<T*>(y), E, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mma(int bm, const void* x, const void* w, const int* off,
                         void* y, int E, int K, int N, int tiles,
                         cudaStream_t st) {
  switch (bm) {
    case 16: return launch_mma<T, 16, 1, 4>(x, w, off, y, E, K, N, tiles, st);
    case 32: return launch_mma<T, 32, 2, 2>(x, w, off, y, E, K, N, tiles, st);
  }
  return cudaErrorInvalidValue;
}

template <int BM, bool TB = false>
cudaError_t launch_f32(const void* x, const void* w, const int* off, void* y,
                       int E, int K, int N, int tiles, cudaStream_t st) {
  dim3 grid(tiles, (N + 63) / 64);
  grouped_f32_kernel<BM, TB><<<grid, 256, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), off,
      static_cast<float*>(y), E, K, N);
  return cudaGetLastError();
}

// the data gradient: w [E, N, K] read in place as w^T (mma.sync at row
// tiles of 16, 32 or 64 in 16-bit; the CUDA-core kernel in fp32)
template <typename T>
cudaError_t dispatch_dgrad(int bm, const void* x, const void* w,
                           const int* off, void* y, int E, int K, int N,
                           int tiles, cudaStream_t st) {
  switch (bm) {
    case 16:
      return launch_mma<T, 16, 1, 4, true>(x, w, off, y, E, K, N, tiles, st);
    case 32:
      return launch_mma<T, 32, 2, 2, true>(x, w, off, y, E, K, N, tiles, st);
    case 64:
      return launch_mma<T, 64, 2, 2, true>(x, w, off, y, E, K, N, tiles, st);
  }
  return cudaErrorInvalidValue;
}

// x [R, K] in boxes of BM rows x 64, w [E, K, N] in boxes of 64 x 64 x
// 1, both 128-byte swizzled
template <typename T>
cudaError_t w_maps(CUtensorMap* tm_x, CUtensorMap* tm_w, const void* x,
                   const void* w, int R, int E, int K, int N, int bm) {
  const CUtensorMapDataType dt = std::is_same<T, f16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)R};
  const cuuint64_t xs[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {WK, (cuuint32_t)bm};
  cudaError_t err = encode_tensor_map(tm_x, dt, 2, x, xd, xs, xb,
                                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const cuuint64_t wd[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t ws[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t wb[3] = {64, WK, 1};
  return encode_tensor_map(tm_w, dt, 3, w, wd, ws, wb,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// in clusters of two: an even grid of at most twice the clusters the
// device holds at once
template <typename T, int BN, int NC>
cudaError_t launch_wgmma(const void* x, const void* w, const int* off,
                         void* y, int R, int E, int K, int N, int slots,
                         int grid, cudaStream_t st) {
  CUtensorMap tm_x, tm_w;
  cudaError_t err = w_maps<T>(&tm_x, &tm_w, x, w, R, E, K, N, 64 * NC);
  if (err != cudaSuccess) return err;
  auto kern = grouped_wgmma_kernel<T, BN, NC>;
  constexpr size_t smem = w_smem_bytes<BN, NC>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(128 * (NC + 1));
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = resident_count(reinterpret_cast<const void*>(kern), 128 * (NC + 1),
                       smem, &cfg, 2, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  grid = min(grid + (grid & 1), 2 * clusters);
  return cluster_launch(kern, dim3(grid), dim3(128 * (NC + 1)), smem, 2, st,
                        tm_x, tm_w, off, static_cast<T*>(y), E, K, N, slots);
}

template <typename T>
cudaError_t dispatch_wgmma(int bm, int bn, const void* x, const void* w,
                           const int* off, void* y, int R, int E, int K,
                           int N, int slots, int grid, cudaStream_t st) {
  if (bm == 128 && bn == 256)
    return launch_wgmma<T, 256, 2>(x, w, off, y, R, E, K, N, slots, grid, st);
  if (bm == 128 && bn == 128)
    return launch_wgmma<T, 128, 2>(x, w, off, y, R, E, K, N, slots, grid, st);
  if (bm == 64 && bn == 256)
    return launch_wgmma<T, 256, 1>(x, w, off, y, R, E, K, N, slots, grid, st);
  if (bm == 64 && bn == 128)
    return launch_wgmma<T, 128, 1>(x, w, off, y, R, E, K, N, slots, grid, st);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------- backward
//
// grouped_wgrad (the weight gradient of ragged_dot, B18): dw[e] = x_e^T @
// dy_e for every expert e, x [R, K] and dy [R, N] sorted by expert, dw [E,
// K, N] in x's dtype. JAX differentiates `jax.lax.ragged_dot` itself, so
// no Pallas kernel stands behind it. One block an output tile (expert,
// 64 rows of K, 128 columns of N): the block reads its expert's offsets
// on the device and walks that expert's rows 32 at a time, staging the
// 32 x 64 slab of x and the 32 x 128 slab of dy by cp.async through three
// shared-memory stages. Eight warps (2 along K x 4 along N) each hold a
// 32 x 32 piece in fp32 accumulators on mma.sync m16n8k16: the A
// fragments (x^T) come from the x slab by transposing ldmatrix, the B
// fragments (dy) from the dy slab by transposing ldmatrix as in the
// forward. Rows past the expert's end are zero-filled, so an expert with
// no rows writes zeros and a ragged tail adds nothing. The sum runs over
// the rows in one fixed order and rounds once: a call's bits repeat.
// fp32 takes grouped_wgrad_f32_kernel, a plain CUDA-core tile of 64 x 64.
// The data gradient (dx = dy @ w_e^T, grouped_dgrad_launch) is
// grouped_mma_kernel<..., TB = true> at row tiles of 16, 32 or 64: it
// stages w_e's rows (the output columns here, K contiguous) as they lie
// and takes its B fragments by plain ldmatrix, so w is never copied
// transposed; fp32 takes grouped_f32_kernel<BM, true>.

constexpr int WGK = 64;            // rows of dw (K) a block
constexpr int WGN = 128;           // columns of dw (N) a block
constexpr int WGR = 32;            // rows of x / dy a stage
constexpr int WG_ALD = WGK + 8;    // x slab row (elements)
constexpr int WG_BLD = WGN + 8;    // dy slab row (elements)

template <typename T>
__device__ __forceinline__ void wgrad_stage(T* As, T* Bs,
                                            const T* __restrict__ x,
                                            const T* __restrict__ dy, int r0,
                                            int r1, int k0, int n0, int K,
                                            int N) {
  for (int i = threadIdx.x; i < WGR * (WGK / 8); i += 256) {
    const int r = i / (WGK / 8), c = (i % (WGK / 8)) * 8;
    const bool live = r0 + r < r1 && k0 + c < K;
    cp_async16(As + r * WG_ALD + c,
               x + (live ? (long long)(r0 + r) * K + k0 + c : 0), live);
  }
  for (int i = threadIdx.x; i < WGR * (WGN / 8); i += 256) {
    const int r = i / (WGN / 8), c = (i % (WGN / 8)) * 8;
    const bool live = r0 + r < r1 && n0 + c < N;
    cp_async16(Bs + r * WG_BLD + c,
               dy + (live ? (long long)(r0 + r) * N + n0 + c : 0), live);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    grouped_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const int* __restrict__ off, T* __restrict__ dw,
                         int K, int N) {
  __shared__ __align__(16) T As[GSTAGES][WGR * WG_ALD];
  __shared__ __align__(16) T Bs[GSTAGES][WGR * WG_BLD];
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * WGK, n0 = blockIdx.x * WGN;
  const int r0 = off[e], r1 = off[e + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_w = (warp >> 2) * 32, col_w = (warp & 3) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int steps = r1 > r0 ? (r1 - r0 + WGR - 1) / WGR : 0;
#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < steps)
      wgrad_stage<T>(As[s], Bs[s], x, dy, r0 + s * WGR, r1, k0, n0, K, N);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();
    const int nxt = s + GSTAGES - 1;
    if (nxt < steps) {
      const int b = nxt % GSTAGES;
      wgrad_stage<T>(As[b], Bs[b], x, dy, r0 + nxt * WGR, r1, k0, n0, K, N);
    }
    cp_async_commit();
    const T* A = As[s % GSTAGES];
    const T* B = Bs[s % GSTAGES];
#pragma unroll
    for (int kk = 0; kk < WGR / 16; ++kk) {
      // A = x^T: matrix l / 8 of lane l is (K rows + 8 (l / 8 & 1), x
      // rows + 8 (l / 16)); the x slab's rows are the reduction index
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_t(a[i], A + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                WG_ALD +
                            row_w + i * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, B + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             WG_BLD +
                         col_w + j * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_16816<T>(acc[i][j], a[i], b[0], b[1]);
          mma_16816<T>(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  T* dwe = dw + (long long)e * K * N;
  const int quad = lane >> 2, qi = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = k0 + row_w + i * 16 + quad + h * 8;
      if (kr >= K) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + col_w + j * 8 + qi * 2;
        if (c < N)
          *reinterpret_cast<uint32_t*>(dwe + (long long)kr * N + c) =
              pack2<T>(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// fp32: a 64 x 64 tile of dw[e] a block of 256 threads (16 x 16), 4 x 4
// a thread; the expert's rows 16 at a time through shared memory
__global__ void __launch_bounds__(256)
    grouped_wgrad_f32_kernel(const float* __restrict__ x,
                             const float* __restrict__ dy,
                             const int* __restrict__ off,
                             float* __restrict__ dw, int K, int N) {
  constexpr int FR = 16, FT = 64;
  __shared__ float As[FR][FT];
  __shared__ float Bs[FR][FT];
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * FT, n0 = blockIdx.x * FT;
  const int r0 = off[e], r1 = off[e + 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int rs = r0; rs < r1; rs += FR) {
    for (int i = threadIdx.x; i < FR * FT; i += 256) {
      const int r = i / FT, c = i % FT;
      const bool row = rs + r < r1;
      As[r][c] = row && k0 + c < K ? x[(long long)(rs + r) * K + k0 + c]
                                   : 0.f;
      Bs[r][c] = row && n0 + c < N ? dy[(long long)(rs + r) * N + n0 + c]
                                   : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < FR; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dwe = dw + (long long)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < N) dwe[(long long)kr * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// dtype code: 0 fp32, 1 bf16, 2 fp16. The plan (grouped_plan): bm, the
// row-tile height (16, 32, 64 or 128); tiles, the row-tile slots; route
// (0 mma, 1 wgmma: 16-bit at bm 64 and 128, 2 f32); bn, the wgmma
// route's column tile (128 or 256); grid, the wgmma route's persistent
// blocks (at most tiles x ceil(N / bn), rounded up to even).
extern "C" int grouped_gemm_launch(const void* x, const void* w,
                                   const void* offsets, void* y, int R, int E,
                                   int K, int N, int bm, int tiles, int route,
                                   int bn, int grid, int dtype, void* stream) {
  if (tiles <= 0 || E <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  cudaError_t err = cudaErrorInvalidValue;
  if (route == 1) {
    const long long slots = (long long)tiles * ((N + bn - 1) / bn);
    if (dtype == 0 || grid < 1 || slots > 0x7fffffff ||
        grid > slots + (slots & 1))
      return (int)cudaErrorInvalidValue;
    if (dtype == 1)
      err = dispatch_wgmma<bf16>(bm, bn, x, w, off, y, R, E, K, N,
                                 (int)slots, grid, st);
    else if (dtype == 2)
      err = dispatch_wgmma<f16>(bm, bn, x, w, off, y, R, E, K, N,
                                (int)slots, grid, st);
  } else if (route == 0 && dtype == 1) {
    err = dispatch_mma<bf16>(bm, x, w, off, y, E, K, N, tiles, st);
  } else if (route == 0 && dtype == 2) {
    err = dispatch_mma<f16>(bm, x, w, off, y, E, K, N, tiles, st);
  } else if (route == 2 && dtype == 0) {
    switch (bm) {
      case 16: err = launch_f32<16>(x, w, off, y, E, K, N, tiles, st); break;
      case 32: err = launch_f32<32>(x, w, off, y, E, K, N, tiles, st); break;
      case 64: err = launch_f32<64>(x, w, off, y, E, K, N, tiles, st); break;
      case 128: err = launch_f32<128>(x, w, off, y, E, K, N, tiles, st); break;
    }
  }
  return (int)err;
}

// dw [E, K, N] = per-expert x_e^T @ dy_e; x [R, K], dy [R, N] sorted by
// expert, offsets [E + 1] int32 on the device; dtype code as above.
extern "C" int grouped_wgrad_launch(const void* x, const void* dy,
                                    const void* offsets, void* dw, int R,
                                    int E, int K, int N, int dtype,
                                    void* stream) {
  if (E <= 0 || E > 65535 || K <= 0 || N <= 0 || R < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (dtype == 0) {
    dim3 grid((N + 63) / 64, (K + 63) / 64, E);
    grouped_wgrad_f32_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), off,
        static_cast<float*>(dw), K, N);
  } else if (dtype == 1 || dtype == 2) {
    if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
    dim3 grid((N + WGN - 1) / WGN, (K + WGK - 1) / WGK, E);
    if (dtype == 1)
      grouped_wgrad_kernel<bf16><<<grid, 256, 0, st>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(dy), off,
          static_cast<bf16*>(dw), K, N);
    else
      grouped_wgrad_kernel<f16><<<grid, 256, 0, st>>>(
          static_cast<const f16*>(x), static_cast<const f16*>(dy), off,
          static_cast<f16*>(dw), K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dx [R, N] = per-expert dy_e @ w_e^T: dy [R, K] sorted by expert, w
// [E, N, K] (the forward's weight, whose rows are the output columns
// here), offsets as the forward's; bm the row tile (16, 32 or 64;
// grouped_gemm.dgrad_plan), tiles its row-tile slots.
extern "C" int grouped_dgrad_launch(const void* dy, const void* w,
                                    const void* offsets, void* dx, int R,
                                    int E, int K, int N, int bm, int tiles,
                                    int dtype, void* stream) {
  if (tiles <= 0 || E <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1)
    err = dispatch_dgrad<bf16>(bm, dy, w, off, dx, E, K, N, tiles, st);
  else if (dtype == 2)
    err = dispatch_dgrad<f16>(bm, dy, w, off, dx, E, K, N, tiles, st);
  else if (dtype == 0) {
    switch (bm) {
      case 16: err = launch_f32<16, true>(dy, w, off, dx, E, K, N, tiles, st);
        break;
      case 32: err = launch_f32<32, true>(dy, w, off, dx, E, K, N, tiles, st);
        break;
      case 64: err = launch_f32<64, true>(dy, w, off, dx, E, K, N, tiles, st);
        break;
    }
  }
  return (int)err;
}
