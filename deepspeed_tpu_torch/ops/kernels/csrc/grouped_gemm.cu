// Grouped expert GEMM for Hopper (sm_90a): y[o_e:o_{e+1}] = x[o_e:o_{e+1}]
// @ w[e] for every expert e, with the row offsets o read on the device,
// and its two gradients (the backward section below): dx by the same
// kernels over w read in place as its transpose, dw by a kernel of its
// own.
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
// The data gradient takes the route and plan the forward would take for
// its shapes, with w's rows as the output columns: on "wgmma" the weight
// boxes come from a 3-D map over w [E, N, K] (the reduction contiguous),
// which is wgmma's native K-major B (KB), where the forward's are
// MN-major; on "mma" the B fragments come by plain ldmatrix from w's
// rows (TB).
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
// the BM = 64 NC row tile each), persistent, in clusters of two. KB: w
// is [E, N, K] (the data gradient's w^T read in place: the reduction is
// its contiguous axis), so a weight box is 64 output columns x 64 of K,
// K-major, which is wgmma's native B; otherwise w is [E, K, N] and a box
// 64 of K x 64 columns, MN-major (the forward). The pair
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
template <typename T, int BN, int NC, bool KB>
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
                tma_box3_mc(st + AB + j * BB, &tm_w,
                            KB ? k * WK : t.n0 + 64 * j,
                            KB ? t.n0 + 64 * j : k * WK, t.e, full + s, 3);
            } else {
#pragma unroll 1
              for (int j = 0; j < boxes; ++j)
                tma_box3(st + AB + j * BB, &tm_w,
                         KB ? k * WK : t.n0 + 64 * j,
                         KB ? t.n0 + 64 * j : k * WK, t.e, full + s);
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
        // B: K-major (KB), a k16 step 32 bytes into each 128-byte row as
        // for A; else MN-major, a k16 step 16 rows of every box
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk)
          wgmma_ss<KB ? 0 : 1, T>(
              acc, wg_desc(a + kk * 32, 16, 1024),
              KB ? wg_desc(b + kk * 32, 16, 1024)
                 : wg_desc(b + kk * 2048, BB, 1024),
              k > 0 || kk > 0, std::integral_constant<int, BN>());
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

// ------------------------------------------------------------- backward
//
// The gradients of ragged_dot (B18; JAX differentiates jax.lax.ragged_dot
// itself, so no Pallas kernel stands behind them). The data gradient dx =
// dy @ w_e^T is the forward's kernels over w read in place as its
// transpose (grouped_dgrad_launch): grouped_wgmma_kernel<..., KB = true>
// at row tiles of 64 and 128, grouped_mma_kernel<..., TB = true> at 16
// and 32, grouped_f32_kernel<BM, true> in fp32, planned by grouped_plan
// as the forward is.
//
// The weight gradient dw[e] = x_e^T @ dy_e (x [R, K] and dy [R, N] sorted
// by expert, dw [E, K, N] in x's dtype) is grouped_wgrad_wgmma_kernel in
// 16-bit. Its bound is bytes: the written dw is most of what it moves
// (346 of 403 MB at Qwen1.5-MoE-A2.7B's 8192 rows over 60 experts, 2048
// -> 1408; 0.12 ms at 3.35 TB/s), with operations near it where the
// experts are few and wide (Mixtral-8x7B: 481 GFLOP, 0.49 ms). The
// design:
//   1. Tiles of 128 rows of K x BN (256 or 128, the forward's bytes rule
//      over ceil(N / bn) (128 + bn)) columns of N, walked by persistent
//      blocks (one an SM) expert by expert, K tile by K tile, column
//      tile fastest (wg_tile): the blocks in flight share one expert's x
//      and dy slabs in L2, and neighbouring blocks store side by side in
//      the same rows of dw. The walk's tile counts come from the plan
//      (grouped_gemm.wgrad_plan), which the launch checks against WG_KT.
//   2. A producer thread keeps a ring of TMA stages: a step is 64 of the
//      expert's rows, two 64 x 64 boxes of x (2-D map over x [R, K]) and
//      BN / 64 boxes of dy (over dy [R, N]), 128-byte swizzled; boxes of
//      dy wholly past N (and of x past K) are not loaded.
//   3. Two consumer warpgroups (64 rows of K each) run m64nBNk16 wgmma
//      with A = x_e^T MN-major (K, dw's row, is x's contiguous axis) and
//      B = dy_e MN-major, fp32 accumulators in registers.
//   4. The ragged tail: the last step of an expert reads rows past its end
//      (the next expert's rows, or TMA's zeros past R), which would be
//      summed into dw. The consumers zero those rows in both operands
//      (a row is 128 bytes whichever way its 16-byte chunks are swizzled)
//      and fence them to the async proxy before the step's wgmma; the
//      two warpgroups meet at a named barrier there, each having zeroed
//      its x box and half the dy boxes.
//   5. The epilogue: each consumer rounds its 64 x BN accumulators into a
//      128-byte-swizzled shared tile and one thread stores it by TMA (a
//      3-D map over dw [E, K, N], which clips rows past K and columns
//      past N); the store drains while the next tile's loads and products
//      run, and the tile is rewritten only once that store has read it.
// An expert with no rows takes no step and stores zeros. The rows are
// summed in one fixed order in fp32 and rounded once: a call's bits
// repeat. fp32 takes grouped_wgrad_f32_kernel, a plain CUDA-core tile.

constexpr int WG_KT = 128;          // rows of dw (K) a tile
constexpr int WG_BOX = 64 * 64 * 2; // one 64 x 64 box of 16-bit elements
constexpr int WG_RING = 160 * 1024; // ring bytes at most

// stage bytes: two x boxes and BN / 64 dy boxes
template <int BN>
__host__ __device__ constexpr int wg_stage_bytes() {
  return (2 + BN / 64) * WG_BOX;
}
template <int BN>
__host__ __device__ constexpr int wg_stages() {
  return WG_RING / wg_stage_bytes<BN>();
}
// the ring, the two consumers' output tiles, the barriers, the offsets
template <int BN>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return (size_t)wg_stages<BN>() * wg_stage_bytes<BN>() + WG_KT * BN * 2 +
         2 * wg_stages<BN>() * sizeof(uint64_t) + W_OFFS * sizeof(int);
}

// Tile L of the walk: expert e = L / (k tiles x column tiles), then K
// tile and column tile (fastest: neighbouring blocks store side by side in
// the same rows of dw). steps: the expert's 64-row steps; boxes: dy boxes
// short of N.
struct WgTile {
  int e, k0, n0, boxes, r0, r1, steps;
};
template <int BN>
__device__ __forceinline__ WgTile wg_tile(const int* offs, int L, int KT,
                                          int NT, int N) {
  const int per = KT * NT, rem = L % per, e = L / per;
  const int kt = rem / NT, nt = rem % NT;
  const int n0 = nt * BN, r0 = offs[e], r1 = offs[e + 1];
  int boxes = 0;
#pragma unroll
  for (int j = 0; j < BN / 64; ++j) boxes += n0 + 64 * j < N;
  return {e, kt * WG_KT, n0, boxes, r0, r1, (r1 - r0 + 63) / 64};
}

// A block of a producer warpgroup and two consumer warpgroups, persistent:
// block b takes tiles b, b + grid, ... of the KT x NT tiles of each of the
// E experts. The K steps are counted over the whole walk (g), which picks
// each one's ring stage and phase, so the ring runs on across tiles.
// full[s]: stage s's boxes landed; empty[s]: both consumers are done with
// stage s.
template <typename T, int BN>
__global__ void __launch_bounds__(384, 1)
    grouped_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                               const __grid_constant__ CUtensorMap tm_dy,
                               const __grid_constant__ CUtensorMap tm_dw,
                               const int* __restrict__ off, int E, int K,
                               int N, int KT, int NT) {
  constexpr int ST = wg_stages<BN>(), SB = wg_stage_bytes<BN>();
  constexpr int OB = 64 * BN * 2;   // one consumer's output tile
  extern __shared__ __align__(1024) unsigned char w_smem[];
  unsigned char* out = w_smem + ST * SB;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 2 * OB);
  uint64_t* empty = full + ST;
  int* s_off = reinterpret_cast<int*>(empty + ST);
  const int slots = E * KT * NT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s);
      mbar_init(empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const bool staged = E < W_OFFS;
  if (staged)
    for (int i = threadIdx.x; i <= E; i += blockDim.x) s_off[i] = off[i];
  __syncthreads();
  const int* offs = staged ? s_off : off;
  const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);

  if (wg == 0) {
    set_max_regs<40, false>();
    if (threadIdx.x == 0) {
      int g = 0;
      for (int L = blockIdx.x; L < slots; L += gridDim.x) {
        const WgTile t = wg_tile<BN>(offs, L, KT, NT, N);
        const int xboxes = t.k0 + 64 < K ? 2 : 1;
        for (int k = 0; k < t.steps; ++k, ++g) {
          const int s = g % ST, r = t.r0 + 64 * k;
          unsigned char* st = w_smem + s * SB;
          mbar_wait(empty + s, ((g / ST) & 1) ^ 1);
          mbar_expect(full + s, (xboxes + t.boxes) * WG_BOX);
#pragma unroll 1
          for (int j = 0; j < xboxes; ++j)
            tma_box(st + j * WG_BOX, &tm_x, t.k0 + 64 * j, r, full + s);
#pragma unroll 1
          for (int j = 0; j < t.boxes; ++j)
            tma_box(st + (2 + j) * WG_BOX, &tm_dy, t.n0 + 64 * j, r,
                    full + s);
        }
      }
    }
    __syncwarp();
  } else {
    set_max_regs<232, true>();
    const int cw = wg - 1, tid = threadIdx.x % 128, warp = tid / 32;
    const int lane = tid % 32, quad = lane / 4, qi = lane % 4;
    unsigned char* mine = out + cw * OB;
    float acc[BN / 2];
    int g = 0;
    for (int L = blockIdx.x; L < slots; L += gridDim.x) {
      const WgTile t = wg_tile<BN>(offs, L, KT, NT, N);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int k = 0;
      for (; k < t.steps; ++k, ++g) {
        const int s = g % ST, r = t.r0 + 64 * k;
        unsigned char* st = w_smem + s * SB;
        mbar_wait(full + s, (g / ST) & 1);
        if (r + 64 > t.r1) {
          // rows live .. 63 of this step lie past the expert: zero them in
          // this consumer's x box and in dy boxes cw, cw + 2, ...
          const int live = t.r1 - r, chunks = (64 - live) * 8;
          const int nb = 1 + (t.boxes - cw + 1) / 2;
          for (int i = tid; i < nb * chunks; i += 128) {
            const int b = i / chunks;
            const int box = b == 0 ? cw : 2 * b + cw;
            *reinterpret_cast<uint4*>(st + box * WG_BOX + live * 128 +
                                      (i % chunks) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          fence_async_smem();
          bar_sync<256>(1);
        }
        fence_regs(acc);
        wg_fence();
        // A = x^T: its box's rows are the reduction (64 K columns a row),
        // B = dy: the same; a k16 step is 16 rows (2048 bytes) of each
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, T, 1>(acc,
                            wg_desc(st + cw * WG_BOX + kk * 2048, WG_BOX,
                                    1024),
                            wg_desc(st + 2 * WG_BOX + kk * 2048, WG_BOX,
                                    1024),
                            k > 0 || kk > 0,
                            std::integral_constant<int, BN>());
        wg_commit();
        // the step before this one is done: its stage may be refilled
        wg_wait<1>();
        fence_regs(acc);
        if (k > 0 && tid == 0) mbar_arrive(empty + (g - 1) % ST);
      }
      if (k > 0) {
        wg_wait<0>();
        fence_regs(acc);
        if (tid == 0) mbar_arrive(empty + (g - 1) % ST);
      }
      // the previous tile's store has read this consumer's output tile
      if (tid == 0) bulk_wait<0, true>();
      bar_sync<128>(2 + cw);
      // accumulator (n, x): row 16 warp + lane / 4 (+8 for x >= 2),
      // column 8 n + 2 (lane % 4) + (x & 1); box n / 8 of the tile
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              mine + (n / 8) * WG_BOX +
              swizzled(16 * warp + quad + 8 * h, (8 * n) % 64 + 2 * qi)) =
              pack2<T>(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
      fence_async_smem();
      bar_sync<128>(2 + cw);
      if (tid == 0 && t.k0 + 64 * cw < K) {
#pragma unroll 1
        for (int j = 0; j < t.boxes; ++j)
          tma_store3(&tm_dw, mine + j * WG_BOX, t.n0 + 64 * j,
                     t.k0 + 64 * cw, t.e);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0, false>();
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

template <typename T, bool TB>
cudaError_t dispatch_mma(int bm, const void* x, const void* w, const int* off,
                         void* y, int E, int K, int N, int tiles,
                         cudaStream_t st) {
  switch (bm) {
    case 16:
      return launch_mma<T, 16, 1, 4, TB>(x, w, off, y, E, K, N, tiles, st);
    case 32:
      return launch_mma<T, 32, 2, 2, TB>(x, w, off, y, E, K, N, tiles, st);
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

template <typename T>
CUtensorMapDataType tma_type() {
  return std::is_same<T, f16>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// a 2-D map over a row-major [rows, cols] 16-bit matrix in boxes of
// `box_rows` rows x 64 columns, 128-byte swizzled
template <typename T>
cudaError_t rows_map(CUtensorMap* tm, const void* p, int rows, int cols,
                     int box_rows) {
  const cuuint64_t d[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t s[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t b[2] = {64, (cuuint32_t)box_rows};
  return encode_tensor_map(tm, tma_type<T>(), 2, p, d, s, b,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// a 3-D map over E row-major [rows, cols] 16-bit matrices in boxes of 64
// x 64 x 1, 128-byte swizzled: a box never reaches another matrix
template <typename T>
cudaError_t stack_map(CUtensorMap* tm, const void* p, int E, int rows,
                      int cols) {
  const cuuint64_t d[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                           (cuuint64_t)E};
  const cuuint64_t s[2] = {(cuuint64_t)cols * 2,
                           (cuuint64_t)rows * cols * 2};
  const cuuint32_t b[3] = {64, 64, 1};
  return encode_tensor_map(tm, tma_type<T>(), 3, p, d, s, b,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// in clusters of two: an even grid of at most twice the clusters the
// device holds at once. x [R, K] in boxes of 64 NC rows x 64; w [E, K, N]
// (KB: [E, N, K]) in boxes of 64 x 64 x 1.
template <typename T, int BN, int NC, bool KB>
cudaError_t launch_wgmma(const void* x, const void* w, const int* off,
                         void* y, int R, int E, int K, int N, int slots,
                         int grid, cudaStream_t st) {
  CUtensorMap tm_x, tm_w;
  cudaError_t err = rows_map<T>(&tm_x, x, R, K, 64 * NC);
  if (err != cudaSuccess) return err;
  err = KB ? stack_map<T>(&tm_w, w, E, N, K) : stack_map<T>(&tm_w, w, E, K, N);
  if (err != cudaSuccess) return err;
  auto kern = grouped_wgmma_kernel<T, BN, NC, KB>;
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

template <typename T, bool KB>
cudaError_t dispatch_wgmma(int bm, int bn, const void* x, const void* w,
                           const int* off, void* y, int R, int E, int K,
                           int N, int slots, int grid, cudaStream_t st) {
  if (bm == 128 && bn == 256)
    return launch_wgmma<T, 256, 2, KB>(x, w, off, y, R, E, K, N, slots, grid,
                                       st);
  if (bm == 128 && bn == 128)
    return launch_wgmma<T, 128, 2, KB>(x, w, off, y, R, E, K, N, slots, grid,
                                       st);
  if (bm == 64 && bn == 256)
    return launch_wgmma<T, 256, 1, KB>(x, w, off, y, R, E, K, N, slots, grid,
                                       st);
  if (bm == 64 && bn == 128)
    return launch_wgmma<T, 128, 1, KB>(x, w, off, y, R, E, K, N, slots, grid,
                                       st);
  return cudaErrorInvalidValue;
}

// the forward (TB false: w [E, K, N]) and the data gradient (TB true: w
// [E, N, K], read in place as w^T) on the route of the plan
template <bool TB>
int grouped_launch(const void* x, const void* w, const void* offsets,
                   void* y, int R, int E, int K, int N, int bm, int tiles,
                   int route, int bn, int grid, int dtype, void* stream) {
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
      err = dispatch_wgmma<bf16, TB>(bm, bn, x, w, off, y, R, E, K, N,
                                     (int)slots, grid, st);
    else if (dtype == 2)
      err = dispatch_wgmma<f16, TB>(bm, bn, x, w, off, y, R, E, K, N,
                                    (int)slots, grid, st);
  } else if (route == 0 && dtype == 1) {
    err = dispatch_mma<bf16, TB>(bm, x, w, off, y, E, K, N, tiles, st);
  } else if (route == 0 && dtype == 2) {
    err = dispatch_mma<f16, TB>(bm, x, w, off, y, E, K, N, tiles, st);
  } else if (route == 2 && dtype == 0) {
    switch (bm) {
      case 16: err = launch_f32<16, TB>(x, w, off, y, E, K, N, tiles, st);
        break;
      case 32: err = launch_f32<32, TB>(x, w, off, y, E, K, N, tiles, st);
        break;
      case 64: err = launch_f32<64, TB>(x, w, off, y, E, K, N, tiles, st);
        break;
      case 128: err = launch_f32<128, TB>(x, w, off, y, E, K, N, tiles, st);
        break;
    }
  }
  return (int)err;
}

template <typename T, int BN>
cudaError_t launch_wgrad(const void* x, const void* dy, const int* off,
                         void* dw, int R, int E, int K, int N, int kt, int nt,
                         int grid, cudaStream_t st) {
  CUtensorMap tm_x, tm_dy, tm_dw;
  cudaError_t err = rows_map<T>(&tm_x, x, R, K, 64);
  if (err == cudaSuccess) err = rows_map<T>(&tm_dy, dy, R, N, 64);
  if (err == cudaSuccess) err = stack_map<T>(&tm_dw, dw, E, K, N);
  if (err != cudaSuccess) return err;
  auto kern = grouped_wgrad_wgmma_kernel<T, BN>;
  constexpr size_t smem = wg_smem_bytes<BN>();
  int resident = 0;
  err = blocks_per_sm(reinterpret_cast<const void*>(kern), 384, smem,
                      &resident);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  kern<<<grid, 384, smem, st>>>(tm_x, tm_dy, tm_dw, off, E, K, N, kt, nt);
  return cudaGetLastError();
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
  return grouped_launch<false>(x, w, offsets, y, R, E, K, N, bm, tiles, route,
                               bn, grid, dtype, stream);
}

// dx [R, N] = per-expert dy_e @ w_e^T: dy [R, K] sorted by expert, w
// [E, N, K] (the forward's weight, whose rows are the output columns
// here), offsets as the forward's; the plan is grouped_plan's for R rows
// over E experts into N columns, as the forward's.
extern "C" int grouped_dgrad_launch(const void* dy, const void* w,
                                    const void* offsets, void* dx, int R,
                                    int E, int K, int N, int bm, int tiles,
                                    int route, int bn, int grid, int dtype,
                                    void* stream) {
  return grouped_launch<true>(dy, w, offsets, dx, R, E, K, N, bm, tiles,
                              route, bn, grid, dtype, stream);
}

// dw [E, K, N] = per-expert x_e^T @ dy_e; x [R, K], dy [R, N] sorted by
// expert, offsets [E + 1] int32 on the device; dtype code as above. 16-bit
// (R > 0): the plan (grouped_gemm.wgrad_plan): bn the column tile (256 or
// 128), kt and nt the K tiles (of WG_KT rows) and column tiles, grid the
// persistent blocks (at most E kt nt); fp32: the CUDA-core kernel, the
// plan unread.
template <typename T>
cudaError_t dispatch_wgrad(int bn, const void* x, const void* dy,
                           const int* off, void* dw, int R, int E, int K,
                           int N, int kt, int nt, int grid, cudaStream_t st) {
  if (bn == 256)
    return launch_wgrad<T, 256>(x, dy, off, dw, R, E, K, N, kt, nt, grid, st);
  if (bn == 128)
    return launch_wgrad<T, 128>(x, dy, off, dw, R, E, K, N, kt, nt, grid, st);
  return cudaErrorInvalidValue;
}

extern "C" int grouped_wgrad_launch(const void* x, const void* dy,
                                    const void* offsets, void* dw, int R,
                                    int E, int K, int N, int bn, int kt,
                                    int nt, int grid, int dtype,
                                    void* stream) {
  if (E <= 0 || E > 65535 || K <= 0 || N <= 0 || R < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (dtype == 0) {
    dim3 g((N + 63) / 64, (K + 63) / 64, E);
    grouped_wgrad_f32_kernel<<<g, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), off,
        static_cast<float*>(dw), K, N);
    return (int)cudaGetLastError();
  }
  // the plan's tiles must be the kernel's: kt tiles of WG_KT rows cover K
  // with none to spare, nt tiles of bn columns cover N
  const long long slots = (long long)E * kt * nt;
  if ((dtype != 1 && dtype != 2) || R < 1 || K % 8 || N % 8 || kt < 1 ||
      nt < 1 || (long long)(kt - 1) * WG_KT >= K ||
      (long long)kt * WG_KT < K || (long long)(nt - 1) * bn >= N ||
      (long long)nt * bn < N || grid < 1 || grid > slots ||
      slots > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == 1 ? dispatch_wgrad<bf16>(bn, x, dy, off, dw, R, E, K,
                                                 N, kt, nt, grid, st)
                          : dispatch_wgrad<f16>(bn, x, dy, off, dw, R, E, K,
                                                N, kt, nt, grid, st));
}
