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
// offsets[E] = R, non-decreasing; y [R, N] in x's dtype.
//
// Work: one block a (row tile, 128-column tile). The grid's x axis holds
// an upper bound of the row tiles (sum over experts of ceil(rows / BM) <=
// (R + min(E, R) (BM - 1)) / BM, from shapes alone); warp 0 of each block
// scans the offsets 32 experts at a time (a warp prefix sum of each
// expert's tile count) to find its expert and its rows, and a block past
// the last tile exits. An expert with no rows owns no tile, so its weights
// are never read: at decode only the routed experts' weights move.
//
// Bound on the H100: at decode (a few rows an expert) bytes, the routed
// experts' weights; at prefill (hundreds of rows an expert) operations.
// The row-tile height BM (16, 32, 64 or 128) comes from the wrapper's plan
// (rows an expert, grouped_gemm.grouped_plan), so a decode tile is not
// mostly empty rows.
//
// bf16 / fp16: mma.sync m16n8k16 with fp32 accumulators (flash_tile.cuh),
// 4 warps (8 at BM 128), a 32-deep K step staged by cp.async through
// three shared-memory stages (rows padded by 8 elements so that ldmatrix
// rows fall on distinct banks); A fragments by ldmatrix, B fragments by
// transposing ldmatrix from the [K][N] weight tile. Rows past the
// expert's end and K past the end are zero-filled, never stored. fp32: a
// plain CUDA-core kernel (tiles of BM x 64, 256 threads) for the parity
// runs. K % 8 == 0 and N % 8 == 0 for the 16-bit kernel (16-byte copies).
//
// Kernels launch on the caller's stream, do not synchronise and allocate
// nothing; the C entry point returns cudaGetLastError().

#include "flash_tile.cuh"

namespace {

constexpr int GBN = 128;           // output columns a block (16-bit kernel)
constexpr int GBK = 32;            // K depth a stage
constexpr int GSTAGES = 3;         // cp.async stages
constexpr int ALD = GBK + 8;       // A tile row (elements)
constexpr int BLD = GBN + 8;       // B tile row (elements)
constexpr unsigned FULL = 0xffffffffu;

// Warp 0 finds this block's expert and rows: tile t of the row tiles laid
// out expert after expert. Writes (e, first row, end row) to `found`; e =
// -1 past the last tile.
template <int BM>
__device__ __forceinline__ void find_tile(const int* __restrict__ off, int E,
                                          int t, int* found) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  bool done = false;
  for (int e0 = 0; e0 < E && !done; e0 += 32) {
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
    const bool mine = tiles > 0 && t >= first && t < first + tiles;
    if (mine) {
      found[0] = e;
      found[1] = lo + (t - first) * BM;
      found[2] = lo + n;
    }
    done = __ballot_sync(FULL, mine) != 0;
    base += __shfl_sync(FULL, inc, 31);
  }
  if (!done && lane == 0) found[0] = -1;
}

// Stage K columns [k0, k0 + 32) of rows [r0, r0 + BM) of x (rows past
// r1 and columns past K are zeros) and rows [k0, k0 + 32) of columns
// [n0, n0 + 128) of w_e (past K or N zeros).
template <int BM, int NTH, typename T>
__device__ __forceinline__ void stage(T* As, T* Bs, const T* __restrict__ x,
                                      const T* __restrict__ we, int r0, int r1,
                                      int k0, int n0, int K, int N) {
  for (int i = threadIdx.x; i < BM * (GBK / 8); i += NTH) {
    const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
    const bool live = r0 + r < r1 && k0 + c < K;
    cp_async16(As + r * ALD + c,
               x + (live ? (long long)(r0 + r) * K + k0 + c : 0), live);
  }
  for (int i = threadIdx.x; i < GBK * (GBN / 8); i += NTH) {
    const int r = i / (GBN / 8), c = (i % (GBN / 8)) * 8;
    const bool live = k0 + r < K && n0 + c < N;
    cp_async16(Bs + r * BLD + c,
               we + (live ? (long long)(k0 + r) * N + n0 + c : 0), live);
  }
}

// BM rows x 128 columns a block; WM x WN warps, each (BM / WM) rows x
// (128 / WN) columns: MT 16-row and NTL 8-column mma tiles.
template <typename T, int BM, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
    grouped_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const int* __restrict__ off, T* __restrict__ y, int E,
                       int K, int N) {
  constexpr int NTH = 32 * WM * WN;
  constexpr int MT = BM / WM / 16, NTL = GBN / WN / 8;
  static_assert(MT >= 1 && NTL % 2 == 0, "warp tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
      stage<BM, NTH>(As + s * BM * ALD, Bs + s * GBK * BLD, x, we, r0, r1,
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
      stage<BM, NTH>(As + b * BM * ALD, Bs + b * GBK * BLD, x, we, r0, r1,
                     nxt * GBK, n0, K, N);
    }
    cp_async_commit();
    const T* A = As + (s % GSTAGES) * BM * ALD;
    const T* B = Bs + (s % GSTAGES) * GBK * BLD;
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
        ldsm_x4_t(b, B + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * BLD +
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

// fp32 on the CUDA cores: BM rows x 64 columns a block of 256 threads
// (16 x 16), each thread BM / 16 rows (strided by 16) x 4 columns; K in
// steps of 16 through shared memory.
template <int BM>
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
                     ? we[(long long)(k0 + r) * N + n0 + c] : 0.f;
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

template <typename T, int BM, int WM, int WN>
cudaError_t launch_mma(const void* x, const void* w, const int* off, void* y,
                       int E, int K, int N, int tiles, cudaStream_t st) {
  auto kern = grouped_mma_kernel<T, BM, WM, WN>;
  const size_t smem =
      (size_t)GSTAGES * (BM * ALD + GBK * BLD) * sizeof(T);
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
    case 64: return launch_mma<T, 64, 2, 2>(x, w, off, y, E, K, N, tiles, st);
    case 128: return launch_mma<T, 128, 4, 2>(x, w, off, y, E, K, N, tiles, st);
  }
  return cudaErrorInvalidValue;
}

template <int BM>
cudaError_t launch_f32(const void* x, const void* w, const int* off, void* y,
                       int E, int K, int N, int tiles, cudaStream_t st) {
  dim3 grid(tiles, (N + 63) / 64);
  grouped_f32_kernel<BM><<<grid, 256, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), off,
      static_cast<float*>(y), E, K, N);
  return cudaGetLastError();
}

}  // namespace

// dtype code: 0 fp32, 1 bf16, 2 fp16. bm: the plan's row-tile height (16,
// 32, 64 or 128); tiles: the grid's row-tile slots (grouped_plan).
extern "C" int grouped_gemm_launch(const void* x, const void* w,
                                   const void* offsets, void* y, int E, int K,
                                   int N, int bm, int tiles, int dtype,
                                   void* stream) {
  if (tiles <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) {
    err = dispatch_mma<bf16>(bm, x, w, off, y, E, K, N, tiles, st);
  } else if (dtype == 2) {
    err = dispatch_mma<f16>(bm, x, w, off, y, E, K, N, tiles, st);
  } else if (dtype == 0) {
    switch (bm) {
      case 16: err = launch_f32<16>(x, w, off, y, E, K, N, tiles, st); break;
      case 32: err = launch_f32<32>(x, w, off, y, E, K, N, tiles, st); break;
      case 64: err = launch_f32<64>(x, w, off, y, E, K, N, tiles, st); break;
      case 128: err = launch_f32<128>(x, w, off, y, E, K, N, tiles, st); break;
    }
  }
  return (int)err;
}
