// Block-sparse flash attention forward for Hopper (sm_90a).
//
// sparse_fwd replaces the Pallas kernel `_fwd_sparse_kernel`
//   (deepspeed_tpu/ops/kernels/flash_attention.py:117, launched by the
//   pallas_call at :195 behind `flash_attention_sparse`, :206): online-
//   softmax attention of each (head, query block) over the key blocks that
//   a static (H, nq, nk) block mask allows, with no causal mask; padded
//   keys (col >= Tk) are masked, and a row that no allowed key reaches
//   writes zeros.
//
// Bound on the H100: operations -- 4 D flops per allowed (query, key)
// pair against O(T D) bytes a row. Beside the tensor cores' work, the
// softmax takes one ex2 a score on the MUFU: at D = 64 that is as many
// cycles as the two products (BERT-large's 16 heads of 64 at T = 4096,
// BSLongformer: 161.5 M scores, ~0.041 ms of MUFU at ~3.9 T ops/s, beside
// a 0.0418 ms tensor bound).
//
// The TPU kernel visits every (q, k) grid step and skips masked ones, with
// a host "fetch schedule" that repeats the last allowed block's index so
// that a skipped step costs no DMA (:147-161); on the card a skipped tile
// would still cost a loop trip, so the host builds once per mask a compact
// list (CSR) of the live key tiles of each (head, query block) -- the
// allowed blocks' tiles that start below Tk, ascending -- and the kernels
// walk the lists. A masked block costs nothing; an empty list stores zeros.
//
// Three kernels, one function; the wrapper picks by sparse_route from the
// shapes alone:
//
// sparse_fwd_wgmma_kernel (bf16 / fp16, D = 64 and 128, block_q a multiple
//   of 128, lists of 128-key tiles): the flash forward's Hopper design
//   (flash_ws.cuh) over the CSR. A persistent block an SM walks work items
//   of (batch, head, 128 query rows) from a host plan (sparse_plan: the
//   items heaviest first, each to the least loaded block, a (batch, head)'s
//   items side by side so that their K/V tiles come from L2), with two
//   consumer warpgroups of 64 rows and a producer warp that loads Q and
//   each live K/V tile by TMA into rings on mbarriers. Q is double-buffered
//   and the rings run on across items, so the next item's Q and first
//   tiles arrive while the consumers finish this one: an item of
//   BSLongformer holds ~4.8 tiles, ~2.7 us of tensor time, about as long
//   as a pipeline's start. Both products run on wgmma (Q K^T from shared
//   memory, P V with P in registers), and the consumers take turns on the
//   tensor cores, so one warpgroup's exponentials run under the other's
//   products: the only lever on the MUFU cost above. Keys past Tk arrive
//   as zeros (the TMA box) and are masked on the one tile that holds them.
// sparse_fwd_mma_kernel<D, T> (bf16 / fp16, D = 16, 32, 64, 80, 96, 128,
//   64-row blocks, lists of 64-key tiles): one block of 4 warps owns 64
//   query rows, K/V tiles double-buffered in shared memory by cp.async,
//   mma.sync m16n8k16 with fp32 accumulators (flash_tile.cuh); the route
//   for the head dims the wgmma kernel has no instance for, and for
//   block_q or block_k of 64 (mod 128).
// sparse_fwd_f32_kernel<D> (fp32, the same head dims): one thread a query
//   row on the CUDA cores over the 64-key lists, the parity oracle for the
//   indexing.
//
// Numerics follow the Pallas kernel: scores in fp32 scaled after the
// product; P cast to V's dtype before P.V with the row sums taken before
// that cast; exponentials by ex2. Every output row is written by one block
// in a fixed order of tiles, so a second call gives the same bits.
//
// Layout: q/o [B, H, Tq, D] and k/v [B, Hk, Tk, D] by element strides of
// (batch, head, time), unit head_dim stride (BTHD views pass without a
// copy); GQA reads KV head h / (H / Hk), never a repeated copy. row_ptr
// int32 [H * nq + 1] and tiles int32 [row_ptr[H * nq]] (key-tile indices:
// key t0 = 64 * tile, or 128 * tile on the wgmma route) on the device; the
// wgmma route also takes the plan, block_ptr int32 [grid + 1] and items
// int32 ((b * H + h) * ceil(Tq / 128) + query tile). The 16-bit routes
// need 16-byte rows (mma: base and strides; wgmma: what TMA reads, the
// strides of dims longer than 1): the wrapper hands them dense copies of
// views that have none. Kernels launch on the caller's stream, do not
// synchronise and allocate nothing; the C entry point returns
// cudaGetLastError().

#include "flash_tile.cuh"
#include "flash_ws.cuh"
#include "hopper.cuh"

namespace {

constexpr int F32_NT = 128;

// ---------------------------------------------------------------- mma.sync

template <int D, typename T>
__global__ void __launch_bounds__(NT)
sparse_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ tiles, Strides sq, Strides sk,
                      Strides sv, Strides so, int H, int Hk, int Tq, int Tk,
                      int nq, int block_q, float scale) {
  constexpr int ND = D / 8, TE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);   // [buf][K, V][64][D+8]
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, qi = lane % 4;
  const int row[2] = {q0 + warp * 16 + quad, q0 + warp * 16 + quad + 8};
  const int at = h * nq + q0 / block_q;
  const int* list = tiles + row_ptr[at];
  const int ntiles = row_ptr[at + 1] - row_ptr[at];

  uint32_t qf[D / 16][4];
  load_a<D>(qf, q + b * sq.b + h * sq.h, sq.t, row, Tq, qi);
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};             // this thread's partial row sums

  if (ntiles > 0) {
    stage_tile<D>(smem, kb, sk.t, list[0] * BK, Tk);
    stage_tile<D>(smem + TE, vb, sv.t, list[0] * BK, Tk);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = list[it] * BK;
    const T* ks = smem + (it & 1) * 2 * TE;
    const T* vs = ks + TE;
    if (it + 1 < ntiles) {
      T* nk = smem + ((it + 1) & 1) * 2 * TE;
      stage_tile<D>(nk, kb, sk.t, list[it + 1] * BK, Tk);
      stage_tile<D>(nk + TE, vb, sv.t, list[it + 1] * BK, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float sc[8][4];
    mma_abt<D, T>(sc, qf, ks, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, j = t0 + nt * 8 + qi * 2 + (e & 1);
        const float x =
            (j < Tk && row[i] < Tq) ? sc[nt][e] * scale : -INFINITY;
        sc[nt][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2], m_safe[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with nothing live yet keeps m = -inf: exp through a finite
      // stand-in so no (-inf) - (-inf) NaN appears; p and alpha come out 0
      m_safe[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = __expf(m[i] - m_safe[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sc[nt][e] - m_safe[e / 2]);
        sc[nt][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e / 2];
    mma_pv<D, T>(acc, sc, vs, lane);
    __syncthreads();
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    inv[i] = li == 0.f ? 0.f : 1.f / li;      // no allowed key: O = 0
  }
  store_rows<D>(o + b * so.b + h * so.h, so.t, acc, row, Tq, inv, qi);
}

// ------------------------------------------------------------------- wgmma
//
// A block of a producer warpgroup and SP_NC = 2 consumer warpgroups walks
// its items from the plan. The producer's thread 0 loads, for each item
// with a live tile, Q (two boxes of 128 rows x 64 columns at D = 128) into
// one of two Q buffers and, for each tile of the item's list, K one tile
// ahead of V into rings of sp_stages buffers; the consumers run
// flash_ws.cuh's WsState over the same tiles with every row live up to
// Tk. Tiles are counted over the block's whole walk (kbase), so the rings
// never drain between items.

constexpr int SP_NC = 2;                       // consumer warpgroups
constexpr int SP_ROWS = 64 * SP_NC;            // query rows of an item
constexpr int SP_THREADS = 128 * (1 + SP_NC);

// ring depth by head dim: as deep as shared memory allows (5 x 32 KB of
// K/V tiles at D = 64, 2 x 64 KB at D = 128), since an item holds few
// tiles and the producer runs ahead across items
template <int D>
__host__ __device__ constexpr int sp_stages() {
  return D == 64 ? 5 : 2;
}
template <int D>
__host__ __device__ constexpr size_t sp_smem_bytes() {
  return (size_t)(2 * SP_ROWS * D + sp_stages<D>() * 2 * WS_K * D) * 2 +
         (4 + 4 * sp_stages<D>()) * sizeof(uint64_t);
}

// Work item `code` of the plan: (batch, head, 128-row query tile), and
// its list of live 128-key tiles (the CSR row of its query block).
struct SpItem {
  int b, h, hk, q0, ntiles;
  const int* list;
  __device__ __forceinline__ SpItem(int code, int H, int Hk, int nqt, int nq,
                                    int block_q, const int* row_ptr,
                                    const int* tiles) {
    const int qt = code % nqt, bh = code / nqt;
    b = bh / H;
    h = bh % H;
    hk = h / (H / Hk);
    q0 = qt * SP_ROWS;
    const int at = h * nq + q0 / block_q;
    list = tiles + row_ptr[at];
    ntiles = row_ptr[at + 1] - row_ptr[at];
  }
};

template <int D, typename T>
__global__ void __launch_bounds__(SP_THREADS, 1)
sparse_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        T* __restrict__ o, const int* __restrict__ row_ptr,
                        const int* __restrict__ tiles,
                        const int* __restrict__ block_ptr,
                        const int* __restrict__ items, Strides so, int H,
                        int Hk, int Tq, int Tk, int nq, int block_q,
                        float scale) {
  using St = WsState<D, T, SP_NC, sp_stages<D>()>;
  constexpr int S = St::S, NC = SP_NC, NB = D / 64;
  constexpr int BOX = St::BOX, QBOX = St::QBOX, TKV = St::TKV;
  constexpr int TQ = SP_ROWS * D;
  extern __shared__ __align__(1024) unsigned char sp_smem[];
  T* qs = reinterpret_cast<T*>(sp_smem);               // [2][NB][128 x 64]
  T* kring = qs + 2 * TQ;                              // [S][NB][128 x 64]
  T* vring = kring + S * TKV;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vring + S * TKV);
  uint64_t* qempty = qfull + 2;
  uint64_t* kfull = qempty + 2;
  uint64_t* vfull = kfull + S;
  uint64_t* kempty = vfull + S;
  uint64_t* vempty = kempty + S;
  const int nqt = (Tq + SP_ROWS - 1) / SP_ROWS;
  const int* mine = items + block_ptr[blockIdx.x];
  const int nmine = block_ptr[blockIdx.x + 1] - block_ptr[blockIdx.x];
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i);
      mbar_init(qempty + i, NC);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(kfull + s);
      mbar_init(vfull + s);
      mbar_init(kempty + s, NC);
      mbar_init(vempty + s, NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    set_max_regs<24, false>();
    if (threadIdx.x != 0) return;
    // tile g of the block's walk of K or V (first key `row`) into its ring
    // once the consumers freed the buffer
    auto load = [&](const CUtensorMap* tm, T* ring, uint64_t* full,
                    uint64_t* empty, int g, int row, int hk, int b) {
      const int st = g % S;
      mbar_wait(empty + st, ((g / S) & 1) ^ 1);
      mbar_expect(full + st, TKV * sizeof(T));
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_box4(ring + st * TKV + nb * BOX, tm, nb * 64, row, hk, b,
                 full + st);
    };
    int kbase = 0, qn = 0;
    for (int r = 0; r < nmine; ++r) {
      const SpItem it(mine[r], H, Hk, nqt, nq, block_q, row_ptr, tiles);
      if (it.ntiles == 0) continue;
      const int qb = qn & 1;
      mbar_wait(qempty + qb, ((qn >> 1) & 1) ^ 1);
      mbar_expect(qfull + qb, TQ * sizeof(T));
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_box4(qs + qb * TQ + nb * QBOX, &tm_q, nb * 64, it.q0, it.h, it.b,
                 qfull + qb);
      int next = it.list[0];
      load(&tm_k, kring, kfull, kempty, kbase, next * WS_K, it.hk, it.b);
      for (int t = 0; t < it.ntiles; ++t) {
        const int cur = next;
        if (t + 1 < it.ntiles) {
          next = it.list[t + 1];
          load(&tm_k, kring, kfull, kempty, kbase + t + 1, next * WS_K,
               it.hk, it.b);
        }
        load(&tm_v, vring, vfull, vempty, kbase + t, cur * WS_K, it.hk,
             it.b);
      }
      kbase += it.ntiles;
      ++qn;
    }
    return;
  }
  set_max_regs<240, true>();
  const int cw = wg - 1;                      // rows 64 cw of an item
  const int lane = threadIdx.x % 32, qi = lane % 4;
  const int rloc = cw * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
  St w;
  w.kring = kring;
  w.vring = vring;
  w.kfull = kfull;
  w.vfull = vfull;
  w.kempty = kempty;
  w.vempty = vempty;
  w.qi = qi;
  w.cw = cw;
  w.scale = scale;
  w.signal = threadIdx.x % 128 == 0;
  w.kbase = 0;
  // no causal limit: every key below Tk is live for every row, and only
  // the tile that holds Tk takes the mask
  w.lim[0] = w.lim[1] = Tk;
  w.live_all = Tk;
#pragma unroll
  for (int i = 0; i < 64; ++i) w.sc[i] = 0.f;
  int qn = 0;
  for (int r = 0; r < nmine; ++r) {
    const SpItem it(mine[r], H, Hk, nqt, nq, block_q, row_ptr, tiles);
    const int row[2] = {it.q0 + rloc, it.q0 + rloc + 8};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) w.acc[i] = 0.f;
    w.m[0] = w.m[1] = -INFINITY;
    w.l[0] = w.l[1] = 0.f;                    // this thread's partial sums
    const int n = it.ntiles;
    if (n > 0) {
      const int qb = qn & 1;
      w.qa = qs + qb * TQ + cw * 64 * 64;     // this warpgroup's rows of Q
      mbar_wait(qfull + qb, (qn >> 1) & 1);
      w.first(it.list[0] * WS_K);
      for (int t = 1; t < n; ++t) w.step(t, it.list[t] * WS_K);
      w.last(n - 1);
      if (w.signal) mbar_arrive(qempty + qb);   // Q read for the last time
      w.kbase += n;
      ++qn;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = w.l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float inv = li == 0.f ? 0.f : 1.f / li;   // no live key: O = 0
      if (row[i] >= Tq) continue;
      T* p = o + it.b * so.b + it.h * so.h + (long long)row[i] * so.t +
             qi * 2;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(p + c * 8) = pack2<T>(
            w.acc[4 * c + 2 * i] * inv, w.acc[4 * c + 2 * i + 1] * inv);
    }
  }
}

// -------------------------------------------------------------------- fp32

template <int D>
__global__ void __launch_bounds__(F32_NT)
sparse_fwd_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ tiles, Strides sq, Strides sk,
                      Strides sv, Strides so, int B, int H, int Hk, int Tq,
                      int Tk, int nq, int block_q, float scale) {
  const long long idx = (long long)blockIdx.x * F32_NT + threadIdx.x;
  if (idx >= (long long)B * H * Tq) return;
  const int i = idx % Tq, h = (idx / Tq) % H, b = idx / ((long long)Tq * H);
  const int hk = h / (H / Hk);
  const int at = h * nq + i / block_q;
  const float* qr = q + b * sq.b + h * sq.h + (long long)i * sq.t;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int it = row_ptr[at]; it < row_ptr[at + 1]; ++it) {
    const int t0 = tiles[it] * BK;
    for (int j = t0; j < min(t0 + BK, Tk); ++j) {
      const float* kr = k + b * sk.b + hk * sk.h + (long long)j * sk.t;
      const float* vr = v + b * sv.b + hk * sv.h + (long long)j * sv.t;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new), p = expf(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = acc[d] * alpha + p * vr[d];
      m = m_new;
    }
  }
  float* orow = o + b * so.b + h * so.h + (long long)i * so.t;
  const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
}

// ---------------------------------------------------------------- dispatch

// the element type (the C entry point's `dtype`, as the flash kernels')
// and the kernel (`route`, flash_attention.SPARSE_ROUTE_CODES)
enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };
enum Route { ROUTE_F32 = 0, ROUTE_MMA = 1, ROUTE_WGMMA = 2 };

struct Args {
  const void *q, *k, *v;
  void* o;
  const int *row_ptr, *tiles, *block_ptr, *items;
  Strides sq, sk, sv, so;
  int B, H, Hk, Tq, Tk, nq, block_q, grid;
  float scale;
};

template <int D, typename T>
cudaError_t fwd_mma(const Args& a, cudaStream_t stream) {
  dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  constexpr size_t smem = 4 * tile_elems<D>() * sizeof(T);
  cudaError_t err = smem_opt_in(sparse_fwd_mma_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  sparse_fwd_mma_kernel<D, T><<<grid, NT, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.row_ptr,
      a.tiles, a.sq, a.sk, a.sv, a.so, a.H, a.Hk, a.Tq, a.Tk, a.nq,
      a.block_q, a.scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t fwd_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = bhtd_map<T>(&tq, a.q, a.sq, a.B, a.H, a.Tq, D, SP_ROWS);
  if (err == cudaSuccess)
    err = bhtd_map<T>(&tk, a.k, a.sk, a.B, a.Hk, a.Tk, D, WS_K);
  if (err == cudaSuccess)
    err = bhtd_map<T>(&tv, a.v, a.sv, a.B, a.Hk, a.Tk, D, WS_K);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = sp_smem_bytes<D>();
  int per_sm = 0;
  err = blocks_per_sm(reinterpret_cast<const void*>(
                          sparse_fwd_wgmma_kernel<D, T>),
                      SP_THREADS, smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  sparse_fwd_wgmma_kernel<D, T><<<a.grid, SP_THREADS, smem, stream>>>(
      tq, tk, tv, (T*)a.o, a.row_ptr, a.tiles, a.block_ptr, a.items, a.so,
      a.H, a.Hk, a.Tq, a.Tk, a.nq, a.block_q, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_f32(const Args& a, cudaStream_t stream) {
  const long long n = (long long)a.B * a.H * a.Tq;
  sparse_fwd_f32_kernel<D><<<(unsigned)((n + F32_NT - 1) / F32_NT), F32_NT,
                             0, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o,
      a.row_ptr, a.tiles, a.sq, a.sk, a.sv, a.so, a.B, a.H, a.Hk, a.Tq,
      a.Tk, a.nq, a.block_q, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd(const Args& a, int dtype, int route, cudaStream_t s) {
  if (route == ROUTE_F32) return fwd_f32<D>(a, s);
  if constexpr (D == 64 || D == 128) {
    if (route == ROUTE_WGMMA)
      return dtype == BF16 ? fwd_wgmma<D, bf16>(a, s)
                           : fwd_wgmma<D, f16>(a, s);
  }
  return dtype == BF16 ? fwd_mma<D, bf16>(a, s) : fwd_mma<D, f16>(a, s);
}

bool rows_aligned(const void* const* ptrs, const long long* strides) {
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return false;
  return true;
}

}  // namespace

extern "C" {

// q [B, H, Tq, D], k / v [B, Hk, Tk, D], o like q (element strides of
// batch, head and time for q, k, v, o in `strides[12]`); row_ptr / tiles
// the CSR of live key tiles per (head, query block of block_q rows), of
// 64 keys (routes f32, mma) or 128 (wgmma); block_ptr / items the wgmma
// route's plan over `grid` blocks (null, 0 otherwise).
int sparse_fwd_launch(const void* q, const void* k, const void* v, void* o,
                      const void* row_ptr, const void* tiles,
                      const void* block_ptr, const void* items,
                      const long long* strides, int B, int H, int Hk, int Tq,
                      int Tk, int D, int nq, int block_q, float scale,
                      int dtype, int route, int grid, void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk || Tq <= 0 || Tk <= 0 ||
      B > 65535 || H > 65535 || block_q <= 0 || block_q % BQ ||
      nq != (Tq + block_q - 1) / block_q || dtype < F32 || dtype > F16 ||
      route < ROUTE_F32 || route > ROUTE_WGMMA ||
      (route == ROUTE_F32) != (dtype == F32) ||
      (D != 16 && D != 32 && D != 64 && D != 80 && D != 96 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (route == ROUTE_WGMMA &&
      ((D != 64 && D != 128) || block_q % SP_ROWS || grid < 1 ||
       !block_ptr || !items))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  // 16-byte rows for cp.async and the 4-byte fragment loads (TMA checks
  // its own in bhtd_map)
  if (route == ROUTE_MMA && !rows_aligned(ptrs, strides))
    return (int)cudaErrorMisalignedAddress;
  auto st = [&](int i) {
    return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  };
  const Args a{q, k, v, o, (const int*)row_ptr, (const int*)tiles,
               (const int*)block_ptr, (const int*)items, st(0), st(1),
               st(2), st(3), B, H, Hk, Tq, Tk, nq, block_q, grid, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)fwd<16>(a, dtype, route, s);
    case 32: return (int)fwd<32>(a, dtype, route, s);
    case 64: return (int)fwd<64>(a, dtype, route, s);
    case 80: return (int)fwd<80>(a, dtype, route, s);
    case 96: return (int)fwd<96>(a, dtype, route, s);
    default: return (int)fwd<128>(a, dtype, route, s);
  }
}

}  // extern "C"
