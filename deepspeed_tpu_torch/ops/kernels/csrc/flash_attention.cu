// FlashAttention-2 forward and backward for Hopper (sm_90a): the kernels
// of the training path's attention.
//
// flash_fwd replaces the Pallas kernel `_fwd_kernel` with
//   `_online_softmax_block` (deepspeed_tpu/ops/kernels/flash_attention.py:44
//   and :92, launched at :276): online-softmax attention that writes O and
//   the row logsumexp lse = m + log(l).
// flash_bwd replaces `_bwd_dq_kernel` (:311, launched at :436) and
//   `_bwd_dkv_kernel` (:359, launched at :473) together at head dims 64
//   and 128 in bf16 / fp16: flash_bwd_wgmma_kernel computes dQ, dK and dV
//   in one pass over the (query tile, key tile) pairs, between a prep pass
//   (delta = rowsum(dO * O) - dlse, the dQ workspace zeroed) and a cast
//   pass (dQ out of its fp32 workspace).
// flash_bwd_dq / flash_bwd_dkv, the pair the Pallas split copies (dQ over
//   the key tiles; dK and dV of one KV head over every query head of its
//   GQA group and every query tile, so no atomics are needed: the Pallas
//   grid fuses (group, q-tile) into its innermost axis at :461-495 for the
//   same end), run the backward at head dims 16 and 32 and in fp32.
//
// Bound on the H100: at the training shape (T = 2048, D = 64, causal)
// attention is FLOP-bound -- 2 matrix products per (query, key) pair
// forward, 5 backward (7 in the pair) -- against O(T * D) bytes per row,
// so bf16 and fp16 run on the tensor cores.
//
// The forward at D = 64 and 128 (the training paths' head dims) is built
// for Hopper (flash_fwd_wgmma_kernel; hopper.cuh, and flash_ws.cuh for the
// consumers' walk, which the block-sparse forward shares): a persistent
// block an SM walks work items of 192 (D = 64) or 128 (D = 128) query
// rows, 64 a consumer warpgroup, both products on wgmma (Q K^T from
// shared memory, P V with P in registers), K/V tiles of 128 keys by TMA
// in rings on mbarriers filled by a producer warp, the consumers taking
// turns on the tensor cores, the causal triangle's items dealt heaviest
// first. D = 16 and 32 (GPT2Config.tiny, untimed) keep the mma.sync
// forward.
//
// The backward at D = 64 and 128 (flash_bwd_wgmma_kernel): a persistent
// block an SM walks work items of (batch, KV head, 128 keys), dK and dV in
// the registers of two consumer warpgroups (64 keys each) over every query
// tile of the GQA group, Q / dO / lse / delta streamed by TMA and bulk
// copies through a ring filled by a producer warp, S^T and dP^T on wgmma
// from shared memory, dV and dK on wgmma with P^T and dS^T as register A
// fragments, dQ on wgmma from dS^T in shared memory (the transposed-A
// form) added into an fp32 workspace by bulk reduce-add (see its section).
//
// The mma.sync kernels (the forward at D = 16 and 32, the dq / dkv pair):
// mma.sync m16n8k16 (bf16 or fp16 in, fp32 accumulate; the kernels are
// templated on the element type T), one block of 4 warps, each warp
// owning 16 rows of the block's 64-row tile, with the scores,
// probabilities and accumulators kept in registers and the streamed
// 64-row tiles of the other operand double-buffered in shared memory
// (cp.async: the next tile's copy runs under this tile's products) and
// read as mma fragments with ldmatrix. The score accumulators re-pack as
// the A fragments of the next product without a trip through shared
// memory. Fully masked key tiles above the causal diagonal are never
// read; exponentials use the fast ex2-based __expf.
//
// Head dims 16, 32, 64 and 128 are instantiated (the GPT-2 configs' 16 and
// 64, the bench's 128), for fp32, bf16 and fp16. The wgmma kernels take
// q/k/v (and the backward's dO) whose base addresses and strides (those
// of dims longer than 1) are 16-byte multiples, as TMA needs; the wrapper
// raises for others.
//
// Numerics follow the Pallas kernels: scores in fp32 scaled after the
// product; P cast to V's dtype before P.V with the row sums taken before
// that cast; ds = p * (dp - delta) * scale cast to K's (dq) or Q's (dk)
// dtype before its product; P cast to dO's dtype for dV; backward
// probabilities exp(s - lse) are zero where masked and where lse is not
// finite. A row with no live key (Tq > Tk under the bottom-right causal
// diagonal) writes O = 0 and lse = -inf.
//
// fp32 inputs run simple CUDA-core kernels (one thread per row), a parity
// oracle for the indexing (strides, causal offset, GQA, ragged edges) at a
// tight tolerance; they are not meant to be fast.
//
// Layout: q/o/do/dq [B, H, Tq, D] and k/v/dk/dv [B, Hk, Tk, D] given by
// element strides of (batch, head, time) with a unit head_dim stride, so
// the BTHD views of a fused qkv projection need no copy. lse and delta are
// contiguous fp32 [B, H, Tq]. The causal diagonal is bottom-right aligned:
// query i sees key j iff j <= i + (Tk - Tq). Sequence edges are masked in
// the kernels (no padded copies). Kernels launch on the caller's stream,
// do not synchronise and allocate nothing; each C entry point returns
// cudaGetLastError().

#include "flash_tile.cuh"
#include "flash_ws.cuh"
#include "hopper.cuh"

namespace {

constexpr int F32_NT = 128;        // threads per block of the fp32 kernels

template <typename T>
__device__ __forceinline__ const T* row_at(const T* base, Strides s, int b,
                                           int h, int t) {
  return base + b * s.b + h * s.h + (long long)t * s.t;
}

// The number of keys query row i sees: [0, limit). Rows past Tq see none.
__device__ __forceinline__ int key_limit(int i, int Tq, int Tk, int causal) {
  if (i >= Tq) return 0;
  return causal ? min(Tk, max(0, i + Tk - Tq + 1)) : Tk;
}

// Shared memory of the mma kernels: two buffers of two [64][D + 8] 16-bit
// tiles (double buffering), plus two [64] fp32 row vectors per buffer for
// the dK/dV kernel's lse and delta.
template <int D>
constexpr size_t mma_smem_bytes(bool rows) {
  return 4 * tile_elems<D>() * sizeof(uint16_t) +
         (rows ? 4 * 64 * sizeof(float) : 0);
}

// ---------------------------------------------------------------- forward

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int H, int Hk, int Tq, int Tk,
                     float scale, int causal) {
  constexpr int ND = D / 8, TE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);   // [buf][K, V][64][D+8]
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, qi = lane % 4;
  const int row[2] = {q0 + warp * 16 + quad, q0 + warp * 16 + quad + 8};
  const int lim[2] = {key_limit(row[0], Tq, Tk, causal),
                      key_limit(row[1], Tq, Tk, causal)};
  // the block's keys: those its last live row sees
  const int kend = key_limit(min(q0 + BQ, Tq) - 1, Tq, Tk, causal);

  uint32_t qf[D / 16][4];
  load_a<D>(qf, row_at(q, sq, b, h, 0), sq.t, row, Tq, qi);
  const T* kb = row_at(k, sk, b, hk, 0);
  const T* vb = row_at(v, sv, b, hk, 0);

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};             // this thread's partial row sums

  // K/V tiles double-buffered: the next tile's copy runs under this
  // tile's products
  if (kend > 0) {
    stage_tile<D>(smem, kb, sk.t, 0, kend);
    stage_tile<D>(smem + TE, vb, sv.t, 0, kend);
    cp_async_commit();
  }
  for (int t0 = 0, it = 0; t0 < kend; t0 += BK, ++it) {
    const T* ks = smem + (it & 1) * 2 * TE;
    const T* vs = ks + TE;
    if (t0 + BK < kend) {
      T* nk = smem + ((it + 1) & 1) * 2 * TE;
      stage_tile<D>(nk, kb, sk.t, t0 + BK, kend);
      stage_tile<D>(nk + TE, vb, sv.t, t0 + BK, kend);
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
        const float x = j < lim[i] ? sc[nt][e] * scale : -INFINITY;
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
    inv[i] = li == 0.f ? 0.f : 1.f / li;             // no live key: O = 0
    if (qi == 0 && row[i] < Tq)
      lse[((long long)b * H + h) * Tq + row[i]] =
          li == 0.f ? -INFINITY : m[i] + logf(li);
  }
  store_rows<D>(o + b * so.b + h * so.h, so.t, acc, row, Tq, inv, qi);
}

// ------------------------------------------------ forward, D = 64 and 128
//
// A block owns 64 NC query rows of a work item (one (batch, head, query
// tile)): warpgroup 0 is the producer (one thread issues TMA boxes after
// the warpgroup gives back its registers), warpgroups 1..NC the consumers,
// 64 rows each. K and V tiles of 128 keys arrive in two rings of
// ws_stages buffers, each buffer on a `full` barrier (TMA's bytes landed)
// and an `empty` one (every consumer done with it); K runs one tile ahead
// of V, and a K buffer is freed as soon as its scores are computed. Q is
// double-buffered across work items. Every box is [rows x 64 columns]
// with the 128-byte swizzle (a D = 128 row spans two boxes), read by a 4-D
// tensor map over (d, time, head, batch) with the caller's strides, so
// strided BTHD views need no copy and rows past the sequence arrive as
// zeros.
//
// A consumer warpgroup runs S = Q K^T on m64n128k16 wgmma from shared
// memory (both K-major), the online softmax on the fp32 accumulators in
// registers, and O += P V on m64nDk16 wgmma with P as register A fragments
// (the probabilities cast to the element type and packed in pairs) and V
// MN-major from shared memory. Two overlaps hide the softmax: within a
// warpgroup, S_t is issued together with P V_{t-1} and its softmax runs
// while P V_{t-1} is on the tensor cores; across warpgroups, the consumers
// take turns to issue their products (named barriers), so one issues
// while the others run their softmax rather than all in step (they read
// the same K/V tiles). Tiles wholly below the causal diagonal skip the
// mask; tiles wholly above it are never loaded.
//
// The grid is persistent, one block an SM: the work items, heaviest first
// (every (batch, head)'s last query tile, then the tiles before, heads of
// a GQA group side by side), are dealt to the blocks in rounds that
// alternate direction, so the causal triangle's long and short items pair
// up; the producer loads the next item's Q and first tiles while the
// consumers finish this one. `flash_attention.fwd_schedule` states the
// deal.

// consumer warpgroups (64 query rows each) and ring depth by head dim
template <int D>
__host__ __device__ constexpr int ws_consumers() {
  return D == 64 ? 3 : 2;
}
template <int D>
__host__ __device__ constexpr int ws_stages() {
  return D == 64 ? 3 : 2;
}
template <int D>
__host__ __device__ constexpr int ws_threads() {
  return 128 * (1 + ws_consumers<D>());
}
template <int D>
__host__ __device__ constexpr size_t ws_smem_bytes() {
  return (size_t)(2 * 64 * ws_consumers<D>() * D +
                  ws_stages<D>() * 2 * WS_K * D) * 2 +
         (4 + 4 * ws_stages<D>()) * sizeof(uint64_t);
}

// Work item `item` of the schedule: every (batch, head)'s last query tile,
// then the tiles before, heads of one GQA group side by side.
struct WsItem {
  int b, h, hk, q0, ntiles;
  __device__ __forceinline__ WsItem(int item, int rows, int B, int H, int Hk,
                                    int Tq, int Tk, int causal) {
    const int nqt = (Tq + rows - 1) / rows, BH = B * H;
    const int qt = nqt - 1 - item / BH, bh = item % BH;
    b = bh / H;
    h = bh % H;
    hk = h / (H / Hk);
    q0 = qt * rows;
    // the item's keys: those its last live row sees
    const int kend = key_limit(min(q0 + rows, Tq) - 1, Tq, Tk, causal);
    ntiles = (kend + WS_K - 1) / WS_K;
  }
};

// The r-th work item of this block: rounds of gridDim.x items, dealt
// forward in even rounds and backward in odd ones.
__device__ __forceinline__ int ws_item(int r) {
  return r * (int)gridDim.x +
         (r & 1 ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

template <int D, typename T>
__global__ void __launch_bounds__(ws_threads<D>(), 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       T* __restrict__ o, float* __restrict__ lse,
                       Strides so, int B, int H, int Hk, int Tq, int Tk,
                       float scale, int causal) {
  using St = WsState<D, T, ws_consumers<D>(), ws_stages<D>()>;
  constexpr int S = St::S, NC = St::NC, NB = D / 64;
  constexpr int BOX = St::BOX, QBOX = St::QBOX, TKV = St::TKV;
  constexpr int ROWS = 64 * NC, TQ = ROWS * D;
  extern __shared__ __align__(1024) unsigned char ws_smem[];
  T* qs = reinterpret_cast<T*>(ws_smem);               // [2][NB][ROWS x 64]
  T* kring = qs + 2 * TQ;                              // [S][NB][128 x 64]
  T* vring = kring + S * TKV;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vring + S * TKV);
  uint64_t* qempty = qfull + 2;
  uint64_t* kfull = qempty + 2;
  uint64_t* vfull = kfull + S;
  uint64_t* kempty = vfull + S;
  uint64_t* vempty = kempty + S;
  const int items = ((Tq + ROWS - 1) / ROWS) * B * H;
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
    // tile g of the block's walk of K or V into its ring once the
    // consumers freed the buffer
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
    for (int r = 0; r * (int)gridDim.x < items; ++r) {
      if (ws_item(r) >= items) continue;
      const WsItem it(ws_item(r), ROWS, B, H, Hk, Tq, Tk, causal);
      if (it.ntiles == 0) continue;
      const int qb = qn & 1;
      mbar_wait(qempty + qb, ((qn >> 1) & 1) ^ 1);
      mbar_expect(qfull + qb, TQ * sizeof(T));
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_box4(qs + qb * TQ + nb * QBOX, &tm_q, nb * 64, it.q0, it.h, it.b,
                 qfull + qb);
      load(&tm_k, kring, kfull, kempty, kbase, 0, it.hk, it.b);
      for (int t = 0; t < it.ntiles; ++t) {
        if (t + 1 < it.ntiles)
          load(&tm_k, kring, kfull, kempty, kbase + t + 1, (t + 1) * WS_K,
               it.hk, it.b);
        load(&tm_v, vring, vfull, vempty, kbase + t, t * WS_K, it.hk, it.b);
      }
      kbase += it.ntiles;
      ++qn;
    }
    return;
  }
  set_max_regs<NC == 2 ? 240 : 160, true>();
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
#pragma unroll
  for (int i = 0; i < 64; ++i) w.sc[i] = 0.f;
  int qn = 0;
  for (int r = 0; r * (int)gridDim.x < items; ++r) {
    if (ws_item(r) >= items) continue;
    const WsItem it(ws_item(r), ROWS, B, H, Hk, Tq, Tk, causal);
    const int row[2] = {it.q0 + rloc, it.q0 + rloc + 8};
    w.lim[0] = key_limit(row[0], Tq, Tk, causal);
    w.lim[1] = key_limit(row[1], Tq, Tk, causal);
    // keys every row of this warpgroup sees (none when its first row is
    // past Tq: such rows are never stored, the mask is then moot)
    const int first = it.q0 + cw * 64;
    w.live_all = first < Tq ? key_limit(first, Tq, Tk, causal) : Tk;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) w.acc[i] = 0.f;
    w.m[0] = w.m[1] = -INFINITY;
    w.l[0] = w.l[1] = 0.f;                    // this thread's partial sums
    const int n = it.ntiles;
    if (n > 0) {
      const int qb = qn & 1;
      w.qa = qs + qb * TQ + cw * 64 * 64;     // this warpgroup's rows of Q
      mbar_wait(qfull + qb, (qn >> 1) & 1);
      w.first(0);
      for (int t = 1; t < n; ++t) w.step(t, t * WS_K);
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
      if (qi == 0)
        lse[((long long)it.b * H + it.h) * Tq + row[i]] =
            li == 0.f ? -INFINITY : w.m[i] + logf(li);
      T* p = o + it.b * so.b + it.h * so.h + (long long)row[i] * so.t +
             qi * 2;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(p + c * 8) = pack2<T>(
            w.acc[4 * c + 2 * i] * inv, w.acc[4 * c + 2 * i + 1] * inv);
    }
  }
}

// ----------------------------------------------- backward, D = 64 and 128
//
// One main kernel computes dQ, dK and dV with five products a (query
// tile, key tile) pair: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
// dK += dS^T Q and dQ += dS K (the Pallas pair, and the mma.sync pair
// below, take seven: each half recomputes S and dP).
//
// A work item is (batch, KV head, 128-key tile). Its block walks every
// query tile that sees the key tile, for every query head of the GQA
// group, in the Pallas order (query head, then query tile), keeping dK and
// dV of its keys in registers: one block owns the item, so they need no
// atomics and come out bit-identical from call to call. Warpgroup 0 is
// the producer (one thread: the K and V tiles once an item by TMA, then
// Q, dO and the item's rows of lse and delta through a ring of BW_STAGES
// buffers on mbarriers); warpgroups 1 and 2 the consumers, 64 keys each,
// 240 registers a thread (setmaxnreg). A consumer runs S^T and dP^T on
// m64nBQk16 wgmma from shared memory (both K-major), the probabilities
// and dS^T on the fp32 accumulators, then dV and dK on m64nDk16 wgmma
// with P^T and dS^T as register A fragments and dO and Q MN-major from
// shared memory. dS^T (cast to the element type, as for dK) goes once to
// shared memory, double-buffered across tiles; when both halves are in,
// each consumer takes a 64 x 64 block of the tile's dQ on wgmma with dS
// read MN-major (the transposed-A form) and K MN-major, and adds it into
// an fp32 workspace with one bulk reduce-add (cp.reduce.async.bulk ...
// add.f32). dQ's summation order over the key tiles thus varies from call
// to call; dK's and dV's does not.
//
// Query tiles are 128 rows at D = 64 and 64 at D = 128 (registers: a
// consumer holds dK and dV of 64 keys, D fp32 each, beside S^T and dP^T
// of 64 keys x BQ queries). The grid is persistent, one block an SM; the
// items run (batch, KV head) by (batch, KV head), its key tiles in order,
// dealt in rounds of alternating direction (ws_item): the blocks at work
// at one time share a few heads, whose Q, dO and dQ workspace then stay
// in L2 (items dealt key tile by key tile instead, every block on a head
// of its own, spilled the 67 MB workspace of the training shape to device
// memory and took a third longer), and a block's items vary in key tile
// from round to round, which evens out the causal triangle.
// `flash_attention.bwd_schedule` states the deal.
//
// Two small passes go with each launch: flash_bwd_prep_kernel before (one
// read of dO and O: delta = rowsum(dO O) - dlse and lse in base 2, +inf
// for a row with no live key or past Tq, into the tile-ordered row buffer;
// the dQ workspace zeroed), flash_bwd_cast_kernel after (the workspace to
// dQ's dtype in its strided layout).

constexpr int BW_K = 128;            // keys of a work item, 64 a consumer
constexpr int BW_STAGES = 2;         // ring depth of the Q / dO tiles
constexpr int BW_THREADS = 384;      // producer + two consumer warpgroups
constexpr int BW_BLOCK = 64 * 64;    // fp32 elements of a dQ block

// query rows of a tile by head dim
template <int D>
__host__ __device__ constexpr int bw_rows() {
  return D == 64 ? 128 : 64;
}

// Shared memory, byte offsets: the K and V tiles ([D / 64][128 x 64]
// 128-byte-swizzled boxes), the Q and dO rings ([D / 64][BQ x 64]), two
// dS^T buffers ([BQ / 64][128 keys x 64 queries], swizzled), each
// consumer's dQ block (fp32, in its accumulator order), the ring's rows
// (lse in base 2, delta: [2][BQ] fp32), and the barriers.
template <int D>
struct BwSmem {
  static constexpr int BQ = bw_rows<D>();
  static constexpr int TKV = BW_K * D, TQ = BQ * D, TDS = BW_K * BQ;
  static constexpr size_t K = 0, V = K + TKV * 2, Q = V + TKV * 2,
                          DO = Q + BW_STAGES * TQ * 2,
                          DS = DO + BW_STAGES * TQ * 2,
                          DQ = DS + 2 * TDS * 2,
                          ROWS = DQ + 2 * BW_BLOCK * 4,
                          BARS = ROWS + BW_STAGES * 2 * BQ * 4,
                          BYTES = BARS + (2 + 2 * BW_STAGES) * 8;
};

// Work item `item`: (batch, KV head) item / nkt, key tile item % nkt;
// the query tiles [qt0, qt0 + nq) of each of the group's G query heads see
// it (nq = 0: no row sees a key of the tile, and dK = dV = 0).
struct BwItem {
  int b, hk, k0, qt0, nq, ntiles;
  __device__ __forceinline__ BwItem(int item, int Hk, int G, int Tq, int Tk,
                                    int causal, int BQ) {
    const int nkt = (Tk + BW_K - 1) / BW_K;
    const int kt = item % nkt, bh = item / nkt;
    b = bh / Hk;
    hk = bh % Hk;
    k0 = kt * BW_K;
    const int nqt = (Tq + BQ - 1) / BQ;
    qt0 = causal ? max(0, k0 - (Tk - Tq)) / BQ : 0;
    nq = max(0, nqt - qt0);
    ntiles = G * nq;
  }
};

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  if constexpr (std::is_same<T, f16>::value)
    return __half22float2(*reinterpret_cast<__half2*>(&v));
  else
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale in place
// on this thread's accumulators of S^T and dP^T (rows: keys kr[0], kr[1];
// columns: queries q0 + 8 n + 2 qi (+1)); lse2 is lse log2(e), +inf for a
// row with no live key. MASK: zero where key j is past Tk, query i past
// Tq, or (causal) j > i + off.
template <bool MASK, int BQ>
__device__ __forceinline__ void bw_probs(float (&s)[BQ / 2],
                                         float (&dp)[BQ / 2],
                                         const float* lse2, const float* dlt,
                                         float scale, const int (&kr)[2],
                                         int q0, int Tq, int Tk, int off,
                                         int causal, int qi) {
  const float sl2 = scale * LOG2E;
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) {
    const int c = 8 * n + 2 * qi;
    const float2 l = *reinterpret_cast<const float2*>(lse2 + c);
    const float2 d = *reinterpret_cast<const float2*>(dlt + c);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int e = x & 1;
      float p = ex2(fmaf(s[4 * n + x], sl2, -(e ? l.y : l.x)));
      if (MASK) {
        const int i = q0 + c + e, j = kr[x / 2];
        if (!(j < Tk && i < Tq && (!causal || j <= i + off))) p = 0.f;
      }
      s[4 * n + x] = p;
      dp[4 * n + x] = p * (dp[4 * n + x] - (e ? d.y : d.x)) * scale;
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(BW_THREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ rows,
                       float* __restrict__ ws, T* __restrict__ dk,
                       T* __restrict__ dv, Strides sdk, Strides sdv, int B,
                       int H, int Hk, int Tq, int Tk, float scale,
                       int causal) {
  using L = BwSmem<D>;
  constexpr int BQ = L::BQ, NB = D / 64, S = BW_STAGES;
  constexpr int TKV = L::TKV, TQ = L::TQ, TDS = L::TDS;
  extern __shared__ __align__(1024) unsigned char bw_smem[];
  T* ks = reinterpret_cast<T*>(bw_smem + L::K);
  T* vs = reinterpret_cast<T*>(bw_smem + L::V);
  T* qring = reinterpret_cast<T*>(bw_smem + L::Q);
  T* doring = reinterpret_cast<T*>(bw_smem + L::DO);
  T* dss = reinterpret_cast<T*>(bw_smem + L::DS);
  float* dqs = reinterpret_cast<float*>(bw_smem + L::DQ);
  float* rring = reinterpret_cast<float*>(bw_smem + L::ROWS);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(bw_smem + L::BARS);
  uint64_t* kvempty = kvfull + 1;
  uint64_t* full = kvempty + 1;
  uint64_t* empty = full + S;
  const int G = H / Hk, off = Tk - Tq, nqt = (Tq + BQ - 1) / BQ;
  const int items = ((Tk + BW_K - 1) / BW_K) * B * Hk;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(kvfull);
    mbar_init(kvempty, 2);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s);
      mbar_init(empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    set_max_regs<24, false>();
    if (threadIdx.x != 0) return;
    int g = 0, n_it = 0;
    for (int r = 0; r * (int)gridDim.x < items; ++r) {
      if (ws_item(r) >= items) continue;
      const BwItem it(ws_item(r), Hk, G, Tq, Tk, causal, BQ);
      if (it.ntiles == 0) continue;
      mbar_wait(kvempty, (n_it & 1) ^ 1);
      mbar_expect(kvfull, 2 * TKV * sizeof(T));
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_box4(ks + nb * BW_K * 64, &tm_k, nb * 64, it.k0, it.hk, it.b,
                 kvfull);
        tma_box4(vs + nb * BW_K * 64, &tm_v, nb * 64, it.k0, it.hk, it.b,
                 kvfull);
      }
      for (int t = 0; t < it.ntiles; ++t, ++g) {
        const int h = it.hk * G + t / it.nq, qt = it.qt0 + t % it.nq;
        const int st = g % S;
        mbar_wait(empty + st, ((g / S) & 1) ^ 1);
        mbar_expect(full + st, 2 * TQ * sizeof(T) + 2 * BQ * sizeof(float));
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_box4(qring + st * TQ + nb * BQ * 64, &tm_q, nb * 64, qt * BQ,
                   h, it.b, full + st);
          tma_box4(doring + st * TQ + nb * BQ * 64, &tm_do, nb * 64,
                   qt * BQ, h, it.b, full + st);
        }
        bulk_load(rring + st * 2 * BQ,
                  rows + (((long long)it.b * H + h) * nqt + qt) * 2 * BQ,
                  2 * BQ * sizeof(float), full + st);
      }
      ++n_it;
    }
    return;
  }
  set_max_regs<240, true>();
  const int w = wg - 1;                       // keys 64 w .. of an item
  const int tid = threadIdx.x % 128, lane = tid % 32, qi = lane % 4;
  const int krow = 64 * w + 16 * (tid / 32) + lane / 4;   // and krow + 8
  const bool signal = tid == 0;
  // this consumer's 64 x 64 block of a dQ tile: rows m0, columns n0
  const int m0 = D == 64 ? 64 * w : 0, n0 = D == 64 ? 0 : 64 * w;
  float* dqb = dqs + w * BW_BLOCK;
  float dka[D / 2], dva[D / 2];
  int g = 0, n_it = 0;
  for (int r = 0; r * (int)gridDim.x < items; ++r) {
    if (ws_item(r) >= items) continue;
    const BwItem it(ws_item(r), Hk, G, Tq, Tk, causal, BQ);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    const int kr[2] = {it.k0 + krow, it.k0 + krow + 8};
    if (it.ntiles > 0) {
      mbar_wait(kvfull, n_it & 1);
      for (int t = 0; t < it.ntiles; ++t, ++g) {
        const int h = it.hk * G + t / it.nq, qt = it.qt0 + t % it.nq;
        const int q0 = qt * BQ, st = g % S;
        const T* qs = qring + st * TQ;
        const T* dos = doring + st * TQ;
        const float* lse2 = rring + st * 2 * BQ;
        T* dsb = dss + (g & 1) * TDS;
        mbar_wait(full + st, (g / S) & 1);
        // S^T = K Q^T and dP^T = V dO^T (this consumer's 64 keys)
        float s[BQ / 2], dp[BQ / 2];
        fence_regs(s);
        fence_regs(dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a = (kk / 4) * BW_K * 64 + w * 64 * 64 + (kk % 4) * 16;
          const int b = (kk / 4) * BQ * 64 + (kk % 4) * 16;
          wgmma_ss<0, T>(s, wg_desc(ks + a, 16, 1024),
                         wg_desc(qs + b, 16, 1024), kk > 0,
                         std::integral_constant<int, BQ>());
          wgmma_ss<0, T>(dp, wg_desc(vs + a, 16, 1024),
                         wg_desc(dos + b, 16, 1024), kk > 0,
                         std::integral_constant<int, BQ>());
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        const int kw0 = it.k0 + 64 * w;
        if (q0 + BQ > Tq || kw0 + 64 > Tk || (causal && kw0 + 63 > q0 + off))
          bw_probs<true, BQ>(s, dp, lse2, lse2 + BQ, scale, kr, q0, Tq, Tk,
                             off, causal, qi);
        else
          bw_probs<false, BQ>(s, dp, lse2, lse2 + BQ, scale, kr, q0, Tq, Tk,
                              off, causal, qi);
        // P^T (dO's dtype) and dS^T (Q's and K's) as A fragments; dS^T
        // into this consumer's rows of the shared buffer
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pa[kk][x] = pack2<T>(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
            da[kk][x] = pack2<T>(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
          }
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const int c = 8 * n + 2 * qi;
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            *reinterpret_cast<uint32_t*>(
                reinterpret_cast<unsigned char*>(dsb + (c / 64) * BW_K * 64) +
                swizzled(krow + 8 * hi, c % 64)) = da[n / 2][2 * (n % 2) + hi];
        }
        fence_async_smem();
        // dV += P^T dO, dK += dS^T Q
        fence_regs(dva);
        fence_regs(dka);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          fence_regs(pa[kk]);
          fence_regs(da[kk]);
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<1, T>(dva, pa[kk],
                         wg_desc(dos + kk * 16 * 64, BQ * 64 * 2, 1024), 1,
                         std::integral_constant<int, D>());
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<1, T>(dka, da[kk],
                         wg_desc(qs + kk * 16 * 64, BQ * 64 * 2, 1024), 1,
                         std::integral_constant<int, D>());
        wg_commit();
        // both consumers' dS^T in: dQ block = dS[m0 .., :] K[:, n0 ..]
        bar_sync<256>(1);
        float dq[32];
        fence_regs(dq);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BW_K / 16; ++kk)
          wgmma_ss<1, T, 1>(
              dq, wg_desc(dsb + (m0 / 64) * BW_K * 64 + kk * 16 * 64,
                          BW_K * 64 * 2, 1024),
              wg_desc(ks + (n0 / 64) * BW_K * 64 + kk * 16 * 64,
                      BW_K * 64 * 2, 1024),
              kk > 0, std::integral_constant<int, 64>());
        wg_commit();
        wg_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          fence_regs(pa[kk]);
          fence_regs(da[kk]);
        }
        if (signal) mbar_arrive(empty + st);   // Q, dO and rows read
        // the block into shared memory once the last reduce has read it,
        // then added into the workspace
        if (signal) bulk_wait<0, true>();
        bar_sync<128>(2 + w);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float4*>(dqb + (j * 128 + tid) * 4) =
              make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2],
                          dq[4 * j + 3]);
        fence_async_smem();
        bar_sync<128>(2 + w);
        if (signal) {
          bulk_reduce_add(
              ws + ((((long long)it.b * H + h) * nqt + qt) * 2 + w) *
                       BW_BLOCK,
              dqb, BW_BLOCK * sizeof(float));
          bulk_commit();
        }
      }
      if (signal) mbar_arrive(kvempty);        // K and V read
      ++n_it;
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      if (kr[hi] >= Tk) continue;
      T* pk = dk + it.b * sdk.b + it.hk * sdk.h + (long long)kr[hi] * sdk.t +
              2 * qi;
      T* pv = dv + it.b * sdv.b + it.hk * sdv.h + (long long)kr[hi] * sdv.t +
              2 * qi;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<uint32_t*>(pk + 8 * c) =
            pack2<T>(dka[4 * c + 2 * hi], dka[4 * c + 2 * hi + 1]);
        *reinterpret_cast<uint32_t*>(pv + 8 * c) =
            pack2<T>(dva[4 * c + 2 * hi], dva[4 * c + 2 * hi + 1]);
      }
    }
  }
  if (signal) bulk_wait<0, false>();
}

// D / 8 threads a row of the padded query range (B H nqt BQ rows), 16
// bytes of dO and of O each: delta = rowsum(dO O) - dlse and lse log2(e)
// (+inf where lse is not finite or the row is past Tq; delta 0 there)
// into the row buffer [B H nqt][2][BQ], and the row's D floats of the dQ
// workspace zeroed.
template <int D, typename T>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dlse,
                      float* __restrict__ rows, float* __restrict__ ws,
                      Strides so, Strides sdo, int H, int Tq,
                      long long n_rows) {
  constexpr int BQ = bw_rows<D>(), CH = D / 8;
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) / CH;
  const int ch = threadIdx.x % CH;
  if (row >= n_rows) return;         // whole rows: CH divides the warp
  const int nqt = (Tq + BQ - 1) / BQ, Tp = nqt * BQ;
  const int i = (int)(row % Tp);
  const long long bh = row / Tp;
  const int b = (int)(bh / H), h = (int)(bh % H);
  float dot = 0.f;
  if (i < Tq) {
    const uint4 a = *reinterpret_cast<const uint4*>(
        dout + b * sdo.b + h * sdo.h + (long long)i * sdo.t + 8 * ch);
    const uint4 c = *reinterpret_cast<const uint4*>(
        o + b * so.b + h * so.h + (long long)i * so.t + 8 * ch);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = unpack2<T>(av[e]), y = unpack2<T>(cv[e]);
      dot = fmaf(x.x, y.x, fmaf(x.y, y.y, dot));
    }
  }
#pragma unroll
  for (int m = CH / 2; m > 0; m /= 2)
    dot += __shfl_xor_sync(0xffffffffu, dot, m);
  float4* wr = reinterpret_cast<float4*>(ws + row * D + 8 * ch);
  wr[0] = wr[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ch == 0) {
    float* rr = rows + (bh * nqt + i / BQ) * 2 * BQ + i % BQ;
    float l2 = INFINITY, de = 0.f;
    if (i < Tq) {
      const float ls = lse[bh * Tq + i];
      l2 = isfinite(ls) ? ls * LOG2E : INFINITY;
      de = dot - (dlse ? dlse[bh * Tq + i] : 0.f);
    }
    rr[0] = l2;
    rr[BQ] = de;
  }
}

// dQ [B, H, Tq, D] (strided) from the workspace: one block a 64 x 64 dQ
// block. Its float4s are read in order (float4 j of consumer thread t
// holds accumulator elements 4 j .. 4 j + 3: rows r and r + 8, columns c
// and c + 1, r = 16 (t / 32) + (t % 32) / 4, c = 8 j + 2 (t % 4)) into
// shared memory as rows, which go out 16 bytes a thread.
template <int D, typename T>
__global__ void __launch_bounds__(256)
flash_bwd_cast_kernel(const float* __restrict__ ws, T* __restrict__ dq,
                      Strides sdq, int H, int Tq) {
  constexpr int BQ = bw_rows<D>(), LD = 64 + 4;
  __shared__ __align__(16) float tile[64 * LD];
  const int nqt = (Tq + BQ - 1) / BQ, nb = blockIdx.x % 2;
  const long long t_ = blockIdx.x / 2, bh = t_ / nqt;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const float4* src =
      reinterpret_cast<const float4*>(ws + (long long)blockIdx.x * BW_BLOCK);
  for (int e = threadIdx.x; e < BW_BLOCK / 4; e += 256) {
    const float4 x = src[e];
    const int j = e / 128, t = e % 128;
    const int r = 16 * (t / 32) + (t % 32) / 4, c = 8 * j + 2 * (t % 4);
    tile[r * LD + c] = x.x;
    tile[r * LD + c + 1] = x.y;
    tile[(r + 8) * LD + c] = x.z;
    tile[(r + 8) * LD + c + 1] = x.w;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 8; e += 256) {
    const int r = e / 8, ch = e % 8;
    const int row = (int)(t_ % nqt) * BQ + (D == 64 ? 64 * nb : 0) + r;
    if (row >= Tq) continue;
    const float* x = tile + r * LD + 8 * ch;
    const uint4 out = {pack2<T>(x[0], x[1]), pack2<T>(x[2], x[3]),
                       pack2<T>(x[4], x[5]), pack2<T>(x[6], x[7])};
    *reinterpret_cast<uint4*>(dq + b * sdq.b + h * sdq.h +
                              (long long)row * sdq.t +
                              (D == 64 ? 0 : 64 * nb) + 8 * ch) = out;
  }
}

// -------------------------------------------------------------- backward dq

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        T* __restrict__ dq, Strides sq, Strides sk,
                        Strides sv, Strides sdo, Strides sdq, int H, int Hk,
                        int Tq, int Tk, float scale, int causal) {
  constexpr int ND = D / 8, TE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);   // [buf][K, V][64][D+8]
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, qi = lane % 4;
  const int row[2] = {q0 + warp * 16 + quad, q0 + warp * 16 + quad + 8};
  int lim[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lim[i] = key_limit(row[i], Tq, Tk, causal);
    const long long at = ((long long)b * H + h) * Tq + row[i];
    lse_r[i] = row[i] < Tq ? lse[at] : -INFINITY;
    delta_r[i] = row[i] < Tq ? delta[at] : 0.f;
    if (!isfinite(lse_r[i])) lim[i] = 0;   // a row with no live key
  }
  const int kend = key_limit(min(q0 + BQ, Tq) - 1, Tq, Tk, causal);

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, row_at(q, sq, b, h, 0), sq.t, row, Tq, qi);
  load_a<D>(df, row_at(dout, sdo, b, h, 0), sdo.t, row, Tq, qi);
  const T* kb = row_at(k, sk, b, hk, 0);
  const T* vb = row_at(v, sv, b, hk, 0);

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  if (kend > 0) {
    stage_tile<D>(smem, kb, sk.t, 0, kend);
    stage_tile<D>(smem + TE, vb, sv.t, 0, kend);
    cp_async_commit();
  }
  for (int t0 = 0, it = 0; t0 < kend; t0 += BK, ++it) {
    const T* ks = smem + (it & 1) * 2 * TE;
    const T* vs = ks + TE;
    if (t0 + BK < kend) {
      T* nk = smem + ((it + 1) & 1) * 2 * TE;
      stage_tile<D>(nk, kb, sk.t, t0 + BK, kend);
      stage_tile<D>(nk + TE, vb, sv.t, t0 + BK, kend);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float sc[8][4], dp[8][4];
    mma_abt<D, T>(sc, qf, ks, lane);
    mma_abt<D, T>(dp, df, vs, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, j = t0 + nt * 8 + qi * 2 + (e & 1);
        const float p =
            j < lim[i] ? __expf(sc[nt][e] * scale - lse_r[i]) : 0.f;
        sc[nt][e] = p * (dp[nt][e] - delta_r[i]) * scale;      // ds
      }
    mma_pv<D, T>(acc, sc, ks, lane);                              // dq += ds.K
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + b * sdq.b + h * sdq.h, sdq.t, acc, row, Tq, one, qi);
}

// ------------------------------------------------------------- backward dkv

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv,
                         Strides sq, Strides sk, Strides sv, Strides sdo,
                         Strides sdk, Strides sdv, int H, int Hk, int Tq,
                         int Tk, float scale, int causal) {
  constexpr int ND = D / 8, TE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [buf][Q, dO][64][D+8] T, then [buf][lse, delta][64] fp32
  T* smem = reinterpret_cast<T*>(smem_raw);
  float* rows_s = reinterpret_cast<float*>(smem + 4 * TE);
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hk, off = Tk - Tq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, qi = lane % 4;
  const int key[2] = {k0 + warp * 16 + quad, k0 + warp * 16 + quad + 8};

  // K and V rows of this warp as A fragments (rows = keys)
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, row_at(k, sk, b, hk, 0), sk.t, key, Tk, qi);
  load_a<D>(vf, row_at(v, sv, b, hk, 0), sv.t, key, Tk, qi);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.f;

  // the (query head, query tile) pairs of this block, walked in order:
  // the query tiles from the first that sees key k0 (i + off >= k0)
  const int qt0 = (causal ? max(0, k0 - off) : 0) / BQ;
  const int nqt = (Tq + BQ - 1) / BQ - qt0;
  const int steps = g * nqt;
  // start the copies of pair `s` into buffer `buf`
  auto stage = [&](int s, int buf) {
    const int hh = hk * g + s / nqt, i0 = (qt0 + s % nqt) * BQ;
    const long long rbase = ((long long)b * H + hh) * Tq;
    T* t = smem + buf * 2 * TE;
    stage_tile<D>(t, row_at(q, sq, b, hh, 0), sq.t, i0, Tq);
    stage_tile<D>(t + TE, row_at(dout, sdo, b, hh, 0), sdo.t, i0, Tq);
    float* rs = rows_s + buf * 2 * BQ;
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool live = i0 + r < Tq;    // zeros past Tq (masked below)
      cp_async4(rs + r, lse + (live ? rbase + i0 + r : 0), live);
      cp_async4(rs + BQ + r, delta + (live ? rbase + i0 + r : 0), live);
    }
    cp_async_commit();
  };
  if (steps > 0) stage(0, 0);
  for (int s = 0; s < steps; ++s) {
    const int i0 = (qt0 + s % nqt) * BQ;
    const T* qs = smem + (s & 1) * 2 * TE;
    const T* dos = qs + TE;
    const float* lse_s = rows_s + (s & 1) * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    if (s + 1 < steps) {
      stage(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    {
      float st[8][4], dpt[8][4];        // S^T and dP^T: rows keys, cols q
      mma_abt<D, T>(st, kf, qs, lane);
      mma_abt<D, T>(dpt, vf, dos, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + qi * 2 + (e & 1), i = i0 + c;
          const int j = key[e / 2];
          const float ls = lse_s[c];
          const bool valid = j < Tk && i < Tq && isfinite(ls) &&
                             (!causal || j <= i + off);
          const float p = valid ? __expf(st[nt][e] * scale - ls) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - delta_s[c]) * scale;  // ds^T
        }
      mma_pv<D, T>(dva, st, dos, lane);                           // dV += P^T.dO
      mma_pv<D, T>(dka, dpt, qs, lane);                           // dK += dS^T.Q
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + b * sdk.b + hk * sdk.h, sdk.t, dka, key, Tk, one, qi);
  store_rows<D>(dv + b * sdv.b + hk * sdv.h, sdv.t, dva, key, Tk, one, qi);
}

// ------------------------------------------------- fp32 (parity oracle)

__device__ __forceinline__ const float* frow(const float* base, Strides s,
                                             int b, int h, int t) {
  return base + b * s.b + h * s.h + (long long)t * s.t;
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <int D>
__global__ void __launch_bounds__(F32_NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int B, int H, int Hk, int Tq,
                     int Tk, float scale, int causal) {
  const long long idx = (long long)blockIdx.x * F32_NT + threadIdx.x;
  if (idx >= (long long)B * H * Tq) return;
  const int i = idx % Tq, h = (idx / Tq) % H, b = idx / ((long long)Tq * H);
  const int hk = h / (H / Hk);
  const int lim = key_limit(i, Tq, Tk, causal);
  const float* qr = frow(q, sq, b, h, i);
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < lim; ++j) {
    const float s = dot<D>(qr, frow(k, sk, b, hk, j)) * scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new), p = expf(s - m_new);
    l = l * alpha + p;
    const float* vr = frow(v, sv, b, hk, j);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = acc[d] * alpha + p * vr[d];
    m = m_new;
  }
  float* orow = o + b * so.b + h * so.h + (long long)i * so.t;
  const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
  lse[idx] = l == 0.f ? -INFINITY : m + logf(l);
}

template <int D>
__global__ void __launch_bounds__(F32_NT)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Strides sq, Strides sk,
                        Strides sv, Strides sdo, Strides sdq, int B, int H,
                        int Hk, int Tq, int Tk, float scale, int causal) {
  const long long idx = (long long)blockIdx.x * F32_NT + threadIdx.x;
  if (idx >= (long long)B * H * Tq) return;
  const int i = idx % Tq, h = (idx / Tq) % H, b = idx / ((long long)Tq * H);
  const int hk = h / (H / Hk);
  const float ls = lse[idx], dl = delta[idx];
  const int lim = isfinite(ls) ? key_limit(i, Tq, Tk, causal) : 0;
  const float* qr = frow(q, sq, b, h, i);
  const float* dr = frow(dout, sdo, b, h, i);
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int j = 0; j < lim; ++j) {
    const float* kr = frow(k, sk, b, hk, j);
    const float p = expf(dot<D>(qr, kr) * scale - ls);
    const float ds = p * (dot<D>(dr, frow(v, sv, b, hk, j)) - dl) * scale;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
  }
  float* out = dq + b * sdq.b + h * sdq.h + (long long)i * sdq.t;
#pragma unroll
  for (int d = 0; d < D; ++d) out[d] = acc[d];
}

template <int D>
__global__ void __launch_bounds__(F32_NT)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Strides sq, Strides sk, Strides sv, Strides sdo,
                         Strides sdk, Strides sdv, int B, int H, int Hk,
                         int Tq, int Tk, float scale, int causal) {
  const long long idx = (long long)blockIdx.x * F32_NT + threadIdx.x;
  if (idx >= (long long)B * Hk * Tk) return;
  const int j = idx % Tk, hk = (idx / Tk) % Hk, b = idx / ((long long)Tk * Hk);
  const int g = H / Hk;
  const int istart = causal ? max(0, j - (Tk - Tq)) : 0;
  const float* kr = frow(k, sk, b, hk, j);
  const float* vr = frow(v, sv, b, hk, j);
  float dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
  for (int hh = hk * g; hh < (hk + 1) * g; ++hh) {
    for (int i = istart; i < Tq; ++i) {
      const long long r = ((long long)b * H + hh) * Tq + i;
      const float ls = lse[r];
      if (!isfinite(ls)) continue;
      const float* qr = frow(q, sq, b, hh, i);
      const float* dr = frow(dout, sdo, b, hh, i);
      const float p = expf(dot<D>(qr, kr) * scale - ls);
      const float ds = p * (dot<D>(dr, vr) - delta[r]) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dva[d] = fmaf(p, dr[d], dva[d]);
        dka[d] = fmaf(ds, qr[d], dka[d]);
      }
    }
  }
  float* ok = dk + b * sdk.b + hk * sdk.h + (long long)j * sdk.t;
  float* ov = dv + b * sdv.b + hk * sdv.h + (long long)j * sdv.t;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ok[d] = dka[d];
    ov[d] = dva[d];
  }
}

// ------------------------------------------------------------ dispatch

// the element type of a launch: the C entry points' `dtype` argument
enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

struct Dims {
  int B, H, Hk, Tq, Tk, D;
  float scale;
  int causal;
};

bool dims_ok(const Dims& d, int dtype) {
  return d.B > 0 && d.H > 0 && d.Hk > 0 && d.H % d.Hk == 0 && d.Tq > 0 &&
         d.Tk > 0 && (d.D == 16 || d.D == 32 || d.D == 64 || d.D == 128) &&
         d.B <= 65535 && d.H <= 65535 && dtype >= F32 && dtype <= F16;
}

// the mma kernels load 16 bytes per row chunk: every row must start on a
// 16-byte boundary (base pointers, and strides in multiples of 8 elements)
bool aligned(const void* const* ptrs, int np, const long long* strides,
             int ns) {
  for (int i = 0; i < np; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  for (int i = 0; i < ns; ++i)
    if (strides[i] % 8) return false;
  return true;
}

Strides st(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + F32_NT - 1) / F32_NT);
}

template <int D, typename T>
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* o,
                    void* lse, const long long* s, const Dims& d,
                    cudaStream_t stream) {
  dim3 grid((d.Tq + BQ - 1) / BQ, d.H, d.B);
  constexpr size_t smem = mma_smem_bytes<D>(false);
  cudaError_t err = smem_opt_in(flash_fwd_mma_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_mma_kernel<D, T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, st(s, 0),
      st(s, 1), st(s, 2), st(s, 3), d.H, d.Hk, d.Tq, d.Tk, d.scale,
      d.causal);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                      void* lse, const long long* s, const Dims& d,
                      cudaStream_t stream) {
  constexpr int rows = 64 * ws_consumers<D>();
  CUtensorMap tq, tk, tv;
  cudaError_t err = bhtd_map<T>(&tq, q, st(s, 0), d.B, d.H, d.Tq, D, rows);
  if (err == cudaSuccess)
    err = bhtd_map<T>(&tk, k, st(s, 1), d.B, d.Hk, d.Tk, D, WS_K);
  if (err == cudaSuccess)
    err = bhtd_map<T>(&tv, v, st(s, 2), d.B, d.Hk, d.Tk, D, WS_K);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = ws_smem_bytes<D>();
  constexpr unsigned threads = ws_threads<D>();
  int per_sm = 0;
  err = blocks_per_sm(reinterpret_cast<const void*>(
                          flash_fwd_wgmma_kernel<D, T>),
                      threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = (long long)((d.Tq + rows - 1) / rows) * d.B * d.H;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long cap = (long long)sms * per_sm;   // one wave, persistent
  const unsigned grid = (unsigned)(items < cap ? items : cap);
  flash_fwd_wgmma_kernel<D, T><<<grid, threads, smem, stream>>>(
      tq, tk, tv, (T*)o, (float*)lse, st(s, 3), d.B, d.H, d.Hk, d.Tq, d.Tk,
      d.scale, d.causal);
  return cudaGetLastError();
}

// bf16 and fp16 at D = 64 and 128 run the wgmma kernel; at D = 16 and 32
// (GPT2Config.tiny's shapes, untimed) the mma.sync one.
template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const long long* s, const Dims& d, int dtype,
                cudaStream_t stream) {
  if constexpr (D >= 64) {
    if (dtype == BF16)
      return fwd_wgmma<D, bf16>(q, k, v, o, lse, s, d, stream);
    if (dtype == F16) return fwd_wgmma<D, f16>(q, k, v, o, lse, s, d, stream);
  } else {
    if (dtype == BF16) return fwd_mma<D, bf16>(q, k, v, o, lse, s, d, stream);
    if (dtype == F16) return fwd_mma<D, f16>(q, k, v, o, lse, s, d, stream);
  }
  flash_fwd_f32_kernel<D><<<blocks_for((long long)d.B * d.H * d.Tq), F32_NT,
                            0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, st(s, 0), st(s, 1), st(s, 2), st(s, 3), d.B, d.H, d.Hk,
      d.Tq, d.Tk, d.scale, d.causal);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t bwd_dq_mma(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, const long long* s, const Dims& d,
                       cudaStream_t stream) {
  dim3 grid((d.Tq + BQ - 1) / BQ, d.H, d.B);
  constexpr size_t smem = mma_smem_bytes<D>(false);
  cudaError_t err = smem_opt_in(flash_bwd_dq_mma_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma_kernel<D, T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, st(s, 0), st(s, 1),
      st(s, 2), st(s, 3), st(s, 4), d.H, d.Hk, d.Tq, d.Tk, d.scale,
      d.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const long long* s, const Dims& d, int dtype,
                   cudaStream_t stream) {
  if constexpr (D < 64) {
    if (dtype == BF16)
      return bwd_dq_mma<D, bf16>(q, k, v, dout, lse, delta, dq, s, d, stream);
    if (dtype == F16)
      return bwd_dq_mma<D, f16>(q, k, v, dout, lse, delta, dq, s, d, stream);
  } else if (dtype != F32) {
    return cudaErrorInvalidValue;          // flash_bwd_launch's wgmma kernel
  }
  flash_bwd_dq_f32_kernel<D><<<blocks_for((long long)d.B * d.H * d.Tq),
                               F32_NT, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, st(s, 0), st(s, 1),
      st(s, 2), st(s, 3), st(s, 4), d.B, d.H, d.Hk, d.Tq, d.Tk, d.scale,
      d.causal);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t bwd_dkv_mma(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, const long long* s, const Dims& d,
                        cudaStream_t stream) {
  dim3 grid((d.Tk + BK - 1) / BK, d.Hk, d.B);
  constexpr size_t smem = mma_smem_bytes<D>(true);
  cudaError_t err = smem_opt_in(flash_bwd_dkv_mma_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_mma_kernel<D, T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, st(s, 0),
      st(s, 1), st(s, 2), st(s, 3), st(s, 4), st(s, 5), d.H, d.Hk, d.Tq,
      d.Tk, d.scale, d.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const long long* s, const Dims& d,
                    int dtype, cudaStream_t stream) {
  if constexpr (D < 64) {
    if (dtype == BF16)
      return bwd_dkv_mma<D, bf16>(q, k, v, dout, lse, delta, dk, dv, s, d,
                                  stream);
    if (dtype == F16)
      return bwd_dkv_mma<D, f16>(q, k, v, dout, lse, delta, dk, dv, s, d,
                                 stream);
  } else if (dtype != F32) {
    return cudaErrorInvalidValue;          // flash_bwd_launch's wgmma kernel
  }
  flash_bwd_dkv_f32_kernel<D><<<blocks_for((long long)d.B * d.Hk * d.Tk),
                                F32_NT, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv,
      st(s, 0), st(s, 1), st(s, 2), st(s, 3), st(s, 4), st(s, 5), d.B, d.H,
      d.Hk, d.Tq, d.Tk, d.scale, d.causal);
  return cudaGetLastError();
}

// The backward at D = 64 and 128 in bf16 / fp16: the prep pass, the main
// kernel on a persistent grid, the cast of dQ, on `stream` in that order.
// ws: the dQ workspace (B H nqt BQ D fp32), rows: B H nqt 2 BQ fp32.
template <int D, typename T>
cudaError_t bwd_wgmma(const void* q, const void* k, const void* v,
                      const void* dout, const void* o, const void* lse,
                      const void* dlse, void* dq, void* dk, void* dv,
                      void* ws, void* rows, const long long* s,
                      const Dims& d, cudaStream_t stream) {
  constexpr int BQ = bw_rows<D>();
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bhtd_map<T>(&tq, q, st(s, 0), d.B, d.H, d.Tq, D, BQ);
  if (err == cudaSuccess)
    err = bhtd_map<T>(&tk, k, st(s, 1), d.B, d.Hk, d.Tk, D, BW_K);
  if (err == cudaSuccess)
    err = bhtd_map<T>(&tv, v, st(s, 2), d.B, d.Hk, d.Tk, D, BW_K);
  if (err == cudaSuccess)
    err = bhtd_map<T>(&tdo, dout, st(s, 3), d.B, d.H, d.Tq, D, BQ);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = BwSmem<D>::BYTES;
  int per_sm = 0;
  err = blocks_per_sm(reinterpret_cast<const void*>(
                          flash_bwd_wgmma_kernel<D, T>),
                      BW_THREADS, smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items =
      (long long)((d.Tk + BW_K - 1) / BW_K) * d.B * d.Hk;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long n_rows =
      (long long)d.B * d.H * ((d.Tq + BQ - 1) / BQ) * BQ;
  flash_bwd_prep_kernel<D, T><<<(unsigned)((n_rows * (D / 8) + 255) / 256),
                                 256, 0, stream>>>(
      (const T*)o, (const T*)dout, (const float*)lse, (const float*)dlse,
      (float*)rows, (float*)ws, st(s, 4), st(s, 3), d.H, d.Tq, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long cap = (long long)sms * per_sm;   // one wave, persistent
  flash_bwd_wgmma_kernel<D, T>
      <<<(unsigned)(items < cap ? items : cap), BW_THREADS, smem, stream>>>(
          tq, tk, tv, tdo, (const float*)rows, (float*)ws, (T*)dk, (T*)dv,
          st(s, 6), st(s, 7), d.B, d.H, d.Hk, d.Tq, d.Tk, d.scale, d.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_cast_kernel<D, T><<<(unsigned)(n_rows * D / BW_BLOCK), 256, 0,
                                 stream>>>((const float*)ws, (T*)dq,
                                           st(s, 5), d.H, d.Tq);
  return cudaGetLastError();
}

// fn<D>(args...) for the head dim of the launch (dims_ok has checked it)
#define BY_HEAD_DIM(D, fn, ...)                                 \
  ((D) == 16   ? fn<16>(__VA_ARGS__)                           \
   : (D) == 32 ? fn<32>(__VA_ARGS__)                           \
   : (D) == 64 ? fn<64>(__VA_ARGS__)                           \
               : fn<128>(__VA_ARGS__))

}  // namespace

extern "C" {

// q [B, H, Tq, D], k / v [B, Hk, Tk, D], o like q (element strides of
// batch, head and time for q, k, v, o in `strides[12]`); lse [B, H, Tq]
// fp32 contiguous. dtype: 0 fp32, 1 bf16, 2 fp16.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     void* lse, const long long* strides, int B, int H,
                     int Hk, int Tq, int Tk, int D, float scale, int causal,
                     int dtype, void* stream) {
  const Dims d{B, H, Hk, Tq, Tk, D, scale, causal};
  const void* ptrs[4] = {q, k, v, o};
  if (!dims_ok(d, dtype)) return (int)cudaErrorInvalidValue;
  // the wgmma kernel's TMA maps check their own (16-byte base and strides
  // of the dims that address data)
  if (dtype != F32 && D < 64 && !aligned(ptrs, 4, strides, 12))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)BY_HEAD_DIM(D, fwd, q, k, v, o, lse, strides, d, dtype, s);
}

// + dout like q, delta like lse, dq like q (strides of q, k, v, dout, dq in
// `strides[15]`)
int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, const long long* strides, int B, int H,
                        int Hk, int Tq, int Tk, int D, float scale,
                        int causal, int dtype, void* stream) {
  const Dims d{B, H, Hk, Tq, Tk, D, scale, causal};
  const void* ptrs[5] = {q, k, v, dout, dq};
  if (!dims_ok(d, dtype)) return (int)cudaErrorInvalidValue;
  if (dtype != F32 && !aligned(ptrs, 5, strides, 15))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)BY_HEAD_DIM(D, bwd_dq, q, k, v, dout, lse, delta, dq, strides,
                          d, dtype, s);
}

// + dk / dv like k (strides of q, k, v, dout, dk, dv in `strides[18]`)
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, const long long* strides, int B,
                         int H, int Hk, int Tq, int Tk, int D, float scale,
                         int causal, int dtype, void* stream) {
  const Dims d{B, H, Hk, Tq, Tk, D, scale, causal};
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  if (!dims_ok(d, dtype)) return (int)cudaErrorInvalidValue;
  if (dtype != F32 && !aligned(ptrs, 6, strides, 18))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)BY_HEAD_DIM(D, bwd_dkv, q, k, v, dout, lse, delta, dk, dv,
                          strides, d, dtype, s);
}

// The backward at D = 64 and 128, bf16 or fp16 (flash_bwd_wgmma_kernel
// and its two passes): q [B, H, Tq, D], k / v [B, Hk, Tk, D], dout, o and
// dq like q, dk / dv like k (element strides of batch, head and time of
// q, k, v, dout, o, dq, dk, dv in `strides[24]`); lse [B, H, Tq] fp32
// contiguous, dlse like lse or null; ws and rows the workspaces
// (flash_attention.bwd_workspace_floats).
int flash_bwd_launch(const void* q, const void* k, const void* v,
                     const void* dout, const void* o, const void* lse,
                     const void* dlse, void* dq, void* dk, void* dv, void* ws,
                     void* rows, const long long* strides, int B, int H,
                     int Hk, int Tq, int Tk, int D, float scale, int causal,
                     int dtype, void* stream) {
  const Dims d{B, H, Hk, Tq, Tk, D, scale, causal};
  const void* ptrs[4] = {o, dq, dk, dv};
  const long long out_strides[12] = {
      strides[12], strides[13], strides[14], strides[15], strides[16],
      strides[17], strides[18], strides[19], strides[20], strides[21],
      strides[22], strides[23]};
  if (!dims_ok(d, dtype) || dtype == F32 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  // q, k, v, dout: the TMA maps check theirs; o, dq, dk, dv are read and
  // written in 4-byte pairs
  if (!aligned(ptrs, 4, out_strides, 12))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)(dtype == BF16
                     ? bwd_wgmma<64, bf16>(q, k, v, dout, o, lse, dlse, dq,
                                           dk, dv, ws, rows, strides, d, s)
                     : bwd_wgmma<64, f16>(q, k, v, dout, o, lse, dlse, dq,
                                          dk, dv, ws, rows, strides, d, s));
  return (int)(dtype == BF16
                   ? bwd_wgmma<128, bf16>(q, k, v, dout, o, lse, dlse, dq,
                                          dk, dv, ws, rows, strides, d, s)
                   : bwd_wgmma<128, f16>(q, k, v, dout, o, lse, dlse, dq, dk,
                                         dv, ws, rows, strides, d, s));
}

}  // extern "C"
