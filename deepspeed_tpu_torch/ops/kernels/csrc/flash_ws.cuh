// The consumer side of the port's persistent wgmma attention forwards
// (flash_attention.cu's flash_fwd_wgmma_kernel, sparse_attention.cu's
// sparse_fwd_wgmma_kernel), shared so that both walk their K/V tiles the
// same way:
//
//   WS_K        keys of a K/V tile (128)
//   ws_softmax  the online softmax of one [64 x 128] fp32 score tile in
//               registers (ex2 on the MUFU, the scale folded into the
//               exponent's multiplier when it is positive)
//   WsState     one consumer warpgroup's walk over an item's tiles: S =
//               Q K^T on m64n128k16 wgmma from shared memory, O += P V on
//               m64nDk16 wgmma with P as register A fragments, K/V ring
//               buffers on full / empty mbarriers, the consumers taking
//               turns on the tensor cores (named barriers 1..NC)
//   bhtd_map    (host) a 4-D TMA map over a [B, H, T, D] view
//
// Each kernel keeps its own producer and its own order of items: the flash
// forward walks a causal range of tiles, the block-sparse one the live
// tiles of a CSR list.
#pragma once
#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

constexpr int WS_K = 128;            // keys of a K/V tile

// Softmax of one [64 x 128] score tile in place (this thread's two rows,
// 32 columns each) at keys [k0, +128): scale, the mask (MASK: key j of row
// i is live iff j < lim[i]), the running max m and sum l (this thread's
// columns), the probabilities left in sc, and alpha, the factor that
// rescales O to the new max. POS: scale > 0, so the row max of the scaled
// scores is the scaled max of the raw ones and the scale folds into the
// exponent's multiplier (one multiply an element fewer).
template <bool MASK, bool POS>
__device__ __forceinline__ void ws_softmax(float (&sc)[64], int k0,
                                           const int (&lim)[2], float scale,
                                           float (&m)[2], float (&l)[2],
                                           float (&alpha)[2], int qi) {
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float v = POS ? sc[4 * n + x] : sc[4 * n + x] * scale;
      if (MASK && k0 + n * 8 + qi * 2 + (x & 1) >= lim[x / 2]) v = -INFINITY;
      sc[4 * n + x] = v;
      mx[x / 2][x & 1] = fmaxf(mx[x / 2][x & 1], v);
    }
  float m_neg[2];
  const float mul = POS ? scale * LOG2E : LOG2E;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mr = fmaxf(mx[i][0], mx[i][1]);
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    if (POS) mr *= scale;
    const float m_new = fmaxf(m[i], mr);
    // a row with nothing live yet keeps m = -inf: exp through a finite
    // stand-in so no (-inf) - (-inf) NaN appears; p and alpha come out 0
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    alpha[i] = ex2((m[i] - m_safe) * LOG2E);
    m[i] = m_new;
    m_neg[i] = -m_safe * LOG2E;
  }
  float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float p = ex2(fmaf(sc[4 * n + x], mul, m_neg[x / 2]));
      sc[4 * n + x] = p;
      rs[x / 2][x & 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = l[i] * alpha[i] + (rs[i][0] + rs[i][1]);
}

// What one consumer warpgroup carries from tile to tile. Tiles are
// counted over the block's whole walk (kbase: the K/V tiles of the work
// items before this one), which picks each tile's ring buffer and phase.
// NC consumer warpgroups of 64 query rows each, K/V rings of S buffers.
// A tile is named twice: by its place t in the item's walk (its ring
// buffer) and by its first key k0 (its mask).
template <int D, typename T, int NC_, int S_>
struct WsState {
  static constexpr int S = S_, NC = NC_;
  static constexpr int BOX = WS_K * 64, TKV = WS_K * D;   // elements
  static constexpr int QBOX = 64 * NC * 64;
  const T *qa, *kring, *vring;
  uint64_t *kfull, *vfull, *kempty, *vempty;
  int lim[2], live_all, qi, cw, kbase;
  float scale;
  float sc[64], acc[D / 2], m[2], l[2], alpha[2];
  uint32_t pa[8][4];
  bool signal;

  // The consumers take turns on the tensor cores, in the order of cw
  // (named barrier 1 + cw: its turn): one issues its products while the
  // others run their softmax. The last consumer opens each work item's
  // first round and passes its last turn of the item to no one, so the
  // turns balance within the item.
  __device__ __forceinline__ void turn() { bar_sync<256>(1 + cw); }
  __device__ __forceinline__ void pass() {
    bar_arrive<256>(1 + (cw + 1) % NC);
  }

  __device__ __forceinline__ void wait_k(int t) {
    const int g = kbase + t;
    mbar_wait(kfull + g % S, (g / S) & 1);
  }
  __device__ __forceinline__ void wait_v(int t) {
    const int g = kbase + t;
    mbar_wait(vfull + g % S, (g / S) & 1);
  }
  // issue S = Q K_t^T into sc, committed
  __device__ __forceinline__ void scores(int t) {
    const T* ks = kring + ((kbase + t) % S) * TKV;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, T>(sc, wg_desc(qa + (kk / 4) * QBOX + (kk % 4) * 16, 16,
                                 1024),
                     wg_desc(ks + (kk / 4) * BOX + (kk % 4) * 16, 16, 1024),
                     kk > 0, std::integral_constant<int, WS_K>());
    wg_commit();
  }
  // O rescaled by the last softmax's alpha, then O += P V_t issued,
  // committed
  __device__ __forceinline__ void pv(int t) {
    const T* vs = vring + ((kbase + t) % S) * TKV;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[4 * n + x] *= alpha[x / 2];
    wait_v(t);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WS_K / 16; ++kk)
      wgmma_rs<1, T>(acc, pa[kk], wg_desc(vs + kk * 16 * 64, BOX * 2, 1024),
                     1, std::integral_constant<int, D>());
    wg_commit();
  }
  __device__ __forceinline__ void softmax(int k0) {
    const bool mask = k0 + WS_K > live_all;
    if (scale > 0.f) {
      if (mask)
        ws_softmax<true, true>(sc, k0, lim, scale, m, l, alpha, qi);
      else
        ws_softmax<false, true>(sc, k0, lim, scale, m, l, alpha, qi);
    } else {
      if (mask)
        ws_softmax<true, false>(sc, k0, lim, scale, m, l, alpha, qi);
      else
        ws_softmax<false, false>(sc, k0, lim, scale, m, l, alpha, qi);
    }
  }
  // the probabilities as T pairs in the A fragments of the P V product;
  // the sums above were taken before this cast to V's dtype
  __device__ __forceinline__ void pack_p() {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }
  __device__ __forceinline__ void free_k(int t) {
    if (signal) mbar_arrive(kempty + (kbase + t) % S);
  }
  __device__ __forceinline__ void free_v(int t) {
    if (signal) mbar_arrive(vempty + (kbase + t) % S);
  }
  // tile 0 (first key k0): S_0 and its softmax
  __device__ __forceinline__ void first(int k0) {
    if (cw == NC - 1) bar_arrive<256>(1);      // opens the item's round
    wait_k(0);
    turn();
    scores(0);
    pass();
    wg_wait<0>();
    fence_regs(sc);
    free_k(0);
    softmax(k0);
    pack_p();
  }
  // tile t (>= 1, first key k0): S_t and P V_{t-1} on the tensor cores
  // together, S_t's softmax under P V_{t-1}
  __device__ __forceinline__ void step(int t, int k0) {
    wait_k(t);
    turn();
    scores(t);
    pv(t - 1);
    pass();
    wg_wait<1>();                             // S_t done
    fence_regs(sc);
    free_k(t);
    softmax(k0);
    wg_wait<0>();                             // P V_{t-1} done
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
    free_v(t - 1);
    pack_p();
  }
  // the last tile's P V
  __device__ __forceinline__ void last(int t) {
    turn();
    pv(t);
    if (cw != NC - 1) pass();
    wg_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
    free_v(t);
  }
};

// ------------------------------------------------------------------ host

// A 4-D TMA map over a [B, Hx, T, D] view with element strides `s` of
// (batch, head, time), boxes of `rows` rows x 64 columns, 128-byte
// swizzle. A dim of extent 1 takes a packed stride (its own is never
// used), so only the strides that address data need to be 16-byte
// multiples.
template <typename T>
cudaError_t bhtd_map(CUtensorMap* map, const void* base, Strides s, int B,
                     int Hx, int T_, int D, int rows) {
  const long long st_ = T_ > 1 ? s.t : D;
  const long long sh = Hx > 1 ? s.h : st_ * T_;
  const long long sb = B > 1 ? s.b : sh * Hx;
  if (reinterpret_cast<uintptr_t>(base) % 16 || st_ % 8 || sh % 8 || sb % 8)
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T_, (cuuint64_t)Hx,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st_ * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return encode_tensor_map(map,
                           std::is_same<T, f16>::value
                               ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                           4, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
