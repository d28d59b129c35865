// Paged-KV flash attention for Hopper (sm_90a): the two kernels of the
// ragged serving path, reading K/V straight through per-sequence block
// tables.
//
// K1 paged_prefill replaces the Pallas kernel `_paged_kernel`
//   (deepspeed_tpu/ops/kernels/paged_attention.py:45, launched at :938).
//   It serves SplitFuse prefill chunks (C > 1 queries per slot).
//   Bound on the H100: bytes at the served shapes (Llama-2-7B's prefill
//   step, 64 slots x 512 queries over 512 keys of 32 KV heads of 128:
//   0.3205 ms of q, K, V and o at 3.35 TB/s, against 0.14 ms of tensor
//   work) or the tensor cores (TinyLlama's second chunk, GQA 8: 4*D FLOPs
//   a (query, key) pair against K/V shared by 8 heads). The first port
//   (one block of 4 warps per (slot, 64 queries, head), synchronous
//   loads, mma.sync) re-read every K/V tile per query tile and head from
//   L2 with no overlap of loads and products: 1.61-1.64 ms at the 7B
//   shape, 1.8x SDPA. So bf16 at head dims 64 and 128 (C >= 64) runs
//   paged_prefill_wgmma_kernel (its section below): persistent blocks
//   dealt items (slot, head, 128 queries), a head's query tiles side by
//   side so that its K/V is read from L2 after the first, K/V through the
//   block table by TMA (or a cp.async gather) into rings a producer warp
//   group fills while two consumer warpgroups run both products on wgmma.
//   paged_prefill_mma_kernel (4 warps per (slot, 64-query tile, head),
//   mma.sync m16n8k16 with K's and V's fragments by ldmatrix) keeps head
//   dims 16, 32, 80 and 96 and chunks of fewer than 64 queries; fp32 (the
//   parity oracle) takes paged_attn_kernel on the CUDA cores. The route
//   is the wrapper's, from the shapes alone (`prefill_route`). Every
//   kernel's key loop covers [lo, hi) of its rows (causal end, sequence
//   length and sliding window), never a dead or padded table entry.
//   Head dims 16, 32, 64, 80, 96, 128 and 256 are instantiated (the tiny
//   test config's 16, TinyLlama's 64, phi-2's 80, phi3's and GPT-NeoX-20B's
//   96, Llama's 128, GPT-J-6B's 256). At 256 the mma.sync kernels keep Q in
//   shared memory and load its fragments by ldmatrix a k-step (QFrags):
//   held in registers, Q's 64 beside the output's 128 fp32 accumulators
//   would pass the 255 registers a thread may hold. Their tiles take
//   dynamic shared memory (K1: 99.5 KiB at 256; K2: two ring stages, 140
//   KiB with Q's tile, 143 KiB over an int8 pool).
//   bf16 and fp16 run the tensor-core kernels; an int8 pool runs
//   paged_prefill_mma_kernel in either (fp32: paged_attn_kernel).
//
// K2 paged_decode replaces the Pallas kernel `_decode_grouped_kernel`
//   (paged_attention.py:205, launched at :615). One query per sequence.
//   Bound on the H100: the bytes of the live K/V rows. Decode attention
//   does 4*D FLOPs per 4*D bytes of bf16 K/V per head group, far below the
//   ridge: at Llama-2-7B's decode (64 sequences at context 576, 32 KV
//   heads of 128) the live K/V is 0.6 GB, 0.1806 ms at 3.35 TB/s. So the
//   design is about keeping bytes in flight on every SM, as
//   flash-decoding: paged_decode_split_kernel takes one block of 4 warps
//   per (sequence, KV head, chunk of <= 16 of its query heads, split of
//   the context), so a short batch still fills the card (the split count
//   comes from the shapes alone, `decode_plan` in paged_attention.py; no
//   host read of seq_lens). K and V stream as stored (bf16, fp16, or int8
//   at half the bytes, with their scales) into a ring of 2 to 4
//   shared-memory stages by 16-byte cp.async, one block-table read per
//   staged row, one __syncthreads a 64-key tile (two over an int8 pool,
//   whose tiles widen into a compute-dtype tile first). Both products run on
//   mma.sync m16n8k16: the group's query heads, padded to 16 rows, are the
//   A fragment held in registers for the whole range, K arrives through
//   ldmatrix as B and V through ldmatrix.trans (the padding costs tensor-
//   core work only, which the byte bound leaves idle). Each warp takes 16
//   keys of a tile with its own online softmax in registers; the four
//   warps merge at the end in warp order. One split writes the bf16 output;
//   several write fp32 partials (o, m, l), and the last split of each
//   (sequence, KV head, head chunk) to arrive, counted by an atomic,
//   merges them in split order (deterministic, one launch). A split wholly
//   outside the live range skips the key loop (m = -inf, l = 0).
//   fp32 K2 (the parity oracle) runs paged_attn_kernel on the CUDA cores.
//
// Both: online softmax in fp32 with the -inf guards of the Pallas kernels
// (a row with no live key emits zeros, never NaN), K/V tiles staged in
// shared memory, products accumulated in fp32. The compute dtype is bf16,
// fp16 or fp32 (q, out, and P's cast before P.V; the row sums are taken
// before that cast). The pool holds rows of the compute dtype, or int8
// rows with per-(token, KV head) f32 scales ([KV, slots], so a tile's
// scales are KV-major runs, one contiguous read a KV head): the codes
// widen to the compute dtype as they are staged (|code| <= 127 is exact in
// bf16 and fp16; ldmatrix and TMA cannot convert), the K scale multiplies
// score column j after Q.K^T, and the V scale multiplies probability
// column j after the row sum and before the cast, as the Pallas kernels
// do. ALiBi is one FMA a score before the mask: score -= slope[h] * (pos -
// j). An int8 pool at head dims 64 and 128 takes K1's mma.sync kernel
// (TMA cannot widen; `prefill_route`).
// K2's ring round: the JAX package's fused decode loop keeps its own K/V
// in a ring of compute-dtype rows that it attends unquantized and
// quantizes only when it flushes (the port's decode loop does the same
// over an int8 pool). The ring is one more split of K2 (its last), whose
// rows r < ring_count sit ring_count - 1 - r behind the query; its
// partial merges in split order with the pool's, so results stay
// bit-identical from call to call. The fp32 kernel attends the ring after
// the pool in the same block.
// Kernels launch on the caller's stream, do not synchronise and allocate
// nothing; each C entry point returns cudaGetLastError().
//
// TPU-only devices of the Pallas kernels are not carried over: lane-
// windowed GQA, the G-sequence grouped DMA and its contiguity check, the
// VMEM-budgeted tile sizes, the pool_full / layer-index scalar prefetch,
// and the Mosaic int8 alignment rules (KV*D and block sizes that are
// multiples of 128).

#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

constexpr int CC_NT = 256;         // threads per block of the fp32 kernel
constexpr int PF_ROWS = 32;        // K1: queries per block
constexpr int PF_TK = 32;          // K1: keys per tile
constexpr int DEC_ROWS = 16;       // K2 fp32: query heads of a block
constexpr int DEC_TK = 64;         // K2 fp32: keys per tile

// What a call adds to the plain pool: an int8 pool's scales ([KV, slots]
// f32, nullptr otherwise), ALiBi slopes ([H] f32 or nullptr).
struct Extras {
  const float* k_scales;
  const float* v_scales;
  const float* alibi;
  int slots;
};

// the decode loop's ring: rows [R][S][KV * D] of the compute dtype,
// `stride` elements apart, `count` of them valid (k == nullptr: none)
template <typename T>
struct Ring {
  const T* k;
  const T* v;
  long long stride;
  int count;
};

// a staged element as fp32 (the CUDA-core kernel: fp32 rows or int8 codes)
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// 16 int8 codes as 16 values of T in two 16-byte vectors (exact)
template <typename T>
__device__ __forceinline__ void widen16(uint4 c, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b0 = (int)(w[i] << 24) >> 24, b1 = (int)(w[i] << 16) >> 24;
    const int b2 = (int)(w[i] << 8) >> 24, b3 = (int)w[i] >> 24;
    r[2 * i] = pack2<T>((float)b0, (float)b1);
    r[2 * i + 1] = pack2<T>((float)b2, (float)b3);
  }
  lo = make_uint4(r[0], r[1], r[2], r[3]);
  hi = make_uint4(r[4], r[5], r[6], r[7]);
}

template <typename T>
__device__ __forceinline__ T to_t(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half to_t<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Q's A fragments (m16n8k16) of the 16 query rows a warp multiplies. Up
// to head dim 128 they sit in registers, KS x 4 of them, held for the whole
// key range. At 256 those 64 registers beside the output's 128 fp32
// accumulators would pass the 255 a thread may hold, so Q stays in a
// [16][D + 8] shared tile of T and each k-step's fragment comes by
// ldmatrix (`tile` is this lane's ldmatrix row; rows past the live ones
// hold zeros).
template <int D, typename T>
struct QFrags {
  static constexpr bool SMEM = D > 128;
  uint32_t r[SMEM ? 1 : D / 16][4];
  const T* tile;

  __device__ __forceinline__ void get(int kk, uint32_t (&a)[4]) const {
    if constexpr (SMEM) {
      ldsm_x4(a, tile + kk * 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = r[kk][e];
    }
  }
};

// Point a QFrags at the [16][ld] tile `t`: lane l gives row l % 8 (+8 for
// lanes 8-15 and 24-31) at column 8 (l / 16), the four 8 x 8 matrices of
// an A fragment.
template <int D, typename T>
__device__ __forceinline__ void qfrags_at(QFrags<D, T>& f, const T* t,
                                          int ld, int lane) {
  f.tile = t + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

// Copy `nrows` rows of D elements (row r at src + r * stride) into a
// [rows][D + 8] shared tile of T, 4 bytes a thread a step, rows nrows ..
// rows - 1 as zeros. Called by every thread of a block of `nt`.
template <int D, typename T>
__device__ __forceinline__ void stage_q(T* dst, const T* src, size_t stride,
                                        int rows, int nrows, int nt) {
  for (int i = threadIdx.x; i < rows * (D / 2); i += nt) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    *reinterpret_cast<uint32_t*>(dst + r * (D + 8) + c) =
        r < nrows ? ld2(src + r * stride + c) : 0u;
  }
}

template <int D, int ROWS, int TK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS * (D + 1) + TK * (D + 1) + TK * D +
                          ROWS * (TK + 1) + 3 * ROWS + 2 * TK) +
         sizeof(int) * 2 * ROWS;
}

// One block attends ROWS query rows that share one KV head against the
// keys of one sequence, in fp32 (KT: fp32 rows, or int8 codes with their
// scales). DECODE: rows are heads [blockIdx.z * ROWS, +ROWS) of the g
// heads of KV head blockIdx.y, at query 0, then the ring's rows. PREFILL:
// rows are PF_ROWS consecutive queries (tile blockIdx.y) of head
// blockIdx.z.
template <typename KT, int D, int ROWS, int TK, bool DECODE>
__global__ void __launch_bounds__(CC_NT)
paged_attn_kernel(const float* __restrict__ q, const KT* __restrict__ k_pool,
                  const KT* __restrict__ v_pool,
                  const int* __restrict__ tables,
                  const int* __restrict__ start_pos,
                  const int* __restrict__ seq_lens, float* __restrict__ out,
                  Extras ex, Ring<float> ring, int C, int H, int KV, int maxb,
                  int bs, float sm_scale, int window) {
  const int s = blockIdx.x;
  const int g = H / KV;
  int kvh, h0, c0, nrows;
  if (DECODE) {
    kvh = blockIdx.y;
    h0 = kvh * g + blockIdx.z * ROWS;
    c0 = 0;
    nrows = min(ROWS, g - (int)blockIdx.z * ROWS);
  } else {
    h0 = blockIdx.z;
    kvh = h0 / g;
    c0 = blockIdx.y * ROWS;
    nrows = min(ROWS, C - c0);
  }
  const int KVD = KV * D;

  extern __shared__ float smem[];
  float* qs = smem;                       // [ROWS][D+1], pre-scaled
  float* ks = qs + ROWS * (D + 1);        // [TK][D+1]
  float* vs = ks + TK * (D + 1);          // [TK][D]
  float* ps = vs + TK * D;                // [ROWS][TK+1] scores, then probs
  float* m_s = ps + ROWS * (TK + 1);      // running max per row
  float* l_s = m_s + ROWS;                // running sum per row
  float* a_s = l_s + ROWS;                // this tile's rescale per row
  float* ksc = a_s + ROWS;                // [TK] K scales of the tile
  float* vsc = ksc + TK;                  // [TK] V scales of the tile
  int* lo_s = reinterpret_cast<int*>(vsc + TK);     // live keys [lo, hi)
  int* hi_s = lo_s + ROWS;

  const int tid = threadIdx.x;
  const int start = start_pos[s];
  // never index past the block table, whatever seq_lens says
  const int seq_len = min(seq_lens[s], maxb * bs);

  for (int r = tid; r < ROWS; r += CC_NT) {
    int lo_r = 0, hi_r = 0;
    if (r < nrows) {
      const int pos = start + (DECODE ? 0 : c0 + r);
      hi_r = max(0, min(seq_len, pos + 1));              // causal + length
      if (window > 0) lo_r = min(max(0, pos - window + 1), hi_r);
    }
    lo_s[r] = lo_r;
    hi_s[r] = hi_r;
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
    a_s[r] = 0.f;
  }
  for (int i = tid; i < ROWS * D; i += CC_NT) {
    const int r = i / D, d = i % D;
    float v = 0.f;
    if (r < nrows) {
      const size_t off =
          DECODE ? ((size_t)s * C * H + h0 + r) * D + d
                 : (((size_t)s * C + c0 + r) * H + h0) * D + d;
      v = q[off] * sm_scale;
    }
    qs[r * (D + 1) + d] = v;
  }
  __syncthreads();

  // the block's key range: the union of its rows' live ranges
  int lo = 0x7fffffff, hi = 0;
  for (int r = 0; r < nrows; ++r) {
    if (hi_s[r] > lo_s[r]) {
      lo = min(lo, lo_s[r]);
      hi = max(hi, hi_s[r]);
    }
  }
  if (hi == 0) lo = 0;
  // the ring's live rows (decode): [rlo, rhi), none for an idle slot
  int rlo = 0, rhi = 0;
  if (DECODE && ring.k != nullptr && seq_lens[s] > 0) {
    rhi = ring.count;
    if (window > 0) rlo = min(max(0, ring.count - window), rhi);
  }
  const bool quant = ex.k_scales != nullptr;

  constexpr int PAIRS = (ROWS * D + CC_NT - 1) / CC_NT;
  float acc[PAIRS];
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) acc[k] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  // segment 0: the pool's keys [lo, hi); segment 1: the ring's [rlo, rhi)
  for (int seg = 0; seg < 2; ++seg) {
    const bool rseg = seg == 1;
    const int a = rseg ? rlo : lo, b = rseg ? rhi : hi;
    for (int t0 = a; t0 < b; t0 += TK) {
      // stage the K/V tile: pool token j lives in row table[j / bs] * bs
      // + j % bs; ring row j at j * stride + s * KVD
      for (int i = tid; i < TK * D; i += CC_NT) {
        const int r = i / D, d = i % D;
        const int j = t0 + r;
        float kv = 0.f, vv = 0.f;
        if (j < b) {
          if (rseg) {
            const size_t off = (size_t)j * ring.stride + (size_t)s * KVD +
                               (size_t)kvh * D + d;
            kv = ring.k[off];
            vv = ring.v[off];
          } else {
            const int blk = tables[(size_t)s * maxb + j / bs];
            const size_t off =
                ((size_t)blk * bs + (j % bs)) * KVD + (size_t)kvh * D + d;
            kv = to_f(k_pool[off]);
            vv = to_f(v_pool[off]);
          }
        }
        ks[r * (D + 1) + d] = kv;
        vs[r * D + d] = vv;
      }
      for (int r = tid; r < TK; r += CC_NT) {
        const int j = t0 + r;
        float kk = 1.f, vv = 1.f;            // the ring is never scaled
        if (quant && !rseg && j < b) {
          const size_t row =
              (size_t)tables[(size_t)s * maxb + j / bs] * bs + j % bs;
          kk = ex.k_scales[(size_t)kvh * ex.slots + row];
          vv = ex.v_scales[(size_t)kvh * ex.slots + row];
        }
        ksc[r] = kk;
        vsc[r] = vv;
      }
      __syncthreads();
      // scores: (q . k) * scale * k scale - slope * distance, masked per row
      for (int i = tid; i < ROWS * TK; i += CC_NT) {
        const int r = i / TK, c = i % TK;
        const int j = t0 + c;
        float sc = -INFINITY;
        const bool live = rseg ? j < b : (j >= lo_s[r] && j < hi_s[r]);
        if (r < nrows && live) {
          const float* qr = qs + r * (D + 1);
          const float* kr = ks + c * (D + 1);
          float a_ = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) a_ = fmaf(qr[d], kr[d], a_);
          sc = a_ * ksc[c];
          if (ex.alibi != nullptr) {
            const int dist = rseg ? ring.count - 1 - j
                                  : start + (DECODE ? 0 : c0 + r) - j;
            sc = fmaf(-ex.alibi[DECODE ? h0 + r : h0], (float)dist, sc);
          }
        }
        ps[r * (TK + 1) + c] = sc;
      }
      __syncthreads();
      // online softmax: one warp per row
      for (int r = warp; r < ROWS; r += CC_NT / 32) {
        float* pr = ps + r * (TK + 1);
        float mt = -INFINITY;
        for (int c = lane; c < TK; c += 32) mt = fmaxf(mt, pr[c]);
        mt = warp_max(mt);
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mt);
        // a row with nothing live yet keeps m = -inf: exp through a finite
        // stand-in so no (-inf) - (-inf) NaN appears; p comes out 0
        const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
        const float alpha =
            (m_old == -INFINITY) ? 0.f : expf(m_old - m_safe);
        float sum = 0.f;
        for (int c = lane; c < TK; c += 32) {
          const float x = pr[c];
          const float p = (x == -INFINITY) ? 0.f : expf(x - m_safe);
          pr[c] = p * vsc[c];          // the V scale after the row sum
          sum += p;
        }
        sum = warp_sum(sum);
        __syncwarp();
        if (lane == 0) {
          m_s[r] = m_new;
          l_s[r] = alpha * l_s[r] + sum;
          a_s[r] = alpha;
        }
      }
      __syncthreads();
      // acc = acc * alpha + P @ V
#pragma unroll
      for (int k = 0; k < PAIRS; ++k) {
        const int i = tid + k * CC_NT;
        if (i < ROWS * D) {
          const int r = i / D, d = i % D;
          const float* pr = ps + r * (TK + 1);
          float a_ = acc[k] * a_s[r];
#pragma unroll 8
          for (int c = 0; c < TK; ++c) a_ = fmaf(pr[c], vs[c * D + d], a_);
          acc[k] = a_;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    const int i = tid + k * CC_NT;
    if (i < ROWS * D) {
      const int r = i / D, d = i % D;
      if (r < nrows) {
        const float l = l_s[r];
        const float o = (l == 0.f) ? 0.f : acc[k] / l;   // idle rows: 0
        const size_t off =
            DECODE ? ((size_t)s * C * H + h0 + r) * D + d
                   : (((size_t)s * C + c0 + r) * H + h0) * D + d;
        out[off] = o;
      }
    }
  }
}

// ------------------------------------------------ K1 on the tensor cores

constexpr int MMA_NT = 128;        // K1 bf16: threads per block (4 warps)
constexpr int MMA_ROWS = 64;       // K1 bf16: queries per block
constexpr int MMA_TK = 64;         // K1 bf16: keys per tile

// The live key range [lo, hi) of the query at chunk row c (window <= 0:
// none); a row past the chunk or with no live key has lo == hi.
__device__ __forceinline__ void live_range(int c, int C, int start,
                                           int seq_len, int window, int& lo,
                                           int& hi) {
  lo = hi = 0;
  if (c < C) {
    const int pos = start + c;
    hi = max(0, min(seq_len, pos + 1));                    // causal + length
    if (window > 0) lo = min(max(0, pos - window + 1), hi);
  }
}

// Dynamic shared memory of K1's mma.sync kernel: the K and V tiles
// [MMA_TK][D + 8] of T, their scales [2][MMA_TK] f32 (int8), and at head
// dim 256 Q's [MMA_ROWS][D + 8] tile (QFrags).
template <int D, typename T>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return ((size_t)2 * MMA_TK + (QFrags<D, T>::SMEM ? MMA_ROWS : 0)) *
             (D + 8) * sizeof(T) +
         2 * MMA_TK * sizeof(float);
}

// S[16 x 64] = Q . K^T for a warp's 16 rows against a staged [64][D + 8]
// K tile: mma_abt with Q's fragments from registers; from Q's shared tile
// (head dim 256) a k-step pair's fragments are loaded once for the eight
// column tiles (the same products in the same order).
template <int D, typename T>
__device__ __forceinline__ void qk_tile(float (&acc)[8][4],
                                        const QFrags<D, T>& q, const T* ks,
                                        int lane) {
  if constexpr (!QFrags<D, T>::SMEM) {
    mma_abt<D, T>(acc, q.r, ks, lane);
  } else {
    constexpr int LD = D + 8, KS = D / 16;
    static_assert(KS % 2 == 0, "k-steps go in pairs");
    const T* base = ks + (lane & 7) * LD + (lane >> 3) * 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
      uint32_t a0[4], a1[4];
      q.get(kk, a0);
      q.get(kk + 1, a1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b[4];
        ldsm_x4(b, base + nt * 8 * LD + kk * 16);
        mma_16816<T>(acc[nt], a0, b[0], b[1]);
        mma_16816<T>(acc[nt], a1, b[2], b[3]);
      }
    }
  }
}

// KT: the pool's element, T (bf16 or fp16) or int8_t (codes widened to T
// in registers as they are staged, 16 a thread; their scales staged
// beside the tile).
template <int D, typename T, typename KT>
__global__ void __launch_bounds__(MMA_NT)
paged_prefill_mma_kernel(const T* __restrict__ q,
                         const KT* __restrict__ k_pool,
                         const KT* __restrict__ v_pool,
                         const int* __restrict__ tables,
                         const int* __restrict__ start_pos,
                         const int* __restrict__ seq_lens,
                         T* __restrict__ out, Extras ex, int C, int H,
                         int KV, int maxb, int bs, float sm_scale,
                         int window) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  constexpr int KS = D / 16;         // k-steps of Q.K^T
  constexpr int NS = MMA_TK / 8;     // 8-key column tiles of a score tile
  constexpr int ND = D / 8;          // 8-wide column tiles of the output
  constexpr int LD = D + 8;          // padded smem row: no bank conflicts
  constexpr int EPC = 16 / sizeof(KT);   // pool elements a 16-byte load
  static_assert(NS == 8 && LD * MMA_TK == tile_elems<D>(),
                "mma_abt / mma_pv take [64][D + 8] tiles");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* ks = reinterpret_cast<T*>(mma_smem);
  T* vs = ks + MMA_TK * LD;
  float* ksc = reinterpret_cast<float*>(vs + MMA_TK * LD);  // scales (int8)
  float* vsc = ksc + MMA_TK;

  const int s = blockIdx.x, c0 = blockIdx.y * MMA_ROWS, h = blockIdx.z;
  const int kvh = h / (H / KV);
  const int KVD = KV * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, qi = lane % 4;
  const int start = start_pos[s];
  // never index past the block table, whatever seq_lens says
  const int seq_len = min(seq_lens[s], maxb * bs);
  const float slope = ex.alibi != nullptr ? ex.alibi[h] : 0.f;

  // this thread's two rows (quad, quad + 8 of its warp's 16) ...
  int lo_r[2], hi_r[2];
  const int crow[2] = {c0 + warp * 16 + quad, c0 + warp * 16 + quad + 8};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    live_range(crow[i], C, start, seq_len, window, lo_r[i], hi_r[i]);
  // ... and the block's key range: the union of its rows' live ranges
  int lo = 0x7fffffff, hi = 0;
  for (int r = 0; r < MMA_ROWS; ++r) {
    int l_r, h_r;
    live_range(c0 + r, C, start, seq_len, window, l_r, h_r);
    if (h_r > l_r) {
      lo = min(lo, l_r);
      hi = max(hi, h_r);
    }
  }
  if (hi == 0) lo = 0;

  // Q as A fragments, loaded once (rows past the chunk are zeros): in
  // registers, or at head dim 256 in a shared tile, 16 rows a warp
  QFrags<D, T> qf;
  if constexpr (QFrags<D, T>::SMEM) {
    T* qs = reinterpret_cast<T*>(vsc + MMA_TK);
    stage_q<D, T>(qs, q + (((size_t)s * C + c0) * H + h) * D,
                  (size_t)H * D, MMA_ROWS, min(MMA_ROWS, C - c0), MMA_NT);
    __syncthreads();
    qfrags_at(qf, qs + warp * 16 * LD, LD, lane);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool live = crow[i] < C;
      const T* qr =
          q + (((size_t)s * C + (live ? crow[i] : 0)) * H + h) * D + qi * 2;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qf.r[kk][i] = live ? ld2(qr + kk * 16) : 0u;
        qf.r[kk][i + 2] = live ? ld2(qr + kk * 16 + 8) : 0u;
      }
    }
  }

  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};             // this thread's partial row sums

  for (int t0 = lo; t0 < hi; t0 += MMA_TK) {
    // stage the K/V tile, 16 bytes a load: token j lives in pool row
    // table[j / bs] * bs + j % bs; rows past hi are zeros (P is 0 there,
    // and 0 * garbage could be NaN); int8 codes widen to T here
    for (int i = tid; i < MMA_TK * (D / EPC); i += MMA_NT) {
      const int r = i / (D / EPC), ch = i % (D / EPC);
      const int j = t0 + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (j < hi) {
        const int blk = tables[(size_t)s * maxb + j / bs];
        const size_t off =
            ((size_t)blk * bs + (j % bs)) * KVD + (size_t)kvh * D + ch * EPC;
        kv4 = *reinterpret_cast<const uint4*>(k_pool + off);
        vv4 = *reinterpret_cast<const uint4*>(v_pool + off);
      }
      if constexpr (Q8) {
        uint4 lo4, hi4;
        widen16<T>(kv4, lo4, hi4);
        *reinterpret_cast<uint4*>(ks + r * LD + ch * 16) = lo4;
        *reinterpret_cast<uint4*>(ks + r * LD + ch * 16 + 8) = hi4;
        widen16<T>(vv4, lo4, hi4);
        *reinterpret_cast<uint4*>(vs + r * LD + ch * 16) = lo4;
        *reinterpret_cast<uint4*>(vs + r * LD + ch * 16 + 8) = hi4;
      } else {
        *reinterpret_cast<uint4*>(ks + r * LD + ch * 8) = kv4;
        *reinterpret_cast<uint4*>(vs + r * LD + ch * 8) = vv4;
      }
    }
    if constexpr (Q8) {
      // thread r < 64 stages row r's K scale, thread 64 + r its V scale
      const int r = tid % MMA_TK, j = t0 + r;
      float sc = 0.f;
      if (j < hi) {
        const size_t row =
            (size_t)tables[(size_t)s * maxb + j / bs] * bs + j % bs;
        sc = (tid < MMA_TK ? ex.k_scales : ex.v_scales)[(size_t)kvh *
                                                            ex.slots + row];
      }
      (tid < MMA_TK ? ksc : vsc)[r] = sc;
    }
    __syncthreads();

    // scores: this warp's 16 rows x MMA_TK keys, K's B fragments by
    // ldmatrix
    float sc[NS][4];
    qk_tile<D, T>(sc, qf, ks, lane);
    // scale (and K scale), ALiBi, mask, row max over the quad that
    // shares a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, c = nt * 8 + qi * 2 + (e & 1), j = t0 + c;
        float x = sc[nt][e] * sm_scale;
        if constexpr (Q8) x *= ksc[c];
        x = fmaf(-slope, (float)(start + crow[i] - j), x);
        x = (j >= lo_r[i] && j < hi_r[i]) ? x : -INFINITY;
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
      m_safe[i] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[i] = expf(m[i] - m_safe[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(sc[nt][e] - m_safe[e / 2]);
        rs[e / 2] += p;                 // the row sums before the V scale
        if constexpr (Q8) p *= vsc[nt * 8 + qi * 2 + (e & 1)];
        sc[nt][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e / 2];

    // o += P.V: the score accumulators re-pack as T A fragments, V's B
    // fragments by ldmatrix.trans
    mma_pv<D, T>(o, sc, vs, lane);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (crow[i] >= C) continue;
    const float inv = (li == 0.f) ? 0.f : 1.f / li;       // idle rows: 0
    T* orow = out + (((size_t)s * C + crow[i]) * H + h) * D;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + qi * 2) =
          pack2<T>(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
  }
}

// --------------------------- K1 in bf16 at head dims 64 and 128: wgmma + TMA
//
// paged_prefill_wgmma_kernel: a persistent block an SM walks work items
// (slot, query head, 128-query tile): a (slot, head)'s query tiles side
// by side, last first, then the next head of the slot (the query heads
// of one KV head next to each other), so that the blocks at work at one
// time read the same K/V tiles and those reads hit L2; dealt in rounds
// of alternating direction (pw_item), so that a block's long and short
// tiles of the causal triangle pair up. The deal depends on the shapes
// alone
// (`paged_attention.prefill_plan` states it); each item finds its live
// key range on the device and an item with none skips its key loop.
//
// Warpgroup 0 is the producer, warpgroups 1 and 2 the consumers (64 query
// rows each). The producer's thread 0 loads the item's Q by TMA (a 4-D map
// over [S, C, H, D]: rows past the chunk arrive as zeros) and the K/V
// tiles of 128 keys by TMA through rings on mbarriers: each tile is two
// halves of 64 keys, each half one 64 x 64 box a 64-column block of D,
// whose row coordinate in a 2-D map over the flat [slots, KV * D] pool is
// table[s, j / bs] * bs + j % bs (a half never crosses a block's end when
// bs % 64 == 0). A half not wholly inside the item's live range [lo, hi)
// (the range's two ends), and every half when bs % 64 != 0 (GATHER), is
// gathered by the producer's 128 threads instead: 16-byte cp.async rows
// through the block table into the same 128-byte-swizzled layout, rows
// outside [lo, hi) zero-filled (no table entry outside the range is read,
// and a zero probability never meets garbage in V), completing on the
// same mbarrier (cp.async.mbarrier.arrive). The consumers run S = Q K^T on
// m64n128k16 wgmma from shared memory, the online softmax in registers
// with the causal / window / length mask only on tiles that cross a row's
// range, and O += P V on m64nDk16 wgmma with P as register A fragments,
// taking turns on the tensor cores as in flash_fwd_wgmma_kernel. One block
// owns an item: no split, no atomics, the same bits from call to call.

constexpr int PW_ROWS = 128;        // queries of a work item
constexpr int PW_KEYS = 128;        // keys of a K/V tile (two 64-key halves)
constexpr int PW_THREADS = 384;     // a producer warpgroup and two consumers
constexpr int PW_PRODUCER_BAR = 3;  // named barrier of the producer's threads

template <int D>
__host__ __device__ constexpr int pw_stages() {
  return D == 64 ? 4 : 2;
}
template <int D>
__host__ __device__ constexpr size_t pw_smem_bytes() {
  return (size_t)(2 * PW_ROWS * D + pw_stages<D>() * 2 * PW_KEYS * D) *
             sizeof(__nv_bfloat16) +
         (4 + 4 * pw_stages<D>()) * sizeof(uint64_t);
}

// the copies this thread started by cp.async arrive on `bar` once done
// (the arrival is added to the phase's count, so the phase waits for it)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Work item `item`: query tile qt of (slot s, head h), and the union of its
// live rows' key ranges [lo, hi) (a superset: the first row's lo, the last
// live row's hi; both grow with the row), covered by `ntiles` tiles of
// PW_KEYS keys from tbeg (a multiple of PW_KEYS).
struct PwItem {
  int s, h, kvh, q0, start, seq_len, lo, hi, tbeg, ntiles;
  __device__ __forceinline__ PwItem(int item, int S, int C, int H, int g,
                                    const int* start_pos,
                                    const int* seq_lens, int cap,
                                    int window) {
    const int nqt = (C + PW_ROWS - 1) / PW_ROWS;
    const int qt = nqt - 1 - item % nqt, sh = item / nqt;
    s = sh / H;
    h = sh % H;
    kvh = h / g;
    q0 = qt * PW_ROWS;
    start = start_pos[s];
    seq_len = min(seq_lens[s], cap);      // never past the block table
    int l_, h_;
    live_range(q0, C, start, seq_len, window, lo, h_);
    live_range(min(C, q0 + PW_ROWS) - 1, C, start, seq_len, window, l_, hi);
    if (hi <= lo) {
      tbeg = ntiles = 0;
    } else {
      tbeg = lo / PW_KEYS * PW_KEYS;
      ntiles = (hi - tbeg + PW_KEYS - 1) / PW_KEYS;
    }
  }
};

// The r-th work item of this block: rounds of gridDim.x items, dealt
// forward in even rounds and backward in odd ones.
__device__ __forceinline__ int pw_item(int r) {
  return r * (int)gridDim.x +
         (r & 1 ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// Softmax of one [64 x 128] score tile in place (this thread's two rows,
// 32 columns each) at keys [k0, +128): scale, ALiBi (ALIBI: score -= slope
// * (pos[i] - j), before the mask), the mask (MASK: key j of row i is live
// iff lo[i] <= j < hi[i]), the running max m and sum l (this thread's
// columns), the probabilities left in sc, and alpha, the factor that
// rescales O to the new max. POS: scale > 0 and no ALiBi, so the scale
// folds into the exponent's multiplier (with ALiBi the bias must enter
// after the scale and before the max, so the scale stays on the scores).
template <bool MASK, bool POS, bool ALIBI>
__device__ __forceinline__ void pw_softmax(float (&sc)[64], int k0,
                                           const int (&lo)[2],
                                           const int (&hi)[2], float scale,
                                           float slope, const int (&pos)[2],
                                           float (&m)[2], float (&l)[2],
                                           float (&alpha)[2], int qi) {
  static_assert(!(POS && ALIBI), "ALiBi keeps the scale on the scores");
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = k0 + n * 8 + qi * 2 + (x & 1);
      float v = POS ? sc[4 * n + x] : sc[4 * n + x] * scale;
      if (ALIBI) v = fmaf(-slope, (float)(pos[x / 2] - j), v);
      if (MASK && (j < lo[x / 2] || j >= hi[x / 2])) v = -INFINITY;
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

// What one consumer warpgroup carries from tile to tile (the paged twin
// of flash_ws.cuh's WsState). Tiles are counted over the block's
// whole walk (kbase), which picks each tile's ring buffer and phase.
template <int D, typename T, bool ALIBI>
struct PwState {
  static constexpr int S = pw_stages<D>();
  static constexpr int BOX = PW_KEYS * 64, TKV = PW_KEYS * D;  // elements
  static constexpr int QBOX = PW_ROWS * 64;
  const T *qa, *kring, *vring;
  uint64_t *kfull, *vfull, *kempty, *vempty;
  // this thread's rows' ranges and positions; every live row of the
  // warpgroup sees [lo_all, hi_all); the item's range [klo, khi) and first
  // tile tbeg
  int lo[2], hi[2], pos[2], lo_all, hi_all, klo, khi, tbeg, qi, cw, kbase;
  float scale, slope;
  float sc[64], acc[D / 2], m[2], l[2], alpha[2];
  uint32_t pa[8][4];
  bool signal, gather;

  // the two consumers take turns on the tensor cores (named barrier
  // 1 + cw: its turn), as WsState's do
  __device__ __forceinline__ void turn() { bar_sync<256>(1 + cw); }
  __device__ __forceinline__ void pass() {
    bar_arrive<256>(1 + (cw + 1) % 2);
  }

  // a tile partly gathered by cp.async: its generic-proxy writes ordered
  // before this thread's wgmma reads them
  __device__ __forceinline__ void fence_if_gathered(int t) {
    const int k0 = tbeg + t * PW_KEYS;
    if (gather || k0 < klo || k0 + PW_KEYS > khi) fence_async_smem();
  }
  __device__ __forceinline__ void wait_k(int t) {
    const int g = kbase + t;
    mbar_wait(kfull + g % S, (g / S) & 1);
    fence_if_gathered(t);
  }
  __device__ __forceinline__ void wait_v(int t) {
    const int g = kbase + t;
    mbar_wait(vfull + g % S, (g / S) & 1);
    fence_if_gathered(t);
  }
  // issue S = Q K_t^T into sc, committed
  __device__ __forceinline__ void scores(int t) {
    const T* ks = kring + ((kbase + t) % S) * TKV;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, T>(sc,
                  wg_desc(qa + (kk / 4) * QBOX + (kk % 4) * 16, 16, 1024),
                  wg_desc(ks + (kk / 4) * BOX + (kk % 4) * 16, 16, 1024),
                  kk > 0, std::integral_constant<int, PW_KEYS>());
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
    for (int kk = 0; kk < PW_KEYS / 16; ++kk)
      wgmma_rs<1, T>(acc, pa[kk], wg_desc(vs + kk * 16 * 64, BOX * 2, 1024),
                     1, std::integral_constant<int, D>());
    wg_commit();
  }
  __device__ __forceinline__ void softmax(int t) {
    const int k0 = tbeg + t * PW_KEYS;
    const bool mask = k0 + PW_KEYS > hi_all || k0 < lo_all;
#define PW_SOFTMAX(M, P, A) \
  pw_softmax<M, P, A>(sc, k0, lo, hi, scale, slope, pos, m, l, alpha, qi)
    if constexpr (ALIBI) {
      if (mask)
        PW_SOFTMAX(true, false, true);
      else
        PW_SOFTMAX(false, false, true);
    } else if (scale > 0.f) {
      if (mask)
        PW_SOFTMAX(true, true, false);
      else
        PW_SOFTMAX(false, true, false);
    } else {
      if (mask)
        PW_SOFTMAX(true, false, false);
      else
        PW_SOFTMAX(false, false, false);
    }
#undef PW_SOFTMAX
  }
  // the probabilities as T pairs in the A fragments of the P V product;
  // the sums above were taken before this cast
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
  // tile 0: S_0 and its softmax
  __device__ __forceinline__ void first() {
    if (cw == 1) bar_arrive<256>(1);         // opens the item's round
    wait_k(0);
    turn();
    scores(0);
    pass();
    wg_wait<0>();
    fence_regs(sc);
    free_k(0);
    softmax(0);
    pack_p();
  }
  // tile t (>= 1): S_t and P V_{t-1} on the tensor cores together, S_t's
  // softmax under P V_{t-1}
  __device__ __forceinline__ void step(int t) {
    wait_k(t);
    turn();
    scores(t);
    pv(t - 1);
    pass();
    wg_wait<1>();                            // S_t done
    fence_regs(sc);
    free_k(t);
    softmax(t);
    wg_wait<0>();                            // P V_{t-1} done
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
    if (cw != 1) pass();
    wg_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
    free_v(t);
  }
};

// ALIBI: a separate instance, so that the registers ALiBi takes (the rows'
// positions, the slope, the unfolded scale) cost the kernel without it
// nothing.
template <int D, bool GATHER, typename T, bool ALIBI>
__global__ void __launch_bounds__(PW_THREADS, 1)
paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool,
                           const int* __restrict__ tables,
                           const int* __restrict__ start_pos,
                           const int* __restrict__ seq_lens,
                           T* __restrict__ out, const float* alibi, int S,
                           int C, int H, int KV, int maxb, int bs,
                           float sm_scale, int window) {
  using St = PwState<D, T, ALIBI>;
  constexpr int ST = St::S, NB = D / 64;
  constexpr int BOX = St::BOX, QBOX = St::QBOX, TKV = St::TKV;
  constexpr int TQ = PW_ROWS * D;
  extern __shared__ __align__(1024) unsigned char pw_smem[];
  // Q [2][NB][128 x 64], then the K and V rings [ST][NB][128 x 64]
  T* qs = reinterpret_cast<T*>(pw_smem);
  T* kring = qs + 2 * TQ;
  T* vring = kring + ST * TKV;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vring + ST * TKV);
  uint64_t* qempty = qfull + 2;
  uint64_t* kfull = qempty + 2;
  uint64_t* vfull = kfull + ST;
  uint64_t* kempty = vfull + ST;
  uint64_t* vempty = kempty + ST;
  const int g = H / KV, cap = maxb * bs, KVD = KV * D;
  const int items = ((C + PW_ROWS - 1) / PW_ROWS) * S * H;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i);
      mbar_init(qempty + i, 2);
    }
    for (int i = 0; i < ST; ++i) {
      mbar_init(kfull + i);
      mbar_init(vfull + i);
      mbar_init(kempty + i, 2);
      mbar_init(vempty + i, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    set_max_regs<40, false>();
    const int ptid = threadIdx.x;              // 0..127
    // tile gt of the block's walk of K or V (keys [t0, t0 + 128) of item
    // `it`) into its ring once the consumers freed the buffer: wholly
    // live halves by TMA (thread 0), the others gathered by all 128
    // threads with rows outside [lo, hi) zero-filled. Only thread 0 waits
    // for the buffer of a tile it loads alone, and the others meet it at
    // a gathered tile before they wait: a parity wait cannot tell its
    // phase from one two phases away, so every waiter must have waited
    // for the buffer's previous phase, as thread 0 has.
    auto load = [&](const CUtensorMap* tm, const T* pool, T* ring,
                    uint64_t* full, uint64_t* empty,
                    int gt, int t0, const PwItem& it) {
      const int st = gt % ST;
      bool tma[2];
#pragma unroll
      for (int bh = 0; bh < 2; ++bh) {
        const int k0 = t0 + bh * 64;
        tma[bh] = !GATHER && k0 >= it.lo && k0 + 64 <= it.hi;
      }
      const bool gathered = !(tma[0] && tma[1]);
      if (gathered) bar_sync<128>(PW_PRODUCER_BAR);   // all at this tile
      if (ptid == 0 || gathered) mbar_wait(empty + st, ((gt / ST) & 1) ^ 1);
      T* dst = ring + st * TKV;
      const int* table = tables + (size_t)it.s * maxb;
#pragma unroll
      for (int bh = 0; bh < 2; ++bh) {
        if (tma[bh]) continue;
        const int k0 = t0 + bh * 64;
        // 64 rows x D / 8 chunks of 16 bytes, row-major over the threads
        for (int i = ptid; i < 64 * (D / 8); i += 128) {
          const int r = i / (D / 8), ch = i % (D / 8), j = k0 + r;
          const bool live = j >= it.lo && j < it.hi;
          const T* src = pool;
          if (live)
            src += ((size_t)table[j / bs] * bs + j % bs) * KVD +
                   (size_t)it.kvh * D + ch * 8;
          cp_async16(reinterpret_cast<unsigned char*>(dst + (ch / 8) * BOX) +
                         swizzled(bh * 64 + r, (ch % 8) * 8),
                     src, live);
        }
      }
      if (gathered) {
        cp_async_mbar_arrive(full + st);
        bar_sync<128>(PW_PRODUCER_BAR);    // every thread's arrival is in
      }
      if (ptid == 0) {
        mbar_expect(full + st, (uint32_t)(tma[0] + tma[1]) * NB * 64 * 64 *
                                   (uint32_t)sizeof(T));
#pragma unroll
        for (int bh = 0; bh < 2; ++bh) {
          if (!tma[bh]) continue;
          const int k0 = t0 + bh * 64;
          const int row = table[k0 / bs] * bs + k0 % bs;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            tma_box(dst + nb * BOX + bh * 64 * 64, tm, it.kvh * D + nb * 64,
                    row, full + st);
        }
      }
    };
    int kbase = 0, qn = 0;
    for (int r = 0; r * (int)gridDim.x < items; ++r) {
      if (pw_item(r) >= items) continue;
      const PwItem it(pw_item(r), S, C, H, g, start_pos, seq_lens, cap,
                      window);
      if (it.ntiles == 0) continue;
      if (ptid == 0) {
        const int qb = qn & 1;
        mbar_wait(qempty + qb, ((qn >> 1) & 1) ^ 1);
        mbar_expect(qfull + qb, TQ * sizeof(T));
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            tma_box4(qs + qb * TQ + nb * QBOX + half * 64 * 64, &tm_q,
                     nb * 64, it.h, it.q0 + half * 64, it.s, qfull + qb);
      }
      load(&tm_k, k_pool, kring, kfull, kempty, kbase, it.tbeg, it);
      for (int t = 0; t < it.ntiles; ++t) {
        if (t + 1 < it.ntiles)
          load(&tm_k, k_pool, kring, kfull, kempty, kbase + t + 1,
               it.tbeg + (t + 1) * PW_KEYS, it);
        load(&tm_v, v_pool, vring, vfull, vempty, kbase + t,
             it.tbeg + t * PW_KEYS, it);
      }
      kbase += it.ntiles;
      ++qn;
    }
    return;
  }
  set_max_regs<232, true>();
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
  w.scale = sm_scale;
  w.signal = threadIdx.x % 128 == 0;
  w.gather = GATHER;
  w.kbase = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) w.sc[i] = 0.f;
  int qn = 0;
  for (int r = 0; r * (int)gridDim.x < items; ++r) {
    if (pw_item(r) >= items) continue;
    const PwItem it(pw_item(r), S, C, H, g, start_pos, seq_lens, cap,
                    window);
    const int row[2] = {it.q0 + rloc, it.q0 + rloc + 8};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      live_range(row[i], C, it.start, it.seq_len, window, w.lo[i], w.hi[i]);
      w.pos[i] = it.start + row[i];
    }
    w.slope = ALIBI ? alibi[it.h] : 0.f;
    // every live row of this warpgroup sees [lo_all, hi_all): its first
    // row's hi and its last live row's lo (none live: no mask, the rows
    // are never stored)
    const int first = it.q0 + cw * 64;
    w.lo_all = 0;
    w.hi_all = 0x7fffffff;
    if (first < C) {
      int l_, h_;
      live_range(first, C, it.start, it.seq_len, window, l_, w.hi_all);
      live_range(min(C, first + 64) - 1, C, it.start, it.seq_len, window,
                 w.lo_all, h_);
    }
    w.klo = it.lo;
    w.khi = it.hi;
    w.tbeg = it.tbeg;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) w.acc[i] = 0.f;
    w.m[0] = w.m[1] = -INFINITY;
    w.l[0] = w.l[1] = 0.f;                    // this thread's partial sums
    const int n = it.ntiles;
    if (n > 0) {
      const int qb = qn & 1;
      w.qa = qs + qb * TQ + cw * 64 * 64;     // this warpgroup's rows of Q
      mbar_wait(qfull + qb, (qn >> 1) & 1);
      w.first();
      for (int t = 1; t < n; ++t) w.step(t);
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
      if (row[i] >= C) continue;
      const float inv = li == 0.f ? 0.f : 1.f / li;   // no live key: zeros
      T* p = out + (((size_t)it.s * C + row[i]) * H + it.h) * D + qi * 2;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(p + c * 8) = pack2<T>(
            w.acc[4 * c + 2 * i] * inv, w.acc[4 * c + 2 * i + 1] * inv);
    }
  }
}

// ---------------------------------- K2 in bf16 and fp16: flash-decoding

constexpr int DEC_NT = 128;        // K2: threads per block (4 warps)
constexpr int DEC_TILE = 64;       // K2: keys per staged tile, 16 a warp
constexpr int DEC_HEADS = 16;      // K2: query heads of a block (mma M)

// stages of the K/V ring: deeper where a tile is small (at head dim 256 a
// stage of K and V is 66 KB, and two keep one tile in flight a block)
template <int D>
__host__ __device__ constexpr int dec_stages() {
  return D <= 64 ? 4 : (D <= 128 ? 3 : 2);
}

// Shared memory of K2 over a pool of KT: the K/V ring [stage][K, V]
// [DEC_TILE][D + 8] of T (a ring split always stages T rows); over an
// int8 pool, the int8 ring [stage][K, V][DEC_TILE][D + 16], the widened
// tile [K, V][DEC_TILE][D + 8] of T and the scales [stage][K, V]
// [DEC_TILE] instead; at head dim 256 Q's [16][D + 8] tile of T follows
// (QFrags). After the key loop the same bytes hold the four warps'
// partial states (o [16][D], m [16], l [16] fp32 each).
template <int D, typename T, typename KT>
__host__ __device__ constexpr size_t dec_stage_bytes() {
  constexpr int ST = dec_stages<D>();
  const size_t ring = (size_t)ST * 2 * DEC_TILE * (D + 8) * sizeof(T);
  const size_t q8 = std::is_same<KT, int8_t>::value
                        ? (size_t)ST * 2 * DEC_TILE * (D + 16) +
                              (size_t)2 * DEC_TILE * (D + 8) * sizeof(T) +
                              (size_t)ST * 2 * DEC_TILE * sizeof(float)
                        : 0;
  return ring > q8 ? ring : q8;
}
template <int D, typename T, typename KT>
__host__ __device__ constexpr size_t dec_smem_bytes() {
  const size_t big =
      dec_stage_bytes<D, T, KT>() +
      (QFrags<D, T>::SMEM ? (size_t)DEC_HEADS * (D + 8) * sizeof(T) : 0);
  const size_t merge = (size_t)4 * DEC_HEADS * (D + 2) * sizeof(float);
  return big > merge ? big : merge;
}

// After a split's block has written its partials: count it in cnt[group]
// (one counter a (sequence, KV head, head chunk)); the last split of the
// group to arrive merges the group's splits in split order, m = max m_i,
// l = sum l_i e^(m_i - m), o = sum o_i e^(m_i - m) / l (an empty split,
// m_i = -inf, adds nothing; a head with none live comes out zeros), and
// resets the counter for the next call. Whichever block merges, the sum
// and its bits are the same. The weights e^(m_i - m) and l of each row
// are formed once in `wl` (shared memory, [nrows][splits + 1]). Called by
// every thread of the block.
template <typename T>
__device__ __forceinline__ void dec_merge_if_last(
    const float* __restrict__ part, T* __restrict__ out,
    int* __restrict__ cnt, float* wl, size_t row0, int nrows, int D,
    int splits, size_t ml_base) {
  __shared__ int last;
  __threadfence();               // this split's partials, visible to all
  __syncthreads();
  if (threadIdx.x == 0) {
    const int group = blockIdx.z * gridDim.y + blockIdx.y;
    last = atomicAdd(cnt + group, 1) == splits - 1;
    if (last) cnt[group] = 0;    // every split of the group has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();               // the other splits' partials, seen here
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const float* ml = part + ml_base + (row0 + r) * splits * 2;
    float* w = wl + r * (splits + 1);
    float mm = -INFINITY;
    for (int sp = 0; sp < splits; ++sp) mm = fmaxf(mm, __ldcg(ml + 2 * sp));
    float ll = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float mi = __ldcg(ml + 2 * sp);
      // an empty split's o was never written: weight 0, and never read
      const float wt = mi == -INFINITY ? 0.f : expf(mi - mm);
      ll += mi == -INFINITY ? 0.f : __ldcg(ml + 2 * sp + 1) * wt;
      w[sp] = wt;
    }
    w[splits] = ll;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const float* w = wl + r * (splits + 1);
    const float* o = part + (row0 + r) * splits * D + d;
    float oo = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      if (w[sp] != 0.f) oo += __ldcg(o + (size_t)sp * D) * w[sp];
    const float ll = w[splits];
    out[(row0 + r) * D + d] = to_t<T>(ll == 0.f ? 0.f : oo / ll);
  }
}

// Where K2 reads key j: the pool through a block table (row table[j / bs]
// * bs + j % bs, whose scales sit at that column of the KV head's scale
// run), or the ring (table == nullptr: row j). Element offset of key j's
// head slice: row * stride + col.
struct DecRows {
  const int* table;
  int bs;
  long long stride, col;
  __device__ __forceinline__ long long row(int j) const {
    return table ? (long long)table[j / bs] * bs + j % bs : (long long)j;
  }
};

// One warp's pass over keys [a, b) of one block (K2): 64-key tiles stream
// through a ring of cp.async stages from `src` (KT: T, or int8 codes that
// widen to T in shared memory, with their scales `ksc` / `vsc` at
// row(j)); warp w takes keys [16 w, 16 w + 16) of each tile with its own
// online softmax in registers. Scores: (q . k) * scale * k scale -
// slope * (dpos - j), then the mask (j < b); the probabilities times the
// V scale after the row sums, cast to T for P.V. Leaves this warp's state
// in o, m, l; ends with the ring free (every copy landed, every read
// done).
template <int D, typename T, typename KT>
__device__ __forceinline__ void dec_attend(
    const QFrags<D, T>& qf, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const DecRows src,
    const float* __restrict__ ksc_g, const float* __restrict__ vsc_g,
    int a, int b, int dpos, const float (&slope)[2], float sm_scale,
    float (&o)[D / 8][4], float (&m)[2], float (&l)[2],
    unsigned char* smem) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  constexpr int ST = dec_stages<D>();
  constexpr int LD = D + 8;          // padded T row: no bank conflicts
  constexpr int LDK = Q8 ? D + 16 : LD;   // a staged row, KT elements
  constexpr int EPC = 16 / sizeof(KT);    // elements a 16-byte copy
  constexpr int CH = D / EPC;             // 16-byte copies a row
  constexpr int KS = D / 16;         // k-steps of Q.K^T
  constexpr int ND = D / 8;          // 8-wide column tiles of the output
  KT* ring = reinterpret_cast<KT*>(smem);
  T* wbuf = reinterpret_cast<T*>(smem + (size_t)ST * 2 * DEC_TILE * LDK *
                                            sizeof(KT));
  float* scs = reinterpret_cast<float*>(wbuf + 2 * DEC_TILE * LD);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qi = lane % 4;

  // tile t: keys [a + 64 t, +64) into stage t % ST, 16 bytes a copy; one
  // block-table read per row a thread stages; rows past b are zeros (P is
  // 0 there, and 0 * garbage could be NaN)
  const int ntiles = (b - a + DEC_TILE - 1) / DEC_TILE;
  auto prefetch = [&](int t) {
    if (t < ntiles) {
      KT* ks = ring + (t % ST) * 2 * DEC_TILE * LDK;
      KT* vs = ks + DEC_TILE * LDK;
      const int t0 = a + t * DEC_TILE;
      for (int i = tid; i < DEC_TILE * CH; i += DEC_NT) {
        const int r = i / CH, ch = i % CH, j = t0 + r;
        const bool live = j < b;
        long long off = 0;
        if (live) off = src.row(j) * src.stride + src.col + ch * EPC;
        cp_async16(ks + r * LDK + ch * EPC, kp + off, live);
        cp_async16(vs + r * LDK + ch * EPC, vp + off, live);
      }
      if constexpr (Q8) {
        // thread r < 64 stages row r's K scale, thread 64 + r its V scale
        const int r = tid % DEC_TILE, j = t0 + r;
        const bool live = j < b;
        const float* g = tid < DEC_TILE ? ksc_g : vsc_g;
        cp_async4(scs + ((t % ST) * 2 + tid / DEC_TILE) * DEC_TILE + r,
                  g + (live ? src.row(j) : 0), live);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;                   // this thread's partial row sums

#pragma unroll
  for (int t = 0; t < ST - 1; ++t) prefetch(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();                   // tile t landed; t - 1 consumed
    prefetch(t + ST - 1);
    const KT* ks8 = ring + (t % ST) * 2 * DEC_TILE * LDK;
    const T* ks;
    const T* vs;
    const float* kscale = scs + (t % ST) * 2 * DEC_TILE;
    const float* vscale = kscale + DEC_TILE;
    if constexpr (Q8) {
      // widen both int8 tiles into the T tile, 16 codes a thread a step
      for (int i = tid; i < 2 * DEC_TILE * (D / 16); i += DEC_NT) {
        const int r = i / (D / 16), ch = i % (D / 16);   // r: K rows, V rows
        uint4 lo4, hi4;
        widen16<T>(*reinterpret_cast<const uint4*>(ks8 + r * LDK + ch * 16),
                   lo4, hi4);
        *reinterpret_cast<uint4*>(wbuf + r * LD + ch * 16) = lo4;
        *reinterpret_cast<uint4*>(wbuf + r * LD + ch * 16 + 8) = hi4;
      }
      __syncthreads();                 // the T tile, seen by every warp
      ks = wbuf;
      vs = wbuf + DEC_TILE * LD;
    } else {
      ks = ks8;
      vs = ks8 + DEC_TILE * LDK;
    }
    const int c0 = warp * 16;          // this warp's 16 keys of the tile
    const int kw = a + t * DEC_TILE + c0;
    if (kw >= b) continue;             // warp-uniform: all dead

    // scores: 16 rows x 16 keys, K through ldmatrix as B (matrix i: keys
    // +8 (i / 2), dims +8 (i % 2) of the k-step)
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    const T* kb = ks + (c0 + (lane >> 4) * 8 + (lane & 7)) * LD +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t r4[4], a[4];
      ldsm_x4(r4, kb + kk * 16);
      qf.get(kk, a);
      mma_16816<T>(sc[0], a, r4[0], r4[1]);
      mma_16816<T>(sc[1], a, r4[2], r4[3]);
    }
    // scale, the K scale of column j (int8), ALiBi, mask; row max over
    // the quad that shares a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + nt * 8 + qi * 2 + (e & 1), j = kw - c0 + c;
        float x = sc[nt][e] * sm_scale;
        if constexpr (Q8) x *= kscale[c];
        x = fmaf(-slope[e / 2], (float)(dpos - j), x);
        x = j < b ? x : -INFINITY;
        sc[nt][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], m_safe[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with nothing live yet keeps m = -inf: exp through a finite
      // stand-in so no (-inf) - (-inf) NaN appears; p and alpha come out 0
      m_safe[i] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[i] = expf(m[i] - m_safe[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(sc[nt][e] - m_safe[e / 2]);
        rs[e / 2] += p;                 // the row sums before the V scale
        if constexpr (Q8) p *= vscale[c0 + nt * 8 + qi * 2 + (e & 1)];
        sc[nt][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e / 2];
    // o += P.V on p cast to T; V through ldmatrix.trans as B (matrix i:
    // keys +8 (i % 2), dims +8 (i / 2))
    const uint32_t pa[4] = {pack2<T>(sc[0][0], sc[0][1]),
                            pack2<T>(sc[0][2], sc[0][3]),
                            pack2<T>(sc[1][0], sc[1][1]),
                            pack2<T>(sc[1][2], sc[1][3])};
    const T* vb = vs + (c0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                  (lane >> 4) * 8;
#pragma unroll
    for (int dn = 0; dn < ND; dn += 2) {
      uint32_t r4[4];
      ldsm_x4_t(r4, vb + dn * 8);
      mma_16816<T>(o[dn], pa, r4[0], r4[1]);
      mma_16816<T>(o[dn + 1], pa, r4[2], r4[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the merge
}

// One block per (split blockIdx.x, KV head and head chunk blockIdx.y,
// sequence blockIdx.z): up to 16 query heads of one KV head (the group's
// g rows padded to 16, the mma's M) against the split's keys
// [sp * kps, (sp + 1) * kps) intersected with the live range, or, in the
// ring split (the last, when there is a ring), against the ring's live
// rows. Each warp runs dec_attend; the four warps' states merge at the
// end in warp order. One split: the T output; several: fp32 partials (o
// unnormalised, m, l) in `part`, which the group's last split merges
// (dec_merge_if_last).
template <int D, typename T, typename KT>
__global__ void __launch_bounds__(DEC_NT)
paged_decode_split_kernel(const T* __restrict__ q,
                          const KT* __restrict__ k_pool,
                          const KT* __restrict__ v_pool,
                          const int* __restrict__ tables,
                          const int* __restrict__ start_pos,
                          const int* __restrict__ seq_lens,
                          T* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ cnt, Extras ex, Ring<T> ring,
                          int H, int KV, int maxb, int bs, float sm_scale,
                          int window, int kps) {
  constexpr int KS = D / 16;         // k-steps of Q.K^T
  constexpr int ND = D / 8;          // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char dec_smem[];

  const int sp = blockIdx.x, splits = gridDim.x, s = blockIdx.z;
  const bool ring_split = ring.k != nullptr && sp == splits - 1;
  const int g = H / KV, hc = gridDim.y / KV;
  const int kvh = blockIdx.y / hc, chunk = blockIdx.y % hc;
  const int h0 = kvh * g + chunk * DEC_HEADS;
  const int nrows = min(DEC_HEADS, g - chunk * DEC_HEADS);
  const int KVD = KV * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, qi = lane % 4;

  // every head of the block shares the query position: one live range,
  // cut to this split (never past the block table); the ring split's is
  // the ring's live rows (none for an idle slot)
  const int pos = start_pos[s];
  int a, b, dpos;
  if (ring_split) {
    b = seq_lens[s] > 0 ? ring.count : 0;
    a = window > 0 ? min(max(0, ring.count - window), b) : 0;
    dpos = ring.count - 1;
  } else {
    const int seq_len = min(seq_lens[s], maxb * bs);
    const int hi = max(0, min(seq_len, pos + 1));
    const int lo = window > 0 ? min(max(0, pos - window + 1), hi) : 0;
    a = max(lo, sp * kps);
    b = min(hi, (sp + 1) * kps);
    dpos = pos;
  }
  const size_t row0 = (size_t)s * H + h0;     // q / out row of head h0
  // part: o [S H][splits][D], then (m, l) [S H][splits]
  const size_t ml_base = (size_t)gridDim.z * H * splits * D;

  if (a >= b) {                      // nothing live here: an empty split
    if (splits == 1) {               // (an idle slot): zeros
      for (int i = tid; i < nrows * D; i += DEC_NT)
        out[row0 * D + i] = to_t<T>(0.f);
      return;
    }
    if (tid < nrows) {
      float* ml = part + ml_base + ((row0 + tid) * splits + sp) * 2;
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    dec_merge_if_last(part, out, cnt, reinterpret_cast<float*>(dec_smem),
                      row0, nrows, D, splits, ml_base);
    return;
  }

  // Q as A fragments, held for the whole range (rows past the group are
  // zeros): in registers, or at head dim 256 in a shared tile past the
  // ring's bytes; and the rows' ALiBi slopes (0 without)
  QFrags<D, T> qf;
  if constexpr (QFrags<D, T>::SMEM) {
    T* qs = reinterpret_cast<T*>(dec_smem + dec_stage_bytes<D, T, KT>());
    stage_q<D, T>(qs, q + row0 * D, D, DEC_HEADS, nrows, DEC_NT);
    __syncthreads();
    qfrags_at(qf, qs, D + 8, lane);
  }
  float slope[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = quad + 8 * i;
    const bool live = r < nrows;
    if constexpr (!QFrags<D, T>::SMEM) {
      const T* qr = q + (row0 + (live ? r : 0)) * D + qi * 2;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qf.r[kk][i] = live ? ld2(qr + kk * 16) : 0u;
        qf.r[kk][i + 2] = live ? ld2(qr + kk * 16 + 8) : 0u;
      }
    }
    slope[i] = live && ex.alibi != nullptr ? ex.alibi[h0 + r] : 0.f;
  }

  float o[ND][4], m[2], l[2];
  if (ring_split)
    dec_attend<D, T, T>(qf, ring.k, ring.v,
                        DecRows{nullptr, 0, ring.stride,
                                (long long)s * KVD + (long long)kvh * D},
                        nullptr, nullptr, a, b, dpos, slope, sm_scale, o, m,
                        l, dec_smem);
  else
    dec_attend<D, T, KT>(
        qf, k_pool, v_pool,
        DecRows{tables + (size_t)s * maxb, bs, KVD, (long long)kvh * D},
        ex.k_scales ? ex.k_scales + (size_t)kvh * ex.slots : nullptr,
        ex.v_scales ? ex.v_scales + (size_t)kvh * ex.slots : nullptr, a, b,
        dpos, slope, sm_scale, o, m, l, dec_smem);

  // the warps' states, then a merge in warp order
  float* ow = reinterpret_cast<float*>(dec_smem);     // [4][16][D]
  float* mw = ow + 4 * DEC_HEADS * D;                  // [4][16]
  float* lw = mw + 4 * DEC_HEADS;                      // [4][16]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = warp * DEC_HEADS + quad + 8 * i;
    if (qi == 0) {
      mw[r] = m[i];
      lw[r] = l[i];
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<float2*>(ow + r * D + dn * 8 + qi * 2) =
          make_float2(o[dn][2 * i], o[dn][2 * i + 1]);
  }
  __syncthreads();
  for (int i = tid; i < nrows * D; i += DEC_NT) {
    const int r = i / D, d = i % D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, mw[w * DEC_HEADS + r]);
    const float m_safe = (mm == -INFINITY) ? 0.f : mm;
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = expf(mw[w * DEC_HEADS + r] - m_safe);  // -inf: 0
      ll += lw[w * DEC_HEADS + r] * wt;
      oo += ow[(w * DEC_HEADS + r) * D + d] * wt;
    }
    if (splits == 1) {
      out[(row0 + r) * D + d] =
          to_t<T>(ll == 0.f ? 0.f : oo / ll);           // idle rows: 0
    } else {
      part[((row0 + r) * splits + sp) * D + d] = oo;
      if (d == 0) {
        float* ml = part + ml_base + ((row0 + r) * splits + sp) * 2;
        ml[0] = mm;
        ml[1] = ll;
      }
    }
  }
  if (splits > 1)                // (its first barrier also ends the reads
                                 // of the warps' states that `wl` reuses)
    dec_merge_if_last(part, out, cnt, reinterpret_cast<float*>(dec_smem),
                      row0, nrows, D, splits, ml_base);
}

// The dynamic shared memory attribute, set once per kernel and device
// (hopper.cuh's cache, keyed by the kernel's address: instances whose
// signatures agree never share an entry), and a block that fits.
template <typename K>
cudaError_t smem_ready(K kern, unsigned threads, size_t smem) {
  int per_sm = 0;
  cudaError_t err = blocks_per_sm(reinterpret_cast<const void*>(kern),
                                  threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  return per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// the pool's 16-byte rows and the scales' 4-byte alignment (int8: scales
// required)
bool pool_ok(const void* k_pool, const void* v_pool, const Extras& ex,
             bool quant) {
  if (((uintptr_t)k_pool | (uintptr_t)v_pool) % 16) return false;
  if (quant)
    return ex.k_scales && ex.v_scales && ex.slots > 0 &&
           ((uintptr_t)ex.k_scales | (uintptr_t)ex.v_scales) % 4 == 0;
  return ex.k_scales == nullptr && ex.v_scales == nullptr;
}

template <int D, typename T, typename KT>
cudaError_t launch_decode_split(const void* q, const void* k_pool,
                                const void* v_pool, const int* tables,
                                const int* start_pos, const int* seq_lens,
                                void* out, void* part, void* cnt,
                                const Extras& ex, const Ring<T>& ring, int S,
                                int H, int KV, int maxb, int bs,
                                float sm_scale, int window, int splits,
                                int kps, cudaStream_t stream) {
  // 16-byte K/V row loads (pool and ring), 4-byte q loads
  if (!pool_ok(k_pool, v_pool, ex, std::is_same<KT, int8_t>::value) ||
      (uintptr_t)q % 4 ||
      (ring.k && (((uintptr_t)ring.k | (uintptr_t)ring.v) % 16 ||
                  ring.stride % 8 || ring.count < 0)))
    return cudaErrorMisalignedAddress;
  const int hc = (H / KV + DEC_HEADS - 1) / DEC_HEADS;
  const int total = splits + (ring.k != nullptr);   // the ring's split last
  // the splits must cover the table's capacity, within the grid's limits;
  // the merge's weights [16][total + 1] fit in the block's shared memory
  constexpr size_t smem = dec_smem_bytes<D, T, KT>();
  if (splits < 1 || kps < 1 ||
      (size_t)DEC_HEADS * (total + 1) * sizeof(float) > smem ||
      (total > 1 && (part == nullptr || cnt == nullptr)) ||
      (long long)splits * kps < (long long)maxb * bs || S > 65535 ||
      (long long)KV * hc > 65535)
    return cudaErrorInvalidValue;
  auto kern = paged_decode_split_kernel<D, T, KT>;
  cudaError_t err = smem_ready(kern, DEC_NT, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(total, KV * hc, S), DEC_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), tables, start_pos, seq_lens,
      static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int*>(cnt), ex, ring, H, KV, maxb, bs, sm_scale, window,
      kps);
  return cudaGetLastError();
}

template <int D, typename T, typename KT>
cudaError_t launch_mma(const void* q, const void* k_pool, const void* v_pool,
                       const int* tables, const int* start_pos,
                       const int* seq_lens, void* out, const Extras& ex,
                       int S, int C, int H, int KV, int maxb, int bs,
                       float sm_scale, int window, cudaStream_t stream) {
  // 16-byte K/V row loads, 4-byte q loads and out stores
  if (!pool_ok(k_pool, v_pool, ex, std::is_same<KT, int8_t>::value) ||
      ((uintptr_t)q | (uintptr_t)out) % 4)
    return cudaErrorMisalignedAddress;
  dim3 grid(S, (C + MMA_ROWS - 1) / MMA_ROWS, H);
  constexpr size_t smem = mma_smem_bytes<D, T>();
  auto kern = paged_prefill_mma_kernel<D, T, KT>;
  cudaError_t err = smem_ready(kern, MMA_NT, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, MMA_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), tables, start_pos, seq_lens,
      static_cast<T*>(out), ex, C, H, KV, maxb, bs, sm_scale, window);
  return cudaGetLastError();
}

// A tiled TMA map over 16-bit data with 64 x `rows` boxes (64 elements of
// the innermost dim, `rows` of the third dim for Q, of the second for the
// pool), the 128-byte swizzle that wgmma reads.
template <typename T>
cudaError_t pw_map(CUtensorMap* map, const void* base, int rank,
                   const cuuint64_t* dims, const cuuint64_t* strides,
                   const cuuint32_t* box) {
  return encode_tensor_map(map,
                           std::is_same<T, __half>::value
                               ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                           rank, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, bool GATHER, typename T>
cudaError_t launch_wgmma(const void* q, const void* k_pool,
                         const void* v_pool, const int* tables,
                         const int* start_pos, const int* seq_lens,
                         void* out, const float* alibi, int S, int C, int H,
                         int KV, int maxb, int bs, float sm_scale, int window,
                         int slots, int grid, cudaStream_t stream) {
  // TMA bases and 16-byte rows; a TMA half never crosses a block's end
  if (((uintptr_t)q | (uintptr_t)k_pool | (uintptr_t)v_pool |
       (uintptr_t)out) % 16)
    return cudaErrorMisalignedAddress;
  if (grid < 1 || C < 64 || (!GATHER && (bs % 64 || slots < 64)))
    return cudaErrorInvalidValue;
  if ((long long)((C + PW_ROWS - 1) / PW_ROWS) * S * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  constexpr size_t E = sizeof(T);
  // Q [S, C, H, D] as (d, h, c, s), boxes of 64 queries of one head
  const cuuint64_t qd[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)C,
                            (cuuint64_t)S};
  const cuuint64_t qst[3] = {(cuuint64_t)D * E, (cuuint64_t)H * D * E,
                             (cuuint64_t)C * H * D * E};
  const cuuint32_t qbox[4] = {64, 1, 64, 1};
  // the pool [slots, KV * D], boxes of 64 token rows
  const cuuint64_t kd[2] = {(cuuint64_t)KV * D, (cuuint64_t)slots};
  const cuuint64_t kst[1] = {(cuuint64_t)KV * D * E};
  const cuuint32_t kbox[2] = {64, 64};
  CUtensorMap tq, tk, tv;
  cudaError_t err = pw_map<T>(&tq, q, 4, qd, qst, qbox);
  tk = tv = tq;                  // GATHER reads the pool by cp.async only
  if (!GATHER && err == cudaSuccess)
    err = pw_map<T>(&tk, k_pool, 2, kd, kst, kbox);
  if (!GATHER && err == cudaSuccess)
    err = pw_map<T>(&tv, v_pool, 2, kd, kst, kbox);
  if (err != cudaSuccess) return err;
  auto kern = alibi ? paged_prefill_wgmma_kernel<D, GATHER, T, true>
                    : paged_prefill_wgmma_kernel<D, GATHER, T, false>;
  constexpr size_t smem = pw_smem_bytes<D>();
  int per_sm = 0;
  err = blocks_per_sm(reinterpret_cast<const void*>(kern), PW_THREADS, smem,
                      &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  kern<<<grid, PW_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, start_pos, seq_lens,
      static_cast<T*>(out), alibi, S, C, H, KV, maxb, bs, sm_scale, window);
  return cudaGetLastError();
}

template <typename KT, int D, int ROWS, int TK, bool DECODE>
cudaError_t launch_f32(const void* q, const void* k_pool, const void* v_pool,
                       const int* tables, const int* start_pos,
                       const int* seq_lens, void* out, const Extras& ex,
                       const Ring<float>& ring, int S, int C, int H, int KV,
                       int maxb, int bs, float sm_scale, int window,
                       cudaStream_t stream) {
  if (!pool_ok(nullptr, nullptr, ex, std::is_same<KT, int8_t>::value))
    return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<D, ROWS, TK>();
  auto kern = paged_attn_kernel<KT, D, ROWS, TK, DECODE>;
  cudaError_t err = smem_ready(kern, CC_NT, smem);
  if (err != cudaSuccess) return err;
  dim3 grid = DECODE ? dim3(S, KV, (H / KV + ROWS - 1) / ROWS)
                     : dim3(S, (C + ROWS - 1) / ROWS, H);
  kern<<<grid, CC_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), tables, start_pos, seq_lens,
      static_cast<float*>(out), ex, ring, C, H, KV, maxb, bs, sm_scale,
      window);
  return cudaGetLastError();
}

// Fn::run<D>(args...) for the head dims the kernels are instantiated
// for; cudaErrorInvalidValue for any other
template <typename Fn, typename... A>
cudaError_t by_head_dim(int D, const A&... a) {
  switch (D) {
    case 16: return Fn::template run<16>(a...);
    case 32: return Fn::template run<32>(a...);
    case 64: return Fn::template run<64>(a...);
    case 80: return Fn::template run<80>(a...);
    case 96: return Fn::template run<96>(a...);
    case 128: return Fn::template run<128>(a...);
    case 256: return Fn::template run<256>(a...);
    default: return cudaErrorInvalidValue;
  }
}

// The launchers of one route with every template argument but the head
// dim bound: K2 / K1 mma.sync over a pool of KT in compute dtype T, and
// the fp32 kernel over a pool of KT.
template <typename T, typename KT>
struct Split {
  template <int D>
  static cudaError_t run(const void* q, const void* kp, const void* vp,
                         const int* t, const int* sp, const int* sl,
                         void* out, void* part, void* cnt, const Extras& ex,
                         const Ring<T>& ring, int S, int H, int KV, int maxb,
                         int bs, float scale, int window, int splits, int kps,
                         cudaStream_t st) {
    return launch_decode_split<D, T, KT>(q, kp, vp, t, sp, sl, out, part,
                                         cnt, ex, ring, S, H, KV, maxb, bs,
                                         scale, window, splits, kps, st);
  }
};
template <typename T, typename KT>
struct Mma {
  template <int D>
  static cudaError_t run(const void* q, const void* kp, const void* vp,
                         const int* t, const int* sp, const int* sl,
                         void* out, const Extras& ex, int S, int C, int H,
                         int KV, int maxb, int bs, float scale, int window,
                         cudaStream_t st) {
    return launch_mma<D, T, KT>(q, kp, vp, t, sp, sl, out, ex, S, C, H, KV,
                                maxb, bs, scale, window, st);
  }
};
template <typename KT, bool DECODE>
struct F32 {
  template <int D>
  static cudaError_t run(const void* q, const void* kp, const void* vp,
                         const int* t, const int* sp, const int* sl,
                         void* out, const Extras& ex, const Ring<float>& ring,
                         int S, int C, int H, int KV, int maxb, int bs,
                         float scale, int window, cudaStream_t st) {
    return launch_f32<KT, D, DECODE ? DEC_ROWS : PF_ROWS,
                      DECODE ? DEC_TK : PF_TK, DECODE>(
        q, kp, vp, t, sp, sl, out, ex, ring, S, C, H, KV, maxb, bs, scale,
        window, st);
  }
};

// K1's routes, as ops/kernels/paged_attention.py `prefill_route` numbers
// them: the CUDA-core kernel (fp32), mma.sync (bf16 / fp16, and every
// int8 pool), and the wgmma kernel with K/V by TMA or by the cp.async
// gather (bf16 / fp16, D = 64 and 128)
enum PrefillRoute { PF_F32 = 0, PF_MMA = 1, PF_WGMMA_TMA = 2,
                    PF_WGMMA_GATHER = 3 };
// the compute dtype codes of the entry points
enum DtypeCode { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

bool heads_ok(int S, int H, int KV, int maxb, int bs) {
  return S > 0 && H > 0 && KV > 0 && H % KV == 0 && bs > 0 && maxb > 0;
}

template <int D, bool GATHER>
cudaError_t wgmma_by_dtype(int dtype, const void* q, const void* kp,
                           const void* vp, const int* t, const int* sp,
                           const int* sl, void* out, const float* alibi,
                           int S, int C, int H, int KV, int maxb, int bs,
                           float scale, int window, int slots, int grid,
                           cudaStream_t st) {
  return dtype == DT_F16
             ? launch_wgmma<D, GATHER, __half>(q, kp, vp, t, sp, sl, out,
                                               alibi, S, C, H, KV, maxb, bs,
                                               scale, window, slots, grid, st)
             : launch_wgmma<D, GATHER, __nv_bfloat16>(
                   q, kp, vp, t, sp, sl, out, alibi, S, C, H, KV, maxb, bs,
                   scale, window, slots, grid, st);
}

}  // namespace

extern "C" {

// q [S, C, H, D] and out in the compute dtype `dtype` (DtypeCode); k_pool
// / v_pool [slots, KV*D] in it, or int8 (quant) with k_scales / v_scales
// [KV, slots] f32; alibi [H] f32 or null; tables [S, maxb] int32;
// start_pos / seq_lens [S] int32. window <= 0: none. `route`
// (PrefillRoute) as the wrapper chose it from the shapes; the wgmma
// routes run `grid` persistent blocks (`prefill_plan`).
int paged_prefill_launch(const void* q, const void* k_pool,
                         const void* v_pool, const void* tables,
                         const void* start_pos, const void* seq_lens,
                         void* out, const void* k_scales,
                         const void* v_scales, const void* alibi, int S,
                         int C, int H, int KV, int D, int maxb, int bs,
                         float sm_scale, int window, int slots, int route,
                         int grid, int dtype, int quant, void* stream) {
  if (!heads_ok(S, H, KV, maxb, bs) || C < 1 || dtype < DT_F32 ||
      dtype > DT_F16 || (route == PF_F32) != (dtype == DT_F32))
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* sp = static_cast<const int*>(start_pos);
  const int* sl = static_cast<const int*>(seq_lens);
  const Extras ex{static_cast<const float*>(k_scales),
                  static_cast<const float*>(v_scales),
                  static_cast<const float*>(alibi), slots};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (route) {
    case PF_F32: {
      const Ring<float> none{nullptr, nullptr, 0, 0};
      return (int)(quant ? by_head_dim<F32<int8_t, false>>(
                               D, q, k_pool, v_pool, t, sp, sl, out, ex,
                               none, S, C, H, KV, maxb, bs, sm_scale, window,
                               st)
                         : by_head_dim<F32<float, false>>(
                               D, q, k_pool, v_pool, t, sp, sl, out, ex,
                               none, S, C, H, KV, maxb, bs, sm_scale, window,
                               st));
    }
    case PF_MMA:
#define PF_MMA_RUN(TY, KTY)                                                \
  by_head_dim<Mma<TY, KTY>>(D, q, k_pool, v_pool, t, sp, sl, out, ex, S, C, \
                            H, KV, maxb, bs, sm_scale, window, st)
      if (dtype == DT_F16)
        return (int)(quant ? PF_MMA_RUN(__half, int8_t)
                           : PF_MMA_RUN(__half, __half));
      return (int)(quant ? PF_MMA_RUN(__nv_bfloat16, int8_t)
                         : PF_MMA_RUN(__nv_bfloat16, __nv_bfloat16));
#undef PF_MMA_RUN
    case PF_WGMMA_TMA:
    case PF_WGMMA_GATHER: {
      // TMA cannot widen int8: an int8 pool takes the mma route
      if (quant || k_scales || v_scales) return (int)cudaErrorInvalidValue;
      const bool g = route == PF_WGMMA_GATHER;
      const float* al = static_cast<const float*>(alibi);
      if (D == 64)
        return (int)(g ? wgmma_by_dtype<64, true>
                       : wgmma_by_dtype<64, false>)(
            dtype, q, k_pool, v_pool, t, sp, sl, out, al, S, C, H, KV, maxb,
            bs, sm_scale, window, slots, grid, st);
      if (D == 128)
        return (int)(g ? wgmma_by_dtype<128, true>
                       : wgmma_by_dtype<128, false>)(
            dtype, q, k_pool, v_pool, t, sp, sl, out, al, S, C, H, KV, maxb,
            bs, sm_scale, window, slots, grid, st);
      return (int)cudaErrorInvalidValue;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// as above with C == 1, and the decode loop's ring: ring_k / ring_v rows
// [R][S][KV*D] of the compute dtype `ring_stride` elements apart,
// `ring_count` of them valid (ring_k null: none). bf16 / fp16 run the
// split kernel on `splits` splits of `kps` keys each (splits * kps >=
// maxb * bs; the plan of ops/kernels/paged_attention.py `decode_plan`),
// plus the ring's split, with fp32 partials in `part` [S * H * (splits +
// ring) * (D + 2)] and zeroed int32 counters `cnt` [S * KV * head chunks]
// (left zeroed) when there is more than one; fp32 ignores the four.
int paged_decode_launch(const void* q, const void* k_pool,
                        const void* v_pool, const void* tables,
                        const void* start_pos, const void* seq_lens,
                        void* out, const void* k_scales, const void* v_scales,
                        const void* alibi, void* part, void* cnt,
                        const void* ring_k, const void* ring_v, int S, int H,
                        int KV, int D, int maxb, int bs, float sm_scale,
                        int window, int slots, int dtype, int quant,
                        int splits, int kps, long long ring_stride,
                        int ring_count, void* stream) {
  if (!heads_ok(S, H, KV, maxb, bs) || dtype < DT_F32 || dtype > DT_F16 ||
      (ring_k == nullptr) != (ring_v == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* sp = static_cast<const int*>(start_pos);
  const int* sl = static_cast<const int*>(seq_lens);
  const Extras ex{static_cast<const float*>(k_scales),
                  static_cast<const float*>(v_scales),
                  static_cast<const float*>(alibi), slots};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    const Ring<float> r{static_cast<const float*>(ring_k),
                        static_cast<const float*>(ring_v), ring_stride,
                        ring_count};
    return (int)(quant ? by_head_dim<F32<int8_t, true>>(
                             D, q, k_pool, v_pool, t, sp, sl, out, ex, r, S,
                             1, H, KV, maxb, bs, sm_scale, window, st)
                       : by_head_dim<F32<float, true>>(
                             D, q, k_pool, v_pool, t, sp, sl, out, ex, r, S,
                             1, H, KV, maxb, bs, sm_scale, window, st));
  }
#define DEC_RUN(TY, KTY)                                                    \
  by_head_dim<Split<TY, KTY>>(                                              \
      D, q, k_pool, v_pool, t, sp, sl, out, part, cnt, ex,                  \
      Ring<TY>{static_cast<const TY*>(ring_k),                              \
               static_cast<const TY*>(ring_v), ring_stride, ring_count},    \
      S, H, KV, maxb, bs, sm_scale, window, splits, kps, st)
  if (dtype == DT_F16)
    return (int)(quant ? DEC_RUN(__half, int8_t) : DEC_RUN(__half, __half));
  return (int)(quant ? DEC_RUN(__nv_bfloat16, int8_t)
                     : DEC_RUN(__nv_bfloat16, __nv_bfloat16));
#undef DEC_RUN
}

}  // extern "C"
