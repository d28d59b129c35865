// Paged-KV flash attention for Hopper (sm_90a): the two kernels of the
// ragged serving path, reading K/V straight through per-sequence block
// tables.
//
// K1 paged_prefill replaces the Pallas kernel `_paged_kernel`
//   (deepspeed_tpu/ops/kernels/paged_attention.py:45, launched at :938).
//   It serves SplitFuse prefill chunks (C > 1 queries per slot).
//   Bound on the H100: at serving chunk sizes (256 queries over <= a few
//   thousand keys) the work is 4*D FLOPs per (query, key) pair against
//   2*D*2 bytes per live key row, so it sits near the bf16 ridge; by
//   shape it is FLOP-bound for long chunks and byte-bound for short ones.
//   So bf16 runs on the tensor cores: paged_prefill_mma_kernel, one block
//   of 4 warps per (sequence, 64-query tile, head), each warp 16 query
//   rows, mma.sync m16n8k16 (bf16 in, fp32 accumulate) for Q.K^T and
//   P.V with the scores, probabilities and output kept in registers.
//   fp32 inputs (the parity oracle) take paged_attn_kernel below
//   on the CUDA cores. Both keep device-memory traffic at the live rows:
//   the key loop covers [lo, hi) of the tile (causal end, sequence
//   length and sliding window), never a dead or padded table entry.
//   Head dims 16, 32, 64, 80, 96 and 128 are instantiated (the tiny test
//   config's 16, TinyLlama's 64, phi-2's 80, phi3's 96, Llama's 128);
//   the tensor-core loops step D in 16s, so every multiple of 16 fits.
//
// K2 paged_decode replaces the Pallas kernel `_decode_grouped_kernel`
//   (paged_attention.py:205, launched at :615). One query per sequence;
//   one block per (sequence, KV head) serves that KV head's g = H / KV
//   query heads, so each K/V row is read from device memory once for all
//   g heads. Bound on the H100: the bytes of the live K/V rows (decode
//   attention does 4*D FLOPs per 4*D bytes of bf16 K/V per head group --
//   far below the ridge). Each K/V element is loaded once per block. A
//   group wider than DEC_ROWS query heads splits across ceil(g / DEC_ROWS)
//   blocks (a third grid axis), each reading the KV head's rows once.
//   Split-K over the context (flash-decoding) is not done yet, so a batch
//   of S sequences fills only S * KV * ceil(g / DEC_ROWS) blocks.
//
// Both: online softmax in fp32 with the -inf guards of the Pallas kernels
// (a row with no live key emits zeros, never NaN), K/V tiles staged in
// shared memory, products accumulated in fp32. bf16 or fp32 inputs. As in
// the Pallas kernels, the probabilities are cast to the V dtype before
// P.V and the row sums are taken before that cast.
// Kernels launch on the caller's stream, do not synchronise and allocate
// nothing; each C entry point returns cudaGetLastError().
//
// TPU-only devices of the Pallas kernels are not carried over: lane-
// windowed GQA, the G-sequence grouped DMA and its contiguity check, the
// VMEM-budgeted tile sizes, the pool_full / layer-index scalar prefetch,
// and the decode-loop ring (the port's decode loop appends each step's
// K/V to the pool before attending).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int PF_ROWS = 32;        // K1: queries per block
constexpr int PF_TK = 32;          // K1: keys per tile
constexpr int DEC_ROWS = 16;       // K2: query heads of a block
constexpr int DEC_TK = 64;         // K2: keys per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
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

template <int D, int ROWS, int TK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS * (D + 1) + TK * (D + 1) + TK * D +
                          ROWS * (TK + 1) + 3 * ROWS) +
         sizeof(int) * 2 * ROWS;
}

// One block attends ROWS query rows that share one KV head against the
// keys of one sequence. DECODE: rows are heads [blockIdx.z * ROWS, +ROWS)
// of the g heads of KV head blockIdx.y, at query 0. PREFILL: rows are
// PF_ROWS consecutive queries (tile blockIdx.y) of head blockIdx.z.
template <typename T, int D, int ROWS, int TK, bool DECODE>
__global__ void __launch_bounds__(NT)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ tables,
                  const int* __restrict__ start_pos,
                  const int* __restrict__ seq_lens, T* __restrict__ out,
                  int C, int H, int KV, int maxb, int bs, float sm_scale,
                  int window) {
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
  int* lo_s = reinterpret_cast<int*>(a_s + ROWS);   // live keys [lo, hi)
  int* hi_s = lo_s + ROWS;

  const int tid = threadIdx.x;
  const int start = start_pos[s];
  // never index past the block table, whatever seq_lens says
  const int seq_len = min(seq_lens[s], maxb * bs);

  for (int r = tid; r < ROWS; r += NT) {
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
  for (int i = tid; i < ROWS * D; i += NT) {
    const int r = i / D, d = i % D;
    float v = 0.f;
    if (r < nrows) {
      const size_t off =
          DECODE ? ((size_t)s * C * H + h0 + r) * D + d
                 : (((size_t)s * C + c0 + r) * H + h0) * D + d;
      v = to_f(q[off]) * sm_scale;
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

  constexpr int PAIRS = (ROWS * D + NT - 1) / NT;
  float acc[PAIRS];
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) acc[k] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  for (int t0 = lo; t0 < hi; t0 += TK) {
    // stage the K/V tile: token j lives in row table[j / bs] * bs + j % bs
    for (int i = tid; i < TK * D; i += NT) {
      const int r = i / D, d = i % D;
      const int j = t0 + r;
      float kv = 0.f, vv = 0.f;
      if (j < hi) {
        const int blk = tables[(size_t)s * maxb + j / bs];
        const size_t off =
            ((size_t)blk * bs + (j % bs)) * KVD + (size_t)kvh * D + d;
        kv = to_f(k_pool[off]);
        vv = to_f(v_pool[off]);
      }
      ks[r * (D + 1) + d] = kv;
      vs[r * D + d] = vv;
    }
    __syncthreads();
    // scores, masked per row
    for (int i = tid; i < ROWS * TK; i += NT) {
      const int r = i / TK, c = i % TK;
      const int j = t0 + c;
      float sc = -INFINITY;
      if (r < nrows && j >= lo_s[r] && j < hi_s[r]) {
        const float* qr = qs + r * (D + 1);
        const float* kr = ks + c * (D + 1);
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        sc = a;
      }
      ps[r * (TK + 1) + c] = sc;
    }
    __syncthreads();
    // online softmax: one warp per row
    for (int r = warp; r < ROWS; r += NT / 32) {
      float* pr = ps + r * (TK + 1);
      float mt = -INFINITY;
      for (int c = lane; c < TK; c += 32) mt = fmaxf(mt, pr[c]);
      mt = warp_max(mt);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mt);
      // a row with nothing live yet keeps m = -inf: exp through a finite
      // stand-in so no (-inf) - (-inf) NaN appears; p comes out 0
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_safe);
      float sum = 0.f;
      for (int c = lane; c < TK; c += 32) {
        const float x = pr[c];
        const float p = (x == -INFINITY) ? 0.f : expf(x - m_safe);
        pr[c] = to_f(from_f<T>(p));      // p in the V dtype, as in Pallas
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
      const int i = tid + k * NT;
      if (i < ROWS * D) {
        const int r = i / D, d = i % D;
        const float* pr = ps + r * (TK + 1);
        float a = acc[k] * a_s[r];
#pragma unroll 8
        for (int c = 0; c < TK; ++c) a = fmaf(pr[c], vs[c * D + d], a);
        acc[k] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    const int i = tid + k * NT;
    if (i < ROWS * D) {
      const int r = i / D, d = i % D;
      if (r < nrows) {
        const float l = l_s[r];
        const float o = (l == 0.f) ? 0.f : acc[k] / l;   // idle rows: 0
        const size_t off =
            DECODE ? ((size_t)s * C * H + h0 + r) * D + d
                   : (((size_t)s * C + c0 + r) * H + h0) * D + d;
        out[off] = from_f<T>(o);
      }
    }
  }
}

// ------------------------------------------------ K1 on the tensor cores

constexpr int MMA_NT = 128;        // K1 bf16: threads per block (4 warps)
constexpr int MMA_ROWS = 64;       // K1 bf16: queries per block
constexpr int MMA_TK = 64;         // K1 bf16: keys per tile

// c += a * b for one m16n8k16 tile. Fragment layout (PTX ISA, mma.m16n8k16
// .bf16), with quad = lane / 4 and qi = lane % 4:
//   a[0..3]: rows quad / quad+8 / quad / quad+8, columns 2qi..2qi+1 (+8
//            for a[2], a[3]) of the 16 x 16 A tile;
//   b0, b1:  rows (k) 2qi..2qi+1 (+8 for b1), column (n) quad of B;
//   c[0..3]: rows quad, quad, quad+8, quad+8; columns 2qi, 2qi+1 (x2).
// In each 32-bit register the lower column (or row for B) is the low half.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

template <int D>
__global__ void __launch_bounds__(MMA_NT)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_pool,
                         const __nv_bfloat16* __restrict__ v_pool,
                         const int* __restrict__ tables,
                         const int* __restrict__ start_pos,
                         const int* __restrict__ seq_lens,
                         __nv_bfloat16* __restrict__ out, int C, int H,
                         int KV, int maxb, int bs, float sm_scale,
                         int window) {
  constexpr int KS = D / 16;         // k-steps of Q.K^T
  constexpr int NS = MMA_TK / 8;     // 8-key column tiles of a score tile
  constexpr int ND = D / 8;          // 8-wide column tiles of the output
  constexpr int LD = D + 8;          // padded smem row: no bank conflicts
  __shared__ __align__(16) __nv_bfloat16 ks[MMA_TK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[MMA_TK * LD];

  const int s = blockIdx.x, c0 = blockIdx.y * MMA_ROWS, h = blockIdx.z;
  const int kvh = h / (H / KV);
  const int KVD = KV * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, qi = lane % 4;
  const int start = start_pos[s];
  // never index past the block table, whatever seq_lens says
  const int seq_len = min(seq_lens[s], maxb * bs);

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

  // Q as A fragments, loaded once (rows past the chunk are zeros)
  uint32_t qf[KS][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = crow[i] < C;
    const __nv_bfloat16* qr =
        q + (((size_t)s * C + (live ? crow[i] : 0)) * H + h) * D + qi * 2;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[kk][i] = live ? ld2(qr + kk * 16) : 0u;
      qf[kk][i + 2] = live ? ld2(qr + kk * 16 + 8) : 0u;
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
    // stage the K/V tile, 16 bytes a thread: token j lives in pool row
    // table[j / bs] * bs + j % bs; rows past hi are zeros (P is 0 there,
    // and 0 * garbage could be NaN)
    for (int i = tid; i < MMA_TK * (D / 8); i += MMA_NT) {
      const int r = i / (D / 8), ch = i % (D / 8);
      const int j = t0 + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (j < hi) {
        const int blk = tables[(size_t)s * maxb + j / bs];
        const size_t off =
            ((size_t)blk * bs + (j % bs)) * KVD + (size_t)kvh * D + ch * 8;
        kv4 = *reinterpret_cast<const uint4*>(k_pool + off);
        vv4 = *reinterpret_cast<const uint4*>(v_pool + off);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + ch * 8) = kv4;
      *reinterpret_cast<uint4*>(vs + r * LD + ch * 8) = vv4;
    }
    __syncthreads();

    // scores: this warp's 16 rows x MMA_TK keys
    float sc[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + quad) * LD + qi * 2;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_16816(sc[nt], qf[kk], ld2(kr + kk * 16), ld2(kr + kk * 16 + 8));
    }
    // mask, scale, row max over the quad that shares a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, j = t0 + nt * 8 + qi * 2 + (e & 1);
        const float x = (j >= lo_r[i] && j < hi_r[i]) ? sc[nt][e] * sm_scale
                                                      : -INFINITY;
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
        const float p = expf(sc[nt][e] - m_safe[e / 2]);
        sc[nt][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e / 2];

    // o += P.V: the score accumulators re-pack as A fragments
#pragma unroll
    for (int kk = 0; kk < MMA_TK / 16; ++kk) {
      const uint32_t a[4] = {pack2(sc[2 * kk][0], sc[2 * kk][1]),
                             pack2(sc[2 * kk][2], sc[2 * kk][3]),
                             pack2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const __nv_bfloat16* vr = vs + (kk * 16 + qi * 2) * LD + quad;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        const __nv_bfloat16* v0 = vr + dn * 8;
        mma_16816(o[dn], a, pack2(v0[0], v0[LD]),
                  pack2(v0[8 * LD], v0[9 * LD]));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (crow[i] >= C) continue;
    const float inv = (li == 0.f) ? 0.f : 1.f / li;       // idle rows: 0
    __nv_bfloat16* orow = out + (((size_t)s * C + crow[i]) * H + h) * D;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + qi * 2) =
          pack2(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k_pool, const void* v_pool,
                       const int* tables, const int* start_pos,
                       const int* seq_lens, void* out, int S, int C, int H,
                       int KV, int maxb, int bs, float sm_scale, int window,
                       cudaStream_t stream) {
  // 16-byte K/V row loads, 4-byte q loads and out stores
  if (((uintptr_t)k_pool | (uintptr_t)v_pool) % 16 ||
      ((uintptr_t)q | (uintptr_t)out) % 4)
    return cudaErrorMisalignedAddress;
  dim3 grid(S, (C + MMA_ROWS - 1) / MMA_ROWS, H);
  paged_prefill_mma_kernel<D><<<grid, MMA_NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), tables, start_pos, seq_lens,
      static_cast<__nv_bfloat16*>(out), C, H, KV, maxb, bs, sm_scale, window);
  return cudaGetLastError();
}

template <typename T, int D, int ROWS, int TK, bool DECODE>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* start_pos,
                   const int* seq_lens, void* out, int S, int C, int H,
                   int KV, int maxb, int bs, float sm_scale, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, ROWS, TK>();
  auto kern = paged_attn_kernel<T, D, ROWS, TK, DECODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid = DECODE ? dim3(S, KV, (H / KV + ROWS - 1) / ROWS)
                     : dim3(S, (C + ROWS - 1) / ROWS, H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, start_pos, seq_lens,
      static_cast<T*>(out), C, H, KV, maxb, bs, sm_scale, window);
  return cudaGetLastError();
}

// fn<D>(args...) for the head dims the kernels are instantiated for;
// cudaErrorInvalidValue for any other
#define BY_HEAD_DIM(D, fn, ...)                                          \
  ((D) == 16    ? fn<16>(__VA_ARGS__)                                   \
   : (D) == 32  ? fn<32>(__VA_ARGS__)                                   \
   : (D) == 64  ? fn<64>(__VA_ARGS__)                                   \
   : (D) == 80  ? fn<80>(__VA_ARGS__)                                   \
   : (D) == 96  ? fn<96>(__VA_ARGS__)                                   \
   : (D) == 128 ? fn<128>(__VA_ARGS__)                                  \
                : cudaErrorInvalidValue)

template <typename T, bool DECODE>
struct ByDim {
  static constexpr int ROWS = DECODE ? DEC_ROWS : PF_ROWS;
  static constexpr int TK = DECODE ? DEC_TK : PF_TK;
  template <int D>
  static cudaError_t run(const void* q, const void* k_pool,
                         const void* v_pool, const int* t, const int* sp,
                         const int* sl, void* out, int S, int C, int H,
                         int KV, int maxb, int bs, float sm_scale, int window,
                         cudaStream_t st) {
    // K1 in bf16 runs on the tensor cores; the rest on the CUDA cores
    if constexpr (!DECODE && std::is_same<T, __nv_bfloat16>::value)
      return launch_mma<D>(q, k_pool, v_pool, t, sp, sl, out, S, C, H, KV,
                           maxb, bs, sm_scale, window, st);
    else
      return launch<T, D, ROWS, TK, DECODE>(q, k_pool, v_pool, t, sp, sl,
                                            out, S, C, H, KV, maxb, bs,
                                            sm_scale, window, st);
  }
};

template <bool DECODE>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* tables, const void* start_pos, const void* seq_lens,
             void* out, int S, int C, int H, int KV, int D, int maxb, int bs,
             float sm_scale, int window, int is_bf16, void* stream) {
  if (S <= 0 || H <= 0 || KV <= 0 || H % KV || bs <= 0 || maxb <= 0)
    return (int)cudaErrorInvalidValue;
  if (DECODE ? C != 1 : C < 1) return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* sp = static_cast<const int*>(start_pos);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using BF = ByDim<__nv_bfloat16, DECODE>;
  using FP = ByDim<float, DECODE>;
  cudaError_t err =
      is_bf16 ? BY_HEAD_DIM(D, BF::template run, q, k_pool, v_pool, t, sp,
                            sl, out, S, C, H, KV, maxb, bs, sm_scale, window,
                            st)
              : BY_HEAD_DIM(D, FP::template run, q, k_pool, v_pool, t, sp,
                            sl, out, S, C, H, KV, maxb, bs, sm_scale, window,
                            st);
  return (int)err;
}

}  // namespace

extern "C" {

// q [S, C, H, D]; k_pool / v_pool [slots, KV*D]; tables [S, maxb] int32;
// start_pos / seq_lens [S] int32; out [S, C, H, D]. window <= 0: none.
int paged_prefill_launch(const void* q, const void* k_pool,
                         const void* v_pool, const void* tables,
                         const void* start_pos, const void* seq_lens,
                         void* out, int S, int C, int H, int KV, int D,
                         int maxb, int bs, float sm_scale, int window,
                         int is_bf16, void* stream) {
  return dispatch<false>(q, k_pool, v_pool, tables, start_pos, seq_lens, out,
                         S, C, H, KV, D, maxb, bs, sm_scale, window, is_bf16,
                         stream);
}

// as above with C == 1
int paged_decode_launch(const void* q, const void* k_pool,
                        const void* v_pool, const void* tables,
                        const void* start_pos, const void* seq_lens,
                        void* out, int S, int H, int KV, int D, int maxb,
                        int bs, float sm_scale, int window, int is_bf16,
                        void* stream) {
  return dispatch<true>(q, k_pool, v_pool, tables, start_pos, seq_lens, out,
                        S, 1, H, KV, D, maxb, bs, sm_scale, window, is_bf16,
                        stream);
}

}  // extern "C"
