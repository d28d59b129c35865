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
//   host read of seq_lens). K and V stay bf16 and stream into a ring of 3
//   or 4 shared-memory stages by 16-byte cp.async, one block-table read
//   per staged row, one __syncthreads a 64-key tile. Both products run on
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
constexpr int DEC_ROWS = 16;       // K2 fp32: query heads of a block
constexpr int DEC_TK = 64;         // K2 fp32: keys per tile

// the CUDA-core kernel runs fp32 only (the parity oracle)
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared without waiting, or zeros when `live` is false
// (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Plain: lane t gets row t / 4, columns
// 2 (t % 4), +1 of each; .trans: column t / 4, rows 2 (t % 4), +1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// ------------------------------------------ K2 in bf16: flash-decoding

constexpr int DEC_NT = 128;        // K2 bf16: threads per block (4 warps)
constexpr int DEC_TILE = 64;       // K2 bf16: keys per staged tile, 16 a warp
constexpr int DEC_HEADS = 16;      // K2 bf16: query heads of a block (mma M)

// stages of the K/V ring: deeper where a tile is small
template <int D>
__host__ __device__ constexpr int dec_stages() { return D <= 64 ? 4 : 3; }

// The K/V ring [stage][K, V][DEC_TILE][D + 8] bf16; after the key loop
// the same bytes hold the four warps' partial states (o [16][D], m [16],
// l [16] fp32 each).
template <int D>
__host__ __device__ constexpr size_t dec_smem_bytes() {
  const size_t ring = (size_t)dec_stages<D>() * 2 * DEC_TILE * (D + 8) *
                      sizeof(__nv_bfloat16);
  const size_t merge = (size_t)4 * DEC_HEADS * (D + 2) * sizeof(float);
  return ring > merge ? ring : merge;
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
__device__ __forceinline__ void dec_merge_if_last(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
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
    out[(row0 + r) * D + d] = __float2bfloat16(ll == 0.f ? 0.f : oo / ll);
  }
}

// One block per (split blockIdx.x, KV head and head chunk blockIdx.y,
// sequence blockIdx.z): up to 16 query heads of one KV head (the group's
// g rows padded to 16, the mma's M) against the split's keys
// [sp * kps, (sp + 1) * kps) intersected with the live range. The keys
// stream in 64-key tiles through a ring of cp.async stages; warp w takes
// keys [16 w, 16 w + 16) of each tile with its own online softmax in
// registers, and the four warps' states merge at the end. One split: the
// bf16 output; several: fp32 partials (o unnormalised, m, l) in `part`,
// which the group's last split merges (dec_merge_if_last).
template <int D>
__global__ void __launch_bounds__(DEC_NT)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k_pool,
                          const __nv_bfloat16* __restrict__ v_pool,
                          const int* __restrict__ tables,
                          const int* __restrict__ start_pos,
                          const int* __restrict__ seq_lens,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ part, int* __restrict__ cnt,
                          int H, int KV, int maxb, int bs, float sm_scale,
                          int window, int kps) {
  constexpr int ST = dec_stages<D>();
  constexpr int LD = D + 8;          // padded smem row: no bank conflicts
  constexpr int CH = D / 8;          // 16-byte chunks of a K/V row
  constexpr int KS = D / 16;         // k-steps of Q.K^T
  constexpr int ND = D / 8;          // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char dec_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(dec_smem);

  const int sp = blockIdx.x, splits = gridDim.x, s = blockIdx.z;
  const int g = H / KV, hc = gridDim.y / KV;
  const int kvh = blockIdx.y / hc, chunk = blockIdx.y % hc;
  const int h0 = kvh * g + chunk * DEC_HEADS;
  const int nrows = min(DEC_HEADS, g - chunk * DEC_HEADS);
  const int KVD = KV * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, qi = lane % 4;

  // every head of the block shares the query position: one live range,
  // cut to this split (never past the block table)
  const int pos = start_pos[s];
  const int seq_len = min(seq_lens[s], maxb * bs);
  const int hi = max(0, min(seq_len, pos + 1));
  const int lo = window > 0 ? min(max(0, pos - window + 1), hi) : 0;
  const int a = max(lo, sp * kps), b = min(hi, (sp + 1) * kps);
  const size_t row0 = (size_t)s * H + h0;     // q / out row of head h0
  // part: o [S H][splits][D], then (m, l) [S H][splits]
  const size_t ml_base = (size_t)gridDim.z * H * splits * D;

  if (a >= b) {                      // nothing live here: an empty split
    if (splits == 1) {               // (an idle slot): zeros
      for (int i = tid; i < nrows * D; i += DEC_NT)
        out[row0 * D + i] = __float2bfloat16(0.f);
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
  // zeros)
  uint32_t qf[KS][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = quad + 8 * i;
    const bool live = r < nrows;
    const __nv_bfloat16* qr = q + (row0 + (live ? r : 0)) * D + qi * 2;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[kk][i] = live ? ld2(qr + kk * 16) : 0u;
      qf[kk][i + 2] = live ? ld2(qr + kk * 16 + 8) : 0u;
    }
  }

  // tile t: keys [a + 64 t, +64) into stage t % ST, 16 bytes a copy; one
  // block-table read per row a thread stages; rows past b are zeros (P is
  // 0 there, and 0 * garbage could be NaN)
  const int ntiles = (b - a + DEC_TILE - 1) / DEC_TILE;
  const int* table = tables + (size_t)s * maxb;
  auto prefetch = [&](int t) {
    if (t < ntiles) {
      __nv_bfloat16* ks = ring + (t % ST) * 2 * DEC_TILE * LD;
      __nv_bfloat16* vs = ks + DEC_TILE * LD;
      const int t0 = a + t * DEC_TILE;
      for (int i = tid; i < DEC_TILE * CH; i += DEC_NT) {
        const int r = i / CH, ch = i % CH, j = t0 + r;
        const bool live = j < b;
        size_t off = 0;
        if (live)
          off = ((size_t)table[j / bs] * bs + (j % bs)) * KVD +
                (size_t)kvh * D + ch * 8;
        cp_async16(ks + r * LD + ch * 8, k_pool + off, live);
        cp_async16(vs + r * LD + ch * 8, v_pool + off, live);
      }
    }
    cp_async_commit();
  };

  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};             // this thread's partial row sums

#pragma unroll
  for (int t = 0; t < ST - 1; ++t) prefetch(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();                   // tile t landed; t - 1 consumed
    prefetch(t + ST - 1);
    const __nv_bfloat16* ks = ring + (t % ST) * 2 * DEC_TILE * LD;
    const __nv_bfloat16* vs = ks + DEC_TILE * LD;
    const int kw = a + t * DEC_TILE + warp * 16;   // this warp's 16 keys
    if (kw >= b) continue;             // warp-uniform: all dead

    // scores: 16 rows x 16 keys, K through ldmatrix as B (matrix i: keys
    // +8 (i / 2), dims +8 (i % 2) of the k-step)
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    const __nv_bfloat16* kb =
        ks + (warp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
        ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t r4[4];
      ldsm_x4(r4, kb + kk * 16);
      mma_16816(sc[0], qf[kk], r4[0], r4[1]);
      mma_16816(sc[1], qf[kk], r4[2], r4[3]);
    }
    // (an int8 pool would scale score column j by its K scale here, and
    // p column j by its V scale before the cast below: the scales belong
    // to the (token, KV head), never to the staged K/V tiles)
    // mask, scale, row max over the quad that shares a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kw + nt * 8 + qi * 2 + (e & 1);
        const float x = j < b ? sc[nt][e] * sm_scale : -INFINITY;
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
        const float p = expf(sc[nt][e] - m_safe[e / 2]);
        sc[nt][e] = p;
        rs[e / 2] += p;                 // the row sums before the cast
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e / 2];
    // o += P.V on p cast to bf16; V through ldmatrix.trans as B (matrix
    // i: keys +8 (i % 2), dims +8 (i / 2))
    const uint32_t pa[4] = {pack2(sc[0][0], sc[0][1]),
                            pack2(sc[0][2], sc[0][3]),
                            pack2(sc[1][0], sc[1][1]),
                            pack2(sc[1][2], sc[1][3])};
    const __nv_bfloat16* vb =
        vs + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
        (lane >> 4) * 8;
#pragma unroll
    for (int dn = 0; dn < ND; dn += 2) {
      uint32_t r4[4];
      ldsm_x4_t(r4, vb + dn * 8);
      mma_16816(o[dn], pa, r4[0], r4[1]);
      mma_16816(o[dn + 1], pa, r4[2], r4[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the merge

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
          __float2bfloat16(ll == 0.f ? 0.f : oo / ll);   // idle rows: 0
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

template <int D>
cudaError_t launch_decode_split(const void* q, const void* k_pool,
                                const void* v_pool, const int* tables,
                                const int* start_pos, const int* seq_lens,
                                void* out, void* part, void* cnt, int S,
                                int H, int KV, int maxb, int bs,
                                float sm_scale, int window, int splits,
                                int kps, cudaStream_t stream) {
  // 16-byte K/V row loads, 4-byte q loads
  if (((uintptr_t)k_pool | (uintptr_t)v_pool) % 16 || (uintptr_t)q % 4)
    return cudaErrorMisalignedAddress;
  const int hc = (H / KV + DEC_HEADS - 1) / DEC_HEADS;
  // the splits must cover the table's capacity, within the grid's limits
  // the merge's weights [16][splits + 1] fit in the block's shared memory
  constexpr size_t smem = dec_smem_bytes<D>();
  if (splits < 1 || kps < 1 ||
      (size_t)DEC_HEADS * (splits + 1) * sizeof(float) > smem ||
      (splits > 1 && (part == nullptr || cnt == nullptr)) ||
      (long long)splits * kps < (long long)maxb * bs || S > 65535 ||
      (long long)KV * hc > 65535)
    return cudaErrorInvalidValue;
  auto kern = paged_decode_split_kernel<D>;
  // the shared memory attribute is a device's: set once per head dim and
  // device, not every step (every launch past the table's devices)
  constexpr int MAX_DEV = 64;
  static bool attr_set[MAX_DEV] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEV || !attr_set[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEV) attr_set[dev] = true;
  }
  kern<<<dim3(splits, KV * hc, S), DEC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), tables, start_pos, seq_lens,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
      static_cast<int*>(cnt), H, KV, maxb, bs, sm_scale, window, kps);
  return cudaGetLastError();
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
    // K1 in bf16 runs on the tensor cores; fp32 (both) on the CUDA cores
    if constexpr (!DECODE && std::is_same<T, __nv_bfloat16>::value)
      return launch_mma<D>(q, k_pool, v_pool, t, sp, sl, out, S, C, H, KV,
                           maxb, bs, sm_scale, window, st);
    else
      return launch<T, D, ROWS, TK, DECODE>(q, k_pool, v_pool, t, sp, sl,
                                            out, S, C, H, KV, maxb, bs,
                                            sm_scale, window, st);
  }
};

bool heads_ok(int S, int H, int KV, int maxb, int bs) {
  return S > 0 && H > 0 && KV > 0 && H % KV == 0 && bs > 0 && maxb > 0;
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
  if (!heads_ok(S, H, KV, maxb, bs) || C < 1)
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* sp = static_cast<const int*>(start_pos);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using BF = ByDim<__nv_bfloat16, false>;
  using FP = ByDim<float, false>;
  return (int)(is_bf16 ? BY_HEAD_DIM(D, BF::template run, q, k_pool, v_pool,
                                     t, sp, sl, out, S, C, H, KV, maxb, bs,
                                     sm_scale, window, st)
                       : BY_HEAD_DIM(D, FP::template run, q, k_pool, v_pool,
                                     t, sp, sl, out, S, C, H, KV, maxb, bs,
                                     sm_scale, window, st));
}

// as above with C == 1. bf16 runs the split kernel on `splits` splits of
// `kps` keys each (splits * kps >= maxb * bs; the plan of
// ops/kernels/paged_attention.py `decode_plan`), with fp32 partials in
// `part` [S * H * splits * (D + 2)] and zeroed int32 counters `cnt` [S *
// KV * head chunks] (left zeroed) when splits > 1; fp32 ignores the four.
int paged_decode_launch(const void* q, const void* k_pool,
                        const void* v_pool, const void* tables,
                        const void* start_pos, const void* seq_lens,
                        void* out, void* part, void* cnt, int S, int H, int KV,
                        int D, int maxb, int bs, float sm_scale, int window,
                        int is_bf16, int splits, int kps, void* stream) {
  if (!heads_ok(S, H, KV, maxb, bs)) return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* sp = static_cast<const int*>(start_pos);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using FP = ByDim<float, true>;
  return (int)(is_bf16
                   ? BY_HEAD_DIM(D, launch_decode_split, q, k_pool, v_pool,
                                 t, sp, sl, out, part, cnt, S, H, KV, maxb, bs,
                                 sm_scale, window, splits, kps, st)
                   : BY_HEAD_DIM(D, FP::template run, q, k_pool, v_pool, t,
                                 sp, sl, out, S, 1, H, KV, maxb, bs,
                                 sm_scale, window, st));
}

}  // extern "C"
