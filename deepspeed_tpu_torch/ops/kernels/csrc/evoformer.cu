// Evoformer attention forward for Hopper (sm_90a): flash attention over
// [B, N, S, H, D] MSA-row / triangle tensors with the two canonical
// additive biases added in the score tile.
//
// evoformer_fwd replaces the Pallas kernel `_fwd_kernel`
//   (deepspeed_tpu/ops/kernels/evoformer.py:39, launched at :135 behind
//   `evoformer_flash`, :213): for each (b, n, h),
//     s = q k^T * scale + mask_bias[b, n, :] + pair_bias[b, h, :, :]
//   with keys past Sk masked, online softmax with the running max clamped
//   at -1e30 (so a row whose every key is -inf gives zeros, not NaN), and
//   o = softmax(s) v. mask_bias [B, N, Sk] broadcasts over heads and
//   queries, pair_bias [B, H, Sq, Sk] over the N rows; either may be
//   absent.
//
// Bound on the H100: bytes at AlphaFold 2's sizes (c = 32: 4 D flops a
// score against q, k, v, o and the biases read once -- the MSA row
// attention's 403 MB of q/k/v/o alone is 0.12 ms). What held the first
// port (one block of 4 warps per (b, n, h, 64-query tile), each thread
// loading its score elements' biases from device memory into registers
// before the product) was not those bytes: timed on an H100 with both
// biases, the mask bias only and neither (tools/port_step_ab.py --evo),
// it read 1.29 / 1.09 / 0.90 ms at the MSA shape, so the biases cost 0.4
// ms -- the 0.8 MB mask bias nearly as much as the 4.7 MB pair bias --
// through the registers they held across the product (fewer blocks an
// SM) and the latency of their loads, and the pair bias besides crossed
// L2 once per MSA row (2.4 GB a call).
//
// So bf16 and fp16 run evoformer_fwd_mma_kernel<D, T> (T the 16-bit
// type: the m16n8k16 product and P's pack in .bf16 or .f16, the biases
// f32 in both): a block owns 64 query rows of
// one (b, h) and EVO_SETS = 2 MSA rows, one warp set of 4 warps each
// (16 query rows a warp), each set the online softmax of its row as the
// tensor-core tile of flash_tile.cuh runs it (mma.sync m16n8k16, fp32
// accumulators). Each 64-key step stages, by cp.async through two stages,
// the sets' K/V tiles and mask-bias rows and one [64 x 64] f32 pair-bias
// tile for both rows; the scores read the biases from shared memory
// (8-byte reads of a swizzled tile, no bank conflicts), so they arrive
// under the previous tile's products, hold no registers across a product
// (<= 128 registers: 4 blocks' worth of warps an SM at D <= 32) and the
// pair bias crosses L2 once per two rows. Holding several rows' states a
// thread (R = 4 or 8 rows a block, as first designed) took 181-255
// registers and ran slower than the first port; four sets of one row
// halved the pair bias again but ran slower with 16 warps on one
// barrier. D = 16, 32 and 64 run natively; the wrapper zero-pads q, k and
// v along D to the next of these for any other D <= 64 (the scores are
// unchanged and the output is sliced back), and raises
// NotImplementedError above 64. The kernel reads q/k/v/o through their
// strides, so the [B, N, S, H, D] tensors need no transposed [B N, H, S,
// D] copies (the JAX wrapper makes them, :159). Ragged Sq and Sk are
// masked in the kernel, so nothing is padded (the JAX tiles pad Sq to 8
// and Sk to 128, :92-93).
//
// Numerics follow the Pallas kernel: scores in fp32 scaled after the
// product, then + mask bias, then + pair bias, all in f32 (a -1e9 mask
// bias in bf16 would lose the scores under it); P cast to V's dtype (T)
// before P.V with the row sums taken before that cast; the -1e30 clamp
// before alpha; __expf. fp32 inputs run a CUDA-core kernel (one thread per
// query row), a parity oracle for the indexing.
//
// Layout: q/k/v/o [B, N, S, H, D] by element strides of (b, n, s, h) with
// a unit D stride; mask_bias contiguous fp32 [B * N, Sk] or null,
// pair_bias contiguous fp32 [B, H, Sq, Sk] or null. Kernels launch on the
// caller's stream, do not synchronise and allocate nothing; the C entry
// point returns cudaGetLastError().

#include "flash_tile.cuh"

namespace {

constexpr int F32_NT = 128;
constexpr float M_FLOOR = -1e30f;
// MSA rows a block: one warp set of 4 warps each, sharing each staged
// pair-bias tile (`evoformer.evo_plan`). Two keep 16 warps an SM at D <=
// 32 (<= 128 registers a thread); four halved the pair bias's L2 traffic
// again but, all 16 warps on one barrier, ran slower on an H100.
constexpr int EVO_SETS = 2;

struct EvoStrides {
  long long b, n, t, h;            // elements; the D stride is 1
};

struct Args {
  const void *q, *k, *v;
  void* o;
  const float *mb, *pb;
  EvoStrides sq, sk, sv, so;
  int B, N, H, Sq, Sk;
  float scale;
};

__device__ __forceinline__ long long head_at(const EvoStrides& s, int b,
                                             int n, int h) {
  return b * s.b + n * s.n + h * s.h;
}

// Shared memory of a stage: each set's K and V tiles ([64][D + 8] 16-bit
// each), the pair-bias tile (64 x 64 f32, each row's 8-float column groups
// XORed with (row % 4) * 8 so that a half-warp's 8-byte reads of four
// rows fall on distinct banks) and each set's mask-bias tile (64 f32).
template <int D>
__host__ __device__ constexpr size_t evo_stage_bytes() {
  return EVO_SETS * (2 * tile_elems<D>() * sizeof(bf16) +
                          64 * sizeof(float)) +
         64 * 64 * sizeof(float);
}
__device__ __forceinline__ int bias_at(int r, int c) {
  return r * 64 + (c ^ ((r & 3) * 8));
}

// Columns [c0, c0 + 64) of `rows` f32 rows (row stride `ld` elements) into
// a bias tile by cp.async, thread `tid` of `nt`: 16 bytes a copy when
// `vec` (ld % 4 == 0 and a 16-byte aligned base: every row starts
// aligned), else 4; columns past `cols` zeros, rows past `rows` skipped
// (their scores are masked); `swz`: the pair-bias tile's layout.
__device__ __forceinline__ void stage_bias(float* dst, const float* src,
                                           long long ld, int rows, int c0,
                                           int cols, int vec, bool swz,
                                           int tid, int nt) {
  if (vec) {
    for (int i = tid; i < 64 * 16; i += nt) {
      const int r = i / 16, c = (i % 16) * 4;
      if (r >= rows) break;
      const int n = max(0, min(4, cols - c0 - c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst + (swz ? bias_at(r, c) : c))),
                   "l"(src + (n ? r * ld + c0 + c : 0)), "r"(n * 4));
    }
  } else {
    for (int i = tid; i < 64 * 64; i += nt) {
      const int r = i / 64, c = i % 64;
      if (r >= rows) break;
      const bool live = c0 + c < cols;
      cp_async4(dst + (swz ? bias_at(r, c) : c),
                src + (live ? r * ld + c0 + c : 0), live);
    }
  }
}

// Rows [r0, r0 + 64) of one (b, n, h)'s K or V into a [64][D + 8] tile,
// 16 bytes a copy by thread `tid` of 128; rows at or past `rows` zeros.
template <int D, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long stride_t, int r0,
                                           int rows, int tid) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int i = tid; i < 64 * CH; i += NT) {
    const int r = i / CH, ch = i % CH;
    const bool live = r0 + r < rows;
    cp_async16(dst + r * LD + ch * 8,
               src + (live ? (long long)(r0 + r) * stride_t + ch * 8 : 0),
               live);
  }
}

// One block owns 64 query rows of one (b, h) and W = EVO_SETS MSA
// rows n0 .. n0 + W - 1: warp set ws (warps 4 ws .. 4 ws + 3, 16 query
// rows each) runs row n0 + ws with its own online softmax, as one block
// of the one-row design did. Each 64-key tile's pair-bias block [64 x 64]
// is staged once for the W rows, beside the sets' K/V tiles and mask-bias
// rows, through two cp.async stages: the biases arrive under the previous
// tile's products, their values are read from shared memory where the
// scores take them (never held in registers across a product), and the
// pair bias crosses L2 once per W rows. A set past N (the last group's
// tail) loads and computes nothing.
template <int D, typename T>
__global__ void __launch_bounds__(NT * EVO_SETS, (D <= 32 ? 2 : 1))
evoformer_fwd_mma_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         const float* __restrict__ mb,
                         const float* __restrict__ pb, EvoStrides sq,
                         EvoStrides sk, EvoStrides sv, EvoStrides so, int N,
                         int H, int Sq, int Sk, float scale, int vec) {
  constexpr int W = EVO_SETS;
  constexpr int ND = D / 8, TE = tile_elems<D>();
  constexpr int SB = (int)evo_stage_bytes<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = (N + W - 1) / W;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int b = blockIdx.z / groups;
  const int ws = threadIdx.x / NT, n = (blockIdx.z % groups) * W + ws;
  const bool live_row = n < N;                // warp-uniform
  const int tid = threadIdx.x % NT;           // within the set
  const int warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, qi = lane % 4;
  const int row[2] = {q0 + warp * 16 + quad, q0 + warp * 16 + quad + 8};
  const int rloc[2] = {warp * 16 + quad, warp * 16 + quad + 8};
  const float* mrow = mb && live_row ? mb + ((long long)b * N + n) * Sk
                                     : nullptr;
  const float* pblk =
      pb ? pb + (((long long)b * H + h) * Sq + q0) * Sk : nullptr;
  const int qrows = min(BQ, Sq - q0);

  uint32_t qf[D / 16][4];
  const int nn = live_row ? n : 0;
  load_a<D>(qf, q + head_at(sq, b, nn, h), sq.t, row, live_row ? Sq : 0,
            qi);
  const T* kb = k + head_at(sk, b, nn, h);
  const T* vb = v + head_at(sv, b, nn, h);
  // stage `buf`: the sets' [K][V] 16-bit tiles, the pair-bias tile, the
  // sets' mask rows
  auto kv_at = [&](int buf) {
    return reinterpret_cast<T*>(smem_raw + buf * SB) + ws * 2 * TE;
  };
  auto pbias_at = [&](int buf) {
    return reinterpret_cast<float*>(smem_raw + buf * SB +
                                    W * 2 * TE * sizeof(T));
  };
  auto prefetch = [&](int buf, int t0) {
    if (live_row) {
      T* kv = kv_at(buf);
      stage_rows<D>(kv, kb, sk.t, t0, Sk, tid);
      stage_rows<D>(kv + TE, vb, sv.t, t0, Sk, tid);
      if (mrow)
        stage_bias(pbias_at(buf) + 64 * 64 + ws * 64, mrow, 0, 1, t0, Sk,
                   vec, false, tid, NT);
    }
    if (pblk)
      stage_bias(pbias_at(buf), pblk, Sk, qrows, t0, Sk, vec, true,
                 threadIdx.x, NT * W);
    cp_async_commit();
  };

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};             // this thread's partial row sums

  prefetch(0, 0);
  for (int t0 = 0, it = 0; t0 < Sk; t0 += BK, ++it) {
    const T* ks = kv_at(it & 1);
    const T* vs = ks + TE;
    const float* pbt = pbias_at(it & 1);
    const float* mbt = pbt + 64 * 64 + ws * 64;
    if (t0 + BK < Sk) {
      prefetch((it + 1) & 1, t0 + BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!live_row) {                  // the tail's sets keep the barriers
      __syncthreads();
      continue;
    }
    float sc[8][4];
    mma_abt<D, T>(sc, qf, ks, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      // this thread's two keys of the column tile; the mask bias of a key
      // serves both rows
      const int c = nt * 8 + qi * 2, j0 = t0 + c;
      const float2 mv = mrow ? *reinterpret_cast<const float2*>(mbt + c)
                             : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 pv =
            pblk ? *reinterpret_cast<const float2*>(pbt + bias_at(rloc[i], c))
                 : make_float2(0.f, 0.f);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 2 * i + x;
          float y = -INFINITY;
          if (j0 + x < Sk && row[i] < Sq) {
            // (s * scale + mask) + pair, each rounded as the plain version
            y = __fmul_rn(sc[nt][e], scale);
            if (mrow) y = __fadd_rn(y, x ? mv.y : mv.x);
            if (pblk) y = __fadd_rn(y, x ? pv.y : pv.x);
          }
          sc[nt][e] = y;
          mx[i] = fmaxf(mx[i], y);
        }
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // the clamp comes before alpha: exp(-inf - -1e30) = 0, never NaN
      const float m_new = fmaxf(fmaxf(m[i], mx[i]), M_FLOOR);
      alpha[i] = __expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sc[nt][e] - m[e / 2]);
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
    inv[i] = li == 0.f ? 0.f : 1.f / li;      // every key -inf: O = 0
  }
  if (live_row)
    store_rows<D>(o + head_at(so, b, n, h), so.t, acc, row, Sq, inv, qi);
}

template <int D>
__global__ void __launch_bounds__(F32_NT)
evoformer_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         const float* __restrict__ mb,
                         const float* __restrict__ pb, EvoStrides sq,
                         EvoStrides sk, EvoStrides sv, EvoStrides so, int B,
                         int N, int H, int Sq, int Sk, float scale) {
  const long long idx = (long long)blockIdx.x * F32_NT + threadIdx.x;
  if (idx >= (long long)B * N * H * Sq) return;
  const int i = idx % Sq, h = (idx / Sq) % H;
  const int bn = idx / ((long long)Sq * H), b = bn / N, n = bn % N;
  const float* qr = q + head_at(sq, b, n, h) + (long long)i * sq.t;
  const float* mrow = mb ? mb + (long long)bn * Sk : nullptr;
  const float* prow = pb ? pb + (((long long)b * H + h) * Sq + i) * Sk
                         : nullptr;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < Sk; ++j) {
    const float* kr = k + head_at(sk, b, n, h) + (long long)j * sk.t;
    const float* vr = v + head_at(sv, b, n, h) + (long long)j * sv.t;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
    s = __fmul_rn(s, scale);
    if (mrow) s = __fadd_rn(s, mrow[j]);
    if (prow) s = __fadd_rn(s, prow[j]);
    const float m_new = fmaxf(fmaxf(m, s), M_FLOOR);
    const float alpha = expf(m - m_new), p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = acc[d] * alpha + p * vr[d];
    m = m_new;
  }
  float* orow = o + head_at(so, b, n, h) + (long long)i * so.t;
  const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
}

// The 16-bit kernel in T (bf16 or fp16).
template <int D, typename T>
cudaError_t fwd_mma(const Args& a, cudaStream_t stream) {
  constexpr int W = EVO_SETS;
  const long long groups = (long long)a.B * ((a.N + W - 1) / W);
  if (groups > 65535) return cudaErrorInvalidValue;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, (unsigned)groups);
  constexpr size_t smem = 2 * evo_stage_bytes<D>();
  cudaError_t err = smem_opt_in(evoformer_fwd_mma_kernel<D, T>, smem);
  if (err != cudaSuccess) return err;
  // 16-byte bias copies where every bias row starts 16-byte aligned
  const int vec = a.Sk % 4 == 0 && (uintptr_t)a.mb % 16 == 0 &&
                  (uintptr_t)a.pb % 16 == 0;
  evoformer_fwd_mma_kernel<D, T><<<grid, NT * W, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.mb, a.pb,
      a.sq, a.sk, a.sv, a.so, a.N, a.H, a.Sq, a.Sk, a.scale, vec);
  return cudaGetLastError();
}

// dtype: 0 fp32, 1 bf16, 2 fp16
template <int D>
cudaError_t fwd(const Args& a, int dtype, cudaStream_t stream) {
  if (dtype == 1) return fwd_mma<D, bf16>(a, stream);
  if (dtype == 2) return fwd_mma<D, f16>(a, stream);
  const long long n = (long long)a.B * a.N * a.H * a.Sq;
  evoformer_fwd_f32_kernel<D><<<(unsigned)((n + F32_NT - 1) / F32_NT),
                                F32_NT, 0, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o,
      a.mb, a.pb, a.sq, a.sk, a.sv, a.so, a.B, a.N, a.H, a.Sq, a.Sk,
      a.scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q / k / v / o [B, N, S, H, D] (element strides of b, n, s, h for q, k,
// v, o in `strides[16]`; dtype 0 fp32, 1 bf16, 2 fp16); mask_bias fp32
// [B * N, Sk] or null; pair_bias fp32 [B, H, Sq, Sk] or null.
int evoformer_fwd_launch(const void* q, const void* k, const void* v,
                         void* o, const void* mask_bias,
                         const void* pair_bias, const long long* strides,
                         int B, int N, int H, int Sq, int Sk, int D,
                         float scale, int dtype, int rows,
                         void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || H > 65535 ||
      (D != 16 && D != 32 && D != 64) || dtype < 0 || dtype > 2 ||
      (dtype && rows != EVO_SETS))
    return (int)cudaErrorInvalidValue;
  if (dtype) {
    const void* ptrs[4] = {q, k, v, o};
    for (int i = 0; i < 4; ++i)
      if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16)
        return (int)cudaErrorMisalignedAddress;
    for (int i = 0; i < 16; ++i)
      if (strides[i] % 8) return (int)cudaErrorMisalignedAddress;
  }
  auto st = [&](int i) {
    return EvoStrides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                      strides[4 * i + 3]};
  };
  const Args a{q, k, v, o, (const float*)mask_bias, (const float*)pair_bias,
               st(0), st(1), st(2), st(3), B, N, H, Sq, Sk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 16   ? fwd<16>(a, dtype, s)
               : D == 32 ? fwd<32>(a, dtype, s)
                         : fwd<64>(a, dtype, s));
}

}  // extern "C"
