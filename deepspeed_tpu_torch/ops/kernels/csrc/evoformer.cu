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
// attention's 403 MB of q/k/v/o alone is 0.12 ms). bf16 runs the
// tensor-core tile of flash_fwd_mma_kernel (flash_tile.cuh): one block of
// 4 warps owns 64 query rows of one (b, n, h), K/V tiles of 64 keys
// double-buffered in shared memory by cp.async, mma.sync m16n8k16 with
// fp32 accumulators. D = 16, 32 and 64 run natively; the wrapper zero-pads
// q, k and v along D to the next of these for any other D <= 64 (the
// scores are unchanged and the output is sliced back), and raises
// NotImplementedError above 64 (the D = 64 instance already takes 251
// registers a thread, so a D = 128 one would spill). The kernel reads
// q/k/v/o through their strides, so the [B, N, S, H, D] tensors need no
// transposed [B N, H, S, D] copies (the JAX wrapper makes them, :159).
// Each thread reads the biases of its own score elements straight from
// device memory as f32: a quad of threads covers 8 neighbouring keys of a
// row, so every 32-byte sector of the [Sq, Sk] pair-bias rows that is
// fetched is used whole; the pair bias of one (b, h) is read by the N
// blocks that share it, mostly from L2. Ragged Sq and Sk are masked in
// the kernel, so nothing is padded (the JAX tiles pad Sq to 8 and Sk to
// 128, :92-93).
//
// Numerics follow the Pallas kernel: scores in fp32 scaled after the
// product, then + mask bias, then + pair bias, all in f32 (a -1e9 mask
// bias in bf16 would lose the scores under it); P cast to V's dtype (bf16)
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

template <int D>
__global__ void __launch_bounds__(NT)
evoformer_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         const float* __restrict__ mb,
                         const float* __restrict__ pb, EvoStrides sq,
                         EvoStrides sk, EvoStrides sv, EvoStrides so, int N,
                         int H, int Sq, int Sk, float scale) {
  constexpr int ND = D / 8, TE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);   // [buf][K, V][64][D+8]
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bn = blockIdx.z;
  const int b = bn / N, n = bn % N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, qi = lane % 4;
  const int row[2] = {q0 + warp * 16 + quad, q0 + warp * 16 + quad + 8};
  const float* mrow = mb ? mb + (long long)bn * Sk : nullptr;
  const float* prow[2] = {nullptr, nullptr};
  if (pb)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      prow[i] = pb + (((long long)b * H + h) * Sq + min(row[i], Sq - 1)) * Sk;

  uint32_t qf[D / 16][4];
  load_a<D>(qf, q + head_at(sq, b, n, h), sq.t, row, Sq, qi);
  const bf16* kb = k + head_at(sk, b, n, h);
  const bf16* vb = v + head_at(sv, b, n, h);

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};             // this thread's partial row sums

  stage_tile<D>(smem, kb, sk.t, 0, Sk);
  stage_tile<D>(smem + TE, vb, sv.t, 0, Sk);
  cp_async_commit();
  for (int t0 = 0, it = 0; t0 < Sk; t0 += BK, ++it) {
    const bf16* ks = smem + (it & 1) * 2 * TE;
    const bf16* vs = ks + TE;
    if (t0 + BK < Sk) {
      bf16* nk = smem + ((it + 1) & 1) * 2 * TE;
      stage_tile<D>(nk, kb, sk.t, t0 + BK, Sk);
      stage_tile<D>(nk + TE, vb, sv.t, t0 + BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // this thread's bias values, read before the product so that their
    // latency hides under it; the mask bias of a column serves both rows
    float mbv[8][2], pbv[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t0 + nt * 8 + qi * 2 + (e & 1);
        if (e < 2) mbv[nt][e] = mrow && j < Sk ? __ldg(mrow + j) : 0.f;
        pbv[nt][e] = pb && j < Sk ? __ldg(prow[e / 2] + j) : 0.f;
      }
    float sc[8][4];
    mma_abt<D>(sc, qf, ks, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, j = t0 + nt * 8 + qi * 2 + (e & 1);
        float x = -INFINITY;
        if (j < Sk && row[i] < Sq) {
          // (s * scale + mask) + pair, each rounded as the plain version
          x = __fmul_rn(sc[nt][e], scale);
          if (mrow) x = __fadd_rn(x, mbv[nt][e & 1]);
          if (pb) x = __fadd_rn(x, pbv[nt][e]);
        }
        sc[nt][e] = x;
        mx[i] = fmaxf(mx[i], x);
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
    mma_pv<D>(acc, sc, vs, lane);
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

template <int D>
cudaError_t fwd(const Args& a, bool bf, cudaStream_t stream) {
  if (bf) {
    dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B * a.N);
    constexpr size_t smem = 4 * tile_elems<D>() * sizeof(bf16);
    cudaError_t err = smem_opt_in(evoformer_fwd_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    evoformer_fwd_mma_kernel<D><<<grid, NT, smem, stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o,
        a.mb, a.pb, a.sq, a.sk, a.sv, a.so, a.N, a.H, a.Sq, a.Sk, a.scale);
  } else {
    const long long n = (long long)a.B * a.N * a.H * a.Sq;
    evoformer_fwd_f32_kernel<D><<<(unsigned)((n + F32_NT - 1) / F32_NT),
                                  F32_NT, 0, stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (float*)a.o, a.mb, a.pb, a.sq, a.sk, a.sv, a.so, a.B, a.N, a.H,
        a.Sq, a.Sk, a.scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q / k / v / o [B, N, S, H, D] (element strides of b, n, s, h for q, k,
// v, o in `strides[16]`); mask_bias fp32 [B * N, Sk] or null; pair_bias
// fp32 [B, H, Sq, Sk] or null.
int evoformer_fwd_launch(const void* q, const void* k, const void* v,
                         void* o, const void* mask_bias,
                         const void* pair_bias, const long long* strides,
                         int B, int N, int H, int Sq, int Sk, int D,
                         float scale, int is_bf16, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || H > 65535 ||
      (long long)B * N > 65535 || (D != 16 && D != 32 && D != 64))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
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
  return (int)(D == 16   ? fwd<16>(a, is_bf16, s)
               : D == 32 ? fwd<32>(a, is_bf16, s)
                         : fwd<64>(a, is_bf16, s));
}

}  // extern "C"
