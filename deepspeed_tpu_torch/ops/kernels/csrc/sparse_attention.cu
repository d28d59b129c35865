// Block-sparse flash attention forward for Hopper (sm_90a).
//
// sparse_fwd replaces the Pallas kernel `_fwd_sparse_kernel`
//   (deepspeed_tpu/ops/kernels/flash_attention.py:117, launched at :195
//   behind `flash_attention_sparse`, :198): online-softmax attention of
//   each (head, query block) over the key blocks that a static
//   (H, nq, nk) block mask allows, with no causal mask; padded keys
//   (col >= Tk) are masked, and a row that no allowed key reaches writes
//   zeros.
//
// Bound on the H100: operations at BERT-large width (D = 64) -- 4 D flops
// per allowed (query, key) pair against O(T D) bytes a row -- so bf16 runs
// the tensor-core tile of flash_fwd_mma_kernel (flash_tile.cuh): one block
// of 4 warps owns 64 query rows, K/V tiles of 64 keys double-buffered in
// shared memory by cp.async, mma.sync m16n8k16 with fp32 accumulators.
// The TPU kernel visits every (q, k) grid step and skips masked ones, with
// a host "fetch schedule" that repeats the last allowed block's index so
// that a skipped step costs no DMA (:147-161); on the card a skipped tile
// still costs a loop trip, so instead the host builds once per mask a
// compact list (CSR) of the live 64-key tiles of each (head, query block)
// -- the allowed blocks' tiles that start below Tk, ascending -- and each
// block walks its list. A masked block costs nothing, and an empty list
// stores zeros.
//
// Numerics follow the Pallas kernel: scores in fp32 scaled after the
// product; P cast to V's dtype (bf16) before P.V with the row sums taken
// before that cast; __expf. fp32 inputs run a CUDA-core kernel (one thread
// per query row) over the same lists, a parity oracle for the indexing.
//
// Layout: q/o [B, H, Tq, D] and k/v [B, Hk, Tk, D] by element strides of
// (batch, head, time), unit head_dim stride (BTHD views pass without a
// copy); GQA reads KV head h / (H / Hk), never a repeated copy. row_ptr
// int32 [H * nq + 1] and tiles int32 [row_ptr[H * nq]] (key-tile indices,
// key t0 = 64 * tile) on the device. block_q is a multiple of 64. Kernels
// launch on the caller's stream, do not synchronise and allocate nothing;
// the C entry point returns cudaGetLastError().

#include "flash_tile.cuh"

namespace {

constexpr int F32_NT = 128;

template <int D>
__global__ void __launch_bounds__(NT)
sparse_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ tiles, Strides sq, Strides sk,
                      Strides sv, Strides so, int H, int Hk, int Tq, int Tk,
                      int nq, int block_q, float scale) {
  constexpr int ND = D / 8, TE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);   // [buf][K, V][64][D+8]
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
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;

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
    const bf16* ks = smem + (it & 1) * 2 * TE;
    const bf16* vs = ks + TE;
    if (it + 1 < ntiles) {
      bf16* nk = smem + ((it + 1) & 1) * 2 * TE;
      stage_tile<D>(nk, kb, sk.t, list[it + 1] * BK, Tk);
      stage_tile<D>(nk + TE, vb, sv.t, list[it + 1] * BK, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float sc[8][4];
    mma_abt<D>(sc, qf, ks, lane);
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
    mma_pv<D>(acc, sc, vs, lane);
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

struct Args {
  const void *q, *k, *v;
  void* o;
  const int *row_ptr, *tiles;
  Strides sq, sk, sv, so;
  int B, H, Hk, Tq, Tk, nq, block_q;
  float scale;
};

template <int D>
cudaError_t fwd(const Args& a, bool bf, cudaStream_t stream) {
  if (bf) {
    dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
    constexpr size_t smem = 4 * tile_elems<D>() * sizeof(bf16);
    cudaError_t err = smem_opt_in(sparse_fwd_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    sparse_fwd_mma_kernel<D><<<grid, NT, smem, stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o,
        a.row_ptr, a.tiles, a.sq, a.sk, a.sv, a.so, a.H, a.Hk, a.Tq, a.Tk,
        a.nq, a.block_q, a.scale);
  } else {
    const long long n = (long long)a.B * a.H * a.Tq;
    sparse_fwd_f32_kernel<D><<<(unsigned)((n + F32_NT - 1) / F32_NT), F32_NT,
                               0, stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (float*)a.o, a.row_ptr, a.tiles, a.sq, a.sk, a.sv, a.so, a.B, a.H,
        a.Hk, a.Tq, a.Tk, a.nq, a.block_q, a.scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, H, Tq, D], k / v [B, Hk, Tk, D], o like q (element strides of
// batch, head and time for q, k, v, o in `strides[12]`); row_ptr / tiles
// the CSR of live 64-key tiles per (head, query block of block_q rows).
int sparse_fwd_launch(const void* q, const void* k, const void* v, void* o,
                      const void* row_ptr, const void* tiles,
                      const long long* strides, int B, int H, int Hk, int Tq,
                      int Tk, int D, int nq, int block_q, float scale,
                      int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk || Tq <= 0 || Tk <= 0 ||
      B > 65535 || H > 65535 || block_q <= 0 || block_q % BQ ||
      nq != (Tq + block_q - 1) / block_q ||
      (D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    // 16-byte rows for cp.async and the 4-byte fragment loads
    const void* ptrs[4] = {q, k, v, o};
    for (int i = 0; i < 4; ++i)
      if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16)
        return (int)cudaErrorMisalignedAddress;
    for (int i = 0; i < 12; ++i)
      if (strides[i] % 8) return (int)cudaErrorMisalignedAddress;
  }
  auto st = [&](int i) {
    return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  };
  const Args a{q, k, v, o, (const int*)row_ptr, (const int*)tiles, st(0),
               st(1), st(2), st(3), B, H, Hk, Tq, Tk, nq, block_q, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)fwd<32>(a, is_bf16, s);
    case 64: return (int)fwd<64>(a, is_bf16, s);
    default: return (int)fwd<128>(a, is_bf16, s);
  }
}

}  // extern "C"
