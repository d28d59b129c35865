// Tensor-core tile machinery shared by the port's attention kernels
// (flash_attention.cu, sparse_attention.cu, evoformer.cu): mma.sync
// m16n8k16 products of 16-bit operands (T = bf16 or fp16) with fp32
// accumulators, cp.async staging of 64-row K/V tiles into shared memory,
// ldmatrix fragment loads, and the 16-bit row store. A block of NT = 128
// threads (4 warps) owns a 64-row query tile, each warp 16 rows; a staged
// tile is [64][D + 8] elements (the 8-element pad keeps ldmatrix rows on
// distinct banks). D is a multiple of 16.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

struct Strides {
  long long b, h, t;               // elements; the head_dim stride is 1
};

constexpr int NT = 128;            // threads per block of the mma kernels
constexpr int BQ = 64;             // query rows per block (fwd, dq) / tile
constexpr int BK = 64;             // key rows per tile (fwd, dq) / block

// c += a * b for one m16n8k16 tile. Fragment layout (PTX ISA, mma.m16n8k16
// .bf16), with quad = lane / 4 and qi = lane % 4:
//   a[0..3]: rows quad / quad+8 / quad / quad+8, columns 2qi..2qi+1 (+8
//            for a[2], a[3]) of the 16 x 16 A tile;
//   b0, b1:  rows (k) 2qi..2qi+1 (+8 for b1), column (n) quad of B;
//   c[0..3]: rows quad, quad, quad+8, quad+8; columns 2qi, 2qi+1 (x2).
// In each 32-bit register the lower column (or row for B) is the low half.
// The .f16 form has the same fragment layout.
template <typename T = bf16>
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, f16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two floats rounded to T (round to nearest even), lo in the low half
template <typename T = bf16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, f16>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}
template <typename T>
__device__ __forceinline__ uint32_t ld2(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

#ifndef PORT_SMEM_ADDR                // hopper.cuh defines the same
#define PORT_SMEM_ADDR
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#endif

// Asynchronous global -> shared copies (cp.async): `bytes` from `src`, or
// zeros when `live` is false (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 16-bit matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Plain: lane t gets row t / 4, columns
// 2 (t % 4), +1 of each; .trans: column t / 4, rows 2 (t % 4), +1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// Two 8x8 matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// Start copying rows [r0, r0 + 64) of one (batch, head) into a [64][D + 8]
// shared tile, 16 bytes a thread, without waiting; rows at or past `rows`
// are zeros (a zero probability times a garbage row could be NaN).
template <int D, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src,
                                           long long stride_t, int r0,
                                           int rows) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NT) {
    const int r = i / CH, ch = i % CH;
    const bool live = r0 + r < rows;
    cp_async16(dst + r * LD + ch * 8,
               src + (live ? (long long)(r0 + r) * stride_t + ch * 8 : 0),
               live);
  }
}

// A fragments of this thread's two rows (16-row warp tile) of a [*, D] row
// set; rows at or past `rows` are zeros.
template <int D, typename T>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4],
                                       const T* base, long long stride_t,
                                       const int (&row)[2], int rows, int qi) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool live = row[i] < rows;
    const T* p = base + (long long)(live ? row[i] : 0) * stride_t + qi * 2;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      f[kk][i] = live ? ld2(p + kk * 16) : 0u;
      f[kk][i + 2] = live ? ld2(p + kk * 16 + 8) : 0u;
    }
  }
}

// acc[16 x 64] = A[16 x D] . B^T with B a staged [64][D + 8] tile: the
// product of this warp's rows with the tile's 64 rows. One ldmatrix gives
// the B fragments of two 16-deep k-steps of one 8-row column tile (and an
// .x2 the last step's when D / 16 is odd).
template <int D, typename T = bf16>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const T* tile, int lane) {
  constexpr int LD = D + 8, KS = D / 16;
  const T* base = tile + (lane & 7) * LD + (lane >> 3) * 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk + 1 < KS; kk += 2) {
      uint32_t b[4];
      ldsm_x4(b, base + nt * 8 * LD + kk * 16);
      mma_16816<T>(acc[nt], a[kk], b[0], b[1]);
      mma_16816<T>(acc[nt], a[kk + 1], b[2], b[3]);
    }
    if constexpr (KS % 2) {
      uint32_t b[2];
      ldsm_x2(b, base + nt * 8 * LD + (KS - 1) * 16);
      mma_16816<T>(acc[nt], a[KS - 1], b[0], b[1]);
    }
  }
}

// out[16 x D] += P[16 x 64] . tile[64][D], P given as the C fragments of
// an mma_abt result (re-packed to T A fragments here). One transposing
// ldmatrix gives the B fragments of two 8-wide output column tiles.
template <int D, typename T = bf16>
__device__ __forceinline__ void mma_pv(float (&out)[D / 8][4],
                                       const float (&p)[8][4],
                                       const T* tile, int lane) {
  constexpr int LD = D + 8;
  const T* base =
      tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack2<T>(p[2 * kk][0], p[2 * kk][1]),
                           pack2<T>(p[2 * kk][2], p[2 * kk][3]),
                           pack2<T>(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack2<T>(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, base + kk * 16 * LD + dn * 8);
      mma_16816<T>(out[dn], a, b[0], b[1]);
      mma_16816<T>(out[dn + 1], a, b[2], b[3]);
    }
  }
}

// Elements of one staged [64][D + 8] 16-bit tile.
template <int D>
__host__ __device__ constexpr int tile_elems() {
  return 64 * (D + 8);
}

// Store this thread's two rows of a [16 x D] fp32 accumulator (times
// `mul[i]`) as T; rows at or past `rows` are skipped.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* base, long long stride_t,
                                           const float (&acc)[D / 8][4],
                                           const int (&row)[2], int rows,
                                           const float (&mul)[2], int qi) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= rows) continue;
    T* p = base + (long long)row[i] * stride_t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(p + dn * 8 + qi * 2) =
          pack2<T>(acc[dn][2 * i] * mul[i], acc[dn][2 * i + 1] * mul[i]);
  }
}


// Opt the kernel in to more than 48 KB of dynamic shared memory where it
// needs it (head_dim 128), then launch.
template <typename K>
cudaError_t smem_opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
