// Hopper (sm_90a) machinery shared by the port's wgmma kernels
// (fused_xent.cu, fp6_gemm.cu, flash_attention.cu): thin wrappers over
// single PTX instructions, and three host helpers.
//
//   smem_addr        a generic pointer as a 32-bit shared-memory address
//   swizzled         byte offset of an element in a 128-byte-swizzled tile
//   wg_desc          wgmma operand descriptor of a 128-byte-swizzled tile
//   wg_fence / wg_commit / wg_wait
//                    wgmma.fence / commit_group / wait_group
//   fence_regs       pins accumulators (or register A fragments) between
//                    wgmma batches (ptxas C7515)
//   wgmma_ss         one m64nNk16 wgmma, A and B from shared memory, bf16
//                    or fp16 at N = 64, 128 and 256 (A K-major, or
//                    MN-major when TA = 1 at N = 64 and 128), fp32
//                    accumulators
//   wgmma_rs         the same with A from registers, N = 64 or 128
//   ex2              2^x on the MUFU
//   set_max_regs     setmaxnreg: a warpgroup gives up (producer) or takes
//                    (consumers) registers of the block's budget
//   bar_sync / bar_arrive
//                    a named barrier of `N` threads (bar.sync / bar.arrive)
//   fence_async_smem fence.proxy.async.shared::cta: ordinary shared stores
//                    made visible to wgmma and TMA (the async proxy)
//   cluster_arrive / cluster_wait
//                    barrier.cluster.arrive.release / wait.acquire
//   mbar_init / mbar_expect / mbar_wait / mbar_arrive
//                    mbarrier.init / arrive.expect_tx / try_wait.parity /
//                    a plain arrival
//   tma_box / tma_box3 / tma_box4
//                    one 2-D, 3-D or 4-D TMA box (cp.async.bulk.tensor)
//                    into shared memory, completing on an mbarrier
//   bulk_load / bulk_reduce_add / bulk_commit / bulk_wait
//                    contiguous bulk copies: global to shared on an
//                    mbarrier; shared fp32 added into global
//                    (cp.reduce.async.bulk) in bulk groups, and the waits
//                    on those groups
//   encode_tensor_map (host)
//                    cuTensorMapEncodeTiled, looked up once through the
//                    runtime so that no library links libcuda, after
//                    bind_context makes a context current on the thread
//   resident_count / blocks_per_sm (host)
//                    the dynamic shared memory attribute set and the
//                    occupancy asked once per device and configuration
//   cluster_launch (host)
//                    cudaLaunchKernelEx with a cluster dimension along x,
//                    refused before launch when no such cluster fits
//
// Everything sits in an anonymous namespace, as in each source;
// flash_tile.cuh defines smem_addr under the same guard, so a source may
// include both.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

#ifndef PORT_SMEM_ADDR
#define PORT_SMEM_ADDR
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#endif

// Byte offset of element (r, c) of a 128-byte-swizzled bf16 tile with 64
// columns (as TMA's SWIZZLE_128B writes it): rows of 128 bytes in 1 KB
// atoms of 8 rows, 16-byte chunk c / 8 of row r stored at chunk
// (c / 8) ^ (r % 8).
__host__ __device__ __forceinline__ int swizzled(int r, int c) {
  return (r / 8) * 1024 + (r % 8) * 128 + (((c / 8) ^ (r % 8)) * 16) +
         (c % 8) * 2;
}

// wgmma operand descriptor of a 128-byte-swizzled layout (rows of 128
// bytes in 1 KB atoms of 8 rows, each 16-byte chunk XORed with its row
// within the atom; atoms 1024-aligned). K-major (rows along M/N, K within
// the row): sbo = 1024, the atom stride along M/N, and lbo unused; a k16
// step adds 32 bytes. MN-major (rows along K, 64 M/N elements a row):
// sbo = 1024, the atom stride along K, and lbo the stride of the 64-wide
// blocks along M/N.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin a wgmma's accumulators at this point of the program: otherwise the
// compiler may place their definitions between the wgmmas of a batch, and
// ptxas then serializes every wgmma of the function (C7515). Before each
// batch's wgmma.fence and after its wait.
template <int n>
__device__ __forceinline__ void fence_regs(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int n>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// Registers a thread of this warpgroup may hold from here on: the
// producer of a warp-specialized block gives its share back (INC false),
// the consumers take it (INC true). Every warp of the warpgroup executes
// it; the kernel's launch bounds fix the count each starts with.
template <int REGS, bool INC>
__device__ __forceinline__ void set_max_regs() {
  if constexpr (INC)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
  else
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
// 2^x on the MUFU (ex2.approx; -inf gives 0): exp(x) = ex2(x LOG2E)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;
// named barrier `id` (1-15; 0 is __syncthreads) of N threads: wait for all
// N, or count this thread's warp in without waiting
template <int N>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}
// this thread's shared-memory writes visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// an mbarrier whose phase completes after `count` arrivals (and, with
// mbar_expect, the expected TMA bytes)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
// the one arrival of a buffer's phase, expecting `bytes` of TMA copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes) : "memory");
}
// wait for the completion of the phase of parity `parity` (the n-th
// completion, counting from 0, has parity n & 1)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// one arrival on this block's barrier
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
// one TMA box of a 2-D map at (x, y) = (`col`, `row`) into `dst`
// (elements past the map's end are zeros), completing on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* tm,
                                        int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(col), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}
// the same for a 3-D map at (x, y, z)
__device__ __forceinline__ void tma_box3(void* dst, const CUtensorMap* tm,
                                         int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(x), "r"(y), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

// d += A . B for one m64nNk16 wgmma of 16-bit operands (bf16; T = bf16
// or fp16 where a kernel takes both) with fp32 accumulators (d in the
// accumulator layout: warp w of the warpgroup holds rows 16 w + lane / 4
// (+8); element 4 n + x at column 8 n + 2 (lane % 4) + (x & 1), row +8
// for x >= 2). wgmma_ss: A and B
// from shared-memory descriptors (A K-major, or MN-major when TA = 1; B
// K-major, or MN-major when TB = 1). wgmma_rs: A from registers, the four 32-bit registers of this
// thread's m16n8k16 A fragment of its warp's 16 rows (a0: row lane / 4,
// columns 2 (lane % 4), +1; a1: row +8; a2: columns +8; a3: both), the
// layout an accumulator's elements 8 kk .. 8 kk + 7 take when packed in
// pairs, so a product's result feeds the next product's A without a trip
// through shared memory.
template <int TB, typename T = __nv_bfloat16, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d,
                                         std::integral_constant<int, 64>) {
#define PORT_WGMMA_SS64(TY)                                                    \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{"                                                                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31"                                                               \
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),\
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),\
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),\
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),\
        "+f"(d[30]), "+f"(d[31])                                             \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB))
  if constexpr (std::is_same<T, __half>::value)
    PORT_WGMMA_SS64("f16");
  else
    PORT_WGMMA_SS64("bf16");
#undef PORT_WGMMA_SS64
}

template <int TB, typename T = __nv_bfloat16, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d,
                                         std::integral_constant<int, 128>) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a, uint64_t b,
                                         int scale_d,
                                         std::integral_constant<int, 256>) {
#define PORT_WGMMA_SS256(TY)                                                   \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), \
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
        "+f"(d[126]), "+f"(d[127]) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB))
  if constexpr (std::is_same<T, __half>::value)
    PORT_WGMMA_SS256("f16");
  else
    PORT_WGMMA_SS256("bf16");
#undef PORT_WGMMA_SS256
}

template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d,
                                         std::integral_constant<int, 64>) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
  }
}

template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d,
                                         std::integral_constant<int, 128>) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
  }
}

// the same for a 4-D map at (x, y, z, w)
__device__ __forceinline__ void tma_box4(void* dst, const CUtensorMap* tm,
                                         int x, int y, int z, int w,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(x), "r"(y), "r"(z), "r"(w),
      "r"(smem_addr(bar))
      : "memory");
}
// `bytes` (a 16-byte multiple) from global `src` into shared `dst` by the
// bulk copy engine (no tensor map), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// global dst[i] += shared src[i] over `bytes` (a 16-byte multiple) of
// fp32, done by the bulk copy engine at L2 (atomic per element), in this
// thread's current bulk group
__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n" ::"l"(__cvta_generic_to_global(dst)),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's bulk groups are pending: READ,
// until their shared sources have been read (the buffer may be reused);
// otherwise until their writes are done
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// ------------------------------------------------------------------ host

// Make the device's primary context current on this thread if no context
// is. The runtime's own calls bind it themselves, a driver call does not:
// PyTorch's autograd engine runs a backward on a thread of its own and,
// for device 0, makes no context current there until one of its calls
// needs one, so cuTensorMapEncodeTiled failed there on a TMA kernel's
// first backward launch (seen on the flash backward, H100 80GB HBM3).
// cuCtxGetCurrent is a thread-local read; cudaSetDevice runs only when no
// context is current.
inline cudaError_t bind_context() {
  typedef CUresult (*GetCurrent)(CUcontext*);
  static GetCurrent get = nullptr;
  if (!get) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuCtxGetCurrent", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    get = reinterpret_cast<GetCurrent>(fn);
  }
  CUcontext ctx = nullptr;
  if (get(&ctx) == CUDA_SUCCESS && ctx) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

// A tiled TMA map of `rank` (2 to 5) dimensions, innermost first: `dims`
// elements, `strides` the byte strides of dims 1.. (rank - 1 of them),
// boxes of `box` elements, no interleave, L2 promotion of 128 bytes,
// out-of-range elements read as zeros.
inline cudaError_t encode_tensor_map(CUtensorMap* map, CUtensorMapDataType dt,
                                     int rank, const void* base,
                                     const cuuint64_t* dims,
                                     const cuuint64_t* strides,
                                     const cuuint32_t* box,
                                     CUtensorMapSwizzle swizzle) {
  cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, dt, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box,
      step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The resident count of `kernel` at `threads` a block and `smem` bytes
// of dynamic shared memory on the current device, its shared memory
// attribute set first: blocks an SM (`cfg` null), or clusters of `cl`
// blocks at the configuration in `cfg` on the device. Both the attribute
// and the count belong to a device, so each (device, kernel, cluster,
// shared memory, threads) is asked once and remembered: a launch on the
// decode path must not pay for the query every call. The attribute is
// only ever raised (to the most any configuration of the kernel asked
// for on the device): a kernel launched at several sizes (the norm
// kernel's staged weights) keeps every size asked before launchable.
inline cudaError_t resident_count(const void* kernel, unsigned threads,
                                  size_t smem, const cudaLaunchConfig_t* cfg,
                                  int cl, int* count) {
  struct Entry {
    int dev;
    const void* fn;
    int cl;
    size_t smem;
    unsigned threads;
    int count;
  };
  static Entry seen[256];
  static int n_seen = 0;
  struct Attr {
    int dev;
    const void* fn;
    size_t smem;
  };
  static Attr set[256];
  static int n_set = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].dev == dev && seen[i].fn == kernel && seen[i].cl == cl &&
        seen[i].smem == smem && seen[i].threads == threads) {
      *count = seen[i].count;
      return cudaSuccess;
    }
  int a = 0;
  while (a < n_set && !(set[a].dev == dev && set[a].fn == kernel)) ++a;
  if (a == n_set || set[a].smem < smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (a < n_set)
      set[a].smem = smem;
    else if (n_set < 256)
      set[n_set++] = {dev, kernel, smem};
  }
  err = cfg ? cudaOccupancyMaxActiveClusters(count, kernel, cfg)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(count, kernel,
                                                            (int)threads,
                                                            smem);
  if (err != cudaSuccess) return err;
  if (n_seen < 256) seen[n_seen++] = {dev, kernel, cl, smem, threads, *count};
  return cudaSuccess;
}

inline cudaError_t blocks_per_sm(const void* kernel, unsigned threads,
                                 size_t smem, int* count) {
  return resident_count(kernel, threads, smem, nullptr, 0, count);
}

// Launch `kernel` on clusters of `cl` blocks along x (grid.x % cl == 0).
// A cluster that cannot be resident is refused before launch
// (cudaErrorInvalidConfiguration) rather than left to hang or fail late.
template <typename... KArgs, typename... Args>
cudaError_t cluster_launch(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                           size_t smem, int cl, cudaStream_t stream,
                           Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = resident_count(reinterpret_cast<const void*>(kernel),
                                   block.x, smem, &cfg, cl, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
