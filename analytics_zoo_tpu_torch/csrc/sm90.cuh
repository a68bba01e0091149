// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (int8_matmul.cu, int8_conv.cu, flash_attention_fwd.cuh,
// flash_attention_bwd.cu, flash_tf32.cuh):
// 16-byte cp.async copies with zero fill, mbarriers and tensor copies
// (TMA), the async-proxy fence, the
// 128-byte-swizzled shared-memory layout that wgmma reads, its matrix
// descriptors, and `wgmma.mma_async` on bf16, f16 and tf32 operands with
// f32 accumulators and on s8 operands with s32 accumulators, as inline
// PTX.  The 16-bit helpers are templates on
// the element type (`__nv_bfloat16` or `__half`): the two issue the same
// instruction shapes and differ only in the type suffix, so a caller
// instantiated for f16 cannot issue a `.bf16` product.  For tf32 (4-byte
// values) the same layout holds 32 values a 128-byte row and the K step of
// 8 values is again 32 bytes; tf32 operands must be K-major.  For s8
// (1-byte values) a 128-byte row holds 128 values and the K step of 32
// values is again 32 bytes; s8 operands must be K-major too.
//
// The layout.  An operand tile is stored as "atoms" of 8 rows x 128 bytes
// (8 rows x 64 bf16).  Row r of an atom sits at r * 128 bytes; its 16-byte
// chunk c (8 bf16) sits at chunk c ^ (r % 8) of that row.  Atoms of one
// 64-column block follow one another down the rows (1024 bytes apart); a
// second 64-column block, where a row is wider than 64 values, follows the
// whole first block.  Every atom starts on a 1024-byte boundary, since
// the hardware applies the XOR to address bits 4-6 from bits 7-9.
//
// The descriptors.  For a K-major operand (the 16 K values of one wgmma
// contiguous in a row: Q, K and bf16 x) the next 8 rows are SBO = 1024
// bytes away and the K step of 16 values is a 32-byte move of the start
// address inside the 128-byte row.  For an MN-major operand (V, and the
// converted int8 W, whose rows run along K with N contiguous) the 8-row
// groups along K are SBO = 1024 bytes apart and the next 64 columns of N
// are LBO bytes away (the size of one 64-column block); wgmma reads it
// with the transpose flag set, which bf16 and f16 allow.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace zoo_sm90 {

// The input types of the kernels: f32, or one of the two 16-bit types,
// which wgmma takes as they are (and which are exact in tf32).
template <typename T>
constexpr bool is_f16_v = std::is_same<T, __half>::value;
template <typename T>
constexpr bool is_16bit_v =
    std::is_same<T, __nv_bfloat16>::value || is_f16_v<T>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` (0..7) of row `r` inside a swizzled
// block of 64-value rows.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; `bytes` < 16 reads that many and zero-fills
// the rest (0: no read, all zeros).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
// The same through L1 (.ca): for gathers whose neighbours re-read the
// same lines (the taps of a convolution).
__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// An mbarrier in shared memory counting `count` arrivals, and the
// transaction bytes a tensor copy (TMA) reports to it.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of tensor copies this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// The box at coordinates (c0, c1), innermost first, of the 2-dimensional
// tensor map at `map` (a __grid_constant__ kernel parameter) into shared
// memory at dst; it completes its bytes on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

// Shared memory at src into the box at coordinates (c0, c1) of the
// 2-dimensional tensor map at `map` (a tensor store, in the bulk group of
// the issuing thread; the parts past the tensor's edges are not written).
__device__ __forceinline__ void tma_store_2d(const void* map, uint32_t src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];\n"
      :: "l"(map), "r"(c0), "r"(c1), "r"(src) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until the issuing thread's tensor stores have read their shared
// memory (the writes to device memory may still be in flight).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Fetches a tensor map (a __grid_constant__ kernel parameter) ahead of
// its first use.
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(map) : "memory");
}

// The box at coordinates (c0, c1, c2, c3), innermost first, of the tensor
// map at `map` (a __grid_constant__ kernel parameter) into shared memory
// at dst; it completes its bytes on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// The same for a 5-dimensional map: coordinates (c0, ..., c4).
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
         "r"(bar)
      : "memory");
}

// Makes generic-proxy writes to shared memory (st.shared, cp.async)
// visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_operand(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Matrix descriptor of a 128-byte-swizzled tile starting at shared address
// `addr` (LBO and SBO in bytes).
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

// Two f32 -> one register of two bf16 (round to nearest even), lo first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// The same for two f16 (round to nearest even; above 65504 is inf), in
// the same order: lo in the low half, as the fragments pair them.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// Two f32 -> one register of two T (bf16 or f16), lo first.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  static_assert(is_16bit_v<T>, "bf16 or f16");
  if constexpr (is_f16_v<T>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// d (64 x N, f32) += A (64 x 16) * B (16 x N), T operands (bf16 or f16:
// the same instruction, `.bf16` or `.f16`).  `_ss`: A and B from shared
// memory by descriptor; `_rs`: A from registers in the accumulator-shaped
// fragment (four registers of two T a thread).  TB = 1 reads B as
// MN-major.  scale_d = 0 overwrites d instead of adding.
#define ZOO_WGMMA_M64N32K16_SS(TY)                                            \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                      \
      " %8, %9, %10, %11, %12, %13, %14, %15}, "                              \
      "%16, %17, p, 1, 1, 0, %19;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                    \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB))
template <typename T, int TB>
__device__ __forceinline__ void wgmma_m64n32k16_ss(
    float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  static_assert(is_16bit_v<T>, "bf16 or f16 operands");
  if constexpr (is_f16_v<T>)
    ZOO_WGMMA_M64N32K16_SS("f16");
  else
    ZOO_WGMMA_M64N32K16_SS("bf16");
}
#undef ZOO_WGMMA_M64N32K16_SS

#define ZOO_WGMMA_M64N64K16_SS(TY)                                            \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                      \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                              \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                            \
      "%32, %33, p, 1, 1, 0, %35;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB))
template <typename T, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  static_assert(is_16bit_v<T>, "bf16 or f16 operands");
  if constexpr (is_f16_v<T>)
    ZOO_WGMMA_M64N64K16_SS("f16");
  else
    ZOO_WGMMA_M64N64K16_SS("bf16");
}
#undef ZOO_WGMMA_M64N64K16_SS

#define ZOO_WGMMA_M64N128K16_SS(TY)                                           \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                      \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                              \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                              \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                              \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                              \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                              \
      " %56, %57, %58, %59, %60, %61, %62, %63}, "                            \
      "%64, %65, p, 1, 1, 0, %67;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB))
template <typename T, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  static_assert(is_16bit_v<T>, "bf16 or f16 operands");
  if constexpr (is_f16_v<T>)
    ZOO_WGMMA_M64N128K16_SS("f16");
  else
    ZOO_WGMMA_M64N128K16_SS("bf16");
}
#undef ZOO_WGMMA_M64N128K16_SS

#define ZOO_WGMMA_M64N64K16_RS(TY)                                            \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                      \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                              \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                            \
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), \
        "n"(TB))
template <typename T, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  static_assert(is_16bit_v<T>, "bf16 or f16 operands");
  if constexpr (is_f16_v<T>)
    ZOO_WGMMA_M64N64K16_RS("f16");
  else
    ZOO_WGMMA_M64N64K16_RS("bf16");
}
#undef ZOO_WGMMA_M64N64K16_RS

#define ZOO_WGMMA_M64N128K16_RS(TY)                                           \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                      \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                              \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                              \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                              \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                              \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                              \
      " %56, %57, %58, %59, %60, %61, %62, %63}, "                            \
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), \
        "n"(TB))
template <typename T, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  static_assert(is_16bit_v<T>, "bf16 or f16 operands");
  if constexpr (is_f16_v<T>)
    ZOO_WGMMA_M64N128K16_RS("f16");
  else
    ZOO_WGMMA_M64N128K16_RS("bf16");
}
#undef ZOO_WGMMA_M64N128K16_RS

// d (64 x 32, f32) += A (64 x 8) * B (8 x 32), tf32 operands read from
// shared memory by descriptor, both K-major (tf32 has no transpose).  An
// f32 value read as tf32 keeps its top 19 bits.
__device__ __forceinline__ void wgmma_tf32_m64n32k8_ss(float (&d)[16],
                                                      uint64_t da,
                                                      uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 8) * B (8 x 64), tf32; A from registers:
// a[0] = (row g, k t), a[1] = (g + 8, t), a[2] = (g, t + 4),
// a[3] = (g + 8, t + 4) of the warp's 16 rows, g = lane / 4, t = lane % 4.
__device__ __forceinline__ void wgmma_tf32_m64n64k8_rs(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 8) * B (8 x 128), tf32; A from registers as
// in wgmma_tf32_m64n64k8_rs.
__device__ __forceinline__ void wgmma_tf32_m64n128k8_rs(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64, s32) += A (64 x 32) * B (32 x 64), s8 operands read from
// shared memory by descriptor, both K-major (8-bit wgmma has no transpose).
__device__ __forceinline__ void wgmma_s8_m64n64k32_ss(int (&d)[32],
                                                     uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, s32) += A (64 x 32) * B (32 x 128), s8 operands read from
// shared memory by descriptor, both K-major (8-bit wgmma has no transpose).
__device__ __forceinline__ void wgmma_s8_m64n128k32_ss(int (&d)[64],
                                                     uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// x = hi + lo exactly: hi is x rounded to tf32 (10 mantissa bits, to
// nearest, ties away from zero), lo = x - hi, which needs at most 13
// significant bits and is read by wgmma as its top 11.  hi * hi + hi * lo
// + lo * hi is then the f32 product to ~2^-21 relative (3xTF32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

}  // namespace zoo_sm90
