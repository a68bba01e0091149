// Flash attention: what the forward kernels (flash_attention_fwd.cuh) and
// the backward (flash_attention_bwd.cu) share: the tiles of the CUDA-core
// bodies and their staging and score products, the running-max floor, the
// forward's argument block, the reference's dropout hash and the f32 <->
// input-type conversions (f32, bf16, f16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace zoo_flash {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per CUDA-core block: 16 x 16
constexpr float NEG = -1e30f; // running-max floor, as in the reference

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // null when there is no bias
  void* out;
  int B, H, Lq, Lk;
  // element strides of the batch, head and sequence dims (the head dim is
  // contiguous); broadcast bias dims have stride 0
  int64_t qs_b, qs_h, qs_l;
  int64_t ks_b, ks_h, ks_l;
  int64_t vs_b, vs_h, vs_l;
  int64_t bs_b, bs_h, bs_q, bs_k;
  int64_t os_b, os_h, os_l;
  float scale;
  int causal;
  // (B, H, Lq) f32 outputs of the running max and the softmax denominator;
  // both null when the caller needs no statistics
  float* m_out;
  float* l_out;
  // dropout: keep an element when keep_bits(...) >= drop_thr; the
  // (seed0, seed1) pair is read from device memory (load_seed), so a
  // captured step's replays each take the pair written before them
  int dropout;
  const uint32_t* seed;  // null without dropout
  uint32_t drop_thr;
  float inv_keep;  // 1 / (1 - p)
  // contiguous (B, Lq) and (B, Lk) int32 segment ids, or both null: a
  // (query, key) pair is live only where the two are equal
  const int* q_seg;
  const int* kv_seg;
};

// The dropout seed pair (seed0, seed1), read from device memory at the
// start of a block; (0, 0) without dropout, when the pointer is null.
template <typename A>
__device__ __forceinline__ uint2 load_seed(const A& a) {
  return a.dropout ? make_uint2(a.seed[0], a.seed[1]) : make_uint2(0u, 0u);
}

// The reference's counter-based dropout hash (`_mix32`, `_keep_bits`,
// flash_attention.py:73-90), bit for bit: uint32 arithmetic wraps.
__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The hash's input is an XOR of a part fixed by (seed, b, h) and one part
// each of the query and the key position, so a kernel can form the fixed
// and per-row parts once and each element with one XOR.
__host__ __device__ __forceinline__ uint32_t keep_base(uint32_t seed0,
                                                       uint32_t seed1,
                                                       uint32_t b,
                                                       uint32_t h) {
  return (b * 0xC2B2AE35u) ^ (h * 0x27D4EB2Fu) ^ seed0 ^
         (seed1 * 0x85EBCA6Bu);
}
__host__ __device__ __forceinline__ uint32_t keep_q(uint32_t q) {
  return q * 0x9E3779B9u;
}
__host__ __device__ __forceinline__ uint32_t keep_k(uint32_t k) {
  return k * 0x85EBCA6Bu;
}

__host__ __device__ __forceinline__ uint32_t keep_bits(
    uint32_t seed0, uint32_t seed1, uint32_t b, uint32_t h, uint32_t q,
    uint32_t k) {
  return mix32(keep_base(seed0, seed1, b, h) ^ keep_q(q) ^ keep_k(k));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
// rounds to nearest even; above f16's largest finite value (65504) is inf,
// as the reference's cast
__device__ __forceinline__ void store_as(__half* p, float x) {
  *p = __float2half_rn(x);
}

// ---------------------------------------------------------------------------
// The CUDA-core bodies (any head dim): 256 threads, 16 x 16, each owning a
// 4 x 4 block of a 64 x 64 tile; the head dim is a loop over 64-column
// chunks held in shared memory with a row pad of 4 floats.
// ---------------------------------------------------------------------------

constexpr int CS = 64 + 4;  // row stride of a 64-column chunk (floats)

// Rows r0 .. r0 + 63, columns col0 .. col0 + 63 of a (rows, D) matrix with
// row stride ls into a 64-row f32 tile of row stride `stride`; rows past n
// and columns past D read as zeros.
template <typename T>
__device__ __forceinline__ void stage_chunk(float* dst, int stride,
                                            const T* src, int64_t ls, int r0,
                                            int n, int col0, int D) {
  for (int i = threadIdx.x; i < 64 * 64; i += NT) {
    const int r = i >> 6, c = i & 63;
    dst[r * stride + c] = r0 + r < n && col0 + c < D
                              ? to_f32(src[(r0 + r) * ls + col0 + c])
                              : 0.f;
  }
}

// acc[i][j] += sum over the 64 columns of A[ty + 16 i] . B[tx + 16 j], both
// 64 x CS tiles
__device__ __forceinline__ void dot_chunk(float (&acc)[4][4], const float* A,
                                          const float* B, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < 64; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * CS + d]);
      bv[i] = *reinterpret_cast<const float4*>(&B[(tx + 16 * i) * CS + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = acc[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        acc[i][j] = x;
      }
  }
}

}  // namespace zoo_flash
