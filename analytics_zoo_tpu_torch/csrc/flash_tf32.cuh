// The 3xTF32 staging shared by the f32 flash forward (flash_attention_fwd.cuh)
// and the backward (flash_attention_bwd.cu): f32 tiles split into tf32 hi
// and lo pieces in the 128-byte-swizzled K-major layout of sm90.cuh, the
// transposed layout whose row order matches a register A fragment, the
// score product of a 64-row tile and a 32-row tile (lo products first), the
// A fragments of a 64 x 32 accumulator, and the output product they feed.

#pragma once

#include <stdint.h>

#include "sm90.cuh"

namespace zoo_tf32 {

constexpr int OWN = 64;  // rows of the A tile of a score product
constexpr int SR = 32;   // rows of its B tile (32 tf32 values: 128 bytes)

// Byte offset of f32 chunk `ch` (values 4 ch .. 4 ch + 3) of row r in a
// K-major swizzled tile of R rows: 32-value column blocks follow each other.
template <int R>
__device__ __forceinline__ uint32_t kmajor(int r, int ch) {
  return static_cast<uint32_t>((ch >> 3) * (R * 128)) +
         zoo_sm90::swz(r, ch & 7);
}

// Byte offset of row r (< 32), column d in a transposed tile (row d, 32
// values a row): within each group of 8, row 2c sits at position c and row
// 2c + 1 at c + 4, the order in which a thread's accumulator columns fill
// the tf32 A fragment (a_frags).
__device__ __forceinline__ uint32_t transposed(int d, int r) {
  const int pos = (r & 24) | ((r & 7) >> 1) | ((r & 1) << 2);
  return zoo_sm90::swz(d, pos >> 2) + (pos & 3) * 4;
}

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  zoo_sm90::split_tf32(x.x, hi.x, lo.x);
  zoo_sm90::split_tf32(x.y, hi.y, lo.y);
  zoo_sm90::split_tf32(x.z, hi.z, lo.z);
  zoo_sm90::split_tf32(x.w, hi.w, lo.w);
}

// acc (64 x 32) = A . B^T over D, A a 64-row and B a 32-row K-major tile in
// hi and lo pieces: lo products first, then hi * hi.
template <int D>
__device__ __forceinline__ void issue_scores(float (&acc)[16], uint32_t a_hi,
                                             uint32_t a_lo, uint32_t b_hi,
                                             uint32_t b_lo) {
  using zoo_sm90::desc_b128;
  auto da = [](uint32_t base, int kk) {
    return desc_b128(base + (kk >> 2) * (OWN * 128) + (kk & 3) * 32, 16, 1024);
  };
  auto db = [](uint32_t base, int kk) {
    return desc_b128(base + (kk >> 2) * (SR * 128) + (kk & 3) * 32, 16, 1024);
  };
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    zoo_sm90::wgmma_tf32_m64n32k8_ss(acc, da(a_lo, kk), db(b_hi, kk), kk > 0);
    zoo_sm90::wgmma_tf32_m64n32k8_ss(acc, da(a_hi, kk), db(b_lo, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    zoo_sm90::wgmma_tf32_m64n32k8_ss(acc, da(a_hi, kk), db(b_hi, kk), 1);
}

// A fragments of a 64 x 32 accumulator-shaped tile for the four k-steps
// over its 32 columns, split into hi and lo.
__device__ __forceinline__ void a_frags(const float (&x)[16],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    zoo_sm90::split_tf32(x[4 * j + 0], hi[j][0], lo[j][0]);
    zoo_sm90::split_tf32(x[4 * j + 2], hi[j][1], lo[j][1]);
    zoo_sm90::split_tf32(x[4 * j + 1], hi[j][2], lo[j][2]);
    zoo_sm90::split_tf32(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// total (64 x 64, warpgroup wg's output columns) += A . B over 32 rows,
// A (64 x 32) from registers in hi and lo pieces, B a transposed tile (wg's
// 64 rows at wg * 8 KB); the product goes into a fresh accumulator first,
// lo products first, and is added into total in f32.  EXACT: B is exact in
// tf32 (bf16), its lo piece is zero and skipped.
template <bool EXACT>
__device__ __forceinline__ void accumulate(float (&total)[32],
                                           const uint32_t (&a_hi)[4][4],
                                           const uint32_t (&a_lo)[4][4],
                                           uint32_t t_hi, uint32_t t_lo,
                                           int wg) {
  using zoo_sm90::desc_b128;
  auto db = [&](uint32_t base, int j) {
    return desc_b128(base + wg * 64 * 128 + j * 32, 16, 1024);
  };
  float f[32];
  zoo_sm90::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    zoo_sm90::wgmma_tf32_m64n64k8_rs(f, a_lo[j], db(t_hi, j), j > 0);
  if (!EXACT) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      zoo_sm90::wgmma_tf32_m64n64k8_rs(f, a_hi[j], db(t_lo, j), 1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    zoo_sm90::wgmma_tf32_m64n64k8_rs(f, a_hi[j], db(t_hi, j), 1);
  zoo_sm90::wgmma_commit();
  zoo_sm90::wgmma_wait<0>();
  zoo_sm90::fence_operand(f);
#pragma unroll
  for (int i = 0; i < 32; ++i) total[i] += f[i];
}

}  // namespace zoo_tf32
