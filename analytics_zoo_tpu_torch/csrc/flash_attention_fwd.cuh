// Flash-attention forward: the device code, and the helpers the backward
// (flash_attention_bwd.cu) shares with it.
//
// Replaces the TPU kernel `_flash_fwd_pallas`
// (analytics_zoo_tpu/ops/pallas/flash_attention.py:216, kernel closure :245,
// pl.pallas_call :399): an additive f32 bias broadcast over
// (B|1, H|1, Lq|1, Lk), end-aligned causal masking, ragged Lq/Lk, f32 or
// bf16 inputs with f32 math, output in the input type, in-kernel attention
// dropout from the reference's position hash, and optionally the softmax
// statistics (m, l) per query row, which the backward reads.  Segment ids
// are not ported yet.
//
// Semantics (identical to the reference's `_attention_reference`): a running
// max m floored at -1e30, so a row whose keys are all masked, by the causal
// triangle or by a bias of finfo.min, comes out as zeros and never as NaN;
// keys past Lk are zeroed in shared memory, not only masked, because 0 * NaN
// would poison the accumulator.  Dropout keeps an element when
// keep_bits(seed0, seed1, b, h, q, k) >= floor(p * 2^32) and scales it by
// 1/(1-p); l sums the probabilities before dropout, so out = acc / l is
// dropout applied after the softmax, as in the reference.
//
// What bounds it on an H100: at BERT-base shapes (B=8, H=12, L=512, D=64)
// the function moves 50 MB in f32 (15 us at 3.35 TB/s) and does 6.4 GFLOP
// (96 us at the 67 TFLOP/s f32 CUDA-core peak), so it is bound by
// operations.  The design therefore spends its effort on the FMA loop:
// - one 256-thread block per (q-tile of 64 rows, head, batch); a loop over
//   64-key tiles inside the block replaces the TPU's sequential `ki` grid
//   axis, and the running (m, l) and the output accumulator stay in
//   registers for the whole loop;
// - Q, K and V tiles are staged once per tile in shared memory as f32, so
//   bf16 inputs are converted once and every product runs in f32;
// - each thread owns a 4x4 block of the 64x64 score tile (rows ty+16i,
//   columns tx+16j) and a 4x(D/16) block of the output, and reads shared
//   memory as float4: 8 FMAs per 16-byte load, with a row pad of 4 floats
//   that keeps the 16 threads of a half-warp on distinct banks;
// - the 16 threads that share a row reduce its max and sum with warp
//   shuffles, and exchange probabilities through a shared 64x64 tile for
//   the P @ V product;
// - under causal masking a q-tile stops at the last key tile any of its
//   rows can see.
// Tensor cores (mma/wgmma on bf16 inputs) and TMA loads are later work.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace zoo_flash {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block: 16 x 16
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
  // dropout: keep an element when keep_bits(...) >= drop_thr
  int dropout;
  uint32_t seed0, seed1, drop_thr;
  float inv_keep;  // 1 / (1 - p)
};

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

__host__ __device__ __forceinline__ uint32_t keep_bits(
    uint32_t seed0, uint32_t seed1, uint32_t b, uint32_t h, uint32_t q,
    uint32_t k) {
  uint32_t x = (q * 0x9E3779B9u) ^ (k * 0x85EBCA6Bu);
  x = x ^ (b * 0xC2B2AE35u) ^ (h * 0x27D4EB2Fu);
  x = x ^ seed0 ^ (seed1 * 0x85EBCA6Bu);
  return mix32(x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Bytes of dynamic shared memory the kernel needs for head dim D.
__host__ __device__ constexpr int smem_bytes(int D) {
  return ((BQ + BK) * (D + 4) + BK * D + BQ * (BK + 4)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  constexpr int QS = D + 4;   // row stride of the Q and K tiles
  constexpr int PS = BK + 4;  // row stride of the probability tile
  constexpr int CPT = D / 16; // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int offset = a.Lk - a.Lq;  // end-aligned causal diagonal
  const T* q = static_cast<const T*>(a.q) + b * a.qs_b + h * a.qs_h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks_b + h * a.ks_h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs_b + h * a.vs_h;
  const float* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.bs_b + h * a.bs_h;

  // Stage the Q tile; rows past Lq are zero.
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    Qs[r * QS + c] = qi < a.Lq ? to_f32(q[qi * a.qs_l + c]) : 0.f;
  }

  float m[4], l[4], o[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;
  }

  // Keys at or past kend are masked for every row of this tile.
  const int kend = a.causal ? min(a.Lk, q0 + BQ + offset) : a.Lk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      const bool in = kj < a.Lk;
      Ks[r * QS + c] = in ? to_f32(k[kj * a.ks_l + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(v[kj * a.vs_l + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4x4 block.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = s[i][j];
          acc = fmaf(qv[i].x, kv[j].x, acc);
          acc = fmaf(qv[i].y, kv[j].y, acc);
          acc = fmaf(qv[i].z, kv[j].z, acc);
          acc = fmaf(qv[i].w, kv[j].w, acc);
          s[i][j] = acc;
        }
    }

    // Scale, bias and mask, then the streaming-softmax update per row.
    unsigned live = 0u;  // bit 4*i+j: element (i, j) is visible
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < a.Lk && qi < a.Lq &&
                        (!a.causal || qi + offset >= kj);
        float x = s[i][j] * a.scale;
        if (ok && bias != nullptr) x += bias[qi * a.bs_q + kj * a.bs_k];
        s[i][j] = ok ? x : NEG;
        live |= (ok ? 1u : 0u) << (4 * i + j);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = (live >> (4 * i + j)) & 1u ? expf(s[i][j] - mnew) : 0.f;
        rs += p;  // l is the denominator before dropout
        if (a.dropout) {
          const uint32_t bits =
              keep_bits(a.seed0, a.seed1, b, h, q0 + ty + 16 * i,
                        k0 + tx + 16 * j);
          p = bits >= a.drop_thr ? p * a.inv_keep : 0.f;
        }
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V for this thread's 4 x CPT block.
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPT];
#pragma unroll
        for (int w = 0; w < CPT; w += 4) {
          const float4 t = *reinterpret_cast<const float4*>(
              &Vs[(kk + u) * D + tx * CPT + w]);
          vv[w] = t.x;
          vv[w + 1] = t.y;
          vv[w + 2] = t.z;
          vv[w + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0   ? pv[i].x
                          : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z
                                   : pv[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out) + b * a.os_b + h * a.os_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < a.Lq) {
      const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        store_as(&out[qi * a.os_l + tx * CPT + c], o[i][c] / denom);
      if (a.m_out != nullptr && tx == 0) {
        const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Lq + qi;
        a.m_out[row] = m[i];
        a.l_out[row] = l[i];
      }
    }
  }
}

}  // namespace zoo_flash
