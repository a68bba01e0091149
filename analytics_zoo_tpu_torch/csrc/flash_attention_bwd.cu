// Flash-attention backward: two kernels and their launch entry point, with a
// plain C interface for ctypes (analytics_zoo_tpu_torch/ops/cuda/
// flash_attention.py).
//
// Replaces the TPU kernel `_flash_bwd_pallas`
// (analytics_zoo_tpu/ops/pallas/flash_attention.py:458; shared tile math
// `tiles` :508, `dq_kernel` :568, `dkv_kernel` :609, pl.pallas_call :721 and
// :754).  It computes, from the forward's saved statistics (m, l) per query
// row and D = rowsum(dO * O) (computed by the caller, as the reference does
// outside its kernels):
//   p  = live ? exp(s - m) / max(l, 1e-20) : 0      s = q.k * scale + bias
//   t  = dropout keep mask * 1/(1-p), re-derived from the forward's hash
//   dS = live ? p * (t * dO.v - D) : 0
//   dq = scale * dS k,   dk = scale * dS^T q,   dv = (p t)^T dO,
//   and, for a bias broadcast as (B|1, H|1, 1, Lk), the partial
//   dbias[b, h, k] = sum over q of dS (the caller sums the broadcast dims).
// The division and the D-subtraction sit inside the `live` select, so a
// padded or masked entry is an exact zero: the dk/dv kernel contracts over
// query rows, and one NaN there would poison every output.
//
// Two kernels, as on the TPU, and no atomics: the dq kernel owns a tile of
// 64 query rows and streams the key tiles past it; the dk/dv kernel owns a
// tile of 64 keys and streams the query tiles past it.  Each output element
// is written by exactly one thread, so the result is deterministic, and the
// bias-gradient partial of a key needs no cross-block reduction.  The cost
// is that both kernels recompute the score tile (five 64x64xD products per
// tile pair in all, against the three a one-kernel design with atomic dq
// adds would need).
//
// What bounds it on an H100: at the BERT-base training shape (B=8, H=12,
// L=512, D=64) the five products are ~16 GFLOP on the dense tiles, about
// 0.24 ms at the 67 TFLOP/s f32 CUDA-core peak, against ~75 MB moved (22 us),
// so it is bound by operations.  The design reuses the forward's FMA loop:
// one 256-thread block per tile, f32 tiles in shared memory (bf16 inputs
// converted once), each thread owning a 4x4 block of the 64x64 score tile
// and reading shared memory as float4.  The dk/dv kernel stores p*t and dS
// transposed, so its contraction over query rows also reads float4.
// Tensor cores and TMA are later work.  Head dims 64 and 128 are built.

#include <cuda_runtime.h>

#include "flash_attention_fwd.cuh"

namespace zoo_flash_bwd {

using zoo_flash::BK;
using zoo_flash::BQ;
using zoo_flash::NT;
using zoo_flash::keep_bits;
using zoo_flash::store_as;
using zoo_flash::to_f32;

constexpr int PS = BK + 4;  // row stride of the 64x64 probability tiles

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;       // dO
  const float* m;      // (B, H, Lq) forward running max
  const float* l;      // (B, H, Lq) forward softmax denominator
  const float* dsum;   // (B, H, Lq) D = rowsum(dO * O)
  const float* bias;   // null when there is no bias
  void* dq;            // contiguous (B, H, Lq, D), input type
  void* dk;            // contiguous (B, H, Lk, D)
  void* dv;
  float* dbias;        // (B, H, Lk) partials, or null
  int B, H, Lq, Lk;
  int64_t qs_b, qs_h, qs_l;
  int64_t ks_b, ks_h, ks_l;
  int64_t vs_b, vs_h, vs_l;
  int64_t gs_b, gs_h, gs_l;
  int64_t bs_b, bs_h, bs_q, bs_k;
  float scale;
  int causal;
  int dropout;
  uint32_t seed0, seed1, drop_thr;
  float inv_keep;
};

__host__ __device__ constexpr int dq_smem_bytes(int D) {
  return ((2 * BQ + 2 * BK) * (D + 4) + BQ * PS) * 4;
}

__host__ __device__ constexpr int dkv_smem_bytes(int D) {
  return ((2 * BQ + 2 * BK) * (D + 4) + 2 * BK * PS + 3 * BQ) * 4;
}

// Stage rows [r0, r0 + 64) of a (L, D) slice with row stride `ls` into a
// shared tile of row stride D + 4, as f32; rows past `len` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t ls,
                                      int r0, int len) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    const int row = r0 + r;
    dst[r * (D + 4) + c] = row < len ? to_f32(src[row * ls + c]) : 0.f;
  }
}

// s[i][j] = A[ty + 16i] . B[tx + 16j] over D, tiles of row stride D + 4.
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm,
                                         int ty, int tx, float (&s)[4][4]) {
  constexpr int S = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * S + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * S + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = s[i][j];
        acc = fmaf(av[i].x, bv[j].x, acc);
        acc = fmaf(av[i].y, bv[j].y, acc);
        acc = fmaf(av[i].z, bv[j].z, acc);
        acc = fmaf(av[i].w, bv[j].w, acc);
        s[i][j] = acc;
      }
  }
}

// The reference's `tiles`: for this thread's 4x4 block of (query rows
// q0 + ty + 16i, keys k0 + tx + 16j), p*t and dS from the raw scores s,
// dp = dO.v, and the rows' statistics (m, floored l, D).
__device__ __forceinline__ void grad_tile(
    const Args& a, int b, int h, int q0, int k0, int ty, int tx,
    const float* bias, const float (&s)[4][4], const float (&dp)[4][4],
    const float (&mr)[4], const float (&lr)[4], const float (&dr)[4],
    float (&pt)[4][4], float (&ds)[4][4]) {
  const int offset = a.Lk - a.Lq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      const bool live =
          qi < a.Lq && kj < a.Lk && (!a.causal || qi + offset >= kj);
      float x = s[i][j] * a.scale;
      if (live && bias != nullptr) x += bias[qi * a.bs_q + kj * a.bs_k];
      const float p = live ? expf(x - mr[i]) / lr[i] : 0.f;
      float t = 1.f;
      if (a.dropout)
        t = keep_bits(a.seed0, a.seed1, b, h, qi, kj) >= a.drop_thr
                ? a.inv_keep
                : 0.f;
      pt[i][j] = p * t;
      ds[i][j] = live ? p * (t * dp[i][j] - dr[i]) : 0.f;
    }
  }
}

// ---- dq: one block per (64 query rows, head, batch); key tiles stream --
template <typename T, int D>
__global__ void __launch_bounds__(NT) dq_kernel(Args a) {
  constexpr int S = D + 4;
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + BQ * S;
  float* Ks = Gs + BQ * S;
  float* Vs = Ks + BK * S;
  float* Ss = Vs + BK * S;  // dS * scale, 64 x 64

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int offset = a.Lk - a.Lq;
  const T* q = static_cast<const T*>(a.q) + b * a.qs_b + h * a.qs_h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs_b + h * a.gs_h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks_b + h * a.ks_h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs_b + h * a.vs_h;
  const float* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.bs_b + h * a.bs_h;
  const int64_t rows = (static_cast<int64_t>(b) * a.H + h) * a.Lq;

  stage<T, D>(Qs, q, a.qs_l, q0, a.Lq);
  stage<T, D>(Gs, g, a.gs_l, q0, a.Lq);
  float mr[4], lr[4], dr[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    const bool in = qi < a.Lq;
    mr[i] = in ? a.m[rows + qi] : 0.f;
    lr[i] = in ? fmaxf(a.l[rows + qi], 1e-20f) : 1.f;
    dr[i] = in ? a.dsum[rows + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int kend = a.causal ? min(a.Lk, q0 + BQ + offset) : a.Lk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(Ks, k + k0 * a.ks_l, a.ks_l, 0, a.Lk - k0);
    stage<T, D>(Vs, v + k0 * a.vs_l, a.vs_l, 0, a.Lk - k0);
    __syncthreads();

    float s[4][4], dp[4][4], pt[4][4], ds[4][4];
    dot_tile<D>(Qs, Ks, ty, tx, s);
    dot_tile<D>(Gs, Vs, ty, tx, dp);
    grad_tile(a, b, h, q0, k0, ty, tx, bias, s, dp, mr, lr, dr, pt, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty + 16 * i) * PS + tx + 16 * j] = ds[i][j] * a.scale;
    __syncthreads();

    // dq += dS K for this thread's 4 x CPT block.
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sv[i] = *reinterpret_cast<const float4*>(&Ss[(ty + 16 * i) * PS + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kv[CPT];
#pragma unroll
        for (int w = 0; w < CPT; w += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(
              &Ks[(kk + u) * S + tx * CPT + w]);
          kv[w] = t4.x;
          kv[w + 1] = t4.y;
          kv[w + 2] = t4.z;
          kv[w + 3] = t4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0   ? sv[i].x
                          : u == 1 ? sv[i].y
                          : u == 2 ? sv[i].z
                                   : sv[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, kv[c], acc[i][c]);
        }
      }
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < a.Lq) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        store_as(&dq[(rows + qi) * D + tx * CPT + c], acc[i][c]);
    }
  }
}

// ---- dk, dv (and dbias partials): one block per (64 keys, head, batch);
// query tiles stream --------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT) dkv_kernel(Args a) {
  constexpr int S = D + 4;
  constexpr int CPT = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * S;
  float* Qs = Vs + BK * S;
  float* Gs = Qs + BQ * S;
  float* PT = Gs + BQ * S;  // (p t)^T: row = key, column = query
  float* DT = PT + BK * PS; // dS^T
  float* Ms = DT + BK * PS; // the query tile's m, floored l and D
  float* Ls = Ms + BQ;
  float* Dsm = Ls + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int offset = a.Lk - a.Lq;
  const T* q = static_cast<const T*>(a.q) + b * a.qs_b + h * a.qs_h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs_b + h * a.gs_h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks_b + h * a.ks_h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs_b + h * a.vs_h;
  const float* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.bs_b + h * a.bs_h;
  const int64_t rows = (static_cast<int64_t>(b) * a.H + h) * a.Lq;

  stage<T, D>(Ks, k, a.ks_l, k0, a.Lk);
  stage<T, D>(Vs, v, a.vs_l, k0, a.Lk);
  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;
  float db = 0.f;  // thread tid < 64: the partial of key k0 + tid

  // Under causal masking, query rows before k0 - offset see no key here.
  const int qstart = a.causal ? max(0, k0 - offset) / BQ * BQ : 0;
  for (int q0 = qstart; q0 < a.Lq; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(Qs, q, a.qs_l, q0, a.Lq);
    stage<T, D>(Gs, g, a.gs_l, q0, a.Lq);
    if (tid < BQ) {
      const int qi = q0 + tid;
      const bool in = qi < a.Lq;
      Ms[tid] = in ? a.m[rows + qi] : 0.f;
      Ls[tid] = in ? fmaxf(a.l[rows + qi], 1e-20f) : 1.f;
      Dsm[tid] = in ? a.dsum[rows + qi] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4], pt[4][4], ds[4][4];
    float mr[4], lr[4], dr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mr[i] = Ms[ty + 16 * i];
      lr[i] = Ls[ty + 16 * i];
      dr[i] = Dsm[ty + 16 * i];
    }
    // rows: queries ty + 16i of this q tile; columns: keys tx + 16j
    dot_tile<D>(Qs, Ks, ty, tx, s);
    dot_tile<D>(Gs, Vs, ty, tx, dp);
    grad_tile(a, b, h, q0, k0, ty, tx, bias, s, dp, mr, lr, dr, pt, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        PT[(tx + 16 * j) * PS + ty + 16 * i] = pt[i][j];
        DT[(tx + 16 * j) * PS + ty + 16 * i] = ds[i][j];
      }
    __syncthreads();

    // dv += (p t)^T dO and dk += dS^T Q for keys ty + 16i, columns
    // tx * CPT + c.
#pragma unroll 2
    for (int qq = 0; qq < BQ; qq += 4) {
      float4 pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(&PT[(ty + 16 * i) * PS + qq]);
        sv[i] = *reinterpret_cast<const float4*>(&DT[(ty + 16 * i) * PS + qq]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float gv[CPT], qv[CPT];
#pragma unroll
        for (int w = 0; w < CPT; w += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(
              &Gs[(qq + u) * S + tx * CPT + w]);
          const float4 q4 = *reinterpret_cast<const float4*>(
              &Qs[(qq + u) * S + tx * CPT + w]);
          gv[w] = g4.x;
          gv[w + 1] = g4.y;
          gv[w + 2] = g4.z;
          gv[w + 3] = g4.w;
          qv[w] = q4.x;
          qv[w + 1] = q4.y;
          qv[w + 2] = q4.z;
          qv[w + 3] = q4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0   ? pv[i].x
                          : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z
                                   : pv[i].w;
          const float d = u == 0   ? sv[i].x
                          : u == 1 ? sv[i].y
                          : u == 2 ? sv[i].z
                                   : sv[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            dv[i][c] = fmaf(p, gv[c], dv[i][c]);
            dk[i][c] = fmaf(d, qv[c], dk[i][c]);
          }
        }
      }
    }
    if (a.dbias != nullptr && tid < BK) {
      for (int qq = 0; qq < BQ; qq += 4) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(&DT[tid * PS + qq]);
        db += (d4.x + d4.y) + (d4.z + d4.w);
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
  const int64_t keys = (static_cast<int64_t>(b) * a.H + h) * a.Lk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj < a.Lk) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        store_as(&dkp[(keys + kj) * D + tx * CPT + c], dk[i][c] * a.scale);
        store_as(&dvp[(keys + kj) * D + tx * CPT + c], dv[i][c]);
      }
    }
  }
  if (a.dbias != nullptr && tid < BK && k0 + tid < a.Lk)
    a.dbias[keys + k0 + tid] = db;
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int dq_smem = dq_smem_bytes(D);
  constexpr int dkv_smem = dkv_smem_bytes(D);
  auto dqk = dq_kernel<T, D>;
  auto dkvk = dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkvk, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (err != cudaSuccess) return err;
  const dim3 qgrid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  dqk<<<qgrid, NT, dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kgrid((a.Lk + BK - 1) / BK, a.H, a.B);
  dkvk<<<kgrid, NT, dkv_smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int head_dim, const Args& a, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return -1;
  }
}

}  // namespace zoo_flash_bwd

// dtype: 0 = float32, 1 = bfloat16.  m, l, dsum: (B, H, Lq) f32.  dq, dk,
// dv: contiguous outputs in the input type.  dbias: (B, H, Lk) f32
// partials, or null when the bias needs no gradient.  Returns 0 on success,
// a cudaError_t code when a launch failed, or -1 for a head dim the kernels
// do not take (64 and 128 are built).
extern "C" int zoo_flash_attention_bwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* g, const float* m, const float* l, const float* dsum,
    const float* bias, void* dq, void* dk, void* dv, float* dbias,
    int B, int H, int Lq, int Lk,
    long long qs_b, long long qs_h, long long qs_l,
    long long ks_b, long long ks_h, long long ks_l,
    long long vs_b, long long vs_h, long long vs_l,
    long long gs_b, long long gs_h, long long gs_l,
    long long bs_b, long long bs_h, long long bs_q, long long bs_k,
    float scale, int causal, int dropout, unsigned seed0, unsigned seed1,
    unsigned drop_thr, float inv_keep, void* stream) {
  zoo_flash_bwd::Args a{q, k, v, g, m, l, dsum, bias, dq, dk, dv, dbias,
                        B, H, Lq, Lk,
                        qs_b, qs_h, qs_l, ks_b, ks_h, ks_l, vs_b, vs_h, vs_l,
                        gs_b, gs_h, gs_l, bs_b, bs_h, bs_q, bs_k,
                        scale, causal, dropout, seed0, seed1, drop_thr,
                        inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return zoo_flash_bwd::dispatch<float>(head_dim, a, s);
  if (dtype == 1)
    return zoo_flash_bwd::dispatch<__nv_bfloat16>(head_dim, a, s);
  return -1;
}
