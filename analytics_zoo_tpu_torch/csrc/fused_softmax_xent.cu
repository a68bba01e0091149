// Fused sparse softmax cross-entropy from logits: forward and backward
// kernels with a plain C interface for ctypes
// (analytics_zoo_tpu_torch/ops/cuda/fused_softmax_xent.py).
//
// Replaces the TPU kernels of analytics_zoo_tpu/ops/pallas/
// fused_softmax_xent.py:
// - forward `_fwd_kernel` (:101), launched by `_fwd_pallas` (:159,
//   pl.pallas_call :170): per row an online max and sum-exp over the vocab
//   gives lse = m + log(s) and loss = lse - x[label], both f32, without
//   writing a (B, V) tensor;
// - backward `_bwd_kernel` (:134), launched by `_bwd_pallas` (:192,
//   pl.pallas_call :205): dx = g * (exp(x - lse) - onehot(label)), written
//   once, in the logits' type.
// A label outside [0, V) picks nothing (loss = lse), as in the TPU kernel.
//
// What bounds it on an H100: both are bound by bytes (a few operations per
// element read).  At the LM-head shape (4096, 30522) f32 the forward reads
// 500 MB (0.15 ms at 3.35 TB/s) and the backward reads and writes it
// (0.30 ms); at the classifier head (8, 2) both are launch latency.  The
// design streams each element through registers once:
// - forward: one 256-thread block per row; each thread keeps its own
//   online (max, sum-exp) over a strided slice of the row, and the pairs
//   merge across the warp with shuffles and across the 8 warps through
//   shared memory;
// - backward: one block per (row, 1024 columns), four coalesced elements
//   per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr float NEG = -1e30f;  // running-max floor, as in the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Merge the online pair (m2, s2) into (m, s).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(NT)
    xent_fwd_kernel(const T* logits, const int* labels, float* loss,
                    float* lse, int V) {
  __shared__ float wm[NT / 32], ws[NT / 32];
  const int row = blockIdx.x;
  const T* x = logits + static_cast<int64_t>(row) * V;
  float m = NEG, s = 0.f;
  for (int j = threadIdx.x; j < V; j += NT) {
    const float xv = to_f32(x[j]);
    if (xv > m) {
      s = s * expf(m - xv) + 1.f;
      m = xv;
    } else {
      s += expf(xv - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = wm[0];
    s = ws[0];
    for (int w = 1; w < NT / 32; ++w) merge(m, s, wm[w], ws[w]);
    const float l = m + logf(s);
    const int lab = labels[row];
    const float picked = lab >= 0 && lab < V ? to_f32(x[lab]) : 0.f;
    lse[row] = l;
    loss[row] = l - picked;
  }
}

constexpr int COLS = 4 * NT;  // columns per backward block

template <typename T>
__global__ void __launch_bounds__(NT)
    xent_bwd_kernel(const T* logits, const int* labels, const float* lse,
                    const float* g, T* dx, int V) {
  const int row = blockIdx.x;
  const int64_t base = static_cast<int64_t>(row) * V;
  const float l = lse[row];
  const float gr = g[row];
  const int lab = labels[row];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = blockIdx.y * COLS + u * NT + threadIdx.x;
    if (j < V) {
      const float p = expf(to_f32(logits[base + j]) - l);
      store_as(&dx[base + j], gr * (p - (j == lab ? 1.f : 0.f)));
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 logits, contiguous (B, V); labels int32
// (B,); loss and lse f32 (B,).  Returns 0, a cudaError_t code, or -1 for an
// unknown dtype.
extern "C" int zoo_softmax_xent_fwd(int dtype, const void* logits,
                                    const int* labels, float* loss,
                                    float* lse, int B, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    xent_fwd_kernel<float><<<B, NT, 0, s>>>(
        static_cast<const float*>(logits), labels, loss, lse, V);
  else if (dtype == 1)
    xent_fwd_kernel<__nv_bfloat16><<<B, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), labels, loss, lse, V);
  else
    return -1;
  return cudaGetLastError();
}

// dx: contiguous (B, V) in the logits' type; g: (B,) f32 cotangent of the
// per-row loss.
extern "C" int zoo_softmax_xent_bwd(int dtype, const void* logits,
                                    const int* labels, const float* lse,
                                    const float* g, void* dx, int B, int V,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, (V + COLS - 1) / COLS);
  if (dtype == 0)
    xent_bwd_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(logits), labels, lse, g,
        static_cast<float*>(dx), V);
  else if (dtype == 1)
    xent_bwd_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), labels, lse, g,
        static_cast<__nv_bfloat16*>(dx), V);
  else
    return -1;
  return cudaGetLastError();
}
