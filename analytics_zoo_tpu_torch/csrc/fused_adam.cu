// Fused Adam update of one f32 leaf, with a plain C interface for ctypes
// (analytics_zoo_tpu_torch/ops/cuda/fused_adam.py).
//
// Replaces the TPU kernel `_adam_kernel` (analytics_zoo_tpu/ops/pallas/
// fused_adam.py:85), launched per leaf by `_adam_leaf_pallas` (:109,
// pl.pallas_call :132): one read of (g, mu, nu) and one write of
//   mu'  = b1 mu + (1 - b1) g
//   nu'  = b2 nu + (1 - b2) g g
//   upd  = -lr (mu' / bc1) / (sqrt(nu' / bc2) + eps)
// with the scalars (lr, b1, b2, eps, bc1, bc2) read from a 6-float device
// array, as the TPU kernel reads them from SMEM: lr is the schedule at the
// pre-increment count and bc = 1 - beta^t at the incremented count, both
// computed by the caller on the device, so no step waits on the host.  The
// caller applies the update to the parameters, as optax.apply_updates does.
//
// What bounds it on an H100: 24 bytes per parameter and ~12 operations, so
// bytes (BERT-base, ~110 M parameters: 2.6 GB, 0.79 ms at 3.35 TB/s).  The
// design is one grid-stride pass with 16-byte loads and stores (float4)
// where the leaf is a multiple of 4 elements, a scalar tail otherwise.  Each
// operation is rounded as written (no fused multiply-add), so the kernel
// gives the plain PyTorch formula's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

struct Scalars {
  float lr, b1, b2, eps, bc1, bc2, c1, c2;  // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ void adam(const Scalars& k, float g, float& mu,
                                     float& nu, float& upd) {
  mu = __fadd_rn(__fmul_rn(k.b1, mu), __fmul_rn(k.c1, g));
  nu = __fadd_rn(__fmul_rn(k.b2, nu), __fmul_rn(__fmul_rn(k.c2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, k.bc2)), k.eps);
  upd = __fdiv_rn(__fmul_rn(-k.lr, __fdiv_rn(mu, k.bc1)), den);
}

__global__ void __launch_bounds__(NT)
    adam_kernel(const float* g, const float* mu, const float* nu,
                const float* scalars, float* upd, float* mu_out,
                float* nu_out, int64_t n, int vec) {
  Scalars k;
  k.lr = scalars[0];
  k.b1 = scalars[1];
  k.b2 = scalars[2];
  k.eps = scalars[3];
  k.bc1 = scalars[4];
  k.bc2 = scalars[5];
  k.c1 = __fsub_rn(1.f, k.b1);
  k.c2 = __fsub_rn(1.f, k.b2);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const int64_t n4 = vec ? n / 4 : 0;
  for (int64_t i = first; i < n4; i += stride) {
    const float4 g4 = reinterpret_cast<const float4*>(g)[i];
    float4 m4 = reinterpret_cast<const float4*>(mu)[i];
    float4 v4 = reinterpret_cast<const float4*>(nu)[i];
    float4 u4;
    adam(k, g4.x, m4.x, v4.x, u4.x);
    adam(k, g4.y, m4.y, v4.y, u4.y);
    adam(k, g4.z, m4.z, v4.z, u4.z);
    adam(k, g4.w, m4.w, v4.w, u4.w);
    reinterpret_cast<float4*>(upd)[i] = u4;
    reinterpret_cast<float4*>(mu_out)[i] = m4;
    reinterpret_cast<float4*>(nu_out)[i] = v4;
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride) {
    float m = mu[i], v = nu[i], u;
    adam(k, g[i], m, v, u);
    upd[i] = u;
    mu_out[i] = m;
    nu_out[i] = v;
  }
}

}  // namespace

// All arrays f32 and contiguous, n elements each (the float4 path runs when
// every pointer is 16-byte aligned); scalars: a device array (lr, b1, b2,
// eps, bc1, bc2).  Returns 0 or a cudaError_t.
extern "C" int zoo_fused_adam(const float* g, const float* mu,
                              const float* nu, const float* scalars,
                              float* upd, float* mu_out, float* nu_out,
                              long long n, void* stream) {
  const int64_t work = (n + 3) / 4;
  const int blocks = static_cast<int>(
      work / NT + 1 < 132 * 16 ? work / NT + 1 : 132 * 16);
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(mu) |
      reinterpret_cast<uintptr_t>(nu) | reinterpret_cast<uintptr_t>(upd) |
      reinterpret_cast<uintptr_t>(mu_out) |
      reinterpret_cast<uintptr_t>(nu_out);
  adam_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      g, mu, nu, scalars, upd, mu_out, nu_out, n, bits % 16 == 0);
  return cudaGetLastError();
}
