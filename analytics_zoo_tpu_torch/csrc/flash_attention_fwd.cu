// Flash-attention forward: the launch entry point, with a plain C interface
// for ctypes (analytics_zoo_tpu_torch/ops/cuda/flash_attention.py).  The
// device code and the design note are in flash_attention_fwd.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu

#include <cuda_runtime.h>

#include "flash_attention_fwd.cuh"

namespace {

template <typename T, int D>
cudaError_t launch(const zoo_flash::Args& a, cudaStream_t stream) {
  constexpr int smem = zoo_flash::smem_bytes(D);
  auto kernel = zoo_flash::flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + zoo_flash::BQ - 1) / zoo_flash::BQ, a.H, a.B);
  kernel<<<grid, zoo_flash::NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int head_dim, const zoo_flash::Args& a, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 192: return launch<T, 192>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  m_out/l_out: (B, H, Lq) f32 outputs
// of the softmax statistics, or both null.  dropout != 0 drops with the
// hash threshold drop_thr and scales kept values by inv_keep.  Returns 0 on
// success, a cudaError_t code when the launch failed, or -1 for a head dim
// the kernel does not take (64, 128, 192 and 256 are built).
extern "C" int zoo_flash_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const float* bias, void* out, float* m_out, float* l_out,
    int B, int H, int Lq, int Lk,
    long long qs_b, long long qs_h, long long qs_l,
    long long ks_b, long long ks_h, long long ks_l,
    long long vs_b, long long vs_h, long long vs_l,
    long long bs_b, long long bs_h, long long bs_q, long long bs_k,
    long long os_b, long long os_h, long long os_l,
    float scale, int causal, int dropout, unsigned seed0, unsigned seed1,
    unsigned drop_thr, float inv_keep, void* stream) {
  zoo_flash::Args a{q, k, v, bias, out, B, H, Lq, Lk,
                    qs_b, qs_h, qs_l, ks_b, ks_h, ks_l, vs_b, vs_h, vs_l,
                    bs_b, bs_h, bs_q, bs_k, os_b, os_h, os_l,
                    scale, causal, m_out, l_out,
                    dropout, seed0, seed1, drop_thr, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(head_dim, a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(head_dim, a, s);
  return -1;
}
