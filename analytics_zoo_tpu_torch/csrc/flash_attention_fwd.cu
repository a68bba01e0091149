// Flash-attention forward: the launch entry point, with a plain C interface
// for ctypes (analytics_zoo_tpu_torch/ops/cuda/flash_attention.py).  The
// device code and the design note are in flash_attention_fwd.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_fwd.cuh"

namespace {

cudaError_t launch_simt_any(const zoo_flash::Args& a, int D, bool bf16,
                            cudaStream_t stream) {
  const int smem = zoo_flash::simt_smem_bytes(D);
  auto kernel = bf16 ? zoo_flash::flash_fwd_simt_kernel<__nv_bfloat16>
                     : zoo_flash::flash_fwd_simt_kernel<float>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int groups = ((D + 63) / 64 + zoo_flash::SLICES - 1) /
                     zoo_flash::SLICES;
  const dim3 grid((a.Lq + zoo_flash::BQ - 1) / zoo_flash::BQ * groups, a.H,
                  a.B);
  kernel<<<grid, zoo_flash::NT, smem, stream>>>(a, D);
  return cudaGetLastError();
}

// 16-byte copies need every row start 16-byte aligned: the base pointer
// and all three strides (in elements of `size` bytes) multiples of
// 16 / size.
bool rows_aligned(const void* p, int size, int64_t s_b, int64_t s_h,
                  int64_t s_l) {
  const int n = 16 / size;
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s_b % n == 0 &&
         s_h % n == 0 && s_l % n == 0;
}

bool qkv_aligned(const zoo_flash::Args& a, int size) {
  return rows_aligned(a.q, size, a.qs_b, a.qs_h, a.qs_l) &&
         rows_aligned(a.k, size, a.ks_b, a.ks_h, a.ks_l) &&
         rows_aligned(a.v, size, a.vs_b, a.vs_h, a.vs_l);
}

template <int D, bool ROW, bool SEG>
cudaError_t launch_wgmma(const zoo_flash::Args& a, cudaStream_t stream) {
  constexpr int smem = zoo_flash::wg_smem_bytes(D);
  auto kernel = zoo_flash::flash_fwd_wgmma_kernel<D, ROW, SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + 63) / 64, a.H, a.B);
  kernel<<<grid, zoo_flash::WG_THREADS, smem, stream>>>(a, qkv_aligned(a, 2));
  return cudaGetLastError();
}

// No bias, or one row per (batch, head) contiguous along the keys and
// 16-byte aligned (the padding mask): the row goes through shared memory
// with K and V (zeros without a bias).  Any other bias: read element by
// element.  With segment ids or without.
template <int D>
cudaError_t launch_wgmma_bias(const zoo_flash::Args& a, cudaStream_t stream) {
  const bool row = a.bias == nullptr ||
                   (a.bs_q == 0 && a.bs_k == 1 && a.bs_b % 4 == 0 &&
                    a.bs_h % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(a.bias) & 15) == 0);
  if (a.q_seg != nullptr)
    return row ? launch_wgmma<D, true, true>(a, stream)
               : launch_wgmma<D, false, true>(a, stream);
  return row ? launch_wgmma<D, true, false>(a, stream)
             : launch_wgmma<D, false, false>(a, stream);
}

template <int D, bool ROW, bool SEG>
cudaError_t launch_tf32(const zoo_flash::Args& a, cudaStream_t stream) {
  constexpr int smem = zoo_flash::tf_smem_bytes(D);
  auto kernel = zoo_flash::flash_fwd_tf32_kernel<D, ROW, SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + 63) / 64, a.H, a.B);
  kernel<<<grid, zoo_flash::WG_THREADS, smem, stream>>>(a, qkv_aligned(a, 4));
  return cudaGetLastError();
}

// No bias or one row per (batch, head): the row rides with each tile
// through shared memory.  Any other bias: read element by element.  With
// segment ids or without.
template <int D>
cudaError_t launch_tf32_bias(const zoo_flash::Args& a, cudaStream_t stream) {
  const bool row = a.bias == nullptr || a.bs_q == 0;
  if (a.q_seg != nullptr)
    return row ? launch_tf32<D, true, true>(a, stream)
               : launch_tf32<D, false, true>(a, stream);
  return row ? launch_tf32<D, true, false>(a, stream)
             : launch_tf32<D, false, false>(a, stream);
}

// f32: 3xTF32 on the tensor cores at head dims 64 and 128, CUDA cores at
// any other.
int dispatch_f32(int head_dim, const zoo_flash::Args& a,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_tf32_bias<64>(a, stream);
    case 128: return launch_tf32_bias<128>(a, stream);
    default: return launch_simt_any(a, head_dim, false, stream);
  }
}

// bf16: the tensor cores at head dims 64 and 128, CUDA cores at any other.
int dispatch_bf16(int head_dim, const zoo_flash::Args& a,
                  cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_wgmma_bias<64>(a, stream);
    case 128: return launch_wgmma_bias<128>(a, stream);
    default: return launch_simt_any(a, head_dim, true, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  m_out/l_out: (B, H, Lq) f32 outputs
// of the softmax statistics, or both null.  q_seg, kv_seg: contiguous
// (B, Lq) and (B, Lk) int32 segment ids, or both null.  dropout != 0
// drops with the hash threshold drop_thr and scales kept values by
// inv_keep.  out must be contiguous.  Any head dim.  Returns 0 on success,
// a cudaError_t code when the launch failed, or -1 for a dtype the kernels
// do not take.
extern "C" int zoo_flash_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const float* bias, void* out, float* m_out, float* l_out,
    const int* q_seg, const int* kv_seg, int B, int H, int Lq, int Lk,
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
                    dropout, seed0, seed1, drop_thr, inv_keep, q_seg, kv_seg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(head_dim, a, s);
  if (dtype == 1) return dispatch_bf16(head_dim, a, s);
  return -1;
}
