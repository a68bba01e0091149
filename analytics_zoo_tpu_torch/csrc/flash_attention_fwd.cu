// Flash-attention forward: the launch entry point, with a plain C interface
// for ctypes (analytics_zoo_tpu_torch/ops/cuda/flash_attention.py).  The
// device code and the design note are in flash_attention_fwd.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_fwd.cuh"

namespace {

template <typename T>
cudaError_t launch_simt_any(const zoo_flash::Args& a, int D,
                            cudaStream_t stream) {
  const int smem = zoo_flash::simt_smem_bytes(D);
  auto kernel = zoo_flash::flash_fwd_simt_kernel<T>;
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

template <typename T, int D, bool ROW, bool SEG>
cudaError_t launch_wgmma(const zoo_flash::Args& a, cudaStream_t stream) {
  constexpr int smem = zoo_flash::wg_smem_bytes(D);
  auto kernel = zoo_flash::flash_fwd_wgmma_kernel<T, D, ROW, SEG>;
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
// element.  With segment ids or without.  T: bf16 or f16.
template <typename T, int D>
cudaError_t launch_wgmma_bias(const zoo_flash::Args& a, cudaStream_t stream) {
  const bool row = a.bias == nullptr ||
                   (a.bs_q == 0 && a.bs_k == 1 && a.bs_b % 4 == 0 &&
                    a.bs_h % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(a.bias) & 15) == 0);
  if (a.q_seg != nullptr)
    return row ? launch_wgmma<T, D, true, true>(a, stream)
               : launch_wgmma<T, D, false, true>(a, stream);
  return row ? launch_wgmma<T, D, true, false>(a, stream)
             : launch_wgmma<T, D, false, false>(a, stream);
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

template <typename T, int NWG, int CPW, bool ROW, bool SEG>
cudaError_t launch_wide_kernel(const zoo_flash::Args& a,
                               const zoo_tma::Maps& maps, int D, int smem,
                               cudaStream_t stream) {
  auto kernel = zoo_flash::flash_fwd_wide_kernel<T, NWG, CPW, ROW, SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int slices = (D + NWG * CPW - 1) / (NWG * CPW);
  const dim3 grid((a.Lq + 63) / 64 * slices, a.H, a.B);
  kernel<<<grid, zoo_flash::WG_THREADS * NWG, smem, stream>>>(a, maps, D);
  return cudaGetLastError();
}

// D > 128, D % 64 == 0: the inputs' tensor maps with the boxes wide_plan
// stages (128-byte swizzled), then flash_fwd_wide_kernel with a bias row
// through shared memory or not, with segment ids or not.  Returns -2 when
// an input's base or strides are not multiples of 16 bytes (the wrapper
// copies such an input first).
template <typename T, int NWG, int CPW>
int launch_wide(const zoo_flash::Args& a, int D, cudaStream_t stream) {
  using zoo_tma::encode_chunked_map;
  constexpr int es = sizeof(T);
  const zoo_flash::WidePlan plan =
      zoo_flash::wide_plan(NWG, CPW, zoo_sm90::is_16bit_v<T>, D);
  zoo_tma::Maps maps = {};
  const bool tma =
      encode_chunked_map<T>(&maps.q, a.q, D, a.Lq, a.H, a.B, a.qs_b, a.qs_h,
                            a.qs_l, 64, plan.qres ? D * es / 128 : plan.cps) &&
      encode_chunked_map<T>(&maps.k, a.k, D, a.Lk, a.H, a.B, a.ks_b, a.ks_h,
                            a.ks_l, 32, plan.cps) &&
      encode_chunked_map<T>(&maps.v, a.v, D, a.Lk, a.H, a.B, a.vs_b, a.vs_h,
                            a.vs_l, 32, plan.vp);
  if (!tma) return -2;
  const bool row = a.bias == nullptr || a.bs_q == 0;
  if (a.q_seg != nullptr)
    return row ? launch_wide_kernel<T, NWG, CPW, true, true>(a, maps, D,
                                                        plan.smem, stream)
               : launch_wide_kernel<T, NWG, CPW, false, true>(a, maps, D,
                                                         plan.smem, stream);
  return row ? launch_wide_kernel<T, NWG, CPW, true, false>(a, maps, D, plan.smem,
                                                       stream)
             : launch_wide_kernel<T, NWG, CPW, false, false>(a, maps, D,
                                                        plan.smem, stream);
}

// The warpgroups' columns and count of fwd_wide_cols and
// fwd_wide_warpgroups (bf16 and f16: 64 columns a warpgroup only).
template <typename T>
int launch_wide_any(const zoo_flash::Args& a, int D, cudaStream_t stream) {
  using zoo_flash::fwd_wide_warpgroups;
  if constexpr (std::is_same<T, float>::value) {
    if (zoo_flash::fwd_wide_cols(false, D) == 128)
      return fwd_wide_warpgroups(D, 128) == 3
                 ? launch_wide<T, 3, 128>(a, D, stream)
                 : launch_wide<T, 2, 128>(a, D, stream);
  }
  return fwd_wide_warpgroups(D, 64) == 3 ? launch_wide<T, 3, 64>(a, D, stream)
                                         : launch_wide<T, 2, 64>(a, D, stream);
}

// f32: 3xTF32 on the tensor cores at head dims 64 and 128 and, in 32-column
// chunks, at every other multiple of 64; CUDA cores at any other head dim.
int dispatch_f32(int head_dim, const zoo_flash::Args& a,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_tf32_bias<64>(a, stream);
    case 128: return launch_tf32_bias<128>(a, stream);
    default:
      return head_dim % 64 == 0
                 ? launch_wide_any<float>(a, head_dim, stream)
                 : launch_simt_any<float>(a, head_dim, stream);
  }
}

// bf16 and f16 (T), one code path keyed on T: the tensor cores at head
// dims 64 and 128 and, in 64-column chunks, at every other multiple of 64;
// CUDA cores at any other head dim.
template <typename T>
int dispatch_16bit(int head_dim, const zoo_flash::Args& a,
                   cudaStream_t stream) {
  static_assert(zoo_sm90::is_16bit_v<T>, "bf16 or f16");
  switch (head_dim) {
    case 64: return launch_wgmma_bias<T, 64>(a, stream);
    case 128: return launch_wgmma_bias<T, 128>(a, stream);
    default:
      return head_dim % 64 == 0 ? launch_wide_any<T>(a, head_dim, stream)
                                : launch_simt_any<T>(a, head_dim, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  m_out/l_out: (B, H, Lq)
// f32 outputs of the softmax statistics, or both null.  q_seg, kv_seg:
// contiguous (B, Lq) and (B, Lk) int32 segment ids, or both null.
// dropout != 0 drops with the hash threshold drop_thr and scales kept
// values by inv_keep.  out must be contiguous.  Any head dim.  Returns 0
// on success, a cudaError_t code when the launch failed, -1 for a dtype
// the kernels do not take, or -2 when the chunked kernel (head dims above
// 128 that are multiples of 64) cannot map an input (a base or a stride
// not a multiple of 16 bytes).
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
  if (dtype == 1) return dispatch_16bit<__nv_bfloat16>(head_dim, a, s);
  if (dtype == 2) return dispatch_16bit<__half>(head_dim, a, s);
  return -1;
}
