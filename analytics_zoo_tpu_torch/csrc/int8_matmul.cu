// Weight-only int8 matrix product with per-output-channel scales, with a
// plain C interface for ctypes (analytics_zoo_tpu_torch/ops/cuda/
// int8_matmul.py).
//
//   out (M, N) = (x (M, K) @ float(W (K, N) int8)) * scale (N,)
//
// x is f32 or bf16, the sum is f32 and the result is cast to x's type.
//
// Replaces the TPU kernel `_mm_kernel` (analytics_zoo_tpu/ops/pallas/
// int8_matmul.py:70), launched by `_matmul_pallas` (:92, pl.pallas_call
// :111).  As there, W stays one byte per element in device memory and in
// shared memory; it becomes f32 only in registers, and the scale multiplies
// the finished f32 sum once, in the epilogue.  Unlike the TPU version, which
// pads x, W and the scale into new arrays to its 128 x 128 x 256 blocks,
// this kernel masks the ragged M, N and K edges itself (the classifier
// head has N = 2, the pooler and head M = 8).
//
// What bounds it on an H100: at BERT-base's shapes (M = 4096 rows, K 768 or
// 3072) the work is 2 M K N operations against ~M K * 4 + K N bytes, about
// 500 operations per byte, so operations: f32 FMAs on CUDA cores at
// 67 TFLOP/s (0.22 ms for the (4096, 768, 2304) QKV product).  The design is
// the plain register-blocked GEMM: a block owns a 128 x 128 tile of the
// output, 256 threads each hold 8 x 8 f32 sums in registers, and K goes by
// in slices of 32 through double-buffered shared memory (x transposed, as
// f32; W as int8), the next slice's loads in flight while the current one
// is multiplied.  The int8 -> f32 conversion uses a byte permute and one add
// per value instead of the I2F instruction, which runs at 1/8 of the FMA
// rate on sm_90.  With bf16 x the products are still f32 on CUDA cores:
// int8 values convert exactly to bf16, so `mma`/`wgmma` on the tensor cores
// (989 TFLOP/s) is the next step for that case, in a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;         // output rows per block
constexpr int BN = 128;         // output columns per block
constexpr int BK = 32;          // K slice staged per step
constexpr int NT = 256;         // threads: 16 x 16, 8 x 8 outputs each
constexpr int XS_LD = BM + 4;   // row of the transposed x slice, padded

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four int8 in one 32-bit word -> four f32, exactly.  Each byte b becomes
// the f32 whose bits are 0x4B000000 | (b + 128), which is 2^23 + 128 + b;
// subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128 in each byte
  const float bias = 8388736.f;        // 2^23 + 128
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - bias;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - bias;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - bias;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - bias;
}

template <typename T>
__global__ void __launch_bounds__(NT)
    int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, T* __restrict__ out,
                       int M, int N, int K) {
  __shared__ __align__(16) float xs[2][BK][XS_LD];
  __shared__ __align__(16) uint32_t ws[2][BK][BN / 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // staging: x element (row warp + 8 i, k lane) for i < 16 (a warp reads
  // 32 consecutive k of one row); W bytes (row tid / 8, columns
  // (tid % 8) * 16 + j) for j < 16, packed four to a word
  const int w_row = tid / 8, w_col = (tid % 8) * 16;

  float xr[16];
  uint32_t wr[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int gm = m0 + warp + 8 * i, gk = k0 + lane;
      xr[i] = (gm < M && gk < K) ? to_f32(x[(int64_t)gm * K + gk]) : 0.f;
    }
    const int gk = k0 + w_row;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + w_col + 4 * q + j;
        const uint32_t b =
            (gk < K && gn < N)
                ? static_cast<uint8_t>(w[(int64_t)gk * N + gn]) : 0u;
        word |= b << (8 * j);
      }
      wr[q] = word;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 16; ++i) xs[buf][lane][warp + 8 * i] = xr[i];
    *reinterpret_cast<uint4*>(&ws[buf][w_row][w_col / 4]) =
        make_uint4(wr[0], wr[1], wr[2], wr[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_steps = (K + BK - 1) / BK;
  load(0);
  stage(0);
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < n_steps) load((s + 1) * BK);
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[cur][k][64 + ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[8];
      int8x4_to_f32(ws[cur][k][tx], b);
      int8x4_to_f32(ws[cur][k][16 + tx], b + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < n_steps) stage(cur ^ 1);
    __syncthreads();
  }

  // epilogue: the per-column scale once, then the cast to x's type
  float sc[8];
  int cols[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cols[j] = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    sc[j] = cols[j] < N ? scale[cols[j]] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (cols[j] < N) store(&out[(int64_t)row * N + cols[j]],
                             acc[i][j] * sc[j]);
  }
}

}  // namespace

// x (m, k) f32 (dtype 0) or bf16 (dtype 1), w (k, n) int8, scale (n,) f32,
// out (m, n) in x's type; all contiguous and row-major on one device, with
// m, n, k >= 1.  Returns 0 or a cudaError_t.
extern "C" int zoo_int8_matmul(const void* x, const int8_t* w,
                               const float* scale, void* out, int m, int n,
                               int k, int dtype, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    int8_matmul_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), w, scale, static_cast<float*>(out), m,
        n, k);
  } else if (dtype == 1) {
    int8_matmul_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, scale,
        static_cast<__nv_bfloat16*>(out), m, n, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
