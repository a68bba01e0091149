// Weight-only int8 matrix product with per-output-channel scales, on the
// H100's tensor cores, with a plain C interface for ctypes
// (analytics_zoo_tpu_torch/ops/cuda/int8_matmul.py).
//
//   out (M, N) = (x (M, K) @ float(W (K, N) int8)) * scale (N,)
//
// x is f32, bf16 or f16, the sum is f32 and the result is cast to x's
// type.
//
// Replaces the TPU kernel `_mm_kernel` (analytics_zoo_tpu/ops/pallas/
// int8_matmul.py:70), launched by `_matmul_pallas` (:92, pl.pallas_call
// :111).  As there, W stays one byte per element in device memory and on
// its way into shared memory, becomes a float only on its way into the
// matrix unit, and the scale multiplies the finished f32 sum once, in the
// epilogue.  Unlike the TPU version, which pads x, W and the scale into
// new arrays to its 128 x 128 x 256 blocks, this kernel masks the ragged
// M, N and K edges itself (the classifier head has N = 2, the pooler and
// head M = 8).
//
// What bounds it on an H100: at BERT-base's shapes (M = 4096 rows, K 768
// or 3072) the work is 2 M K N operations against ~M K * 2 + K N bytes,
// far above the ~295 operations a byte at which the bf16 tensor cores
// (989 TFLOP/s) stop waiting on device memory: operations bound it,
// 0.015 ms for the (4096, 768, 2304) QKV product in bf16, 0.044 ms for
// f32 x as three bf16 products.  At M = 8 (pooler, head) only latency
// does: the 0.6 MB of W takes 0.18 us to read.  Inside the SM the limit
// of this design is shared memory, not the tensor cores: every K slice is
// written by the copies, read and written again by the W conversion, and
// read by wgmma (the converted W tile once by each warpgroup), about
// 96 KB a slice against 512 clocks of products.
//
// The design:
// - a block of two warpgroups owns a 128 x 128 output tile, each warpgroup
//   64 rows, its f32 sums in registers, fed by `wgmma.mma_async` m64n128k16
//   on 16-bit operands (bf16, or f16 for f16 x);
// - K goes by in slices of 64 through a ring of 3 shared-memory stages
//   filled by 16-byte cp.async copies that zero-fill past M, N and K, one
//   slice ahead; with 16-bit x a block takes 105 KB and 128 registers a
//   thread, so two blocks share an SM and one's copies and conversion run
//   under the other's products;
// - W arrives as int8 bytes, and each slice is converted once per block
//   into a bf16 tile in the swizzled MN-major layout wgmma reads as B
//   (transposed B, which bf16 allows).  The conversion takes no I2F: a
//   byte permute makes the f32 2^23 + 128 + b, one subtraction leaves b,
//   and the upper 16 bits of that f32 are b as an exact bf16 (an int8 has
//   at most 8 significant bits), so two weights pack into one register
//   with one more permute.  For f16 x the tile is f16, made the same way
//   with f16's own magic number: the byte permute makes the f16 1024 + 128
//   + b (f16's spacing is 1 from 1024 to 2048), and one f16x2 subtraction
//   leaves b exactly (|b| <= 128 < 2^11); the bf16 bit trick does not
//   carry over, and which of the two a kernel runs is keyed on x's type;
// - bf16 and f16 x are copied straight into the swizzled K-major layout
//   and read by descriptor (A from shared memory); the product of slice s
//   is in flight while slice s + 1 is converted;
// - f32 x runs on the tensor cores as three bf16 products: each value is
//   split in registers into x_hi = bf16(x), x_mid = bf16(x - x_hi) and
//   x_lo = bf16(x - x_hi - x_mid), which sum to x exactly (24 mantissa
//   bits in three pieces of 8), and the three pieces go in as register A
//   operands against the same W tile.  Each product of an int8 and a bf16
//   piece is exact, but wgmma adds into its f32 accumulator with a
//   rounding of its own that drifts one way, so an accumulator kept over
//   all of K errs in proportion to K.  Each K slice's 12 products (the
//   small pieces first) therefore go into a fresh accumulator, which is
//   then added into the running f32 sum on the CUDA cores: the error of a
//   slice no longer carries into the next, and the result is close to,
//   not equal to, the f32 sum in another order.  The fragments are
//   registers the next slice rewrites, so each slice's products are
//   retired before the next begins;
// - the epilogue scales the tile, stages it in shared memory and writes
//   it out in 16-byte rows;
// - rows whose x or W is not 16-byte aligned (K or N not a multiple of 16
//   bytes, as the N = 2 head) take element loads instead of cp.async, in
//   the same kernel.
//
// At M = 8 (pooler, head) the grid holds only N / 128 blocks, each walking
// all of K; the kernel's time there is below the wrapper's host time per
// call, so nothing spreads K over more blocks.
//
// Next steps, not taken: W converted in registers as the A operand of a
// swapped product (out^T = W^T x^T), which removes the converted tile's
// trips through shared memory and makes M = 8 a wgmma N of 8, and TMA with
// warp-specialised producers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace zoo_sm90;

constexpr int BM = 128;  // output rows per block: two warpgroups of 64
constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // K slice per stage
constexpr int NT = 256;
constexpr int W_RAW = BK * BN;      // int8 W slice, 128 bytes a row
// converted 16-bit W slice (bf16, or f16 for f16 x), two 64-column blocks
constexpr int W_BF = BK * BN * 2;

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int ST = 3;                 // stages (105 KB a block)
  static constexpr int X_BYTES = BM * BK * 2;  // swizzled bf16 x slice
};
template <>
struct Cfg<__half> : Cfg<__nv_bfloat16> {};    // the same layout in f16
template <>
struct Cfg<float> {
  static constexpr int ST = 3;
  static constexpr int XLD = BK + 8;  // f32 row, padded: conflict-free float2
  static constexpr int X_BYTES = BM * XLD * 4;
};

template <typename T>
constexpr int smem_bytes() {
  return Cfg<T>::ST * (Cfg<T>::X_BYTES + W_RAW) + 2 * W_BF + 1024;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);  // above 65504: inf, as the reference's cast
}

// Four int8 in one word -> four bf16 in two words, exactly: byte b becomes
// the f32 with bits 0x4B0000xx (2^23 + 128 + b), minus 2^23 + 128 is b, and
// the upper half of b's f32 bits is b as a bf16 (the lower half is zero).
__device__ __forceinline__ uint2 int8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float bias = 8388736.f;
  auto byte = [&](uint32_t sel) {  // byte `sel` of w as an exact f32
    return __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - bias);
  };
  const uint32_t f0 = byte(0x7540), f1 = byte(0x7541);
  const uint32_t f2 = byte(0x7542), f3 = byte(0x7543);
  return make_uint2(__byte_perm(f0, f1, 0x7632),
                    __byte_perm(f2, f3, 0x7632));
}

// Four int8 in one word -> four f16 in two words, exactly: byte b, as
// u = b + 128 (its sign bit flipped), becomes the low byte of the f16
// 0x6400 | u = 1024 + u (f16 steps by 1 from 1024 to 2048), and one f16x2
// subtraction of 1024 + 128 (0x6480) leaves b.
__device__ __forceinline__ uint2 int8x4_to_f16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t lo = __byte_perm(u, 0x64646464u, 0x4140);  // bytes 0, 1
  const uint32_t hi = __byte_perm(u, 0x64646464u, 0x4342);  // bytes 2, 3
  uint2 r;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(r.x) : "r"(lo), "r"(0x64806480u));
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(r.y) : "r"(hi), "r"(0x64806480u));
  return r;
}

// x = hi + mid + lo exactly, each a bf16 (for |x| well inside f32's normal
// range); the same arithmetic as `split_bf16x3` in the wrapper.
__device__ __forceinline__ void split3(float x, float& hi, float& mid,
                                       float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r = x - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = r - mid;
}

template <typename T>
struct Tile {
  uint8_t* base;  // 1024-byte aligned
  __device__ uint8_t* x(int s) const { return base + s * Cfg<T>::X_BYTES; }
  __device__ uint8_t* wraw(int s) const {
    return base + Cfg<T>::ST * Cfg<T>::X_BYTES + s * W_RAW;
  }
  __device__ uint8_t* wbf(int s) const {
    return base + Cfg<T>::ST * (Cfg<T>::X_BYTES + W_RAW) + s * W_BF;
  }
};

// Issue the copies of K slice `kt` into stage `s`.  Chunk i of a thread
// is row (its first row) + i * (rows a pass covers), at a fixed column, so
// the row and column tests and the addresses reduce to a base and a
// stride.
template <typename T>
__device__ __forceinline__ void load_slice(const Tile<T>& tl, int s, int kt,
                                           const T* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           int M, int N, int K, int m0,
                                           int n0, bool vec_x, bool vec_w) {
  const int tid = threadIdx.x;
  const int k0 = kt * BK;
  uint8_t* xs = tl.x(s);
  if constexpr (is_16bit_v<T>) {
    if (vec_x) {  // 128 rows x 8 chunks of 8 16-bit values: 32 rows a pass
      const int r = tid >> 3, ch = tid & 7, gk = k0 + ch * 8;
      const T* src = x + (int64_t)(m0 + r) * K + gk;
      const uint32_t dst = smem_u32(xs) + swz(r, ch);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = m0 + r + 32 * i < M && gk < K;
        cp_async16(dst + i * 32 * 128, in ? src + (int64_t)i * 32 * K : x,
                   in ? 16 : 0);
      }
    } else {
      const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
      for (int e = tid; e < BM * BK; e += NT) {  // the bits, as they are
        const int r = e >> 6, kk = e & 63;
        const int gm = m0 + r, gk = k0 + kk;
        const uint16_t v = (gm < M && gk < K) ? xb[(int64_t)gm * K + gk] : 0;
        *reinterpret_cast<uint16_t*>(xs + swz(r, kk >> 3) + (kk & 7) * 2) =
            v;
      }
    }
  } else {
    constexpr int XLD = Cfg<float>::XLD;
    float* xf = reinterpret_cast<float*>(xs);
    if (vec_x) {  // 128 rows x 16 chunks of 4 f32: 16 rows a pass
      const int r = tid >> 4, ch = tid & 15, gk = k0 + ch * 4;
      const float* src = x + (int64_t)(m0 + r) * K + gk;
      const uint32_t dst = smem_u32(xf + r * XLD + ch * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool in = m0 + r + 16 * i < M && gk < K;
        cp_async16(dst + i * 16 * XLD * 4, in ? src + (int64_t)i * 16 * K : x,
                   in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e >> 6, kk = e & 63;
        const int gm = m0 + r, gk = k0 + kk;
        xf[r * XLD + kk] = (gm < M && gk < K) ? x[(int64_t)gm * K + gk] : 0.f;
      }
    }
  }
  uint8_t* ws = tl.wraw(s);
  if (vec_w) {  // 64 rows x 8 chunks of 16 bytes: 32 rows a pass
    const int r = tid >> 3, ch = tid & 7, gn = n0 + ch * 16;
    const int8_t* src = w + (int64_t)(k0 + r) * N + gn;
    const uint32_t dst = smem_u32(ws + r * 128 + ch * 16);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = k0 + r + 32 * i < K && gn < N;
      cp_async16(dst + i * 32 * 128, in ? src + (int64_t)i * 32 * N : w,
                 in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BK * BN; e += NT) {
      const int r = e >> 7, cn = e & 127;
      const int gk = k0 + r, gn = n0 + cn;
      ws[e] = (gk < K && gn < N) ? static_cast<uint8_t>(w[(int64_t)gk * N + gn])
                                 : 0;
    }
  }
}

// int8 W slice of stage s -> 16-bit tile `dst` of type W (bf16, or f16
// for f16 x): two 64-column blocks of 64 swizzled rows (row = k),
// MN-major for wgmma.
template <typename W>
__device__ __forceinline__ void convert_w(const uint8_t* src, uint8_t* dst) {
  auto conv = [](uint32_t w) {
    if constexpr (is_f16_v<W>)
      return int8x4_to_f16x4(w);
    else
      return int8x4_to_bf16x4(w);
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // 1024 groups of 8 weights
    const int c = threadIdx.x + i * NT, r = c >> 4, j = c & 15;
    const uint2 raw = *reinterpret_cast<const uint2*>(src + r * 128 + j * 8);
    const uint2 lo = conv(raw.x), hi = conv(raw.y);
    *reinterpret_cast<uint4*>(dst + (j >> 3) * (BK * 128) + swz(r, j & 7)) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

constexpr int C_LD = BN + 8;  // f32 row of the staged output tile

// The staged 128 x 128 f32 tile -> rows m0.., columns n0.. of a row-major
// (M, N) output in U, masked at the edges; 16-byte stores when every row
// of the output starts 16-byte aligned.
template <typename U>
__device__ __forceinline__ void store_tile(const float* ct,
                                           U* __restrict__ dst, int M, int N,
                                           int m0, int n0, bool vec) {
  constexpr int E = 16 / sizeof(U);  // values a 16-byte store holds
  if (vec) {
    for (int c = threadIdx.x; c < BM * BN / E; c += NT) {
      const int r = c / (BN / E), col = (c % (BN / E)) * E;
      if (m0 + r >= M || n0 + col >= N) continue;
      const float* v = ct + r * C_LD + col;
      U* p = dst + (int64_t)(m0 + r) * N + n0 + col;
      if constexpr (std::is_same<U, float>::value) {
        *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(v);
      } else {
        uint4 u;
        u.x = pack2<U>(v[0], v[1]);
        u.y = pack2<U>(v[2], v[3]);
        u.z = pack2<U>(v[4], v[5]);
        u.w = pack2<U>(v[6], v[7]);
        *reinterpret_cast<uint4*>(p) = u;
      }
    }
  } else {
    for (int e = threadIdx.x; e < BM * BN; e += NT) {
      const int r = e / BN, col = e % BN;
      if (m0 + r < M && n0 + col < N)
        store(&dst[(int64_t)(m0 + r) * N + n0 + col], ct[r * C_LD + col]);
    }
  }
}

// bf16 and f16 x: two blocks an SM (128 registers a thread); f32 x: one
// (its stages take 168 KB, and its fragments more registers).  The W tile
// is f16 for f16 x and bf16 otherwise (f32 x goes in as bf16 pieces).
template <typename T>
__global__ void __launch_bounds__(NT, is_16bit_v<T> ? 2 : 1)
    int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, T* __restrict__ out,
                       int M, int N, int K, bool vec_x, bool vec_w,
                       bool vec_out) {
  using W = std::conditional_t<is_f16_v<T>, __half, __nv_bfloat16>;
  constexpr int ST = Cfg<T>::ST;
  constexpr int AHEAD = ST - 2;  // slices loaded ahead of the one multiplied
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  const Tile<T> tl{smem_raw + pad};

  const int tid = threadIdx.x;
  const int wg = tid >> 7;               // warpgroup: rows 64 wg ..
  const int warp = (tid >> 5) & 3;       // warp in the warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int steps = (K + BK - 1) / BK;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int p = 0; p < AHEAD; ++p) {
    if (p < steps)
      load_slice<T>(tl, p, p, x, w, M, N, K, m0, n0, vec_x, vec_w);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<AHEAD - 1>();  // slice s has landed (this thread's copies)
    // every thread's copies of slice s are visible, and every warpgroup has
    // retired the products of slice s - 2, so that stage (the one the next
    // load fills) and its converted W buffer are free
    __syncthreads();
    if (s + AHEAD < steps)
      load_slice<T>(tl, (s + AHEAD) % ST, s + AHEAD, x, w, M, N, K, m0, n0,
                    vec_x, vec_w);
    cp_async_commit();
    convert_w<W>(tl.wraw(s % ST), tl.wbf(s & 1));
    fence_proxy_async();
    __syncthreads();

    const uint32_t wb = smem_u32(tl.wbf(s & 1));
    if constexpr (is_16bit_v<T>) {
      const uint32_t xa = smem_u32(tl.x(s % ST)) + wg * 64 * 128;
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_ss<T, 1>(acc, desc_b128(xa + kk * 32, 16, 1024),
                                  desc_b128(wb + kk * 2048, BK * 128, 1024),
                                  1);
      wgmma_commit();
      wgmma_wait<1>();  // the product of slice s - 1 is done
      fence_operand(acc);
    } else {
      constexpr int XLD = Cfg<float>::XLD;
      const float* xf = reinterpret_cast<const float*>(tl.x(s % ST));
      const int r0 = wg * 64 + warp * 16 + g;
      uint32_t a[4][3][4];  // [k step][hi, mid, lo][fragment register]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = kk * 16 + 2 * t;
        const float2 v[4] = {
            *reinterpret_cast<const float2*>(xf + r0 * XLD + k),
            *reinterpret_cast<const float2*>(xf + (r0 + 8) * XLD + k),
            *reinterpret_cast<const float2*>(xf + r0 * XLD + k + 8),
            *reinterpret_cast<const float2*>(xf + (r0 + 8) * XLD + k + 8)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float h0, m0_, l0, h1, m1, l1;
          split3(v[q].x, h0, m0_, l0);
          split3(v[q].y, h1, m1, l1);
          a[kk][0][q] = pack_bf16(h0, h1);
          a[kk][1][q] = pack_bf16(m0_, m1);
          a[kk][2][q] = pack_bf16(l0, l1);
        }
      }
      // this slice's products, lo pieces first, into a fresh sum
      float part[64];
      wgmma_fence();
#pragma unroll
      for (int p = 2; p >= 0; --p) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs<__nv_bfloat16, 1>(
              part, a[kk][p], desc_b128(wb + kk * 2048, BK * 128, 1024),
              p != 2 || kk != 0);
      }
      wgmma_commit();
      // the A fragments are registers the next slice rewrites: retire now
      wgmma_wait<0>();
      fence_operand(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
  }
  wgmma_wait<0>();
  fence_operand(acc);
  cp_async_wait<0>();
  __syncthreads();  // every stage is free: the tile goes through them

  // Epilogue: the f32 tile times the scale into shared memory, then out to
  // device memory in 16-byte rows.  Fragment element i is row
  // g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2 of this warp's
  // 16 x 128 piece.
  float* ct = reinterpret_cast<float*>(tl.base);
  const int lrow = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + 2 * t;
    const float2 sc =
        make_float2(n0 + col < N ? scale[n0 + col] : 0.f,
                    n0 + col + 1 < N ? scale[n0 + col + 1] : 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(ct + (lrow + 8 * h) * C_LD + col) =
          make_float2(acc[j * 4 + h * 2] * sc.x, acc[j * 4 + h * 2 + 1] * sc.y);
  }
  __syncthreads();
  store_tile(ct, out, M, N, m0, n0, vec_out);
}

template <typename T>
int launch(const void* x, const int8_t* w, const float* scale, void* out,
           int m, int n, int k, cudaStream_t s) {
  constexpr int smem = smem_bytes<T>();
  auto kernel = int8_matmul_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_x = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                     (static_cast<int64_t>(k) * sizeof(T)) % 16 == 0;
  const bool vec_w = (reinterpret_cast<uintptr_t>(w) & 15) == 0 && n % 16 == 0;
  // rows of the output 16-byte aligned
  const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                       (static_cast<int64_t>(n) * sizeof(T)) % 16 == 0;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  kernel<<<grid, NT, smem, s>>>(static_cast<const T*>(x), w, scale,
                                static_cast<T*>(out), m, n, k, vec_x, vec_w,
                                vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) f32 (dtype 0), bf16 (dtype 1) or f16 (dtype 2), w (k, n)
// int8, scale (n,) f32, out (m, n) in x's type; all contiguous and
// row-major on one device, with m, n, k >= 1.  Returns 0 or a cudaError_t.
extern "C" int zoo_int8_matmul(const void* x, const int8_t* w,
                               const float* scale, void* out, int m, int n,
                               int k, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((n + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(x, w, scale, out, m, n, k, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, scale, out, m, n, k, s);
  if (dtype == 2) return launch<__half>(x, w, scale, out, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
