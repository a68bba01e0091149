// int8 x int8 -> int32 N-d convolution on the H100's integer tensor cores,
// with a plain C interface for ctypes
// (analytics_zoo_tpu_torch/ops/cuda/int8_conv.py).
//
//   out (N, OD, OH, OW, Cout) int32 =
//     sum over taps (kd, kh, kw) and ci of
//       x (N, D, H, W, Cin) int8 [n, od*sd - pd + kd*dd, ...][ci]
//       * w (kd, kh, kw, ci, Cout) int8
//
// x is the unpadded channels-last activation: the pads are numbers, and a
// tap that falls outside the input reads 0 (the quantized zero, since the
// scales are symmetric).  Rank 1 and 2 convolutions come in as rank 3 with
// unit dims (D = KD = 1, and H = KH = 1 for rank 1).  The sums are exact:
// the wrapper refuses a K for which K * 127^2 could pass 2^31 - 1.
//
// Replaces no TPU kernel.  The reference's calibrated conv (`_int8_conv`,
// analytics_zoo_tpu/pipeline/inference/quantize.py:282) is a
// lax.conv_general_dilated with int32 accumulation that XLA lowers itself,
// and no Pallas kernel computes it; this kernel exists because PyTorch has
// no int8 convolution on CUDA (the calibrated Dense layers take it too, as
// a 1x1 convolution over the rows).
//
// What bounds it on an H100: a convolution is a product of
// M = N * OD * OH * OW rows, K = KD * KH * KW * Cin and Cout columns, and at
// ResNet-50's shapes 2 M K Cout operations against M K / taps + K Cout
// bytes in and 4 M Cout out: on the int8 tensor cores (1,979 TOP/s) most
// layers sit near the ~590 operations a byte where the memory rate
// (3.35 TB/s) takes over, and the int32 output (four bytes an element,
// against one in) is the largest stream of the 1x1 layers.  This first
// design is simple, not at either bound: `mma.sync` m16n8k32 (warp-level,
// below the rate `wgmma` reaches), no TMA, two stages.
//
// The design (implicit GEMM: nothing is expanded in device memory):
// - a block of four warps owns a 128-row x 64-column output tile, each warp
//   64 x 32 (4 x 4 mma tiles of 16 x 8, int32 sums in registers);
// - K goes by in slices of 32 through two shared-memory stages.  The mma's
//   B operand wants K contiguous for each output column, so the kernel
//   takes the weights as a (Cout, K) copy made once by the caller (the
//   HWIO kernel has Cout contiguous, and ldmatrix.trans moves only 16-bit
//   elements);
// - the A slice is gathered from the NHWC activation: each thread owns two
//   output rows (their input origins worked out once) and one 16-byte half
//   of the slice.  Where Cin and K are multiples of 16 and both operands
//   are 16-byte aligned, a 16-byte run of K lies inside one tap and comes
//   by one cp.async, zero-filled (a 0-byte read) outside the input, past M,
//   past Cout or past K; otherwise (the 7x7 stem's Cin = 3, K = 147) the
//   thread gathers its 16 bytes one by one, zero past K;
// - rows of shared memory are 48 bytes apart, so the fragment loads of the
//   eight row groups of a warp fall on distinct banks;
// - the epilogue writes the int32 sums straight from the registers, two
//   columns a thread, masked at the M and Cout edges.
//
// Next steps, not taken: wgmma on s8 with TMA-fed operands and a deeper
// ring, the float epilogue (scale, bias, activation: `__fmul_rn` and
// `__fadd_rn` keep the reference's rounding) fused so that the int32 sums
// never reach device memory, and the next layer's activation quantization
// fused into it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace zoo_sm90;

constexpr int BM = 128;   // output rows (pixels) per block
constexpr int BN = 64;    // output columns (channels) per block
constexpr int BK = 32;    // K slice per stage: one m16n8k32 step
constexpr int LDS = 48;   // bytes between shared-memory rows
constexpr int NT = 128;   // four warps

struct Geo {
  int n, d, h, w, cin;        // input
  int od, oh, ow, cout;       // output
  int kd, kh, kw;             // taps
  int sd, sh, sw;             // strides
  int dd, dh, dw;             // dilation
  int pd, ph, pw;             // pads before (the pads after only size out)
  int k;                      // kd * kh * kw * cin
  int m;                      // n * od * oh * ow
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The input offset of tap element k of an output row whose window starts
// at (bd, bh, bw) in image nb, or -1 where the tap falls outside the input.
__device__ __forceinline__ long long x_offset(const Geo& g, int nb, int bd,
                                              int bh, int bw, int k) {
  const int tap = k / g.cin;
  const int ci = k - tap * g.cin;
  const int kw = tap % g.kw;
  const int t = tap / g.kw;
  const int kh = t % g.kh;
  const int kd = t / g.kh;
  const int id = bd + kd * g.dd, ih = bh + kh * g.dh, iw = bw + kw * g.dw;
  if (id < 0 || id >= g.d || ih < 0 || ih >= g.h || iw < 0 || iw >= g.w)
    return -1;
  return ((((long long)nb * g.d + id) * g.h + ih) * g.w + iw) * g.cin + ci;
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 int32_t* __restrict__ out, const Geo g) {
  __shared__ __align__(16) int8_t as[2][BM * LDS];
  __shared__ __align__(16) int8_t bs[2][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int half = tid & 1;  // which 16 bytes of a 32-byte K slice

  // this thread's two A rows (tid / 2 and 64 + tid / 2): the image and the
  // input origin of the window, nb = -1 past M
  int nb[2], bd[2], bh[2], bw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 1) + 64 * i;
    nb[i] = -1;
    bd[i] = bh[i] = bw[i] = 0;
    if (m < g.m) {
      int t = m;
      const int ow = t % g.ow;
      t /= g.ow;
      const int oh = t % g.oh;
      t /= g.oh;
      const int od = t % g.od;
      nb[i] = t / g.od;
      bd[i] = od * g.sd - g.pd;
      bh[i] = oh * g.sh - g.ph;
      bw[i] = ow * g.sw - g.pw;
    }
  }
  const int co_ld = n0 + (tid >> 1);  // this thread's B row (output column)

  auto load = [&](int s, int k0) {
    const int kc = k0 + half * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int8_t* dst = &as[s][((tid >> 1) + 64 * i) * LDS + half * 16];
      if constexpr (VEC) {
        long long off = -1;
        if (nb[i] >= 0 && kc < g.k)
          off = x_offset(g, nb[i], bd[i], bh[i], bw[i], kc);
        cp_async16(smem_u32(dst), off >= 0 ? x + off : x, off >= 0 ? 16 : 0);
      } else {
        uint32_t words[4] = {0u, 0u, 0u, 0u};
        if (nb[i] >= 0) {
#pragma unroll 4
          for (int j = 0; j < 16; ++j) {
            const int k = kc + j;
            if (k >= g.k) break;
            const long long off = x_offset(g, nb[i], bd[i], bh[i], bw[i], k);
            if (off >= 0)
              words[j >> 2] |= static_cast<uint32_t>(
                  static_cast<uint8_t>(x[off])) << (8 * (j & 3));
          }
        }
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
    int8_t* dst = &bs[s][(tid >> 1) * LDS + half * 16];
    const bool col = co_ld < g.cout;
    if constexpr (VEC) {
      const bool ok = col && kc < g.k;
      cp_async16(smem_u32(dst), ok ? wt + (long long)co_ld * g.k + kc : wt,
                 ok ? 16 : 0);
    } else {
      uint32_t words[4] = {0u, 0u, 0u, 0u};
      if (col) {
        const int8_t* row = wt + (long long)co_ld * g.k;
#pragma unroll 4
        for (int j = 0; j < 16; ++j) {
          const int k = kc + j;
          if (k >= g.k) break;
          words[j >> 2] |= static_cast<uint32_t>(
              static_cast<uint8_t>(row[k])) << (8 * (j & 3));
        }
      }
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  const int gr = lane >> 2, tq = lane & 3;  // mma row group, thread in group
  const int nk = (g.k + BK - 1) / BK;

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load(s ^ 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int8_t* r0 = &as[s][(wm + mi * 16 + gr) * LDS + tq * 4];
      const int8_t* r8 = r0 + 8 * LDS;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* c0 = &bs[s][(wn + ni * 8 + gr) * LDS + tq * 4];
      b[ni][0] = *reinterpret_cast<const uint32_t*>(c0);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    __syncthreads();  // the next iteration's load overwrites this stage
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + wn + ni * 8 + tq * 2;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + wm + mi * 16 + gr + 8 * hf;
        if (r >= g.m) continue;
        int32_t* o = out + (long long)r * g.cout + c;
        if (c < g.cout) o[0] = acc[mi][ni][2 * hf];
        if (c + 1 < g.cout) o[1] = acc[mi][ni][2 * hf + 1];
      }
    }
  }
}

}  // namespace

// geo: 21 ints, (n, d, h, w, cin), (od, oh, ow, cout), (kd, kh, kw),
// strides, dilations and pads before, each (d, h, w).  Returns a
// cudaError_t (0: launched).
extern "C" int zoo_int8_conv(const void* x, const void* wt, void* out,
                             const int* geo, void* stream) {
  Geo g;
  g.n = geo[0], g.d = geo[1], g.h = geo[2], g.w = geo[3], g.cin = geo[4];
  g.od = geo[5], g.oh = geo[6], g.ow = geo[7], g.cout = geo[8];
  g.kd = geo[9], g.kh = geo[10], g.kw = geo[11];
  g.sd = geo[12], g.sh = geo[13], g.sw = geo[14];
  g.dd = geo[15], g.dh = geo[16], g.dw = geo[17];
  g.pd = geo[18], g.ph = geo[19], g.pw = geo[20];
  const long long k = (long long)g.kd * g.kh * g.kw * g.cin;
  const long long m = (long long)g.n * g.od * g.oh * g.ow;
  if (k <= 0 || m <= 0 || g.cout <= 0 || k > 0x7fffffff || m > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  g.k = static_cast<int>(k);
  g.m = static_cast<int>(m);
  const dim3 grid((g.m + BM - 1) / BM, (g.cout + BN - 1) / BN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = g.cin % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(wt);
  int32_t* o = static_cast<int32_t*>(out);
  if (vec)
    int8_conv_kernel<true><<<grid, NT, 0, s>>>(xi, wi, o, g);
  else
    int8_conv_kernel<false><<<grid, NT, 0, s>>>(xi, wi, o, g);
  return static_cast<int>(cudaGetLastError());
}
