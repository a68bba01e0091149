// The calibrated int8 layer on the H100, as two kernels with a plain C
// interface for ctypes (analytics_zoo_tpu_torch/ops/cuda/int8_conv.py):
//
//   quantize_act: xs (N, ..spatial.., Cin_p) int8 =
//     clamp(rint(x (N, ..spatial.., Cin) f32 / scale), -127, 127),
//     its channels zero-padded from Cin to Cin_p (a multiple of 16);
//
//   int8_conv: out (N, OD, OH, OW, Cout) =
//     sum over taps (kd, kh, kw) and ci of
//       xs [n, od*sd - pd + kd*dd, ...][ci] * w (kd, kh, kw, ci, Cout),
//     either the exact int32 sums, or (the fused epilogue) the f32
//     y = acc * mult[c] (+ bias[c]) (then ReLU), mult = act_scale * w_scale.
//
// xs is the unpadded channels-last activation: the pads are numbers, and a
// tap that falls outside the input reads 0 (the quantized zero, since the
// scales are symmetric).  Rank 1 and 2 convolutions come in as rank 3 with
// unit dims (D = KD = 1, and H = KH = 1 for rank 1); a Dense is a 1x1 over
// its rows.  The sums are exact: the wrapper refuses a K for which
// K * 127^2 could pass 2^31 - 1, and integer sums are the same in any
// order.
//
// Replaces no TPU kernel.  The reference's calibrated conv and Dense
// (`_int8_conv` and `_int8_dense`, analytics_zoo_tpu/pipeline/inference/
// quantize.py:282 and :268, with `_quantize_act` :263) are lax ops with
// int32 sums that XLA lowers itself, and no Pallas kernel computes them;
// these kernels exist because PyTorch has no int8 convolution on CUDA.
//
// What bounds them on an H100: a convolution is a product of
// M = N * OD * OH * OW rows, K = KD * KH * KW * Cin_p and Cout columns, 2 M
// K Cout operations (1,979 TOP/s on the int8 tensor cores) against
// M K / taps + K Cout bytes in and 4 M Cout (f32 or int32) out (3.35 TB/s):
// at ResNet-50's shapes most layers sit near the ~590 operations a byte
// where the memory rate takes over, and the 4-byte output is the largest
// stream of the 1x1 layers.  The quantization moves 4 bytes in and 1 out
// an element and is bound by bytes alone.
//
// The design of int8_conv (implicit GEMM: nothing is expanded in device
// memory):
// - a block of two warpgroups owns a 128-row x BN-column output tile
//   (BN = 64 or 128, picked by the wrapper from M, K, Cout and the taps:
//   128 halves A's gathers, which pays where K is deep and the tiles
//   still fill the card; a 256-column body lost at every ResNet-50
//   shape, its 128 sums a thread leaving room for one block an SM), each
//   warpgroup 64 rows, its s32 sums in registers, fed by
//   `wgmma.mma_async` m64nBNk32 on s8 operands read from shared memory;
// - K goes by in tiles of 128 bytes, one 128-byte-swizzled row a tile row
//   (four wgmma K steps of 32 bytes), through a ring of ST = 3 stages
//   (fewer where a block takes fewer K tiles), loaded
//   AHEAD = ST - 2 tiles ahead: a stage is refilled only after both
//   warpgroups have retired the products that read it (one barrier a
//   tile; the products of tile t run while tile t + 1 waits).  Three
//   blocks share an SM at BN 64 and two at 128, so that one block's
//   barrier and copy waits run under another's products;
// - B, the (Cout, K) weight copy, is a plain 2-D tensor: one thread
//   loads each tile by TMA (box 128 bytes x BN rows, 128-byte swizzle,
//   zeros past Cout and K) and completes it on the stage's mbarrier;
// - A is the implicit-GEMM gather from the NHWC activation, by 16-byte
//   cp.async (through L1: the taps of neighbouring rows re-read the same
//   lines) straight into the swizzled layout; 0-byte reads zero-fill
//   outside the input, past M and past K.  TMA's im2col mode is not used:
//   its box walks one image's pixels in order with the taps as offsets,
//   which fits a tile of output rows inside one image, but a tile here
//   spans images at the 7x7 and 14x14 stages and at 1-image requests, and
//   the dilation and the rank-1 and rank-3 cases would each need a map of
//   their own.  Cin_p is a multiple of 16 (quantize_act pads it, the
//   weight copy has zero rows per tap), so a 16-byte run of K lies inside
//   one tap and every row takes 16-byte copies; each thread decodes its
//   tap once a K tile for its four rows;
// - split-K where the output tiles fill less than the card: block z of
//   `split` sums K tiles [z per, (z + 1) per), writes its partial int32
//   tile to a workspace (in fragment order, so each thread's stores and
//   loads are coalesced), and takes a ticket (an int32 counter per output
//   tile, in an array the caller owns and keeps zeroed: Int8Model holds
//   one a layer, so launches on two streams never share one); the block
//   that arrives last adds the other partials, runs the epilogue and sets
//   the ticket back to 0, so a replayed CUDA graph starts clean.  The
//   partials pass through a workspace of split x tiles x 128 x BN int32
//   values;
// - the epilogue: the int32 sums, or the f32
//   y = __fmul_rn(__int2float_rn(acc), mult[c]), __fadd_rn(y, bias[c])
//   where the layer has a bias, ReLU where its activation is relu (as
//   jax.nn.relu: -0 becomes +0 and NaN stays NaN).  The intrinsics keep
//   nvcc from contracting the product and the sum into an FMA that the
//   reference does not compute.  No int32 output tensor is written in
//   the fused mode: only split-K's partials touch device memory.
//   Where Cout is a multiple of 4, the tile is staged in the freed ring
//   (128-byte swizzled, so the fragment stores meet no bank conflict) and
//   leaves by tensor stores: the block waits only until they have read
//   shared memory, and the next block on the SM starts while the writes
//   drain (the output is the largest stream of most layers).  Other Couts
//   are written from the registers.
//
// quantize_act is one elementwise pass (four outputs a thread from one
// float4, or, where the channels are padded, 16 a thread and one 16-byte
// store): the quotient by IEEE division (__fdiv_rn, as the reference's
// x / scale), rounded half to even (rintf, as jnp.round), clamped, and
// the padding channels written as zeros.  The scale is read from device
// memory (the f32 scalar the model holds), so a captured forward reads it
// by address.  It stays a launch of its own: the 3x3 layers gather each
// input nine times, and gathering f32 would quadruple A's bytes and take
// A off the asynchronous path.
//
// Next steps, not taken: the next layer's quantization fused into this
// epilogue where a hooked conv feeds another directly, a persistent grid
// whose epilogue overlaps the next tile's loads, and B shared by a
// cluster's blocks through TMA multicast.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tma.cuh"
#include "sm90.cuh"

namespace {

using namespace zoo_sm90;

constexpr int BM = 128;            // output rows (pixels) per block
constexpr int BK = 128;            // K bytes per stage: one swizzled row
constexpr int NT = 256;            // two warpgroups
constexpr int A_BYTES = BM * BK;   // one stage of A (16 KB)

template <int BN>
struct Cfg {
  // ring stages at most, and blocks an SM: three blocks share an SM at
  // 64 columns and two at 128, so that their barriers and copy waits
  // interleave (more blocks hide more than a deeper ring)
  static constexpr int ST = 3;
  static constexpr int AHEAD = ST - 2;             // tiles loaded ahead
  static constexpr int BLOCKS = BN == 64 ? 3 : 2;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int NR = BN / 2;                // sums a thread
  static constexpr int BOX = 32;                   // output columns a box
};

// The ring of `nst` stages (or the staged output tile where it is
// larger), from a 1024-byte boundary.
__host__ __device__ constexpr int ring_bytes(int bn, int nst) {
  return nst * (A_BYTES + bn * BK) > BM * bn * 4 ? nst * (A_BYTES + bn * BK)
                                                 : BM * bn * 4;
}

struct Geo {
  int n, d, h, w, cin;        // input (cin a multiple of 16)
  int od, oh, ow, cout;       // output
  int kd, kh, kw;             // taps
  int sd, sh, sw;             // strides
  int dd, dh, dw;             // dilation
  int pd, ph, pw;             // pads before (the pads after only size out)
  int k;                      // kd * kh * kw * cin
  int m;                      // n * od * oh * ow
};

struct Args {
  const int8_t* x;
  void* out;                  // int32 sums, or f32 with the epilogue
  const float* mult;          // (cout,) f32, the epilogue's scale
  const float* bias;          // (cout,) f32 or null
  int32_t* ws;                // split-K partials, or null
  int* tickets;               // split-K arrivals per output tile, or null
  int split, per;             // K tiles: `split` blocks of `per`
  int nst;                    // ring stages: min(ST, per)
  int fused, relu;
  int staged;                 // the tile leaves by tensor store (omap)
};

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 64)
    wgmma_s8_m64n64k32_ss(d, da, db, 1);
  else
    wgmma_s8_m64n128k32_ss(d, da, db, 1);
}

__device__ __forceinline__ float epilogue(int acc, float mult,
                                          const float* bias, int c,
                                          int relu) {
  float y = __fmul_rn(__int2float_rn(acc), mult);
  if (bias != nullptr) y = __fadd_rn(y, bias[c]);
  if (relu) y = y <= 0.f ? 0.f : y;
  return y;
}

template <int BN>
__global__ void __launch_bounds__(NT, Cfg<BN>::BLOCKS)
    int8_conv_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap, const Geo g,
                     const Args a) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  uint8_t* as = smem_raw + pad;                 // nst x A_BYTES
  uint8_t* bs = as + a.nst * A_BYTES;           // nst x B_BYTES
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(as + ring_bytes(BN, a.nst));
  int* last = reinterpret_cast<int*>(bars + C::ST);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * a.per;
  const int nk = min(a.per, (g.k + BK - 1) / BK - kt0);  // >= 1

  if (tid == 0) {
    prefetch_tensormap(&wmap);
    if (a.staged) prefetch_tensormap(&omap);
#pragma unroll
    for (int s = 0; s < C::ST; ++s) mbar_init(smem_u32(&bars[s]), 1);
  }

  // this thread's 16-byte chunk of a K tile and its four rows
  // (tid / 8 + 32 i): the image's input origin of each row's window as a
  // linear offset, and its (d, h, w) origin; rows past M get an origin no
  // tap can bring inside the input
  const int ch = tid & 7, r = tid >> 3;
  int rb[4], rd[4], rh[4], rw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r + 32 * i;
    rb[i] = 0;
    rd[i] = -(1 << 30);
    rh[i] = rw[i] = 0;
    if (m < g.m) {
      int t = m;
      const int ow = t % g.ow;
      t /= g.ow;
      const int oh = t % g.oh;
      t /= g.oh;
      const int od = t % g.od;
      const int nb = t / g.od;
      rd[i] = od * g.sd - g.pd;
      rh[i] = oh * g.sh - g.ph;
      rw[i] = ow * g.sw - g.pw;
      rb[i] = (((nb * g.d + rd[i]) * g.h + rh[i]) * g.w + rw[i]) * g.cin;
    }
  }

  // K tile kt into stage s: A by cp.async (this thread's four chunks),
  // B by one tensor copy
  auto load = [&](int s, int kt) {
    const int k = kt * BK + ch * 16;
    const bool kin = k < g.k;
    int dz = 0, dy = 0, dx = 0, toff = 0;
    if (kin) {
      const int tap = k / g.cin;
      const int ci = k - tap * g.cin;
      const int kw = tap % g.kw;
      const int t = tap / g.kw;
      dz = (t / g.kh) * g.dd;
      dy = (t % g.kh) * g.dh;
      dx = kw * g.dw;
      toff = ((dz * g.h + dy) * g.w + dx) * g.cin + ci;
    }
    const uint32_t dst = smem_u32(as + s * A_BYTES) + swz(r, ch);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = kin &&
                      static_cast<unsigned>(rd[i] + dz) <
                          static_cast<unsigned>(g.d) &&
                      static_cast<unsigned>(rh[i] + dy) <
                          static_cast<unsigned>(g.h) &&
                      static_cast<unsigned>(rw[i] + dx) <
                          static_cast<unsigned>(g.w);
      cp_async16_ca(dst + i * 32 * 128, ok ? a.x + rb[i] + toff : a.x,
                    ok ? 16 : 0);
    }
    if (tid == 0) {
      const uint32_t bar = smem_u32(&bars[s]);
      mbar_arrive_tx(bar, C::B_BYTES);
      tma_load_2d(smem_u32(bs + s * C::B_BYTES), &wmap, kt * BK, n0, bar);
    }
  };

  int acc[C::NR];
#pragma unroll
  for (int i = 0; i < C::NR; ++i) acc[i] = 0;

  __syncthreads();  // the mbarriers are initialised
#pragma unroll
  for (int p = 0; p < C::AHEAD; ++p) {
    if (p < nk) load(p, kt0 + p);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    const int s = i % C::ST;
    cp_async_wait<C::AHEAD - 1>();  // this thread's A chunks of tile i
    fence_proxy_async();            // ... visible to wgmma
    // every thread's chunks of tile i have landed, and both warpgroups
    // have retired the products of tile i - 2, whose stage the next load
    // fills
    __syncthreads();
    if (i + C::AHEAD < nk) load((i + C::AHEAD) % C::ST, kt0 + i + C::AHEAD);
    cp_async_commit();
    mbar_wait(smem_u32(&bars[s]), (i / C::ST) & 1);  // B of tile i
    const uint32_t sa = smem_u32(as + s * A_BYTES) + wg * 64 * 128;
    const uint32_t sb = smem_u32(bs + s * C::B_BYTES);
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_s8<BN>(acc, desc_b128(sa + kk * 32, 16, 1024),
                   desc_b128(sb + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the products of tile i - 1 are done
    fence_operand(acc);
  }
  wgmma_wait<0>();
  fence_operand(acc);
  cp_async_wait<0>();

  if (a.split > 1) {
    // this block's partial tile, in fragment order; the last block of the
    // tile to arrive adds the others
    const int tiles = gridDim.x * gridDim.y;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int32_t* mine = a.ws + (static_cast<size_t>(blockIdx.z) * tiles + tile) *
                               C::NR * NT + tid;
#pragma unroll
    for (int j = 0; j < C::NR; ++j) mine[j * NT] = acc[j];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int arrived = atomicAdd(&a.tickets[tile], 1);
      *last = arrived == a.split - 1;
      if (*last) a.tickets[tile] = 0;  // clean for the next launch
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int z = 0; z < a.split; ++z) {
      if (z == static_cast<int>(blockIdx.z)) continue;
      const int32_t* part =
          a.ws + (static_cast<size_t>(z) * tiles + tile) * C::NR * NT + tid;
#pragma unroll
      for (int j = 0; j < C::NR; ++j) acc[j] += __ldcg(part + j * NT);
    }
  }

  // Epilogue.  Fragment element 4 j + 2 h + e is row g + 8 h of this
  // warp's 16 rows, column 8 j + 2 t + e.
  const int lane = tid & 31, tq = lane & 3;
  const int lrow = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  if (a.staged) {
    // the tile, as 32-bit words, into the freed ring as BN / 32 boxes of
    // 128 rows x 128 bytes in the 128-byte-swizzled layout (column pair
    // 2 t of box j / 4 is 16-byte chunk 2 (j % 4) + t / 2, at byte
    // 8 (t % 2)), then out by tensor stores, which skip the rows past M
    // and the columns past Cout
    __syncthreads();  // every warpgroup's products are retired
    const uint32_t st = smem_u32(as);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + j * 8 + 2 * tq;
      float mu0 = 0.f, mu1 = 0.f;
      if (a.fused) {
        mu0 = c < g.cout ? a.mult[c] : 0.f;
        mu1 = c + 1 < g.cout ? a.mult[c + 1] : 0.f;
      }
      const uint32_t box = st + (j >> 2) * (BM * C::BOX * 4) + (tq & 1) * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lrow + 8 * h;
        const int v0 = acc[j * 4 + h * 2], v1 = acc[j * 4 + h * 2 + 1];
        uint32_t w0 = static_cast<uint32_t>(v0);
        uint32_t w1 = static_cast<uint32_t>(v1);
        if (a.fused) {
          w0 = __float_as_uint(
              epilogue(v0, mu0, c < g.cout ? a.bias : nullptr, c, a.relu));
          w1 = __float_as_uint(epilogue(
              v1, mu1, c + 1 < g.cout ? a.bias : nullptr, c + 1, a.relu));
        }
        asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n"
                     :: "r"(box + swz(r, 2 * (j & 3) + (tq >> 1))),
                        "r"(w0), "r"(w1)
                     : "memory");
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int b = 0; b < BN / C::BOX; ++b)
        if (n0 + b * C::BOX < g.cout)
          tma_store_2d(&omap, st + b * (BM * C::BOX * 4), n0 + b * C::BOX,
                       m0);
      bulk_commit();
      bulk_wait_read();  // the ring is read; the writes drain on their own
    }
    return;
  }
  // Cout not a multiple of 4: from the registers
  const int row0 = m0 + lrow;
  const bool pair = (g.cout & 1) == 0;  // 8-byte aligned column pairs
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + j * 8 + 2 * tq;
    if (c >= g.cout) continue;
    const bool two = c + 1 < g.cout;
    float mu0 = 0.f, mu1 = 0.f;
    if (a.fused) {
      mu0 = a.mult[c];
      mu1 = two ? a.mult[c + 1] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= g.m) continue;
      const size_t o = static_cast<size_t>(row) * g.cout + c;
      const int v0 = acc[j * 4 + h * 2], v1 = acc[j * 4 + h * 2 + 1];
      if (a.fused) {
        float* out = static_cast<float*>(a.out) + o;
        const float y0 = epilogue(v0, mu0, a.bias, c, a.relu);
        if (two) {
          const float y1 = epilogue(v1, mu1, a.bias, c + 1, a.relu);
          if (pair)
            *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
          else
            out[0] = y0, out[1] = y1;
        } else {
          out[0] = y0;
        }
      } else {
        int32_t* out = static_cast<int32_t*>(a.out) + o;
        if (two) {
          if (pair)
            *reinterpret_cast<int2*>(out) = make_int2(v0, v1);
          else
            out[0] = v0, out[1] = v1;
        } else {
          out[0] = v0;
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t quantize(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(__float2int_rn(q))));
}

// vec (cin == cin_p, x 16-byte aligned): item q is the four outputs at
// 4 q, from one float4.  Otherwise item q is the 16 outputs of row
// q / (cin_p / 16) from channel 16 (q % (cin_p / 16)): the channels past
// cin are the padding's zeros (the stem's three channels make one item a
// pixel).  32-bit indices: the wrapper keeps the items below 2^31.
__global__ void __launch_bounds__(256)
    quantize_act_kernel(const float* __restrict__ x,
                        const float* __restrict__ scale,
                        int8_t* __restrict__ out, int items, int cin,
                        int cin_p, int vec) {
  const float s = *scale;
  const int per_row = cin_p / 16;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < items;
       q += gridDim.x * blockDim.x) {
    if (vec) {
      const float4 v = reinterpret_cast<const float4*>(x)[q];
      reinterpret_cast<uint32_t*>(out)[q] =
          quantize(v.x, s) | quantize(v.y, s) << 8 |
          quantize(v.z, s) << 16 | quantize(v.w, s) << 24;
    } else {
      const int row = q / per_row;
      const int c0 = (q - row * per_row) * 16;
      const float* src = x + static_cast<size_t>(row) * cin;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (c0 + j < cin)
          w[j >> 2] |= quantize(src[c0 + j], s) << (8 * (j & 3));
      reinterpret_cast<uint4*>(out)[q] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int BN>
int launch(const CUtensorMap& wmap, const CUtensorMap& omap, const Geo& g,
           Args a, cudaStream_t s) {
  a.nst = a.per < Cfg<BN>::ST ? a.per : Cfg<BN>::ST;
  // the ring (or the staged tile), alignment slack, the mbarriers, the
  // flag: a block that takes few K tiles leaves room for more blocks
  const int smem = ring_bytes(BN, a.nst) + 1024 + 8 * Cfg<BN>::ST + 16;
  const cudaError_t attr = cudaFuncSetAttribute(
      int8_conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((g.m + BM - 1) / BM, (g.cout + BN - 1) / BN, a.split);
  int8_conv_kernel<BN><<<grid, NT, smem, s>>>(wmap, omap, g, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// geo: 21 ints, (n, d, h, w, cin), (od, oh, ow, cout), (kd, kh, kw),
// strides, dilations and pads before, each (d, h, w).  cin a multiple of
// 16; x and wt 16-byte aligned.  plan: (bn, split, per): the N tile (64
// or 128) and K split into `split` blocks of `per` K tiles of 128;
// with split > 1, ws holds split x tiles x BM x bn int32 and tickets one
// zeroed int32 per output tile.  fused: 0 writes the int32 sums to out,
// 1 the f32 epilogue with mult (and bias, null for none, and relu).
// Returns a cudaError_t (0: launched).
extern "C" int zoo_int8_conv(const void* x, const void* wt, void* out,
                             const float* mult, const float* bias, void* ws,
                             void* tickets, const int* geo, const int* plan,
                             int fused, int relu, void* stream) {
  Geo g;
  g.n = geo[0], g.d = geo[1], g.h = geo[2], g.w = geo[3], g.cin = geo[4];
  g.od = geo[5], g.oh = geo[6], g.ow = geo[7], g.cout = geo[8];
  g.kd = geo[9], g.kh = geo[10], g.kw = geo[11];
  g.sd = geo[12], g.sh = geo[13], g.sw = geo[14];
  g.dd = geo[15], g.dh = geo[16], g.dw = geo[17];
  g.pd = geo[18], g.ph = geo[19], g.pw = geo[20];
  const long long k = (long long)g.kd * g.kh * g.kw * g.cin;
  const long long m = (long long)g.n * g.od * g.oh * g.ow;
  const int bn = plan[0], split = plan[1], per = plan[2];
  const long long nk = (k + BK - 1) / BK;
  if (k <= 0 || m <= 0 || g.cout <= 0 || k > 0x7fffffff || m > 0x7fffffff ||
      g.cin % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0 || split < 1 || per < 1 ||
      (long long)(split - 1) * per >= nk || (long long)split * per < nk ||
      (split > 1 && (ws == nullptr || tickets == nullptr)) ||
      (fused && mult == nullptr) || (g.cout + bn - 1) / bn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  g.k = static_cast<int>(k);
  g.m = static_cast<int>(m);

  // the (cout, k) weight copy as a 2-D tensor of bytes, boxes of 128
  // bytes x bn rows into the 128-byte-swizzled layout, zeros past its
  // edges
  const zoo_tma::EncodeTiled encode = zoo_tma::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(g.k),
                              static_cast<cuuint64_t>(g.cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(g.k)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(bn)};
  const cuuint32_t step[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wt),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  // the (m, cout) output of 4-byte words, boxes of 32 columns x 128 rows
  // out of the 128-byte-swizzled staged tile, where its rows are 16-byte
  // aligned
  CUtensorMap omap = {};
  const int staged = g.cout % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (staged) {
    const cuuint64_t odims[2] = {static_cast<cuuint64_t>(g.cout),
                                 static_cast<cuuint64_t>(g.m)};
    const cuuint64_t ostrides[1] = {static_cast<cuuint64_t>(g.cout) * 4};
    const cuuint32_t obox[2] = {32, BM};
    if (encode(&omap,
               fused ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_INT32,
               2, out, odims, ostrides, obox, step,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }

  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.out = out;
  a.mult = mult;
  a.bias = bias;
  a.ws = static_cast<int32_t*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.split = split;
  a.per = per;
  a.fused = fused;
  a.relu = relu;
  a.staged = staged;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) return launch<64>(map, omap, g, a, s);
  if (bn == 128) return launch<128>(map, omap, g, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (rows, cin) f32 contiguous, scale one f32 in device memory, out
// (rows, cin_p) int8, cin_p a multiple of 16 and >= cin.  Returns a
// cudaError_t (0: launched).
extern "C" int zoo_quantize_act(const float* x, const float* scale,
                                void* out, long long rows, int cin,
                                int cin_p, void* stream) {
  const int vec = cin == cin_p && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long items = rows * (cin_p / (vec ? 4 : 16));
  if (rows <= 0 || cin <= 0 || cin_p < cin || cin_p % 16 != 0 ||
      items > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (items + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  quantize_act_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, scale, static_cast<int8_t*>(out), static_cast<int>(items), cin,
      cin_p, vec);
  return static_cast<int>(cudaGetLastError());
}
