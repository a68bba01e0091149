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
// A pair is live inside the causal triangle, inside Lq and Lk, and where
// the query's and the key's segment ids are equal (when given).  The
// division and the D-subtraction sit inside the `live` select, so a padded
// or masked entry is an exact zero: the dk/dv kernel contracts over query
// rows, and one NaN there would poison every output.  The gradient of a
// full (..., Lq, Lk) bias is not computed here: the caller takes the
// reference's blockwise route for it.
//
// Two kernels, as on the TPU, and no atomics: the dq kernel owns a tile of
// 64 query rows and streams the keys past it; the dk/dv kernel owns a tile
// of 64 keys and streams the query rows past it.  Each output element is
// written by one thread, so the result is deterministic, and the
// bias-gradient partial of a key needs no cross-block reduction.  Both
// recompute the score tile: seven products per tile pair in all, against
// the five a one-kernel design with atomic dq adds would need.
//
// What bounds it on an H100.  At the BERT-base training shape (B=8, H=12,
// L=512, D=64, the padding bias, dropout 0.1) each kernel moves q, k, v,
// dO, the statistics and the outputs once: 50 MB in bf16 or f16, 0.0151 ms
// at 3.35 TB/s.  The seven products are ~22.5 GFLOP on dense tiles: 0.023
// ms at the 16-bit tensor cores' 989 TFLOP/s, 0.13 ms as f32's three tf32
// products a value at 495, 0.33 ms in f32 on the CUDA cores.  What takes
// the time is neither: it is the work on the CUDA cores for each (query,
// key) pair, in both kernels (the softmax recompute, the live select, the
// dropout hash, dS, the operands' rounding), and the latency of the
// phases a block walks through in order.
//
// bf16 and f16 at head dims 64 and 128: `bwd16_kernel<T, D, KV, ROW>`, on
// the 16-bit tensor cores.  T's own `wgmma` (`.bf16` or `.f16`, chosen by
// the type through sm90.cuh's `wgmma_*<T, TB>`), f32 accumulators.
// - One warpgroup a block owns 64 rows; the streamed rows come in tiles of
//   NS = 64 (32 in the dk/dv kernel at head dim 128, whose dK and dV
//   accumulators alone take 128 registers a thread).  Three blocks an SM
//   at head dim 64, two at 128: while one block runs its softmax on the
//   CUDA cores, another's products run on the tensor cores.
// - Tensor copies (TMA) bring the own tiles once and the streamed tiles
//   through a ring of two stages, one mbarrier a stage, issued by one
//   thread a tile ahead; the maps (flash_tma.cuh, `encode_chunked_map`)
//   cut a row into 64-column chunks of 128 bytes that land 128-byte
//   swizzled, as `wgmma` reads them.  Rows past the lengths land as zeros.
//   The split_heads views of one fused projection are read through their
//   strides; an input whose base or strides are not multiples of 16 bytes
//   is copied by the wrapper first.
// - Every operand stays in T in shared memory: no widening, no hi and lo
//   pieces, and no transposed copy.  S = own0 . str0^T and dP = own1 .
//   str1^T read both tiles K-major; each output product reads its streamed
//   tile MN-major (the transpose bit 16-bit `wgmma` has and tf32 lacks)
//   and takes, as its register A operand, the accumulator it was computed
//   from: an m64nN f32 fragment, two values packed to a T register, is the
//   k16 A fragment.  The dq kernel (own rows: queries) forms S = Q K^T,
//   dP = dO V^T, then dQ = dS K; the dk/dv kernel (own rows: keys) forms
//   S^T = K Q^T and dP^T = V dO^T directly, then dV = (P t)^T dO and
//   dK = dS^T Q (the reference's tile math and contractions,
//   analytics_zoo_tpu/ops/pallas/flash_attention.py:552-566, :595, :645,
//   :648).  Seven products a pair of tiles in all.
// - S and dP go out as two `wgmma` groups; the softmax recompute runs when
//   S is done, while dP is multiplied, and in the dk/dv kernel dV's
//   product runs while dS is formed.  (Issuing tile j + 1's S and dP at
//   the end of tile j, behind its last output product, measured 8-19%
//   slower in both kernels: tools/flash_bwd_variants.py.)
//   p = 2^(x scale log2 e + u), u the
//   key's bias times log2 e less the query's m log2 e + log2 l: one FMA
//   and one ex2 an element (the bias row and the streamed rows' terms come
//   through shared memory with each tile, ROW; a full bias is read element
//   by element).  The dropout hash is the forward's, its streamed-row part
//   a tile's constant plus an element's.  Tiles inside the lengths and the
//   causal triangle, without segment ids, skip the live test; under causal
//   masking a block skips the tiles none of its rows can see.
// - Each output element is written once, by one thread, from one f32 sum
//   (the wgmma accumulator over all tiles): no atomics, and two calls give
//   the same bits.  The bias-gradient partial of a key sums its dS row in
//   f32 in the dk/dv kernel.
// - Numerics.  P t and dS are rounded to T as the A operands (2^-9
//   relative in bf16, 2^-12 in f16); every product of two T values is
//   exact and sums in f32.  f16 has no loss scaling, and in the f16 step
//   of BERT-base dS lies below f16's normal range (2^-14) almost
//   everywhere and mostly below 2^-25, where it would round to zero
//   (tools/flash_bwd_magnitudes.py).  So in f16 each own row's dS is
//   lifted by 2^e before it is rounded, e = 14 - floor(log2 of the row's
//   largest |dS| in the tile), clamped to [0, 100]: e starts at 100 and
//   only falls along the row, and when it does the row's accumulator is
//   brought to the new scale first; the output is scaled by 2^-e at the
//   end.  Powers of two: exact.  The lift costs little: p is formed
//   lifted (2^e in its exponent), so dS comes out lifted; a tile's largest
//   lifted |dS| at or above 2^15 is what lowers e.  P t <= 1/(1-p) needs
//   no lift (its 2^-e rides on 1/(1-p)), nor does bf16, which has f32's
//   range.  attention_bwd16_model (ops/cuda/flash_attention.py) repeats
//   this order in plain PyTorch.
// - ptxas -v (CUDA 12.9), registers (bytes spilled) with a bias row, dq /
//   dk-dv kernel: bf16 D64 159 / 168 (112), D128 191 / 208; f16 D64 164 /
//   168 (128), D128 195 / 210.  At D64 the registers are capped at 168
//   for three blocks an SM; the dk/dv kernel's small spill (to L1) costs
//   less than the third block gains.  The full-bias instances (on no
//   model path) hold 168-238 registers and spill up to 524 bytes at D64.
//
// f32 at head dims 64 and 128: `bwd_kernel<D, KV>`, on the tf32 tensor
// cores.  A tf32 product keeps 11 bits of each factor, so each f32 operand
// x is split into hi = tf32(x) and lo = x - hi, and a product is lo*hi +
// hi*lo + hi*hi (3xTF32, as CUTLASS's OpMultiplyAddFastF32), ~2^-21
// relative per product: f32 math in another order.
// - D / 64 warpgroups a block; all of them compute the 64 x 32 score and
//   dO.v tiles of the block's 64 own rows and the current 32 streamed rows
//   (S = own0 . str0^T, dP = own1 . str1^T, `wgmma` m64n32k8 with both
//   operands K-major in shared memory), and each owns 64 columns of the
//   outputs (`wgmma` m64n64k8).  The own tile (Q, dO in the dq kernel; K,
//   V in the dk/dv kernel) is split into hi and lo pieces once.
// - The streamed rows (K, V past the dq kernel; Q, dO with their m, l and
//   D past the dk/dv kernel) are loaded into registers one tile ahead,
//   16 bytes a load where the rows allow.  Split into hi and lo, they are
//   written to shared memory twice from those registers: row-major for S
//   and dP, then, once those products are done, transposed into the same
//   buffer for the products that contract over the streamed rows (dq over
//   keys; dk, dv over queries): tf32 `wgmma` reads shared memory only
//   K-major.  All tiles use the 128-byte-swizzled layout of sm90.cuh.
// - The softmax recompute, the live select, the dropout hash and dbias work
//   on the accumulator fragments in registers.  P*t and dS then are, split
//   into hi and lo, the register A operands of the output products.  A
//   thread holds columns 2t, 2t + 1 of each group of 8 where the tf32 A
//   fragment wants columns t, t + 4; instead of shuffling, the transposed
//   tile stores its 8 streamed rows in the matching order (row 2c at
//   position c, row 2c + 1 at c + 4), which leaves the sum unchanged.
// - Products are issued lo pieces first, so the small terms enter the
//   accumulator before it grows.  Each output's per-tile contribution goes
//   into a fresh accumulator that is added into the f32 total on the CUDA
//   cores, so the accumulator's rounding does not build up over a 512-long
//   sequence (as in the int8 matmul).
// - Under causal masking a block skips the streamed tiles none of its rows
//   can see.  Segment ids: the own rows' in registers, the streamed rows'
//   read where a pair is tested; with segment ids every tile tests every
//   pair.  At head dim 128, two warpgroups and 192 KB of shared memory a
//   block.
//
// Head dims above 128 that are multiples of 64 (`bwd_wide_kernel<T, KV,
// NWG>`, the head dim a runtime value).  The whole own tile does not fit
// here: its hi and lo pieces and the streamed tile's take 1536 D bytes,
// 295 KB at D 192.  So S and dP contract over the head dim in 32-column
// chunks (one 128-byte swizzled row of f32):
// - Tensor copies (TMA) bring each chunk's own rows (64) and streamed rows
//   (32) of both operands into a ring of three slots, two chunks ahead of
//   the one being multiplied; one thread issues them, and an mbarrier a
//   slot says when they have landed.  f32 rows land as they are, in the
//   128-byte-swizzled K-major layout; the threads split each value with
//   split_tf32, write hi back in place and lo into a lo slot, and write the
//   transposed copies below.  bf16 and f16 rows land in a staging slot and
//   are widened into the hi slot (exactly).  The own rows are read again, from
//   L2, for every streamed tile.  An input whose base or strides are not
//   multiples of 16 bytes (which tensor maps need) is copied by the
//   wrapper first.
// - While chunk n's products run, chunk n + 2's copies are issued and
//   chunk n + 1 is completed.
// - The NWG warpgroups of a block share each chunk's products, every
//   warpgroup with the same wgmma sequence (a warpgroup-dependent branch
//   around wgmma makes ptxas serialize all of them): three warpgroups take
//   one product each (lo . hi, hi . lo, hi . hi, added in that order: lo
//   products first) over all k-steps; two split the k-steps.  The partial
//   S and dP go through shared memory; each warpgroup adds them, in
//   warpgroup order, for its share of the 16 accumulator elements a thread
//   holds (bf16 on three warpgroups: each forms the whole of S and dP and
//   takes its share from its own registers), runs the softmax recompute,
//   live select and dropout hash on that share as above, and passes P t
//   and dS back through shared memory.  Every warpgroup then holds them
//   whole as the register A operands of the output products, one fresh
//   accumulator per 32-row tile; dbias is summed from dS as above.
// - A block owns 64 rows and NWG groups of 64 output columns (its slice,
//   carried by blockIdx.x), one a warpgroup, and forms S and dP over the
//   whole head dim for them.  NWG is 3 where the head dim has a multiple of
//   3 groups, else 2: the dk/dv kernel holds two 64 x 64 accumulators a
//   thread, and three warpgroups get 168 registers a thread.  Slices: one
//   at D 192, two at 256 and 384, three at 320 (2, 2 and 1 groups), four at
//   512.  Only slice 0 writes the bias-gradient partials.
// - The streamed chunks of the slice are also written transposed
//   (zoo_tf32::transposed, in the fragment's row order, no shuffles), 32 x
//   64 NWG x 8 bytes: K in the dq kernel, Q and dO in the dk/dv kernel.
// - Shared memory a block, f32 / bf16: the transposed pieces (24 KB a
//   warpgroup and operand), three hi slots of 24 KB, two lo slots of 24 KB
//   (bf16: three staging slots of 12 KB), the streamed rows' m, 1 / l, D
//   and a bias row, three mbarriers and 1 KB to align: the dq kernel 153.6 /
//   141.6 KB with two warpgroups, 169.6 / 157.6 KB with three; the dk/dv
//   kernel 185.6 / 173.6 KB and 217.6 / 205.6 KB; one block an SM.
// - ptxas -v (CUDA 12.9): no spills in any of the eight instances;
//   registers in PERF.md section 6.
//
// Any other head dim (not a multiple of 64; only direct calls of
// flash_attention reach these, never the router, which sends multiples of
// 64 only): `bwd_simt_kernel<T, KV>`, the same two kernels on CUDA cores,
// with the head dim a runtime loop over 64-column chunks.  A block owns 64
// rows and one 64-column slice of their outputs, and recomputes S and dP
// over the whole head dim for it: D / 64 times the score work, which keeps
// shared memory at 105 KB at any head dim (two blocks an SM) and the
// outputs in registers.

#include <cuda.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_tf32.cuh"
#include "flash_tma.cuh"
#include "sm90.cuh"

namespace zoo_flash_bwd {

using zoo_flash::keep_base;
using zoo_flash::keep_k;
using zoo_flash::keep_q;
using zoo_flash::mix32;

// own rows a block (one warpgroup's M) and streamed rows a tile
using zoo_tf32::OWN;
using zoo_tf32::SR;
using zoo_tf32::a_frags;
using zoo_tf32::accumulate;
using zoo_tf32::issue_scores;
using zoo_tf32::kmajor;
using zoo_tf32::split4;
using zoo_tf32::transposed;
using zoo_tma::Maps;

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
  const int* q_seg;    // (B, Lq) and (B, Lk) segment ids, or both null
  const int* kv_seg;
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
  int vec;  // every row start aligned to 4 elements: vector loads
};

// Shared memory: four own pieces (own0 hi, lo; own1 hi, lo: 64 x D f32
// each), four streamed pieces (32 x D f32 each, row-major or transposed),
// the streamed rows' m, l, D, a bias row (the streamed keys' in the dq
// kernel, the own keys' in the dk/dv kernel), and room to align to 1024
// bytes.
__host__ __device__ constexpr int own_bytes(int D) { return OWN * D * 4; }
__host__ __device__ constexpr int str_bytes(int D) { return SR * D * 4; }
__host__ __device__ constexpr int smem_bytes(int D) {
  return 4 * own_bytes(D) + 4 * str_bytes(D) + (3 * SR + OWN) * 4 + 1024;
}

// Four 16-bit values as the chunked body's staging slot holds them, still
// packed two to a register.  f16's eight bytes have a type of their own
// (Half4), so the widening (to_float4) is picked by the type, never by the
// size.
struct Half4 {
  uint2 bits;
};
template <typename T> struct Raw4;
template <> struct Raw4<__nv_bfloat16> { using type = uint2; };
template <> struct Raw4<__half> { using type = Half4; };

__device__ __forceinline__ float4 to_float4(const uint2& x) {
  // bf16 -> f32 is a 16-bit shift
  return make_float4(__uint_as_float(x.x << 16),
                     __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
}
__device__ __forceinline__ float4 to_float4(const Half4& x) {
  // f16 -> f32 is a conversion (exact), a pair at a time
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(
      &x.bits.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(
      &x.bits.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// The chunks of an R-row tile a thread loads, splits and writes: rows
// lane + 32 rr, chunks warp + NW i (NW = D / 16 warps a block), so the
// 32 lanes of a store are 32 rows: the row-major stores hit every bank once
// per 8 lanes, the transposed ones once per warp.
template <int R>
__host__ __device__ constexpr int tile_chunks() { return R / 32 * 4; }

template <int D, int R>
__device__ __forceinline__ void load_tile(float4 (&raw)[tile_chunks<R>()],
                                          const float* src, int64_t ls,
                                          int r0, int len, bool vec) {
  constexpr int NW = D / 16;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
#pragma unroll
  for (int rr = 0; rr < R / 32; ++rr) {
    const int row = r0 + lane + 32 * rr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = wi + NW * i;
      raw[rr * 4 + i] = row < len ? load4(src + row * ls + 4 * ch, vec)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// 2^x to ~2 ulp; denormal results flush to zero
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Write a loaded tile as hi and lo pieces, K-major (row-major in D).
template <int D, int R>
__device__ __forceinline__ void store_kmajor(
    const float4 (&raw)[tile_chunks<R>()], uint8_t* hi, uint8_t* lo) {
  constexpr int NW = D / 16;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
#pragma unroll
  for (int rr = 0; rr < R / 32; ++rr)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off = kmajor<R>(lane + 32 * rr, wi + NW * i);
      uint4 h, l;
      split4(raw[rr * 4 + i], h, l);
      *reinterpret_cast<uint4*>(hi + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = l;
    }
}

// Write a loaded 32-row streamed tile as hi and lo pieces, transposed.
template <int D>
__device__ __forceinline__ void store_transposed(
    const float4 (&raw)[tile_chunks<SR>()], uint8_t* hi, uint8_t* lo) {
  constexpr int NW = D / 16;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d0 = 4 * (wi + NW * i);
    uint4 h, l;
    split4(raw[i], h, l);
    const uint32_t hv[4] = {h.x, h.y, h.z, h.w};
    const uint32_t lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = transposed(d0 + e, lane);
      *reinterpret_cast<uint32_t*>(hi + off) = hv[e];
      *reinterpret_cast<uint32_t*>(lo + off) = lv[e];
    }
  }
}

// f32 inputs.  KV = false: the dq kernel (own rows: queries; streamed:
// keys).  KV = true: the dk/dv kernel (own rows: keys; streamed: queries),
// which also writes the bias-gradient partials.
template <int D, bool KV>
__global__ void __launch_bounds__(2 * D, 1) bwd_kernel(Args a) {
  using namespace zoo_sm90;
  using T = float;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* own[4];  // own0 hi, own0 lo, own1 hi, own1 lo
  uint8_t* str[4];  // str0 hi, str0 lo, str1 hi, str1 lo (or transposed)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    own[i] = base + i * own_bytes(D);
    str[i] = base + 4 * own_bytes(D) + i * str_bytes(D);
  }
  float* Ms = reinterpret_cast<float*>(base + 4 * own_bytes(D) +
                                       4 * str_bytes(D));
  float* Ls = Ms + SR;
  float* Dm = Ls + SR;
  float* Bs = Dm + SR;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * OWN;  // first own row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int offset = a.Lk - a.Lq;  // end-aligned causal diagonal
  const bool vec = a.vec != 0;
  const T* q = static_cast<const T*>(a.q) + b * a.qs_b + h * a.qs_h;
  const T* gp = static_cast<const T*>(a.g) + b * a.gs_b + h * a.gs_h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks_b + h * a.ks_h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs_b + h * a.vs_h;
  const float* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.bs_b + h * a.bs_h;
  // a bias of one row per (batch, head), BERT's padding mask, or none: the
  // row goes through shared memory (zeros without a bias); any other bias
  // is read element by element
  const bool row_bias = bias == nullptr || a.bs_q == 0;
  const int64_t rows = (static_cast<int64_t>(b) * a.H + h) * a.Lq;
  const int64_t keys = (static_cast<int64_t>(b) * a.H + h) * a.Lk;
  // segment ids: the own rows' in registers, the streamed rows' read where
  // a pair is tested (only tiles with segment ids test every pair)
  const bool seg = a.q_seg != nullptr;
  const int* own_seg = !seg ? nullptr
                       : KV ? a.kv_seg + b * a.Lk : a.q_seg + b * a.Lq;
  const int* str_seg = !seg ? nullptr
                       : KV ? a.q_seg + b * a.Lq : a.kv_seg + b * a.Lk;

  // own0 / own1 and str0 / str1 with their row strides and lengths
  const T* o0 = KV ? k : q;
  const T* o1 = KV ? v : gp;
  const int64_t o0s = KV ? a.ks_l : a.qs_l, o1s = KV ? a.vs_l : a.gs_l;
  const int own_len = KV ? a.Lk : a.Lq;
  const T* s0 = KV ? q : k;
  const T* s1 = KV ? gp : v;
  const int64_t s0s = KV ? a.qs_l : a.ks_l, s1s = KV ? a.gs_l : a.vs_l;
  const int str_len = KV ? a.Lq : a.Lk;

  // the streamed range
  int sbeg = 0, send = str_len;
  if (a.causal) {
    if (KV) sbeg = max(0, r0 - offset) / SR * SR;
    else send = min(a.Lk, r0 + OWN + offset);
  }

  float4 raw0[tile_chunks<SR>()], raw1[tile_chunks<SR>()];
  // this thread's value of the streamed m, l or D rows (dk/dv kernel) or
  // of the streamed keys' bias row (dq kernel)
  float mld = 0.f;
  auto load_streamed = [&](int s) {
    load_tile<D, SR>(raw0, s0, s0s, s, str_len, vec);
    load_tile<D, SR>(raw1, s1, s1s, s, str_len, vec);
    if (KV && tid < 3 * SR) {
      const int qi = s + tid % SR;
      const int which = tid / SR;
      mld = which == 0 ? (qi < a.Lq ? a.m[rows + qi] : 0.f)
          : which == 1 ? (qi < a.Lq ? 1.f / fmaxf(a.l[rows + qi], 1e-20f)
                                    : 1.f)
                       : (qi < a.Lq ? a.dsum[rows + qi] : 0.f);
    }
    if (!KV && tid < SR)
      mld = bias != nullptr && row_bias && s + tid < a.Lk
                ? bias[(s + tid) * a.bs_k] : 0.f;
  };
  if (sbeg < send) load_streamed(sbeg);
  if (KV && tid < OWN)
    Bs[tid] = bias != nullptr && row_bias && r0 + tid < a.Lk
                  ? bias[(r0 + tid) * a.bs_k] : 0.f;
  {
    float4 own_raw[tile_chunks<OWN>()];
    load_tile<D, OWN>(own_raw, o0, o0s, r0, own_len, vec);
    store_kmajor<D, OWN>(own_raw, own[0], own[1]);
    load_tile<D, OWN>(own_raw, o1, o1s, r0, own_len, vec);
    store_kmajor<D, OWN>(own_raw, own[2], own[3]);
  }

  // this thread's own rows: warp * 16 + g + 8 hh, hh = 0, 1, with their
  // part of the dropout hash and, in the dq kernel, their m, 1 / l and D
  const uint32_t hash = keep_base(a.seed0, a.seed1, b, h);
  int rw[2];
  uint32_t rhash[2];
  float mr[2] = {0.f, 0.f}, lr[2] = {1.f, 1.f}, dr[2] = {0.f, 0.f};
  int rseg[2] = {0, 0};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rw[hh] = r0 + warp * 16 + g + 8 * hh;
    rhash[hh] = hash ^ (KV ? keep_k(rw[hh]) : keep_q(rw[hh]));
    if (seg && rw[hh] < own_len) rseg[hh] = own_seg[rw[hh]];
    if (!KV && rw[hh] < a.Lq) {
      mr[hh] = a.m[rows + rw[hh]];
      lr[hh] = 1.f / fmaxf(a.l[rows + rw[hh]], 1e-20f);
      dr[hh] = a.dsum[rows + rw[hh]];
    }
  }
  float acc0[32], acc1[32];  // dq, or dk and dv
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  float db[2] = {0.f, 0.f};

  for (int s = sbeg; s < send; s += SR) {
    // ---- phase 1: the streamed rows, row-major; S and dP ----------------
    __syncthreads();  // the previous tile's products are done
    store_kmajor<D, SR>(raw0, str[0], str[1]);
    store_kmajor<D, SR>(raw1, str[2], str[3]);
    if (KV && tid < 3 * SR) Ms[tid] = mld;  // Ms, Ls, Dm are contiguous
    if (!KV && tid < SR) Bs[tid] = mld;
    fence_proxy_async();
    __syncthreads();

    float sc[16], dp[16];
    wgmma_fence();
    issue_scores<D>(sc, smem_u32(own[0]), smem_u32(own[1]),
                    smem_u32(str[0]), smem_u32(str[1]));
    issue_scores<D>(dp, smem_u32(own[2]), smem_u32(own[3]),
                    smem_u32(str[2]), smem_u32(str[3]));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);
    fence_operand(dp);

    // ---- the softmax recompute on the fragments -------------------------
    // element i: own row rw[(i >> 1) & 1], streamed row
    // s + 8 (i >> 2) + 2 t + (i & 1).  Tiles inside the rows, the keys and
    // the causal triangle, without segment ids, skip the live test.
    const bool whole = !seg && s + SR <= str_len && r0 + OWN <= own_len &&
                       (!a.causal || (KV ? s + offset >= r0 + OWN - 1
                                         : r0 + offset >= s + SR - 1));
    float pt[16], ds[16];
    // branch-free per element: a tile takes one of two bodies, with the
    // bias row from shared memory or each bias element from global memory
    auto body = [&](auto row_tag) {
      constexpr bool ROWB = decltype(row_tag)::value;
      constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int hh = (i >> 1) & 1;
        const int sr = s + 8 * (i >> 2) + 2 * t + (i & 1);
        const int qi = KV ? sr : rw[hh];
        const int kj = KV ? rw[hh] : sr;
        const int c = sr - s;
        const float m = KV ? Ms[c] : mr[hh];
        const float inv_l = KV ? Ls[c] : lr[hh];
        const float dd = KV ? Dm[c] : dr[hh];
        const bool live = whole || (qi < a.Lq && kj < a.Lk &&
                                    (!a.causal || qi + offset >= kj) &&
                                    (!seg || rseg[hh] == str_seg[sr]));
        float bv;
        if constexpr (ROWB)
          bv = Bs[KV ? rw[hh] - r0 : c];
        else
          bv = bias[min(qi, a.Lq - 1) * a.bs_q + min(kj, a.Lk - 1) * a.bs_k];
        // exp(x - m) as 2^((x - m) log2 e): the plain version's rounding
        // of x - m, then one rounding of the scale
        const float e = fast_exp2((fmaf(sc[i], a.scale, bv) - m) * LOG2E);
        const float p = live ? e * inv_l : 0.f;
        // without dropout drop_thr is 0 and inv_keep 1: every bit pattern
        // keeps its element
        const float keep =
            mix32(rhash[hh] ^ (KV ? keep_q(sr) : keep_k(sr))) >= a.drop_thr
                ? a.inv_keep
                : 0.f;
        pt[i] = p * keep;
        ds[i] = live ? p * (keep * dp[i] - dd) : 0.f;
      }
    };
    if (row_bias)
      body(std::true_type());
    else
      body(std::false_type());
    if (KV && a.dbias != nullptr && wg == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) db[(i >> 1) & 1] += ds[i];
    }

    // ---- phase 2: the streamed rows, transposed; the output products ----
    __syncthreads();  // every warpgroup's S and dP products are done
    store_transposed<D>(raw0, str[0], str[1]);
    if (KV) store_transposed<D>(raw1, str[2], str[3]);
    if (s + SR < send) load_streamed(s + SR);
    fence_proxy_async();
    __syncthreads();

    uint32_t hi[4][4], lo[4][4];
    if (KV) {
      a_frags(pt, hi, lo);  // dv += (p t)^T dO
      accumulate<false>(acc1, hi, lo, smem_u32(str[2]), smem_u32(str[3]),
                        wg);
    }
    a_frags(ds, hi, lo);  // dq += dS k, or dk += dS^T q
    accumulate<false>(acc0, hi, lo, smem_u32(str[0]), smem_u32(str[1]), wg);
  }

  // element i: own row rw[(i >> 1) & 1], output column
  // 64 wg + 8 (i >> 2) + 2 t + (i & 1)
  T* out0 = static_cast<T*>(KV ? a.dk : a.dq);
  T* out1 = static_cast<T*>(a.dv);
  const int64_t first = KV ? keys : rows;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = rw[(i >> 1) & 1];
    if (r >= own_len) continue;
    const int64_t e = (first + r) * D + 64 * wg + 8 * (i >> 2) + 2 * t;
    zoo_flash::store_as(&out0[e], acc0[i] * a.scale);
    zoo_flash::store_as(&out0[e + 1], acc0[i + 1] * a.scale);
    if (KV) {
      zoo_flash::store_as(&out1[e], acc1[i]);
      zoo_flash::store_as(&out1[e + 1], acc1[i + 1]);
    }
  }
  if (KV && a.dbias != nullptr && wg == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = db[hh];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (t == 0 && rw[hh] < a.Lk) a.dbias[keys + rw[hh]] = x;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16, head dims 64 and 128: 16-bit wgmma (design note at the top
// of the file)
// ---------------------------------------------------------------------------

// Streamed rows a tile: 64, but 32 in the dk/dv kernel at head dim 128,
// whose dK and dV accumulators alone take 128 registers a thread.
__host__ __device__ constexpr int rows16(int D, bool kv) {
  return D == 128 && kv ? 32 : 64;
}
constexpr int NSTAGE = 2;  // ring stages of streamed tiles
// Bytes of an R-row 16-bit tile: D / 64 blocks of R 128-byte swizzled rows.
__host__ __device__ constexpr int tile16_bytes(int R, int D) {
  return R * D * 2;
}
// Shared memory: the own tiles (own0, own1), NSTAGE stages of the streamed
// tiles (str0, str1), each stage's streamed row values (2 NS f32), NSTAGE
// + 1 mbarriers and room to align to 1024 bytes.
__host__ __device__ constexpr int smem16_bytes(int D, bool kv) {
  return 2 * tile16_bytes(OWN, D) +
         NSTAGE * (2 * tile16_bytes(rows16(D, kv), D) + 2 * rows16(D, kv) * 4) +
         (NSTAGE + 1) * 8 + 1024;
}
static_assert(2 * smem16_bytes(128, false) <= 232448 &&
                  3 * smem16_bytes(64, false) <= 232448,
              "two blocks an SM at head dim 128, three at 64");

// f16: the exponent e = 14 - floor(log2 x) that brings a row's largest
// |dS| x (> 0, normal) into [2^14, 2^15) before it is rounded to f16.
// The kernel lifts each row's dS by 2^e clamped to [0, 100]
// (attention_bwd16_model's lift_exp), 100 for x = 0 or subnormal.
__device__ __forceinline__ int lift_exp_signed(float x) {
  return 141 - ((__float_as_int(x) >> 23) & 0xff);
}
__device__ __forceinline__ float exp2i(int e) {  // 2^e, |e| <= 126
  return __int_as_float((e + 127) << 23);
}

// d (64 x N) (+)= A . B^T, both K-major in shared memory (N = 32 or 64)
template <typename T, int N>
__device__ __forceinline__ void wgmma16_ss(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (N == 64)
    zoo_sm90::wgmma_m64n64k16_ss<T, 0>(d, da, db, scale_d);
  else
    zoo_sm90::wgmma_m64n32k16_ss<T, 0>(d, da, db, scale_d);
}
// d (64 x D) += A . B, A from registers, B MN-major in shared memory
template <typename T, int D>
__device__ __forceinline__ void wgmma16_rs(float (&d)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (D == 64)
    zoo_sm90::wgmma_m64n64k16_rs<T, 1>(d, a, db, 1);
  else
    zoo_sm90::wgmma_m64n128k16_rs<T, 1>(d, a, db, 1);
}

// The two kernels for 16-bit T (bf16 or f16) at head dim D (64 or 128),
// KV as in bwd_kernel: one warpgroup a block owns 64 rows; NS streamed rows
// a tile come through a ring of NSTAGE stages by tensor copies.  ROW: the
// bias is one row per (batch, head) or there is none (its values, times
// log2 e, go through shared memory with each tile in the dq kernel and sit
// in registers in the dk/dv kernel); otherwise each bias element is read
// from global memory.  Three blocks an SM at head dim 64 (registers capped
// at 168 a thread), two at 128 (shared memory).
template <typename T, int D, bool KV, bool ROW>
__global__ void __launch_bounds__(128, D == 64 ? 3 : 2)
    bwd16_kernel(Args a, const __grid_constant__ Maps maps) {
  using namespace zoo_sm90;
  static_assert(is_16bit_v<T>, "bf16 or f16");
  constexpr int NS = rows16(D, KV);
  constexpr int OWNB = tile16_bytes(OWN, D), STRB = tile16_bytes(NS, D);
  constexpr int NV = (KV ? 2 : 1) * NS;  // streamed row values a tile
  constexpr int NU = (NV + 127) / 128;   // of them a thread
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t own0 = smem_u32(base), own1 = own0 + OWNB;
  const uint32_t stages = own1 + OWNB;  // stage st: str0, then str1
  float* rowv = reinterpret_cast<float*>(base + 2 * OWNB + NSTAGE * 2 * STRB);
  const uint32_t bars = smem_u32(rowv + NSTAGE * 2 * NS);  // NSTAGE + own

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * OWN;  // first own row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int offset = a.Lk - a.Lq;  // end-aligned causal diagonal
  const float* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.bs_b + h * a.bs_h;
  const int64_t rows = (static_cast<int64_t>(b) * a.H + h) * a.Lq;
  const int64_t keys = (static_cast<int64_t>(b) * a.H + h) * a.Lk;
  const bool seg = a.q_seg != nullptr;
  const int* own_seg = !seg ? nullptr
                       : KV ? a.kv_seg + b * a.Lk : a.q_seg + b * a.Lq;
  const int* str_seg = !seg ? nullptr
                       : KV ? a.q_seg + b * a.Lq : a.kv_seg + b * a.Lk;
  const int own_len = KV ? a.Lk : a.Lq;
  const int str_len = KV ? a.Lq : a.Lk;
  int sbeg = 0, send = str_len;
  if (a.causal) {
    if (KV) sbeg = max(0, r0 - offset) / NS * NS;
    else send = min(a.Lk, r0 + OWN + offset);
  }
  const int ntiles = sbeg < send ? (send - sbeg + NS - 1) / NS : 0;

  // tile j of the streamed rows into stage j % NSTAGE: two tensor copies
  // from one thread, complete on the stage's mbarrier; rows past the
  // length read as zeros
  const CUtensorMap* sm0 = KV ? &maps.q : &maps.k;
  const CUtensorMap* sm1 = KV ? &maps.g : &maps.v;
  auto issue = [&](int j) {
    const int st = j % NSTAGE;
    const uint32_t bar = bars + 8 * st;
    const uint32_t dst = stages + st * 2 * STRB;
    fence_proxy_async();  // the stage's last readers are done
    mbar_arrive_tx(bar, 2 * STRB);
    tma_load_5d(dst, sm0, 0, sbeg + j * NS, 0, h, b, bar);
    tma_load_5d(dst + STRB, sm1, 0, sbeg + j * NS, 0, h, b, bar);
  };
  // the softmax recompute p = exp(x scale + bias - m) / l is
  // 2^(x scale log2 e + (bias log2 e - (m log2 e + log2 l))): one FMA of
  // the score with a bias term of its key and a term of its query.  This
  // thread's NU values of tile j's streamed rows, loaded one tile ahead
  // and stored into the tile's stage: the queries' m log2 e + log2 l and
  // D (dk/dv kernel), or the keys' bias times log2 e (dq kernel)
  float rv[NU];
  auto load_rows = [&](int j) {
    const int s = sbeg + j * NS;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int idx = tid + 128 * u;
      const int sr = s + idx % NS;
      if (KV)
        rv[u] = sr >= a.Lq ? 0.f
                : idx < NS ? fmaf(a.m[rows + sr], LOG2E,
                                  __log2f(fmaxf(a.l[rows + sr], 1e-20f)))
                           : a.dsum[rows + sr];
      else
        rv[u] = ROW && bias != nullptr && sr < a.Lk
                    ? bias[sr * a.bs_k] * LOG2E : 0.f;
    }
  };
  auto store_rows = [&](int j) {
    float* dst = rowv + j % NSTAGE * 2 * NS;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (tid + 128 * u < NV) dst[tid + 128 * u] = rv[u];
  };

  if (tid == 0)
    for (int j = 0; j <= NSTAGE; ++j) mbar_init(bars + 8 * j, 1);
  __syncthreads();
  if (tid == 0 && ntiles > 0) {
    const uint32_t bar = bars + 8 * NSTAGE;
    mbar_arrive_tx(bar, 2 * OWNB);
    tma_load_5d(own0, KV ? &maps.k : &maps.q, 0, r0, 0, h, b, bar);
    tma_load_5d(own1, KV ? &maps.v : &maps.g, 0, r0, 0, h, b, bar);
    for (int j = 0; j < NSTAGE && j < ntiles; ++j) issue(j);
  }
  if (ntiles > 0) {
    load_rows(0);
    store_rows(0);
  }

  // this thread's own rows: warp * 16 + g + 8 hh, hh = 0, 1, with their
  // part of the dropout hash, segment ids and, in the dq kernel, their m
  // log2 e + log2 l and D; in the dk/dv kernel their bias times log2 e
  const uint32_t hash = keep_base(a.seed0, a.seed1, b, h);
  int rw[2], rseg[2] = {0, 0};
  uint32_t rhash[2];
  float ml[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f}, ob[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rw[hh] = r0 + warp * 16 + g + 8 * hh;
    rhash[hh] = hash ^ (KV ? keep_k(rw[hh]) : keep_q(rw[hh]));
    if (seg && rw[hh] < own_len) rseg[hh] = own_seg[rw[hh]];
    if (!KV && rw[hh] < a.Lq) {
      ml[hh] = fmaf(a.m[rows + rw[hh]], LOG2E,
                    __log2f(fmaxf(a.l[rows + rw[hh]], 1e-20f)));
      dr[hh] = a.dsum[rows + rw[hh]];
    }
    if (KV && ROW && bias != nullptr && rw[hh] < a.Lk)
      ob[hh] = bias[rw[hh] * a.bs_k] * LOG2E;
  }
  const float sl2 = a.scale * LOG2E;
  float acc0[D / 2], acc1[KV ? D / 2 : 1];  // dq, or dk and dv
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (KV ? D / 2 : 1); ++i) acc1[i] = 0.f;
  float db[2] = {0.f, 0.f};
  // f16: acc0's own rows hold 2^ex[hh] times their sums (ex only falls)
  int ex[2] = {100, 100};
  __syncthreads();  // tile 0's row values
  if (ntiles > 0) mbar_wait(bars + 8 * NSTAGE, 0);

  auto kdesc = [](uint32_t tile, int r, int kk) {  // K-major, k-step kk
    return desc_b128(tile + (kk >> 2) * (r * 128) + (kk & 3) * 32, 16, 1024);
  };
  for (int j = 0; j < ntiles; ++j) {
    const int s = sbeg + j * NS;
    const int st = j % NSTAGE;
    const uint32_t s0 = stages + st * 2 * STRB, s1 = s0 + STRB;
    const float* rvs = rowv + st * 2 * NS;
    if (j + 1 < ntiles) load_rows(j + 1);
    mbar_wait(bars + 8 * st, (j / NSTAGE) & 1);

    // S = own0 . str0^T and dP = own1 . str1^T, two groups: the softmax
    // recompute runs while dP is multiplied
    float sc[NS / 2], dp[NS / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma16_ss<T, NS>(sc, kdesc(own0, OWN, kk), kdesc(s0, NS, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma16_ss<T, NS>(dp, kdesc(own1, OWN, kk), kdesc(s1, NS, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operand(sc);

    // element i: own row rw[(i >> 1) & 1], streamed row s + c,
    // c = 8 (i >> 2) + 2 t + (i & 1)
    const bool whole = !seg && s + NS <= str_len && r0 + OWN <= own_len &&
                       (!a.causal || (KV ? s + offset >= r0 + OWN - 1
                                         : r0 + offset >= s + NS - 1));
    // the hash's streamed-row part, (s + c) times its constant: a part of
    // the tile and the thread, plus one of the element
    const uint32_t sh = KV ? keep_q(s + 2 * t) : keep_k(s + 2 * t);
    uint32_t kept = 0;  // bit i: the hash keeps element i
    // f16: p is formed lifted, 2^(... + ex), so that dS comes out lifted
    // with no multiply; P t is brought back by the row's 2^-ex
    float ik[2] = {a.inv_keep, a.inv_keep};  // 1 / (1 - p) 2^-ex
    auto lifted = [&](float x, int hh) {
      if constexpr (is_f16_v<T>)
        return x + static_cast<float>(ex[hh]);
      else
        return x;
    };
    if constexpr (is_f16_v<T>) {
      ik[0] = a.inv_keep * exp2i(-ex[0]);
      ik[1] = a.inv_keep * exp2i(-ex[1]);
    }
    // p (f16: lifted) and the keep bits; with a bias row, tiles inside the
    // lengths and the causal triangle, without segment ids (WHOLE), take a
    // body with no live test (a sixth off the dk/dv kernel's time,
    // tools/flash_bwd_variants.py; a second body for the full bias would
    // only add spills)
    auto probs = [&](auto whole_tag) {
      constexpr bool WHOLE = decltype(whole_tag)::value;
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {
        const int hh = (i >> 1) & 1;
        const int c = 8 * (i >> 2) + 2 * t + (i & 1);
        const int sr = s + c;
        const int qi = KV ? sr : rw[hh];
        const int kj = KV ? rw[hh] : sr;
        const bool live = WHOLE || (qi < a.Lq && kj < a.Lk &&
                                    (!a.causal || qi + offset >= kj) &&
                                    (!seg || rseg[hh] == str_seg[sr]));
        float u;  // bias log2 e - (m log2 e + log2 l) (+ ex in f16)
        if constexpr (ROW)
          u = KV ? lifted(ob[hh], hh) - rvs[c]
                 : rvs[c] - (ml[hh] - lifted(0.f, hh));
        else
          u = fmaf(bias[min(qi, a.Lq - 1) * a.bs_q +
                        min(kj, a.Lk - 1) * a.bs_k],
                   LOG2E, lifted(-(KV ? rvs[c] : ml[hh]), hh));
        const float e = fast_exp2(fmaf(sc[i], sl2, u));
        sc[i] = live ? e : 0.f;
        const uint32_t part =
            sh + (KV ? keep_q(8 * (i >> 2) + (i & 1))
                     : keep_k(8 * (i >> 2) + (i & 1)));
        const bool keep =
            !a.dropout || mix32(rhash[hh] ^ part) >= a.drop_thr;
        kept |= static_cast<uint32_t>(keep) << i;
      }
    };
    if (ROW && whole)
      probs(std::bool_constant<ROW>());
    else
      probs(std::false_type());
    if constexpr (KV) {  // dv += (P t)^T dO, while dP finishes
      uint32_t pa[NS / 16][4];  // P t in T, the register A operand
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          pa[kk][r] = pack2<T>(kept >> i & 1 ? sc[i] * ik[r & 1] : 0.f,
                               kept >> (i + 1) & 1 ? sc[i + 1] * ik[r & 1]
                                                    : 0.f);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk)
        wgmma16_rs<T, D>(acc1, pa[kk], desc_b128(s1 + kk * 2048, NS * 128,
                                                 1024));
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_operand(dp);

    // dS = p (t dP - D), zero where p is (f16: lifted by 2^ex)
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      const int c = 8 * (i >> 2) + 2 * t + (i & 1);
      const float keep = kept >> i & 1 ? a.inv_keep : 0.f;
      dp[i] = sc[i] * (keep * dp[i] - (KV ? rvs[NS + c] : dr[(i >> 1) & 1]));
    }
    if constexpr (is_f16_v<T>) {
      // each own row's dS lifted by 2^ex before it is rounded to f16; where
      // the tile's largest lifted |dS| reaches 2^15, ex falls to this
      // tile's lift (lift_exp of its largest |dS|, no lower than 0), and
      // acc0's row is brought to the new scale first (powers of two:
      // exact).  Where ex stays the multiplies are by 1: a warp-uniform
      // branch around them measured no faster in this body, and a quarter
      // slower in an earlier one (tools/flash_bwd_variants.py).
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = 0.f;
#pragma unroll
        for (int i = 0; i < NS / 2; ++i)
          if (((i >> 1) & 1) == hh) mx = fmaxf(mx, fabsf(dp[i]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const int fall = mx >= 32768.f ? max(lift_exp_signed(mx), -ex[hh])
                                       : 0;
        ex[hh] += fall;
        const float f = exp2i(fall);
#pragma unroll
        for (int i = 0; i < D / 2; ++i)
          if (((i >> 1) & 1) == hh) acc0[i] *= f;
#pragma unroll
        for (int i = 0; i < NS / 2; ++i)
          if (((i >> 1) & 1) == hh) dp[i] *= f;
      }
    }
    if (KV && a.dbias != nullptr) {  // the bias gradient sums dS
      float il[2] = {1.f, 1.f};
      if constexpr (is_f16_v<T>) {
        il[0] = exp2i(-ex[0]);
        il[1] = exp2i(-ex[1]);
      }
#pragma unroll
      for (int i = 0; i < NS / 2; ++i)
        db[(i >> 1) & 1] = fmaf(dp[i], il[(i >> 1) & 1], db[(i >> 1) & 1]);
    }
    // dq += dS k, or dk += dS^T q
    uint32_t da[NS / 16][4];
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = pack2<T>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    fence_operand(acc0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk)
      wgmma16_rs<T, D>(acc0, da[kk], desc_b128(s0 + kk * 2048, NS * 128,
                                               1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc0);
    if (KV) fence_operand(acc1);
    if (j + 1 < ntiles) store_rows(j + 1);
    __syncthreads();  // stage st and its row values are free
    if (tid == 0 && j + NSTAGE < ntiles) issue(j + NSTAGE);
  }

  // element i: own row rw[(i >> 1) & 1], output column 8 (i >> 2) + 2 t
  // + (i & 1); stored in pairs
  T* out0 = static_cast<T*>(KV ? a.dk : a.dq);
  T* out1 = static_cast<T*>(a.dv);
  const int64_t first = KV ? keys : rows;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rw[hh];
    if (r >= own_len) continue;
    const float post = a.scale * (is_f16_v<T> ? exp2i(-ex[hh]) : 1.f);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * hh;
      const int64_t e = (first + r) * D + 8 * c + 2 * t;
      *reinterpret_cast<uint32_t*>(&out0[e]) =
          pack2<T>(acc0[i] * post, acc0[i + 1] * post);
      if (KV)
        *reinterpret_cast<uint32_t*>(&out1[e]) =
            pack2<T>(acc1[i], acc1[i + 1]);
    }
  }
  if (KV && a.dbias != nullptr) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = db[hh];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (t == 0 && rw[hh] < a.Lk) a.dbias[keys + rw[hh]] = x;
    }
  }
}

// ---------------------------------------------------------------------------
// Head dims above 128 that are multiples of 64: 3xTF32 wgmma over 32-column
// chunks (design note at the top of the file)
// ---------------------------------------------------------------------------

constexpr int CW = 32;                    // columns a chunk (128 f32 bytes)
constexpr int OWN_PIECE = OWN * CW * 4;   // a 64 x 32 f32 piece: 8 KB
constexpr int STR_PIECE = SR * CW * 4;    // a 32 x 32 f32 piece: 4 KB
// The pieces of a chunk, K-major: a hi slot (own0, own1, str0, str1) and,
// for f32, a lo slot of the same layout.  f32 rows land in the hi slot as
// loaded and are split there (hi in place, lo into the lo slot); bf16 and
// f16 rows land in a staging slot (rows of 64 bytes) and are widened into
// the hi slot.
constexpr int HALF_SLOT = 2 * OWN_PIECE + 2 * STR_PIECE;  // 24 KB
constexpr int BF_ROW = CW * 2;
constexpr int BF_SLOT = (2 * OWN + 2 * SR) * BF_ROW;       // 12 KB
constexpr int NSLOT = 3;  // hi (and staging) slots: two chunks in flight
// 4-value units of a chunk: 1024 of the own rows, then 512 streamed
constexpr int OWN_UNITS = 2 * OWN * CW / 4;
constexpr int CHUNK_UNITS = OWN_UNITS + 2 * SR * CW / 4;
// Warpgroups a block: 3 where the head dim has a multiple of 3 groups of
// 64 columns, else 2 (the dk/dv kernel holds two 64 x 64 accumulators a
// thread, and 128 NWG threads share 64 K registers).  Every warpgroup
// issues the same wgmma sequence: a warpgroup-dependent branch around
// wgmma makes ptxas serialize them all.
__host__ __device__ constexpr int wide_warpgroups(int D) {
  return D / 64 % 3 == 0 ? 3 : 2;
}
// One transposed piece: the slice's 64 NWG columns as rows of 32 values.
__host__ __device__ constexpr int wide_t_bytes(int nwg) {
  return nwg * 64 * 128;
}
// Transposed str0 hi, lo (and str1 hi, lo in the dk/dv kernel); NSLOT hi
// slots; two lo slots (f32) or NSLOT staging slots (16-bit); the streamed
// rows' m, 1 / l, D and a bias row; an mbarrier a slot; room to align to
// 1024 bytes.
__host__ __device__ constexpr int wide_smem_bytes(bool kv, int nwg,
                                                  bool exact) {
  return (kv ? 4 : 2) * wide_t_bytes(nwg) + NSLOT * HALF_SLOT +
         (exact ? NSLOT * BF_SLOT : 2 * HALF_SLOT) + (3 * SR + OWN) * 4 +
         NSLOT * 8 + 1024;
}

// The chunked kernels' tensor maps of q, k, v and dO: (D, L, H, B) with
// boxes of 32 columns x 32 rows (flash_tma.cuh).
static_assert(wide_smem_bytes(true, 3, false) <= 232448,
              "a block may have 227 KB of shared memory");

// Warpgroup wg's part of sc += own0 . str0^T and dp += own1 . str1^T over
// one 32-column chunk, from its hi and lo slots; the two accumulators'
// products alternate.  Three warpgroups take one product of the three
// each (lo . hi, hi . lo, hi . hi: summed in that order they are the lo
// products first), over all 4 k-steps; 16-bit (EXACT: hi . hi only) there
// has every warpgroup form the whole of S and dP.  Two split the k-steps:
// wg and wg + 2, lo products first, then hi * hi.
template <bool EXACT, int NWG>
__device__ __forceinline__ void chunk_scores(float (&sc)[16], float (&dp)[16],
                                             uint32_t hi, uint32_t lo,
                                             int wg) {
  static_assert(NWG == 2 || NWG == 3, "two or three warpgroups");
  using zoo_sm90::desc_b128;
  using zoo_sm90::wgmma_tf32_m64n32k8_ss;
  // own0, own1 at 0, OWN_PIECE; str0, str1 after them
  auto da = [](uint32_t slot, int which, int kk) {
    return desc_b128(slot + which * OWN_PIECE + kk * 32, 16, 1024);
  };
  auto db = [](uint32_t slot, int which, int kk) {
    return desc_b128(slot + 2 * OWN_PIECE + which * STR_PIECE + kk * 32, 16,
                     1024);
  };
  if constexpr (NWG == 3) {
    const uint32_t a = !EXACT && wg == 0 ? lo : hi;
    const uint32_t b = !EXACT && wg == 1 ? lo : hi;
#pragma unroll
    for (int kk = 0; kk < CW / 8; ++kk) {
      wgmma_tf32_m64n32k8_ss(sc, da(a, 0, kk), db(b, 0, kk), 1);
      wgmma_tf32_m64n32k8_ss(dp, da(a, 1, kk), db(b, 1, kk), 1);
    }
    return;
  }
  if (!EXACT) {
#pragma unroll
    for (int j = 0; j < CW / 8 / NWG; ++j) {
      const int kk = wg + NWG * j;
      wgmma_tf32_m64n32k8_ss(sc, da(lo, 0, kk), db(hi, 0, kk), 1);
      wgmma_tf32_m64n32k8_ss(dp, da(lo, 1, kk), db(hi, 1, kk), 1);
      wgmma_tf32_m64n32k8_ss(sc, da(hi, 0, kk), db(lo, 0, kk), 1);
      wgmma_tf32_m64n32k8_ss(dp, da(hi, 1, kk), db(lo, 1, kk), 1);
    }
  }
#pragma unroll
  for (int j = 0; j < CW / 8 / NWG; ++j) {
    const int kk = wg + NWG * j;
    wgmma_tf32_m64n32k8_ss(sc, da(hi, 0, kk), db(hi, 0, kk), 1);
    wgmma_tf32_m64n32k8_ss(dp, da(hi, 1, kk), db(hi, 1, kk), 1);
  }
}

// The two kernels at a head dim D > 128, D % 64 == 0 (KV as in bwd_kernel).
// NWG warpgroups a block; a block owns 64 rows and the output columns of
// the 64-column groups g0 .. g0 + NWG - 1 (its slice, blockIdx.x = row tile
// x slices + slice) and computes S and dP over the whole head dim for them.
template <typename T, bool KV, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
    bwd_wide_kernel(Args a, const __grid_constant__ Maps maps, int D) {
  using namespace zoo_sm90;
  constexpr bool EXACT = zoo_sm90::is_16bit_v<T>;  // lo pieces are zero
  constexpr int NT = 128 * NWG;
  constexpr int U = CHUNK_UNITS / NT;     // units of a chunk a thread
  static_assert(CHUNK_UNITS % NT == 0, "a chunk splits evenly");
  constexpr int TB = wide_t_bytes(NWG);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* tp = base;                        // transposed pieces
  uint8_t* his = base + (KV ? 4 : 2) * TB;   // NSLOT hi slots
  uint8_t* aux = his + NSLOT * HALF_SLOT;    // lo or staging slots
  float* Ms = reinterpret_cast<float*>(
      aux + (EXACT ? NSLOT * BF_SLOT : 2 * HALF_SLOT));
  float* Ls = Ms + SR;
  float* Dm = Ls + SR;
  float* Bs = Dm + SR;
  const uint32_t full = smem_u32(Bs + OWN);  // NSLOT mbarriers: chunk landed

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nch = D / CW;
  const int ns = (D / 64 + NWG - 1) / NWG;  // slices
  const int slice = blockIdx.x % ns;
  const int r0 = blockIdx.x / ns * OWN;     // first own row
  const int g0 = slice * NWG;               // first 64-column group
  const int nout = min(NWG, D / 64 - g0);   // warpgroups with outputs
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int offset = a.Lk - a.Lq;  // end-aligned causal diagonal
  const float* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.bs_b + h * a.bs_h;
  const bool row_bias = bias == nullptr || a.bs_q == 0;
  const int64_t rows = (static_cast<int64_t>(b) * a.H + h) * a.Lq;
  const int64_t keys = (static_cast<int64_t>(b) * a.H + h) * a.Lk;
  const bool seg = a.q_seg != nullptr;
  const int* own_seg = !seg ? nullptr
                       : KV ? a.kv_seg + b * a.Lk : a.q_seg + b * a.Lq;
  const int* str_seg = !seg ? nullptr
                       : KV ? a.q_seg + b * a.Lq : a.kv_seg + b * a.Lk;
  const int own_len = KV ? a.Lk : a.Lq;
  const int str_len = KV ? a.Lq : a.Lk;

  int sbeg = 0, send = str_len;
  if (a.causal) {
    if (KV) sbeg = max(0, r0 - offset) / SR * SR;
    else send = min(a.Lk, r0 + OWN + offset);
  }
  const int ntiles = sbeg < send ? (send - sbeg + SR - 1) / SR : 0;

  // A chunk's unit (which, row, ch: 4 values) lies in a hi or lo slot at
  // piece(is_own, which) + kmaj(row, ch), in a staging slot at bf_off.
  auto piece = [](bool is_own, int which) {
    return is_own ? which * OWN_PIECE : 2 * OWN_PIECE + which * STR_PIECE;
  };
  auto kmaj = [](bool is_own, int row, int ch) {
    return is_own ? kmajor<OWN>(row, ch) : kmajor<SR>(row, ch);
  };
  auto bf_off = [](bool is_own, int which, int row, int ch) {
    return ((is_own ? which * OWN : 2 * OWN + which * SR) + row) * BF_ROW +
           ch * 8;
  };
  // Copy chunk n (chunk c of the own rows and of the streamed rows s .. s
  // + 31) into hi slot (f32) or staging slot (16-bit) st = n % NSLOT: six
  // tensor copies from one thread, which complete on the slot's mbarrier;
  // rows past the lengths are zeros.
  auto tma_chunk = [&](int st, int s, int c) {
    const uint32_t bar = full + 8 * st;
    const uint32_t dst = EXACT ? smem_u32(aux + st * BF_SLOT)
                               : smem_u32(his + st * HALF_SLOT);
    const int half = EXACT ? 32 * BF_ROW : 32 * 128;  // 32 rows' bytes
    fence_proxy_async();  // the slot's last readers were generic too
    mbar_arrive_tx(bar, 6 * 32 * CW * sizeof(T));
    const CUtensorMap* om0 = KV ? &maps.k : &maps.q;
    const CUtensorMap* om1 = KV ? &maps.v : &maps.g;
    const CUtensorMap* sm0 = KV ? &maps.q : &maps.k;
    const CUtensorMap* sm1 = KV ? &maps.g : &maps.v;
    const uint32_t own_b = EXACT ? OWN * BF_ROW : OWN_PIECE;
    const uint32_t str_b = EXACT ? SR * BF_ROW : STR_PIECE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tma_load_4d(dst + j * half, om0, c * CW, r0 + 32 * j, h, b, bar);
      tma_load_4d(dst + own_b + j * half, om1, c * CW, r0 + 32 * j, h, b,
                  bar);
    }
    tma_load_4d(dst + 2 * own_b, sm0, c * CW, s, h, b, bar);
    tma_load_4d(dst + 2 * own_b + str_b, sm1, c * CW, s, h, b, bar);
  };
  // Complete chunk n (chunk c of a tile): f32 its lo slot n % 2 from the
  // hi slot, 16-bit its hi slot from the staging slot; a streamed chunk of
  // the block's slice also transposed, hi and lo (str0, and str1 in the
  // dk/dv kernel).  Own units: 8 lanes a row; streamed units: lane = row,
  // so that the transposed stores hit every bank once a warp.
  auto complete_chunk = [&](int n, int c) {
    uint8_t* hs = his + n % NSLOT * HALF_SLOT;
    const int tc = c - 2 * g0;  // chunk within the slice
    const bool in_slice = tc >= 0 && tc < 2 * nout;
    auto unit = [&](int i) {
      const int u = tid + NT * i;
      const bool is_own = u < OWN_UNITS;
      const int w = is_own ? u : u - OWN_UNITS;
      const int which = is_own ? w >> 9 : w >> 8;
      const int row = is_own ? (w >> 3) & (OWN - 1) : w & (SR - 1);
      const int ch = is_own ? w & 7 : (w >> 5) & 7;
      const uint32_t off = piece(is_own, which) + kmaj(is_own, row, ch);
      uint32_t h4[4], l4[4];
      if constexpr (EXACT) {
        // widened by the type: bf16 a shift, f16 a conversion
        const float4 x = to_float4(
            *reinterpret_cast<const typename Raw4<T>::type*>(
                aux + n % NSLOT * BF_SLOT + bf_off(is_own, which, row, ch)));
        h4[0] = __float_as_uint(x.x), h4[1] = __float_as_uint(x.y);
        h4[2] = __float_as_uint(x.z), h4[3] = __float_as_uint(x.w);
        *reinterpret_cast<uint4*>(hs + off) =
            make_uint4(h4[0], h4[1], h4[2], h4[3]);
      } else {
        const uint4 x = *reinterpret_cast<const uint4*>(hs + off);
        const uint32_t x4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(x4[e]), h4[e], l4[e]);
        *reinterpret_cast<uint4*>(hs + off) =
            make_uint4(h4[0], h4[1], h4[2], h4[3]);
        *reinterpret_cast<uint4*>(aux + n % 2 * HALF_SLOT + off) =
            make_uint4(l4[0], l4[1], l4[2], l4[3]);
      }
      if (!is_own && in_slice && (KV || which == 0)) {
        uint8_t* th = tp + 2 * which * TB;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t toff = transposed(CW * tc + 4 * ch + e, row);
          *reinterpret_cast<uint32_t*>(th + toff) = h4[e];
          if (!EXACT) *reinterpret_cast<uint32_t*>(th + TB + toff) = l4[e];
        }
      }
    };
#pragma unroll
    for (int i = 0; i < U; ++i) unit(i);
  };
  // chunks in the order (streamed tile, chunk): NSLOT - 1 in flight ahead
  // of the one multiplied; chunk n's copies land in its slot's phase
  // n / NSLOT
  const int nall = ntiles * nch;
  auto issue = [&](int n) {
    if (tid == 0 && n < nall)
      tma_chunk(n % NSLOT, sbeg + SR * (n / nch), n % nch);
  };
  auto landed = [&](int n) {
    mbar_wait(full + 8 * (n % NSLOT), (n / NSLOT) & 1);
  };

  float mld = 0.f;  // as in bwd_kernel: streamed m, 1 / l, D, or bias
  auto load_rowvals = [&](int s) {
    if (KV && tid < 3 * SR) {
      const int qi = s + tid % SR;
      const int which = tid / SR;
      mld = which == 0 ? (qi < a.Lq ? a.m[rows + qi] : 0.f)
          : which == 1 ? (qi < a.Lq ? 1.f / fmaxf(a.l[rows + qi], 1e-20f)
                                    : 1.f)
                       : (qi < a.Lq ? a.dsum[rows + qi] : 0.f);
    }
    if (!KV && tid < SR)
      mld = bias != nullptr && row_bias && s + tid < a.Lk
                ? bias[(s + tid) * a.bs_k] : 0.f;
  };
  if (tid == 0)
    for (int j = 0; j < NSLOT; ++j) mbar_init(full + 8 * j, 1);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NSLOT - 1; ++j) issue(j);
  if (ntiles) load_rowvals(sbeg);
  if (KV && tid < OWN)
    Bs[tid] = bias != nullptr && row_bias && r0 + tid < a.Lk
                  ? bias[(r0 + tid) * a.bs_k] : 0.f;

  const uint32_t hash = keep_base(a.seed0, a.seed1, b, h);
  int rw[2];
  uint32_t rhash[2];
  float mr[2] = {0.f, 0.f}, lr[2] = {1.f, 1.f}, dr[2] = {0.f, 0.f};
  int rseg[2] = {0, 0};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rw[hh] = r0 + warp * 16 + g + 8 * hh;
    rhash[hh] = hash ^ (KV ? keep_k(rw[hh]) : keep_q(rw[hh]));
    if (seg && rw[hh] < own_len) rseg[hh] = own_seg[rw[hh]];
    if (!KV && rw[hh] < a.Lq) {
      mr[hh] = a.m[rows + rw[hh]];
      lr[hh] = 1.f / fmaxf(a.l[rows + rw[hh]], 1e-20f);
      dr[hh] = a.dsum[rows + rw[hh]];
    }
  }
  float acc0[32], acc1[32];  // dq, or dk and dv: this warpgroup's columns
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  float db[2] = {0.f, 0.f};
  const int lt = tid & 127;
  // the warpgroups' partial S and dP (16 KB a warpgroup) go through the
  // lo slots (f32) or the hi slots (16-bit), free between tiles
  float* red = reinterpret_cast<float*>(EXACT ? his : aux);
  static_assert(NWG * 16384 <= 2 * HALF_SLOT, "the partials fit");

  int n = 0;  // the chunk being multiplied
  for (int s = sbeg; s < send; s += SR) {
    // ---- S and dP: each warpgroup sums its part of every chunk --------
    float sc[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
    landed(n);  // the tile's first chunk
    __syncthreads();  // and the last tile's readers are done
    complete_chunk(n, 0);
    if (KV && tid < 3 * SR) Ms[tid] = mld;  // Ms, Ls, Dm contiguous
    if (!KV && tid < SR) Bs[tid] = mld;
    if (s + SR < send) load_rowvals(s + SR);
    fence_proxy_async();
    __syncthreads();
    for (int c = 0; c < nch; ++c, ++n) {
      // chunk n's products run while chunk n + NSLOT - 1 is copied (into
      // the slots chunk n - 1 left) and chunk n + 1 is completed
      wgmma_fence();
      chunk_scores<EXACT, NWG>(sc, dp, smem_u32(his + n % NSLOT * HALF_SLOT),
                               smem_u32(aux + n % 2 * HALF_SLOT), wg);
      wgmma_commit();
      issue(n + NSLOT - 1);
      if (c + 1 < nch) {
        landed(n + 1);
        complete_chunk(n + 1, c + 1);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      fence_operand(sc);
      fence_operand(dp);
      __syncthreads();  // chunk n + 1 complete; chunk n's slots free
    }
    // ---- S and dP summed and the softmax recompute, shared out: each
    // warpgroup adds the partials of its share of the 16 fragment elements
    // a thread holds, in warpgroup order (16-bit on three warpgroups holds
    // whole values already), forms P t and dS for them as bwd_kernel does,
    // and passes them on through the last chunk's hi slot (f32) or the
    // third hi slot (16-bit), free between tiles.  Partials and results are
    // planes of one value a thread.
    float* pts = reinterpret_cast<float*>(
        his + (EXACT ? 2 : (n - 1) % NSLOT) * HALF_SLOT);
    float* dss = pts + 16 * 128;
    constexpr bool PARTIALS = !EXACT || NWG != 3;
    if (PARTIALS) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        red[(wg * 32 + i) * 128 + lt] = sc[i];
        red[(wg * 32 + 16 + i) * 128 + lt] = dp[i];
      }
      __syncthreads();
    }
    const bool whole = !seg && s + SR <= str_len && r0 + OWN <= own_len &&
                       (!a.causal || (KV ? s + offset >= r0 + OWN - 1
                                         : r0 + offset >= s + SR - 1));
    // elements LO .. HI - 1, with the bias row from shared memory (ROWB) or
    // each bias element from global memory
    auto share = [&](auto row_tag, auto lo_tag, auto hi_tag) {
      constexpr bool ROWB = decltype(row_tag)::value;
      constexpr int LO = decltype(lo_tag)::value, HI = decltype(hi_tag)::value;
      constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
      for (int i = LO; i < HI; ++i) {
        float x = sc[i], y = dp[i];
        if (PARTIALS) {
          x = y = 0.f;
#pragma unroll
          for (int w = 0; w < NWG; ++w) {
            x += red[(w * 32 + i) * 128 + lt];
            y += red[(w * 32 + 16 + i) * 128 + lt];
          }
        }
        const int hh = (i >> 1) & 1;
        const int sr = s + 8 * (i >> 2) + 2 * t + (i & 1);
        const int qi = KV ? sr : rw[hh];
        const int kj = KV ? rw[hh] : sr;
        const int c = sr - s;
        const float m = KV ? Ms[c] : mr[hh];
        const float inv_l = KV ? Ls[c] : lr[hh];
        const float dd = KV ? Dm[c] : dr[hh];
        const bool live = whole || (qi < a.Lq && kj < a.Lk &&
                                    (!a.causal || qi + offset >= kj) &&
                                    (!seg || rseg[hh] == str_seg[sr]));
        float bv;
        if constexpr (ROWB)
          bv = Bs[KV ? rw[hh] - r0 : c];
        else
          bv = bias[min(qi, a.Lq - 1) * a.bs_q + min(kj, a.Lk - 1) * a.bs_k];
        const float e = fast_exp2((fmaf(x, a.scale, bv) - m) * LOG2E);
        const float p = live ? e * inv_l : 0.f;
        const float keep =
            mix32(rhash[hh] ^ (KV ? keep_q(sr) : keep_k(sr))) >= a.drop_thr
                ? a.inv_keep
                : 0.f;
        if (KV) pts[i * 128 + lt] = p * keep;
        dss[i * 128 + lt] = live ? p * (keep * y - dd) : 0.f;
      }
    };
    auto shares = [&](auto row_tag) {
      using std::integral_constant;
      if constexpr (NWG == 3) {
        if (wg == 0)
          share(row_tag, integral_constant<int, 0>(),
                integral_constant<int, 6>());
        else if (wg == 1)
          share(row_tag, integral_constant<int, 6>(),
                integral_constant<int, 11>());
        else
          share(row_tag, integral_constant<int, 11>(),
                integral_constant<int, 16>());
      } else {
        if (wg == 0)
          share(row_tag, integral_constant<int, 0>(),
                integral_constant<int, 8>());
        else
          share(row_tag, integral_constant<int, 8>(),
                integral_constant<int, 16>());
      }
    };
    if (row_bias)
      shares(std::true_type());
    else
      shares(std::false_type());
    __syncthreads();

    // ---- the output products over the transposed streamed rows (every
    // warpgroup issues them; one past the slice's columns stores nothing),
    // P t and dS read back one at a time
    uint32_t hi[4][4], lo[4][4];
    if (KV) {  // dv += (p t)^T dO
      float pt[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) pt[i] = pts[i * 128 + lt];
      a_frags(pt, hi, lo);
      accumulate<EXACT>(acc1, hi, lo, smem_u32(tp + 2 * TB),
                        smem_u32(tp + 3 * TB), wg);
    }
    float ds[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) ds[i] = dss[i * 128 + lt];
    if (KV && a.dbias != nullptr && slice == 0 && wg == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) db[(i >> 1) & 1] += ds[i];
    }
    a_frags(ds, hi, lo);  // dq += dS k, or dk += dS^T q
    accumulate<EXACT>(acc0, hi, lo, smem_u32(tp), smem_u32(tp + TB), wg);
  }

  T* out0 = static_cast<T*>(KV ? a.dk : a.dq);
  T* out1 = static_cast<T*>(a.dv);
  const int64_t first = KV ? keys : rows;
  if (wg < nout) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = rw[(i >> 1) & 1];
      if (r >= own_len) continue;
      const int64_t e =
          (first + r) * D + (g0 + wg) * 64 + 8 * (i >> 2) + 2 * t;
      zoo_flash::store_as(&out0[e], acc0[i] * a.scale);
      zoo_flash::store_as(&out0[e + 1], acc0[i + 1] * a.scale);
      if (KV) {
        zoo_flash::store_as(&out1[e], acc1[i]);
        zoo_flash::store_as(&out1[e + 1], acc1[i + 1]);
      }
    }
  }
  if (KV && a.dbias != nullptr && slice == 0 && wg == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = db[hh];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (t == 0 && rw[hh] < a.Lk) a.dbias[keys + rw[hh]] = x;
    }
  }
}

// ---------------------------------------------------------------------------
// Head dims that are not multiples of 64: CUDA cores
// ---------------------------------------------------------------------------

using zoo_flash::CS;
using zoo_flash::dot_chunk;
constexpr int ST = 64;                    // own and streamed rows a tile
constexpr int SIMT_NT = zoo_flash::NT;    // 16 x 16 threads

// Shared memory of the CUDA-core kernels: own0, str0, own1, str1 chunks,
// dS and P t tiles (64 x CS f32 each), and the streamed rows' m, 1 / l, D.
__host__ __device__ constexpr int simt_smem_bytes() {
  return 6 * ST * CS * 4 + 3 * ST * 4;
}

// out[i][w] += sum over s of X[ty + 16 i][s] . S[s][4 tx + w]
__device__ __forceinline__ void mul_chunk(float (&out)[4][4], const float* X,
                                          const float* S, int ty, int tx) {
#pragma unroll 2
  for (int s = 0; s < ST; s += 4) {
    float4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = *reinterpret_cast<const float4*>(&X[(ty + 16 * i) * CS + s]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 sv =
          *reinterpret_cast<const float4*>(&S[(s + u) * CS + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = u == 0 ? xv[i].x : u == 1 ? xv[i].y
                        : u == 2 ? xv[i].z : xv[i].w;
        out[i][0] = fmaf(x, sv.x, out[i][0]);
        out[i][1] = fmaf(x, sv.y, out[i][1]);
        out[i][2] = fmaf(x, sv.z, out[i][2]);
        out[i][3] = fmaf(x, sv.w, out[i][3]);
      }
    }
  }
}

// The same two kernels at any head dim D, on CUDA cores.  A block owns 64
// rows and one 64-column slice of their outputs (blockIdx.x = row tile x
// slices + slice) and recomputes S and dP over the whole of D, 64 columns
// at a time: D / 64 times the score work of one block per row tile, which
// keeps shared memory at 105 KB whatever D is.  The column chunks run in
// an order that ends with the block's own slice, so the streamed chunks
// left in shared memory are the ones the output products need.  Columns
// past D are zeros in shared memory and are never stored.  Only slice 0
// writes the bias-gradient partials.
template <typename T, bool KV>
__global__ void __launch_bounds__(SIMT_NT) bwd_simt_kernel(Args a, int D) {
  extern __shared__ float4 smem4[];
  float* A0 = reinterpret_cast<float*>(smem4);
  float* B0 = A0 + ST * CS;
  float* A1 = B0 + ST * CS;
  float* B1 = A1 + ST * CS;
  float* X = B1 + ST * CS;   // dS
  float* X2 = X + ST * CS;   // P t
  float* Ms = X2 + ST * CS;  // the streamed rows' m, 1 / l, D (dk/dv)
  float* Ls = Ms + ST;
  float* Dm = Ls + ST;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nch = (D + 63) / 64;
  const int cs = blockIdx.x % nch;  // this block's output slice
  const int r0 = blockIdx.x / nch * ST;
  const int h = blockIdx.y, b = blockIdx.z;
  const int offset = a.Lk - a.Lq;
  const T* q = static_cast<const T*>(a.q) + b * a.qs_b + h * a.qs_h;
  const T* gp = static_cast<const T*>(a.g) + b * a.gs_b + h * a.gs_h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks_b + h * a.ks_h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs_b + h * a.vs_h;
  const float* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.bs_b + h * a.bs_h;
  const int64_t rows = (static_cast<int64_t>(b) * a.H + h) * a.Lq;
  const int64_t keys = (static_cast<int64_t>(b) * a.H + h) * a.Lk;
  const bool seg = a.q_seg != nullptr;
  const int* qsg = seg ? a.q_seg + b * a.Lq : nullptr;
  const int* ksg = seg ? a.kv_seg + b * a.Lk : nullptr;

  const T* o0 = KV ? k : q;
  const T* o1 = KV ? v : gp;
  const int64_t o0s = KV ? a.ks_l : a.qs_l, o1s = KV ? a.vs_l : a.gs_l;
  const int own_len = KV ? a.Lk : a.Lq;
  const T* s0p = KV ? q : k;
  const T* s1p = KV ? gp : v;
  const int64_t s0s = KV ? a.qs_l : a.ks_l, s1s = KV ? a.gs_l : a.vs_l;
  const int str_len = KV ? a.Lq : a.Lk;
  int sbeg = 0, send = str_len;
  if (a.causal) {
    if (KV) sbeg = max(0, r0 - offset) / ST * ST;
    else send = min(a.Lk, r0 + ST + offset);
  }

  // the own rows ty + 16 i: their segment ids and, in the dq kernel, m,
  // 1 / l and D
  const uint32_t hash = keep_base(a.seed0, a.seed1, b, h);
  float mr[4], lr[4], dr[4];
  int rseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    const bool in = r < own_len;
    rseg[i] = seg && in ? (KV ? ksg[r] : qsg[r]) : 0;
    mr[i] = !KV && in ? a.m[rows + r] : 0.f;
    lr[i] = !KV && in ? 1.f / fmaxf(a.l[rows + r], 1e-20f) : 1.f;
    dr[i] = !KV && in ? a.dsum[rows + r] : 0.f;
  }
  float acc0[4][4], acc1[4][4], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc0[i][j] = acc1[i][j] = 0.f;
  }

  for (int s = sbeg; s < send; s += ST) {
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int n = 1; n <= nch; ++n) {
      const int col0 = (cs + n) % nch * 64;  // the last chunk is slice cs
      __syncthreads();  // the previous readers of every tile are done
      if (nch > 1 || s == sbeg) {
        zoo_flash::stage_chunk<T>(A0, CS, o0, o0s, r0, own_len, col0, D);
        zoo_flash::stage_chunk<T>(A1, CS, o1, o1s, r0, own_len, col0, D);
      }
      zoo_flash::stage_chunk<T>(B0, CS, s0p, s0s, s, str_len, col0, D);
      zoo_flash::stage_chunk<T>(B1, CS, s1p, s1s, s, str_len, col0, D);
      if (KV && n == 1 && tid < ST) {
        const int qi = s + tid;
        const bool in = qi < a.Lq;
        Ms[tid] = in ? a.m[rows + qi] : 0.f;
        Ls[tid] = in ? 1.f / fmaxf(a.l[rows + qi], 1e-20f) : 1.f;
        Dm[tid] = in ? a.dsum[rows + qi] : 0.f;
      }
      __syncthreads();
      dot_chunk(sc, A0, B0, ty, tx);
      dot_chunk(dp, A1, B1, ty, tx);
    }

    // element (i, j): own row r0 + ty + 16 i, streamed row s + tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int own = r0 + ty + 16 * i, str = s + c;
        const int qi = KV ? str : own, kj = KV ? own : str;
        const bool live = qi < a.Lq && kj < a.Lk &&
                          (!a.causal || qi + offset >= kj) &&
                          (!seg || rseg[i] == (KV ? qsg[qi] : ksg[kj]));
        float p = 0.f, pt = 0.f, ds = 0.f;
        if (live) {
          const float m = KV ? Ms[c] : mr[i];
          const float inv_l = KV ? Ls[c] : lr[i];
          const float dd = KV ? Dm[c] : dr[i];
          float x = sc[i][j] * a.scale;
          if (bias != nullptr) x += bias[qi * a.bs_q + kj * a.bs_k];
          p = expf(x - m) * inv_l;
          const float keep =
              mix32(hash ^ keep_q(qi) ^ keep_k(kj)) >= a.drop_thr
                  ? a.inv_keep : 0.f;
          pt = p * keep;
          ds = p * (keep * dp[i][j] - dd);
        }
        X[(ty + 16 * i) * CS + c] = ds;
        if (KV) X2[(ty + 16 * i) * CS + c] = pt;
        db[i] += ds;
      }
    }
    __syncthreads();
    // dq += dS k, or dk += dS^T q and dv += (P t)^T dO, over this slice
    mul_chunk(acc0, X, B0, ty, tx);
    if (KV) mul_chunk(acc1, X2, B1, ty, tx);
  }

  T* out0 = static_cast<T*>(KV ? a.dk : a.dq);
  T* out1 = static_cast<T*>(a.dv);
  const int64_t first = KV ? keys : rows;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= own_len) continue;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int col = cs * 64 + 4 * tx + w;
      if (col >= D) continue;
      zoo_flash::store_as(&out0[(first + r) * D + col], acc0[i][w] * a.scale);
      if (KV) zoo_flash::store_as(&out1[(first + r) * D + col], acc1[i][w]);
    }
  }
  if (KV && a.dbias != nullptr && cs == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = db[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      const int r = r0 + ty + 16 * i;
      if (tx == 0 && r < a.Lk) a.dbias[keys + r] = x;
    }
  }
}

template <typename T>
cudaError_t launch_simt(const Args& a, int D, cudaStream_t stream) {
  constexpr int smem = simt_smem_bytes();
  auto dqk = bwd_simt_kernel<T, false>;
  auto dkvk = bwd_simt_kernel<T, true>;
  cudaError_t err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkvk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nch = (D + 63) / 64;
  const dim3 qgrid((a.Lq + ST - 1) / ST * nch, a.H, a.B);
  dqk<<<qgrid, SIMT_NT, smem, stream>>>(a, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kgrid((a.Lk + ST - 1) / ST * nch, a.H, a.B);
  dkvk<<<kgrid, SIMT_NT, smem, stream>>>(a, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes(D);
  auto dqk = bwd_kernel<D, false>;
  auto dkvk = bwd_kernel<D, true>;
  cudaError_t err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkvk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 qgrid((a.Lq + OWN - 1) / OWN, a.H, a.B);
  dqk<<<qgrid, 2 * D, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kgrid((a.Lk + OWN - 1) / OWN, a.H, a.B);
  dkvk<<<kgrid, 2 * D, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool KV>
cudaError_t launch16_kernel(const Args& a, const Maps& maps,
                            cudaStream_t stream) {
  constexpr int smem = smem16_bytes(D, KV);
  auto kern = a.bias == nullptr || a.bs_q == 0 ? bwd16_kernel<T, D, KV, true>
                                               : bwd16_kernel<T, D, KV, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((KV ? a.Lk : a.Lq) + OWN - 1) / OWN, a.H, a.B);
  kern<<<grid, 128, smem, stream>>>(a, maps);
  return cudaGetLastError();
}

// 16-bit T at head dim 64 or 128: the inputs' tensor maps (64-row boxes of
// the own rows, NS-row boxes of the streamed rows), then the dq and the
// dk/dv kernels.  Returns -2 when an input's base or strides are not
// multiples of 16 bytes (the wrapper copies such an input first).
template <typename T, int D>
int launch16(const Args& a, cudaStream_t stream) {
  auto enc = [&](CUtensorMap* map, const void* p, int L, int64_t s_b,
                 int64_t s_h, int64_t s_l, int rows) {
    return zoo_tma::encode_chunked_map<T>(map, p, D, L, a.H, a.B, s_b, s_h,
                                          s_l, rows, D / 64);
  };
  auto maps_for = [&](Maps* m, int q_rows, int k_rows) {
    return enc(&m->q, a.q, a.Lq, a.qs_b, a.qs_h, a.qs_l, q_rows) &&
           enc(&m->g, a.g, a.Lq, a.gs_b, a.gs_h, a.gs_l, q_rows) &&
           enc(&m->k, a.k, a.Lk, a.ks_b, a.ks_h, a.ks_l, k_rows) &&
           enc(&m->v, a.v, a.Lk, a.vs_b, a.vs_h, a.vs_l, k_rows);
  };
  // the dq kernel streams keys, the dk/dv kernel queries
  Maps dq_maps, kv_maps;
  if (!maps_for(&dq_maps, OWN, rows16(D, false))) return -2;
  if (rows16(D, true) == OWN)
    kv_maps = dq_maps;
  else if (!maps_for(&kv_maps, rows16(D, true), OWN))
    return -2;
  const cudaError_t err = launch16_kernel<T, D, false>(a, dq_maps, stream);
  if (err != cudaSuccess) return err;
  return launch16_kernel<T, D, true>(a, kv_maps, stream);
}

template <typename T, bool KV, int NWG>
cudaError_t launch_wide_kernel(const Args& a, const Maps& maps, int D,
                               cudaStream_t stream) {
  constexpr int smem = wide_smem_bytes(KV, NWG, zoo_sm90::is_16bit_v<T>);
  auto kern = bwd_wide_kernel<T, KV, NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int slices = (D / 64 + NWG - 1) / NWG;
  const int len = KV ? a.Lk : a.Lq;
  const dim3 grid((len + OWN - 1) / OWN * slices, a.H, a.B);
  kern<<<grid, 128 * NWG, smem, stream>>>(a, maps, D);
  return cudaGetLastError();
}

// D > 128, D % 64 == 0: the inputs' tensor maps, then the dq and the
// dk/dv kernels.  Returns -2 when an input's base or strides are not
// multiples of 16 bytes (the wrapper copies such an input first).
template <typename T>
int launch_wide(const Args& a, int D, cudaStream_t stream) {
  using zoo_tma::encode_map;
  Maps maps;
  const bool tma =
      encode_map<T>(&maps.q, a.q, D, a.Lq, a.H, a.B, a.qs_b, a.qs_h,
                    a.qs_l) &&
      encode_map<T>(&maps.k, a.k, D, a.Lk, a.H, a.B, a.ks_b, a.ks_h,
                    a.ks_l) &&
      encode_map<T>(&maps.v, a.v, D, a.Lk, a.H, a.B, a.vs_b, a.vs_h,
                    a.vs_l) &&
      encode_map<T>(&maps.g, a.g, D, a.Lq, a.H, a.B, a.gs_b, a.gs_h,
                    a.gs_l);
  if (!tma) return -2;
  const bool three = wide_warpgroups(D) == 3;
  const cudaError_t err =
      three ? launch_wide_kernel<T, false, 3>(a, maps, D, stream)
            : launch_wide_kernel<T, false, 2>(a, maps, D, stream);
  if (err != cudaSuccess) return err;
  return three ? launch_wide_kernel<T, true, 3>(a, maps, D, stream)
               : launch_wide_kernel<T, true, 2>(a, maps, D, stream);
}

// Head dims 64 and 128: bwd16_kernel for bf16 and f16, bwd_kernel for
// f32; every other multiple of 64: the chunked bwd_wide_kernel; any other
// head dim: the CUDA-core kernels.
template <typename T>
int dispatch(int head_dim, const Args& a, cudaStream_t stream) {
  if (head_dim == 64 || head_dim == 128) {
    if constexpr (zoo_sm90::is_16bit_v<T>)
      return head_dim == 64 ? launch16<T, 64>(a, stream)
                            : launch16<T, 128>(a, stream);
    else
      return head_dim == 64 ? launch<64>(a, stream) : launch<128>(a, stream);
  }
  return head_dim % 64 == 0 ? launch_wide<T>(a, head_dim, stream)
                            : launch_simt<T>(a, head_dim, stream);
}

// Vector loads need every row start aligned to 4 elements: the base pointer
// and all three strides.
bool rows_aligned(const void* p, int bytes, int64_t s_b, int64_t s_h,
                  int64_t s_l) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0 && s_b % 4 == 0 &&
         s_h % 4 == 0 && s_l % 4 == 0;
}

}  // namespace zoo_flash_bwd

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  m, l, dsum: (B, H, Lq)
// f32.  dq, dk, dv: contiguous outputs in the input type.  dbias: (B, H,
// Lk) f32 partials, or null when the bias needs no gradient.  q_seg, kv_seg:
// contiguous (B, Lq) and (B, Lk) int32 segment ids, or both null.  Head
// dims 64 and 128 take the tensor-core kernels, every other multiple of 64
// the chunked tensor-core kernels, any other the CUDA-core ones.  Returns
// 0 on success, a cudaError_t code when a launch failed, -1 for a dtype the
// kernels do not take, or -2 when the chunked kernels cannot map an input
// (a base or a stride not a multiple of 16 bytes).
extern "C" int zoo_flash_attention_bwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* g, const float* m, const float* l, const float* dsum,
    const float* bias, void* dq, void* dk, void* dv, float* dbias,
    const int* q_seg, const int* kv_seg, int B, int H, int Lq, int Lk,
    long long qs_b, long long qs_h, long long qs_l,
    long long ks_b, long long ks_h, long long ks_l,
    long long vs_b, long long vs_h, long long vs_l,
    long long gs_b, long long gs_h, long long gs_l,
    long long bs_b, long long bs_h, long long bs_q, long long bs_k,
    float scale, int causal, int dropout, unsigned seed0, unsigned seed1,
    unsigned drop_thr, float inv_keep, void* stream) {
  using zoo_flash_bwd::rows_aligned;
  const int bytes = dtype == 0 ? 16 : 8;
  const int vec = rows_aligned(q, bytes, qs_b, qs_h, qs_l) &&
                  rows_aligned(k, bytes, ks_b, ks_h, ks_l) &&
                  rows_aligned(v, bytes, vs_b, vs_h, vs_l) &&
                  rows_aligned(g, bytes, gs_b, gs_h, gs_l);
  if (!dropout) {  // every element kept, unscaled
    drop_thr = 0;
    inv_keep = 1.f;
  }
  zoo_flash_bwd::Args a{q, k, v, g, m, l, dsum, bias, dq, dk, dv, dbias,
                        q_seg, kv_seg, B, H, Lq, Lk,
                        qs_b, qs_h, qs_l, ks_b, ks_h, ks_l, vs_b, vs_h, vs_l,
                        gs_b, gs_h, gs_l, bs_b, bs_h, bs_q, bs_k,
                        scale, causal, dropout, seed0, seed1, drop_thr,
                        inv_keep, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return zoo_flash_bwd::dispatch<float>(head_dim, a, s);
  if (dtype == 1)
    return zoo_flash_bwd::dispatch<__nv_bfloat16>(head_dim, a, s);
  if (dtype == 2) return zoo_flash_bwd::dispatch<__half>(head_dim, a, s);
  return -1;
}
