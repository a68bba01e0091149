// Flash-attention forward: the device code of the three forward kernels.
//
// Replaces the TPU kernel `_flash_fwd_pallas`
// (analytics_zoo_tpu/ops/pallas/flash_attention.py:216, kernel closure :245,
// pl.pallas_call :399): an additive f32 bias broadcast over
// (B|1, H|1, Lq|1, Lk), end-aligned causal masking, segment ids (a pair is
// live only where the query's and the key's ids are equal: packed
// sequences), ragged Lq/Lk, any head dim, f32, bf16 or f16 inputs with
// f32 softmax math, output in the input type, in-kernel attention dropout from
// the reference's position hash, and optionally the softmax statistics
// (m, l) per query row, which the backward reads.
//
// Semantics (identical to the reference's `_attention_reference`): a running
// max m floored at -1e30, so a row whose keys are all masked, by the causal
// triangle, by segment ids or by a bias of finfo.min, comes out as zeros and
// never as NaN; keys past Lk are zeroed in shared memory, not only masked,
// because 0 * NaN would poison the accumulator.  Dropout keeps an element
// when keep_bits(seed0, seed1, b, h, q, k) >= floor(p * 2^32) and scales it
// by 1/(1-p); l sums the probabilities before dropout, so out = acc / l is
// dropout applied after the softmax, as in the reference.
//
// What bounds it on an H100.  At BERT-base serving shapes (B=8, H=12,
// L=512, D=64, the padding mask of chip_smoke.py) the two products are
// 3.5 GFLOP on the live keys.  In bf16 or f16 on the tensor cores (989
// TFLOP/s)
// that is ~3.5 us, against 25 MB moved (q, k, v, out and the bias once:
// 7.5 us at 3.35 TB/s), so bytes bound it; in f32 as three tf32 products a
// value (494.7 TFLOP/s) ~21 us, so operations do (on CUDA cores, 67
// TFLOP/s, ~52 us).
//
// Which body: every head dim that is a multiple of 64 takes the tensor
// cores (bf16 and f16 as they are, f32 as 3xTF32): 64 and 128 whole-tile
// bodies, every other multiple of 64 the chunked body; only head dims that
// are not multiples of 64 (direct calls of flash_attention; the router
// sends multiples of 64 only) take the CUDA-core body.  The backward splits the
// same way (flash_attention_bwd.cu).
//
// 16-bit inputs (bf16 or f16, the kernels' T) with head dim 64 or 128:
// `flash_fwd_wgmma_kernel<T, ...>`, on the tensor cores.  The two types
// take the same code; every 16-bit step (the copies, the `wgmma` type
// suffix, the rounding of P and of the output) is keyed on T itself.  With
// the products there, the work left on the CUDA cores (scale, bias, mask,
// the running max and sum, exp, the rescale of the accumulator) is what
// takes the time, so the design spends its effort on doing little of it
// per element.
// - One warpgroup (128 threads) per block owns 64 query rows of one
//   (batch, head); a loop over key tiles (128 keys at head dim 64, 64 at
//   128) inside the block replaces the TPU's sequential `ki` grid axis,
//   with the running (m, l) and the output accumulator in registers for
//   the whole loop.
// - The Q tile sits in shared memory; K and V tiles go through a ring of
//   two stages, the next tile's 16-byte cp.async copies in flight while
//   the current one is used.  Rows are read through their strides (the
//   split_heads views of a fused projection have row strides of 3 H D),
//   and rows past Lq or Lk are zero-filled by the copy itself.  All three
//   are stored in the 128-byte-swizzled layout of sm90.cuh.  A bias of one
//   row per (batch, head), BERT's padding mask, rides with each K tile as
//   one more copy; without a bias that row is zeros.
// - S = Q K^T is `wgmma` m64nBKk16 with both operands in shared memory
//   (K-major), f32 out.  Scale and bias are one FMA on the accumulator
//   fragment in registers; the causal, ragged and segment masks, needed
//   only in tiles that cross an edge or when segment ids are given (a
//   template parameter: a call without them compiles no test of them), set
//   an element to -inf, so its exp is 0 with no per-element flag while the
//   running max, which starts at the floor, stays finite.  The keys'
//   segment ids are read where a pair is tested; a row's own id sits in a
//   register.  Each element's (row, key) follows from the fragment layout,
//   and a row's max and sum reduce over the 4 threads that share it with
//   two shuffles.  exp is exp2 of one FMA.
// - P is rounded to T in registers and is, as it stands, the register A
//   operand of the second `wgmma` (m64nDk16), with V from shared memory as
//   MN-major B; l keeps summing the f32 probabilities, as the plain version
//   does.  Dropout, when on, multiplies P by the hash's keep mask after l.
// - Under causal masking a q-tile stops at the last key tile any of its
//   rows can see.
//
// f32 inputs with head dim 64 or 128: `flash_fwd_tf32_kernel`, the same
// design with f32 products as three tf32 `wgmma`s a value (x = hi + lo,
// hi = tf32(x); lo * hi + hi * lo + hi * hi, the lo products first: f32
// math to ~2^-21 relative, the backward's arithmetic, flash_tf32.cuh).
// - tf32 operands must be K-major.  Q and K are (D contiguous), so their hi
//   and lo pieces are staged straight into the swizzled layout; P V
//   contracts over keys, so V is staged transposed (V^T, keys contiguous),
//   with the keys of each 8 in the order a thread's S columns fill the
//   tf32 A fragment (columns 2t, 2t + 1 of the accumulator are the
//   fragment's t, t + 4): P goes from the S accumulator into the register
//   A operand with no shuffle, split into hi and lo in registers.
// - The split needs the values in registers, so K and V rows travel raw:
//   16-byte cp.async copies into a two-stage ring of raw rows (padded by 16
//   bytes a row, so the splitting reads hit every bank once), two tiles
//   ahead; each tile's rows are then split into the K and V^T hi/lo tiles,
//   which every warp reads through wgmma.  Q is split once.
// - Shared memory is the limit: hi and lo double every tile.  32-key tiles
//   keep a block at 101.6 KB at head dim 64 (Q 32 KB, K and V^T 32 KB, two
//   raw stages 34 KB), so two blocks share an SM; at 128 the same layout
//   takes 200 KB, one block an SM, which leaves room for the ring of two
//   raw stages: a single stage would not let a second block in (166 KB)
//   and would stall every tile on its copies.
// - Each tile's P V goes into a fresh accumulator that is added into the
//   f32 output, after the output's rescale by the running max, on the CUDA
//   cores, so the tensor cores' accumulator rounding does not build up over
//   the keys.  Softmax as in the bf16 kernel: one FMA for scale and bias,
//   -inf masking only in edge tiles, exp2; dropout multiplies P after l.
//
// Head dims above 128 that are multiples of 64: `flash_fwd_wide_kernel<T,
// NWG, CPW, ROW, SEG>`, the head dim a runtime value, the backward's chunked
// design (bwd_wide_kernel) with one output accumulator.  Q, K and V do not
// fit whole (f32 Q hi and lo alone take 96 KB at head dim 192), so S = Q K^T
// contracts over the head dim in 128-byte column chunks (32 f32 or 64
// 16-bit columns), 32 keys a tile:
// - A block owns 64 query rows and a slice of NWG x CPW output columns,
//   CPW a warpgroup (blockIdx.x = query tile x slices + slice); each
//   slice's block forms S over the whole head dim again.  CPW is 64, or
//   128 for f32 at head dims that are multiples of 128 (two 64-column
//   halves of O, each its own fresh accumulator: half the slices).  NWG is
//   3 where the head dim has a multiple of 3 warpgroups' columns, else 2.
//   f32 slices: one at 192, 256 and 384, three at 320, two at 512 and 768;
//   bf16 and f16: one at 192, two at 256 and 384, four at 512.
// - Tensor copies (TMA), issued by one thread with an mbarrier a ring slot,
//   bring the chunks in, 128-byte swizzled as wgmma reads them.  The maps
//   view an input as (column in chunk, row, chunk, head, batch), so that
//   one copy brings several chunks; rows and columns past the tensor read
//   as zeros.  An input whose base or strides are not multiples of 16 bytes
//   is copied by the wrapper first.
// - f32: a slot holds one or two chunks (CPW 128 or 64) of Q's 64 rows, of
//   the tile's K rows and, for the chunks of the block's slice, of its V
//   rows; three slots, two in flight (deeper rings were no faster).  The
//   threads split each Q and K value with split_tf32, hi back in place and
//   lo into a lo slot, and V's values into hi and lo tiles transposed in the
//   A fragment's key order (zoo_tf32::transposed), while the last slot's
//   products run.  The warpgroups share the score products: three take one
//   each (lo . hi, hi . lo, hi . hi), two take half the k-steps each; their
//   partial S go through shared memory and every warpgroup adds them in
//   warpgroup order (the lo products first), so all hold the same S.  P,
//   split into hi and lo in registers, is the register A operand of O += P
//   V (`accumulate`: a fresh accumulator per tile and 64 columns, lo
//   products first, added into O in f32).  One block an SM (153-217 KB).
// - bf16 and f16: Q's 64 rows stay whole in shared memory, brought by one
//   copy; a slot holds all of a tile's K chunks and the slice's V chunks,
//   two slots.  Every warpgroup forms the whole S with 16-bit wgmma
//   (sharing it out and adding the parts through shared memory was
//   slower), rounds P to the input type as the register A operand, and
//   reads its 64 columns of V in the slot (MN-major).  Blocks fit two an
//   SM up to head dim 320 (73-97 KB), and get the registers for it except
//   the three-warpgroup full-bias kernel.  Past head dim 832 Q and two
//   slots do not fit: one chunk a slot, Q with it, V copied out of the
//   ring for the output product.
// - The softmax, masks, bias (a one-row bias through shared memory with
//   each tile, any other read element by element), dropout and statistics
//   are the tensor-core bodies' above; each warpgroup computes them for the
//   whole tile (the same values in all), and warpgroup 0 of slice 0 writes
//   (m, l).  Every warpgroup issues the same wgmma sequence (a
//   warpgroup-dependent branch around wgmma makes ptxas serialize them
//   all); one past the head dim computes and stores nothing.
// - What bounds it: like the bodies above, operations on the tf32 route
//   and bytes in bf16, far below what it takes.  clock64() phase sums in a
//   probed copy (PERF.md section 6) put f32's time in the splits (a third:
//   shared-memory traffic, hi, lo and the transposed V written for every 16
//   bytes read) and the score products (small-N wgmma reading both operands
//   from shared memory), bf16's in the score products and the softmax; one
//   block an SM walks the phases in lockstep, so their latencies add up.
// - ptxas -v (CUDA 12.9): no spills in any of the 24 instances; registers
//   in PERF.md section 6.
//
// Any other head dim (not a multiple of 64): `flash_fwd_simt_kernel`, on
// CUDA cores, with the head dim a runtime loop over 64-column chunks: one
// 256-thread block per 64
// query rows and up to four 64-column slices of their output, each thread
// owning a 4x4 block of the 64x64 score tile and a 4x4 block of each slice,
// float4 shared-memory reads with a row pad of 4 floats, the 16 threads of
// a row reducing with shuffles and exchanging probabilities through a
// shared 64x64 tile.  Columns past D are zeros in shared memory and are
// never stored.  Q stays in shared memory up to head dim 384 (six chunks);
// above 256 a second block per query tile computes S again for the next
// four slices.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tf32.cuh"
#include "flash_tma.cuh"
#include "sm90.cuh"

namespace zoo_flash {

// ---------------------------------------------------------------------------
// Any head dim: CUDA cores
// ---------------------------------------------------------------------------

constexpr int SLICES = 4;   // 64-column output slices a block owns, at most
constexpr int Q_RESIDENT = 6;  // Q stays in shared memory up to 6 chunks

// The Q chunks kept in shared memory: all of them up to head dim 384, else
// one, staged anew for each key tile.
__host__ __device__ constexpr int q_slots(int D) {
  return (D + 63) / 64 <= Q_RESIDENT ? (D + 63) / 64 : 1;
}
// Bytes of dynamic shared memory of the CUDA-core kernel: the Q chunks, a
// K chunk, a block's V slices and the probability tile.
__host__ __device__ constexpr int simt_smem_bytes(int D) {
  return ((q_slots(D) * BQ + BK) * CS + SLICES * BK * 64 + BQ * CS) * 4;
}

// One 256-thread block per 64 query rows and up to SLICES 64-column slices
// of their output (blockIdx.x = query tile x groups + group); S is summed
// over the whole head dim, 64 columns at a time, so every group's block
// computes the same S (group 0 writes the statistics): once per query tile
// up to head dim 256, twice up to 512.
template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd_simt_kernel(Args a, int D) {
  constexpr int PS = BK + 4;  // row stride of the probability tile
  extern __shared__ float4 smem4[];
  const int qslots = q_slots(D);
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + qslots * BQ * CS;
  float* Vs = Ks + BK * CS;
  float* Ps = Vs + SLICES * BK * 64;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nch = (D + 63) / 64;
  const int ngr = (nch + SLICES - 1) / SLICES;
  const int c0 = blockIdx.x % ngr * SLICES * 64;  // this block's columns
  const int ns = min(SLICES, nch - c0 / 64);      // and its slices
  const int q0 = blockIdx.x / ngr * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const uint2 sd = load_seed(a);  // the dropout seed pair
  const int offset = a.Lk - a.Lq;  // end-aligned causal diagonal
  const T* q = static_cast<const T*>(a.q) + b * a.qs_b + h * a.qs_h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks_b + h * a.ks_h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs_b + h * a.vs_h;
  const float* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.bs_b + h * a.bs_h;
  const bool seg = a.q_seg != nullptr;
  const int* ksg = seg ? a.kv_seg + b * a.Lk : nullptr;
  int qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    qseg[i] = seg && qi < a.Lq ? a.q_seg[b * a.Lq + qi] : 0;
  }

  float m[4], l[4], o[SLICES][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int sl = 0; sl < SLICES; ++sl)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[sl][i][c] = 0.f;
  }

  // Keys at or past kend are masked for every row of this tile.
  const int kend = a.causal ? min(a.Lk, q0 + BQ + offset) : a.Lk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    // S = Q K^T for this thread's 4x4 block, over the head dim in chunks.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int dc = 0; dc < nch; ++dc) {
      // Q chunk dc: staged once when every chunk stays, else each time
      float* Qc = qslots > 1 ? Qs + dc * BQ * CS : Qs;
      __syncthreads();  // the previous readers of every tile are done
      if (k0 == 0 || (qslots == 1 && nch > 1))
        stage_chunk<T>(Qc, CS, q, a.qs_l, q0, a.Lq, dc * 64, D);
      stage_chunk<T>(Ks, CS, k, a.ks_l, k0, a.Lk, dc * 64, D);
      if (dc == 0)
        for (int sl = 0; sl < ns; ++sl)
          stage_chunk<T>(Vs + sl * BK * 64, 64, v, a.vs_l, k0, a.Lk,
                         c0 + sl * 64, D);
      __syncthreads();
      dot_chunk(s, Qc, Ks, ty, tx);
    }

    // Scale, bias and mask, then the streaming-softmax update per row.
    unsigned live = 0u;  // bit 4*i+j: element (i, j) is visible
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < a.Lk && qi < a.Lq &&
                        (!a.causal || qi + offset >= kj) &&
                        (!seg || qseg[i] == ksg[kj]);
        float x = s[i][j] * a.scale;
        if (ok && bias != nullptr) x += bias[qi * a.bs_q + kj * a.bs_k];
        s[i][j] = ok ? x : NEG;
        live |= (ok ? 1u : 0u) << (4 * i + j);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = (live >> (4 * i + j)) & 1u ? expf(s[i][j] - mnew) : 0.f;
        rs += p;  // l is the denominator before dropout
        if (a.dropout) {
          const uint32_t bits =
              keep_bits(sd.x, sd.y, b, h, q0 + ty + 16 * i,
                        k0 + tx + 16 * j);
          p = bits >= a.drop_thr ? p * a.inv_keep : 0.f;
        }
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mnew;
#pragma unroll
      for (int sl = 0; sl < SLICES; ++sl)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[sl][i][c] *= alpha;
    }
    __syncthreads();

    // O += P V for this thread's 4 x 4 block of each slice.
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + kk]);
#pragma unroll
      for (int sl = 0; sl < SLICES; ++sl) {
        if (sl >= ns) break;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 t = *reinterpret_cast<const float4*>(
              &Vs[sl * BK * 64 + (kk + u) * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0   ? pv[i].x
                            : u == 1 ? pv[i].y
                            : u == 2 ? pv[i].z
                                     : pv[i].w;
            o[sl][i][0] = fmaf(p, t.x, o[sl][i][0]);
            o[sl][i][1] = fmaf(p, t.y, o[sl][i][1]);
            o[sl][i][2] = fmaf(p, t.z, o[sl][i][2]);
            o[sl][i][3] = fmaf(p, t.w, o[sl][i][3]);
          }
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out) + b * a.os_b + h * a.os_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < a.Lq) {
      const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
      for (int sl = 0; sl < SLICES; ++sl)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + sl * 64 + tx * 4 + c;
          if (sl < ns && col < D)
            store_as(&out[qi * a.os_l + col], o[sl][i][c] / denom);
        }
      if (a.m_out != nullptr && tx == 0 && c0 == 0) {
        const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Lq + qi;
        a.m_out[row] = m[i];
        a.l_out[row] = l[i];
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 or f16, head dim 64 or 128: tensor cores
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128;  // one warpgroup, 64 query rows

// Keys per tile: 128 at head dim 64, 64 at 128, so that two stages of K
// and V fit beside Q with room for more than one block an SM.
__host__ __device__ constexpr int wg_keys(int D) { return D == 64 ? 128 : 64; }
// Bytes of the dynamic shared memory: Q (64 rows), two stages of K, V
// (wg_keys rows each) and of a row of bias, and room to align.
__host__ __device__ constexpr int wg_smem_bytes(int D) {
  return 64 * D * 2 + 2 * (2 * wg_keys(D) * D * 2 + wg_keys(D) * 4) + 1024;
}

// Copy rows row0 .. row0 + R - 1 of a (rows, D) matrix of 16-bit T with
// row stride `ls` elements into a swizzled tile; rows at or past `n` read
// as zeros.  The copy moves bits: it is the same for bf16 and f16.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(uint8_t* dst, const T* src,
                                          int64_t ls, int row0, int n,
                                          bool vec) {
  static_assert(zoo_sm90::is_16bit_v<T>, "bf16 or f16");
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  const int tid = threadIdx.x;
  if (vec) {  // chunk i of a thread: row r + i * RP, chunk j of the row
    constexpr int RP = WG_THREADS / CPR;  // rows a pass covers, 8 or 16
    const int r = tid / CPR, j = tid % CPR;
    const uint32_t d0 = zoo_sm90::smem_u32(dst + (j >> 3) * (R * 128)) +
                        zoo_sm90::swz(r, j & 7);
    const T* s0 = src + (row0 + r) * ls + j * 8;
#pragma unroll
    for (int i = 0; i < R / RP; ++i) {
      const bool in = row0 + r + i * RP < n;
      zoo_sm90::cp_async16(d0 + i * RP * 128, in ? s0 + i * RP * ls : src,
                           in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < R * D; e += WG_THREADS) {
      const int r = e / D, d = e % D;
      const uint16_t v =
          row0 + r < n
              ? reinterpret_cast<const uint16_t*>(src)[(row0 + r) * ls + d]
              : 0;
      *reinterpret_cast<uint16_t*>(
          dst + (d >> 6) * (R * 128) + zoo_sm90::swz(r, (d & 63) >> 3) +
          (d & 7) * 2) = v;
    }
  }
}

// Copy keys k0 .. k0 + R - 1 of one bias row (f32, contiguous along the
// keys, 16-byte aligned) into shared memory; keys at or past lk read as
// zeros.
template <int R>
__device__ __forceinline__ void load_bias_row(float* dst, const float* src,
                                              int k0, int lk) {
  for (int c = threadIdx.x; c < R / 4; c += WG_THREADS) {
    const int kj = k0 + 4 * c;
    const int bytes = kj >= lk ? 0 : (lk - kj >= 4 ? 16 : (lk - kj) * 4);
    zoo_sm90::cp_async16(zoo_sm90::smem_u32(dst + 4 * c),
                         bytes ? src + kj : src, bytes);
  }
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_s(float (&d)[N / 2], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (N == 64)
    zoo_sm90::wgmma_m64n64k16_ss<T, 0>(d, da, db, scale_d);
  else
    zoo_sm90::wgmma_m64n128k16_ss<T, 0>(d, da, db, scale_d);
}
template <typename T, int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    zoo_sm90::wgmma_m64n64k16_rs<T, 1>(d, a, db, 1);
  else
    zoo_sm90::wgmma_m64n128k16_rs<T, 1>(d, a, db, 1);
}

// ROW: the bias is one row per (batch, head) (bs_q == 0), contiguous along
// the keys and 16-byte aligned, or there is none; the row goes through
// shared memory with the K and V tiles (zeros without a bias), so the
// BERT padding mask and no mask take one code path.  Otherwise each bias
// element is read from global memory.  SEG: segment ids are given (a call
// without them runs no test of them).  At head dim 64 the registers are
// capped at 128 a thread, for four blocks an SM (measured faster than two
// blocks with more registers; at head dim 128 shared memory allows two).
// T: bf16 or f16.
template <typename T, int D, bool ROW, bool SEG>
__global__ void __launch_bounds__(WG_THREADS, D == 64 ? 4 : 1)
    flash_fwd_wgmma_kernel(Args a, bool vec) {
  using namespace zoo_sm90;
  static_assert(is_16bit_v<T>, "bf16 or f16");
  constexpr int BKV = wg_keys(D);
  constexpr int KV = BKV * D * 2;  // bytes of a K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* stages = Qs + 64 * D * 2;
  auto Ks = [&](int st) { return stages + st * 2 * KV; };
  auto Vs = [&](int st) { return stages + st * 2 * KV + KV; };
  float* Bs = reinterpret_cast<float*>(stages + 4 * KV);  // [2][BKV]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const uint2 sd = load_seed(a);  // the dropout seed pair
  const int offset = a.Lk - a.Lq;  // end-aligned causal diagonal
  const T* q = static_cast<const T*>(a.q) + b * a.qs_b + h * a.qs_h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks_b + h * a.ks_h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs_b + h * a.vs_h;
  const float* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.bs_b + h * a.bs_h;
  const int* ksg = SEG ? a.kv_seg + b * a.Lk : nullptr;

  // Keys at or past kend are masked for every row of this tile.
  const int kend = a.causal ? min(a.Lk, q0 + 64 + offset) : a.Lk;
  const int n_tiles = kend > 0 ? (kend + BKV - 1) / BKV : 0;
  auto load_tile = [&](int st, int k0) {
    load_rows<T, D, BKV>(Ks(st), k, a.ks_l, k0, a.Lk, vec);
    load_rows<T, D, BKV>(Vs(st), v, a.vs_l, k0, a.Lk, vec);
    if (ROW && bias != nullptr)
      load_bias_row<BKV>(Bs + st * BKV, bias, k0, a.Lk);
  };

  if (ROW && bias == nullptr)
    for (int i = tid; i < 2 * BKV; i += WG_THREADS) Bs[i] = 0.f;
  load_rows<T, D, 64>(Qs, q, a.qs_l, q0, a.Lq, vec);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // this thread's rows of the tile: warp * 16 + g + 8 hh, hh = 0, 1, with
  // their segment ids
  int qi[2], qseg[2];
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qi[hh] = q0 + warp * 16 + g + 8 * hh;
    qseg[hh] = SEG && qi[hh] < a.Lq ? a.q_seg[b * a.Lq + qi[hh]] : 0;
    m[hh] = NEG;
    l[hh] = 0.f;
  }
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKV;
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // the other stage was freed at the end of j - 1
      load_tile(st ^ 1, k0 + BKV);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T, 64 x BKV, f32
    float s[BKV / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_s<T, BKV>(s,
                   desc_b128(smem_u32(Qs) + (kk >> 2) * 8192 + (kk & 3) * 32,
                             16, 1024),
                   desc_b128(smem_u32(Ks(st)) + (kk >> 2) * (BKV * 128) +
                                 (kk & 3) * 32, 16, 1024),
                   kk > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(s);

    // Scale, bias and mask: element i is row g + 8 ((i / 2) % 2), key
    // 8 (i / 4) + 2 t + i % 2 of the tile.  A masked element becomes -inf,
    // so its probability is exactly 0 while the running max, which starts
    // at the floor NEG, stays finite.  Tiles wholly inside the keys, the
    // rows and the causal triangle, without segment ids, skip the mask.
    const bool whole = !SEG && k0 + BKV <= a.Lk && q0 + 64 <= a.Lq &&
                       (!a.causal || q0 + offset >= k0 + BKV - 1);
    const float* brow = Bs + st * BKV;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int row = qi[(i >> 1) & 1];
      const int col = (i >> 2) * 8 + 2 * t + (i & 1);
      const int kj = k0 + col;
      float bv = 0.f;
      if constexpr (ROW)
        bv = brow[col];
      else if (bias != nullptr && (whole || (kj < a.Lk && row < a.Lq)))
        bv = bias[row * a.bs_q + kj * a.bs_k];
      float x = fmaf(s[i], a.scale, bv);
      if (!whole && !(kj < a.Lk && row < a.Lq &&
                      (!a.causal || row + offset >= kj) &&
                      (!SEG || qseg[(i >> 1) & 1] == ksg[kj])))
        x = __int_as_float(0xff800000u);  // -inf
      s[i] = x;
    }
    // The streaming-softmax update per row, exp as exp2 of one FMA.
    constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        if (((i >> 1) & 1) == hh) mx = fmaxf(mx, s[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[hh], mx);
      const float alpha = exp2f((m[hh] - mnew) * LOG2E);
      const float ml = mnew * LOG2E;
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        if (((i >> 1) & 1) != hh) continue;
        s[i] = exp2f(fmaf(s[i], LOG2E, -ml));
        rs += s[i];  // l is the denominator before dropout
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[hh] = l[hh] * alpha + rs;
      m[hh] = mnew;
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        if (((i >> 1) & 1) == hh) o[i] *= alpha;
    }
    if (a.dropout) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int kj = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        s[i] = keep_bits(sd.x, sd.y, b, h, qi[(i >> 1) & 1], kj) >=
                       a.drop_thr
                   ? s[i] * a.inv_keep : 0.f;
      }
    }

    // O += P V: the accumulator fragment of S is, in pairs of T, the
    // register fragment of A for keys 16 kk .. 16 kk + 15.
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    fence_operand(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_pv<T, D>(o, pa[kk],
                  desc_b128(smem_u32(Vs(st)) + kk * 2048, BKV * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(o);
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_async_wait<0>();

  T* out = static_cast<T*>(a.out) + b * a.os_b + h * a.os_h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (qi[hh] >= a.Lq) continue;
    const float inv = 1.f / fmaxf(l[hh], 1e-20f);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = c * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(&out[qi[hh] * a.os_l + col]) =
          pack2<T>(o[4 * c + 2 * hh] * inv, o[4 * c + 2 * hh + 1] * inv);
    }
    if (a.m_out != nullptr && t == 0) {
      const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Lq + qi[hh];
      a.m_out[row] = m[hh];
      a.l_out[row] = l[hh];
    }
  }
}

// ---------------------------------------------------------------------------
// f32, head dim 64 or 128: tensor cores, three tf32 products a value
// ---------------------------------------------------------------------------

constexpr int TF_KEYS = zoo_tf32::SR;  // keys a tile: 32

// f32 values of one stage of raw rows: 32 K rows then 32 V rows, each
// padded by 16 bytes so that the splitting reads hit every bank once.
__host__ __device__ constexpr int tf_raw_floats(int D) {
  return 2 * TF_KEYS * (D + 4);
}
// Bytes of the dynamic shared memory: Q hi and lo (64 x D), K hi and lo
// (32 x D), V^T hi and lo (D x 32), two stages of raw rows, a bias row and
// room to align.
__host__ __device__ constexpr int tf_smem_bytes(int D) {
  return 2 * 64 * D * 4 + 4 * TF_KEYS * D * 4 + 2 * tf_raw_floats(D) * 4 +
         TF_KEYS * 4 + 1024;
}

template <int D>
__device__ __forceinline__ void wgmma_pv_tf32(float (&d)[D / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  if constexpr (D == 64)
    zoo_sm90::wgmma_tf32_m64n64k8_rs(d, a, db, scale_d);
  else
    zoo_sm90::wgmma_tf32_m64n128k8_rs(d, a, db, scale_d);
}

// ROW: the bias is one row per (batch, head) (bs_q == 0) or there is none;
// the row goes through shared memory with each tile (zeros without a
// bias).  Otherwise each bias element is read from global memory.  SEG:
// segment ids are given.
template <int D, bool ROW, bool SEG>
__global__ void __launch_bounds__(WG_THREADS, D == 64 ? 2 : 1)
    flash_fwd_tf32_kernel(Args a, bool vec) {
  using namespace zoo_sm90;
  using zoo_tf32::kmajor;
  using zoo_tf32::split4;
  using zoo_tf32::transposed;
  constexpr int BKV = TF_KEYS;
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  constexpr int RS = D + 4;   // row stride of the raw rows (floats)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qhi = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* Qlo = Qhi + 64 * D * 4;
  uint8_t* Khi = Qlo + 64 * D * 4;
  uint8_t* Klo = Khi + BKV * D * 4;
  uint8_t* Vhi = Klo + BKV * D * 4;
  uint8_t* Vlo = Vhi + BKV * D * 4;
  float* raw = reinterpret_cast<float*>(Vlo + BKV * D * 4);
  float* Bs = raw + 2 * tf_raw_floats(D);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const uint2 sd = load_seed(a);  // the dropout seed pair
  const int offset = a.Lk - a.Lq;  // end-aligned causal diagonal
  const float* q = static_cast<const float*>(a.q) + b * a.qs_b + h * a.qs_h;
  const float* k = static_cast<const float*>(a.k) + b * a.ks_b + h * a.ks_h;
  const float* v = static_cast<const float*>(a.v) + b * a.vs_b + h * a.vs_h;
  const float* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.bs_b + h * a.bs_h;
  const int* ksg = SEG ? a.kv_seg + b * a.Lk : nullptr;

  // Keys at or past kend are masked for every row of this tile.
  const int kend = a.causal ? min(a.Lk, q0 + 64 + offset) : a.Lk;
  const int n_tiles = kend > 0 ? (kend + BKV - 1) / BKV : 0;

  // Raw K and V rows k0 .. k0 + 31 into stage st, 16-byte copies where
  // the rows allow; rows past Lk are zeros.
  auto load_raw = [&](int st, int k0) {
    float* rk = raw + st * tf_raw_floats(D);
    float* rv = rk + BKV * RS;
    if (vec) {
#pragma unroll
      for (int i = 0; i < BKV * CPR / WG_THREADS; ++i) {
        const int e = tid + i * WG_THREADS;
        const int r = e / CPR, c = e % CPR;
        const bool in = k0 + r < a.Lk;
        cp_async16(smem_u32(rk + r * RS + 4 * c),
                   in ? k + (k0 + r) * a.ks_l + 4 * c : k, in ? 16 : 0);
        cp_async16(smem_u32(rv + r * RS + 4 * c),
                   in ? v + (k0 + r) * a.vs_l + 4 * c : v, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BKV * D; e += WG_THREADS) {
        const int r = e / D, c = e % D;
        const bool in = k0 + r < a.Lk;
        rk[r * RS + c] = in ? k[(k0 + r) * a.ks_l + c] : 0.f;
        rv[r * RS + c] = in ? v[(k0 + r) * a.vs_l + c] : 0.f;
      }
    }
  };
  // Stage st's raw rows split into hi and lo: K K-major, V transposed (key
  // lane of chunk c at row 4 c + e), and the keys' bias row.
  auto split_tile = [&](int st, int k0) {
    const float* rk = raw + st * tf_raw_floats(D);
    const float* rv = rk + BKV * RS;
#pragma unroll
    for (int i = 0; i < CPR / 4; ++i) {
      const int c = warp + 4 * i;
      uint4 hi, lo;
      split4(*reinterpret_cast<const float4*>(rk + lane * RS + 4 * c), hi,
             lo);
      *reinterpret_cast<uint4*>(Khi + kmajor<BKV>(lane, c)) = hi;
      *reinterpret_cast<uint4*>(Klo + kmajor<BKV>(lane, c)) = lo;
      split4(*reinterpret_cast<const float4*>(rv + lane * RS + 4 * c), hi,
             lo);
      const uint32_t hv[4] = {hi.x, hi.y, hi.z, hi.w};
      const uint32_t lv[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t off = transposed(4 * c + e, lane);
        *reinterpret_cast<uint32_t*>(Vhi + off) = hv[e];
        *reinterpret_cast<uint32_t*>(Vlo + off) = lv[e];
      }
    }
    if (ROW && tid < BKV)
      Bs[tid] = bias != nullptr && k0 + tid < a.Lk ? bias[(k0 + tid) * a.bs_k]
                                                    : 0.f;
  };

  if (n_tiles > 0) load_raw(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_raw(1, BKV);
  cp_async_commit();
  // Q, split into hi and lo: rows lane + 32 rr, chunks warp + 4 i
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = lane + 32 * rr;
    const bool in = q0 + r < a.Lq;
    const float* src = q + (q0 + r) * a.qs_l;
#pragma unroll
    for (int i = 0; i < CPR / 4; ++i) {
      const int c = warp + 4 * i;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in)
        x = vec ? __ldg(reinterpret_cast<const float4*>(src + 4 * c))
                : make_float4(src[4 * c], src[4 * c + 1], src[4 * c + 2],
                              src[4 * c + 3]);
      uint4 hi, lo;
      split4(x, hi, lo);
      *reinterpret_cast<uint4*>(Qhi + kmajor<64>(r, c)) = hi;
      *reinterpret_cast<uint4*>(Qlo + kmajor<64>(r, c)) = lo;
    }
  }

  // this thread's rows of the tile: warp * 16 + g + 8 hh, hh = 0, 1, with
  // their segment ids
  int qi[2], qseg[2];
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qi[hh] = q0 + warp * 16 + g + 8 * hh;
    qseg[hh] = SEG && qi[hh] < a.Lq ? a.q_seg[b * a.Lq + qi[hh]] : 0;
    m[hh] = NEG;
    l[hh] = 0.f;
  }
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKV;
    const int st = j & 1;
    cp_async_wait<1>();  // this thread's copies of tile j have landed
    __syncthreads();     // everyone's; and tile j - 1's products are done
    split_tile(st, k0);
    fence_proxy_async();
    __syncthreads();
    if (j + 2 < n_tiles) load_raw(st, k0 + 2 * BKV);  // stage st is free
    cp_async_commit();

    // S = Q K^T, 64 x 32, f32 as 3xTF32
    float s[BKV / 2];
    wgmma_fence();
    zoo_tf32::issue_scores<D>(s, smem_u32(Qhi), smem_u32(Qlo),
                              smem_u32(Khi), smem_u32(Klo));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(s);

    // Scale, bias and mask as in the bf16 kernel (the same code, inline in
    // each: as one shared function it made the bf16 kernel 10% slower at
    // head dim 128): element i is row g + 8 ((i / 2) % 2), key
    // 8 (i / 4) + 2 t + i % 2 of the tile.  A masked element becomes -inf,
    // so its probability is exactly 0 while the running max, which starts
    // at the floor NEG, stays finite.  Tiles wholly inside the keys, the
    // rows and the causal triangle, without segment ids, skip the mask.
    const bool whole = !SEG && k0 + BKV <= a.Lk && q0 + 64 <= a.Lq &&
                       (!a.causal || q0 + offset >= k0 + BKV - 1);
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int row = qi[(i >> 1) & 1];
      const int col = (i >> 2) * 8 + 2 * t + (i & 1);
      const int kj = k0 + col;
      float bv = 0.f;
      if constexpr (ROW)
        bv = Bs[col];
      else if (bias != nullptr && (whole || (kj < a.Lk && row < a.Lq)))
        bv = bias[row * a.bs_q + kj * a.bs_k];
      float x = fmaf(s[i], a.scale, bv);
      if (!whole && !(kj < a.Lk && row < a.Lq &&
                      (!a.causal || row + offset >= kj) &&
                      (!SEG || qseg[(i >> 1) & 1] == ksg[kj])))
        x = __int_as_float(0xff800000u);  // -inf
      s[i] = x;
    }
    // The streaming-softmax update per row, exp as exp2 of one FMA.
    constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        if (((i >> 1) & 1) == hh) mx = fmaxf(mx, s[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[hh], mx);
      const float alpha = exp2f((m[hh] - mnew) * LOG2E);
      const float ml = mnew * LOG2E;
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        if (((i >> 1) & 1) != hh) continue;
        s[i] = exp2f(fmaf(s[i], LOG2E, -ml));
        rs += s[i];  // l is the denominator before dropout
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[hh] = l[hh] * alpha + rs;
      m[hh] = mnew;
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        if (((i >> 1) & 1) == hh) o[i] *= alpha;
    }
    if (a.dropout) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int kj = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        s[i] = keep_bits(sd.x, sd.y, b, h, qi[(i >> 1) & 1], kj) >=
                       a.drop_thr
                   ? s[i] * a.inv_keep : 0.f;
      }
    }

    // O += P V (O already rescaled): P from the S fragment, split into hi
    // and lo, is the register A operand; this tile's product goes into a
    // fresh accumulator, lo products first, and is added into O in f32.
    uint32_t phi[4][4], plo[4][4];
    zoo_tf32::a_frags(s, phi, plo);
    auto dv = [](uint8_t* base, int jj) {
      return desc_b128(smem_u32(base) + jj * 32, 16, 1024);
    };
    float f[D / 2];
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      wgmma_pv_tf32<D>(f, plo[jj], dv(Vhi, jj), jj > 0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) wgmma_pv_tf32<D>(f, phi[jj], dv(Vlo, jj), 1);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) wgmma_pv_tf32<D>(f, phi[jj], dv(Vhi, jj), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(f);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] += f[i];
  }
  cp_async_wait<0>();

  float* out = static_cast<float*>(a.out) + b * a.os_b + h * a.os_h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (qi[hh] >= a.Lq) continue;
    const float inv = 1.f / fmaxf(l[hh], 1e-20f);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = c * 8 + 2 * t;
      *reinterpret_cast<float2*>(&out[qi[hh] * a.os_l + col]) =
          make_float2(o[4 * c + 2 * hh] * inv, o[4 * c + 2 * hh + 1] * inv);
    }
    if (a.m_out != nullptr && t == 0) {
      const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Lq + qi[hh];
      a.m_out[row] = m[hh];
      a.l_out[row] = l[hh];
    }
  }
}

// ---------------------------------------------------------------------------
// Head dims above 128 that are multiples of 64: tensor cores over 128-byte
// column chunks (design note at the top of the file)
// ---------------------------------------------------------------------------

constexpr int WIDE_KEYS = zoo_tf32::SR;     // keys a tile: 32
constexpr int Q_PIECE = 64 * 128;           // a chunk of the 64 query rows
constexpr int KV_PIECE = WIDE_KEYS * 128;   // a chunk of a tile's 32 keys
// f32 column chunks a slot: two with 64 columns a warpgroup, one with 128
// (whose transposed V leaves no room for larger slots)
__host__ __device__ constexpr int wide_cps(int cpw) {
  return cpw == 64 ? 2 : 1;
}
constexpr int WIDE_REST = WIDE_KEYS * 4 + 9 * 8 + 1024;  // bias row,
                                            // mbarriers, alignment

// Output columns a warpgroup: f32 128 where the head dim is a multiple of
// 128 (two 64-column halves, each its own fresh accumulator per tile: half
// the slices, which each form S again), else 64; bf16 and f16 64.
__host__ __device__ constexpr int fwd_wide_cols(bool exact, int D) {
  return !exact && D % 128 == 0 ? 128 : 64;
}
// Warpgroups a block, one per `cpw` output columns of its slice: 3 where
// the head dim has a multiple of 3 warpgroups' columns, else 2.
__host__ __device__ constexpr int fwd_wide_warpgroups(int D, int cpw) {
  return D / cpw % 3 == 0 ? 3 : 2;
}

// How the chunked forward stages a tile.  A chunk is one 128-byte column
// chunk (32 f32 or 64 16-bit columns) of the rows; a group is the `cps`
// chunks one ring slot holds, brought in by one tensor copy per operand:
// Q's 64 rows (unless Q stays whole in shared memory, `qres`), K's 32 rows
// of the tile and, in the groups that hold columns of the block's slice,
// `vp` chunks of V's 32 rows.  Sizes in bytes.
struct WidePlan {
  int qres, cps, vp, nslot, slot, vbytes, smem;
};
__host__ __device__ constexpr WidePlan wide_plan(int nwg, int cpw,
                                                 bool exact, int D) {
  if (!exact) {
    // f32: wide_cps chunks a slot, Q with them; the slice's V split and
    // transposed into hi and lo tiles; two lo slots, the warpgroups'
    // partial scores
    const int cps = wide_cps(cpw);
    const int slot = cps * (Q_PIECE + 2 * KV_PIECE);
    const int vbytes = 2 * nwg * cpw * 128;
    return {0, cps, cps, 3, slot, vbytes,
            vbytes + 3 * slot + 2 * cps * (Q_PIECE + KV_PIECE) +
                nwg * 16 * 128 * 4 + WIDE_REST};
  }
  // bf16, f16: Q whole, loaded once, and a slot a tile (all its K chunks
  // and the slice's V, read by wgmma where it landed), two slots, where
  // they fit (two blocks an SM up to head dim 320; more slots were no
  // faster)
  const int nch = D / 64;
  const int slot = (nch + nwg) * KV_PIECE;
  if (D * 128 + 2 * slot + WIDE_REST <= 232448)
    return {1, nch, nwg, 2, slot, 0, D * 128 + 2 * slot + WIDE_REST};
  // wider 16-bit: one chunk a slot, Q with it, V copied out of the ring
  return {0, 1, 1, 8, Q_PIECE + 2 * KV_PIECE, nwg * KV_PIECE,
          nwg * KV_PIECE + 8 * (Q_PIECE + 2 * KV_PIECE) + WIDE_REST};
}
static_assert(wide_plan(3, 64, false, 192).smem <= 232448 &&
                  wide_plan(3, 128, false, 384).smem <= 232448 &&
                  wide_plan(3, 64, true, 4096).smem <= 232448,
              "a block may have 227 KB of shared memory");

// 16-bit blocks that fit two to an SM (by shared memory: head dims up to
// 320)
// get the registers for two, except the three-warpgroup full-bias kernel,
// which then spills; f32 takes one block an SM.
__host__ __device__ constexpr int wide_min_blocks(bool exact, int nwg,
                                                  bool row) {
  return exact && (row || nwg == 2) ? 2 : 1;
}

// One block per 64 query rows and NWG x CPW output columns (its slice:
// blockIdx.x = query tile x slices + slice), NWG warpgroups, CPW columns
// each.  ROW and SEG as in flash_fwd_tf32_kernel.  T = float: 3xTF32;
// T = bf16 or f16: wgmma of that type.  The tensor maps are (column in
// chunk, row, chunk, head, batch), with boxes as wide_plan stages them.
template <typename T, int NWG, int CPW, bool ROW, bool SEG>
__global__ void __launch_bounds__(
    WG_THREADS * NWG, wide_min_blocks(zoo_sm90::is_16bit_v<T>, NWG, ROW))
    flash_fwd_wide_kernel(Args a, const __grid_constant__ zoo_tma::Maps maps,
                          int D) {
  using namespace zoo_sm90;
  using zoo_tf32::transposed;
  constexpr bool EXACT = is_16bit_v<T>;  // bf16, f16: no lo pieces
  constexpr int NT = WG_THREADS * NWG;
  constexpr int CW = 128 / sizeof(T);     // columns a chunk
  constexpr int BKV = WIDE_KEYS;
  constexpr int NVC = NWG * CPW / CW;     // chunks of the slice's columns
  constexpr int FCPS = wide_cps(CPW);     // f32 chunks a slot
  constexpr int LO = FCPS * (Q_PIECE + KV_PIECE);  // an f32 lo slot
  const WidePlan plan = wide_plan(NWG, CPW, EXACT, D);
  const bool qres = plan.qres;
  const int cps = plan.cps, nslot = plan.nslot, sbytes = plan.slot;
  const int kofs = qres ? 0 : cps * Q_PIECE;  // K pieces in a slot
  const int vofs = kofs + cps * KV_PIECE;     // V pieces
  extern __shared__ uint8_t smem_raw[];
  uint8_t* vs = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* qs = vs + plan.vbytes;  // Q kept whole
  uint8_t* slots = qs + (qres ? D * 128 : 0);
  uint8_t* los = slots + nslot * sbytes;  // f32 only
  float* red = reinterpret_cast<float*>(los + (EXACT ? 0 : 2 * LO));
  float* Bs = red + (EXACT ? 0 : NWG * 16 * 128);
  // an mbarrier a slot (its group landed), then one for Q kept whole
  const uint32_t full = smem_u32(Bs + BKV);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, lt = tid & 127;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nch = D / CW;
  const int ngr = nch / cps;                // groups a tile
  const int ns = (D + NWG * CPW - 1) / (NWG * CPW);  // slices
  const int slice = blockIdx.x % ns;
  const int q0 = blockIdx.x / ns * 64;
  const int c0 = slice * NWG * CPW;         // the slice's first column
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int offset = a.Lk - a.Lq;  // end-aligned causal diagonal
  const float* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.bs_b + h * a.bs_h;
  const int* ksg = SEG ? a.kv_seg + b * a.Lk : nullptr;

  // Keys at or past kend are masked for every row of this tile.
  const int kend = a.causal ? min(a.Lk, q0 + 64 + offset) : a.Lk;
  const int n_tiles = kend > 0 ? (kend + BKV - 1) / BKV : 0;
  const int nall = n_tiles * ngr;  // groups, in (tile, group) order

  // Group n (group gi of tile n / ngr) into slot n % nslot, one tensor
  // copy an operand from one thread, completing on the slot's mbarrier;
  // rows and columns past the tensor read as zeros.
  auto issue = [&](int n) {
    if (tid != 0 || n >= nall) return;
    const int st = n % nslot, gi = n % ngr, k0 = n / ngr * BKV;
    const bool with_v = gi * cps < NVC;
    const uint32_t bar = full + 8 * st;
    const uint32_t dst = smem_u32(slots + st * sbytes);
    fence_proxy_async();  // the slot's last readers were generic too
    mbar_arrive_tx(bar, vofs + (with_v ? plan.vp * KV_PIECE : 0));
    if (!qres) tma_load_5d(dst, &maps.q, 0, q0, gi * cps, h, b, bar);
    tma_load_5d(dst + kofs, &maps.k, 0, k0, gi * cps, h, b, bar);
    if (with_v)
      tma_load_5d(dst + vofs, &maps.v, 0, k0, c0 / CW + gi * cps, h, b,
                  bar);
  };
  auto landed = [&](int n) {
    mbar_wait(full + 8 * (n % nslot), (n / nslot) & 1);
  };
  // Complete group n (group gi): f32 splits its Q and K values, hi in place
  // and lo into lo slot n % 2, and its V chunks of the slice into the
  // transposed hi and lo tiles; 16-bit one chunk a slot copies a V chunk
  // as it is (16-bit with Q whole reads V in the slot).  Q and K units: 8 lanes
  // a row; V units: lane = key, so that the transposed stores hit every
  // bank once a warp.
  auto complete = [&](int n, int gi) {
    uint8_t* sl = slots + n % nslot * sbytes;
    if constexpr (EXACT) {
      if (!qres && gi < NVC)
        for (int u = tid; u < KV_PIECE / 16; u += NT) {
          const uint32_t off = swz(u & 31, u >> 5);
          *reinterpret_cast<uint4*>(vs + gi * KV_PIECE + off) =
              *reinterpret_cast<const uint4*>(sl + vofs + off);
        }
    } else {
      constexpr int QU = FCPS * Q_PIECE / 16;   // Q units, then K's
      constexpr int KU = FCPS * KV_PIECE / 16;  // and V's
      uint8_t* lo = los + n % 2 * LO;
      const int units = QU + KU + (gi * FCPS < NVC ? KU : 0);
      // not unrolled: the temporaries of several units at once made the
      // three-warpgroup kernel spill
#pragma unroll 1
      for (int u = tid; u < units; u += NT) {
        uint32_t h4[4], l4[4];
        const bool qk = u < QU + KU;
        uint32_t off;
        if (qk)  // Q rows, then K rows, of both chunks
          off = u < QU ? (u >> 9) * Q_PIECE + swz((u >> 3) & 63, u & 7)
                       : FCPS * Q_PIECE + ((u - QU) >> 8) * KV_PIECE +
                             swz(((u - QU) >> 3) & 31, u & 7);
        else  // V: key row (the lane), 4 columns of a chunk
          off = vofs + ((u - QU - KU) >> 8) * KV_PIECE +
                swz(u & 31, ((u - QU - KU) >> 5) & 7);
        const uint4 x = *reinterpret_cast<const uint4*>(sl + off);
        split_tf32(__uint_as_float(x.x), h4[0], l4[0]);
        split_tf32(__uint_as_float(x.y), h4[1], l4[1]);
        split_tf32(__uint_as_float(x.z), h4[2], l4[2]);
        split_tf32(__uint_as_float(x.w), h4[3], l4[3]);
        if (qk) {
          *reinterpret_cast<uint4*>(sl + off) =
              make_uint4(h4[0], h4[1], h4[2], h4[3]);
          *reinterpret_cast<uint4*>(lo + off) =
              make_uint4(l4[0], l4[1], l4[2], l4[3]);
        } else {
          const int w = u - QU - KU;
          const int col = (gi * FCPS + (w >> 8)) * CW + 4 * ((w >> 5) & 7);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t toff = transposed(col + e, u & 31);
            *reinterpret_cast<uint32_t*>(vs + toff) = h4[e];
            *reinterpret_cast<uint32_t*>(vs + NWG * CPW * 128 + toff) =
                l4[e];
          }
        }
      }
    }
  };

  float mld = 0.f;  // this thread's key of the next tile's bias row
  auto load_row = [&](int k0) {
    if (ROW && tid < BKV)
      mld = bias != nullptr && k0 + tid < a.Lk ? bias[(k0 + tid) * a.bs_k]
                                               : 0.f;
  };
  if (tid == 0)
    for (int j = 0; j <= nslot; ++j) mbar_init(full + 8 * j, 1);
  __syncthreads();
  if (qres && tid == 0 && n_tiles > 0) {  // Q whole: one copy
    const uint32_t bar = full + 8 * nslot;
    mbar_arrive_tx(bar, D * 128);
    tma_load_5d(smem_u32(qs), &maps.q, 0, q0, 0, h, b, bar);
  }
  for (int j = 0; j < nslot - 1; ++j) issue(j);
  load_row(0);

  // this thread's rows of the tile: warp * 16 + g + 8 hh, hh = 0, 1, with
  // their segment ids and dropout hashes
  const uint2 sd = load_seed(a);
  const uint32_t hash = keep_base(sd.x, sd.y, b, h);
  int qi[2], qseg[2];
  uint32_t rhash[2];
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qi[hh] = q0 + warp * 16 + g + 8 * hh;
    qseg[hh] = SEG && qi[hh] < a.Lq ? a.q_seg[b * a.Lq + qi[hh]] : 0;
    rhash[hh] = hash ^ keep_q(qi[hh]);
    m[hh] = NEG;
    l[hh] = 0.f;
  }
  float o[CPW / 64][32];  // this warpgroup's output columns, 64 at a time
#pragma unroll
  for (int hf = 0; hf < CPW / 64; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hf][i] = 0.f;
  if (qres && n_tiles > 0) mbar_wait(full + 8 * nslot, 0);

  int n = 0;  // the group being multiplied
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKV;
    // ---- S = Q K^T over the head dim, group by group: f32 each
    // warpgroup its part (three: one product each, lo . hi, hi . lo,
    // hi . hi; two: half the k-steps), 16-bit each warpgroup the whole
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    landed(n);        // the tile's first group
    __syncthreads();  // and the last tile's readers are done
    complete(n, 0);
    if (ROW && tid < BKV) Bs[tid] = mld;
    if (j + 1 < n_tiles) load_row(k0 + BKV);
    fence_proxy_async();
    __syncthreads();
    const uint8_t* vtile = slots + n % nslot * sbytes + vofs;  // Q whole
    for (int gi = 0; gi < ngr; ++gi, ++n) {
      // group n's products run while group n + nslot - 1 is copied (into
      // the slot group n - 1 left) and group n + 1 is completed
      const uint32_t hi = smem_u32(slots + n % nslot * sbytes);
      auto desc = [](uint32_t base, int kk) {
        return desc_b128(base + kk * 32, 16, 1024);
      };
      wgmma_fence();
      if constexpr (EXACT) {  // Q kept whole or in the slot
        for (int c = 0; c < cps; ++c) {
          const uint32_t qa =
              qres ? smem_u32(qs + (gi * cps + c) * Q_PIECE) : hi;
          const uint32_t kb = hi + kofs + c * KV_PIECE;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n32k16_ss<T, 0>(s, desc(qa, kk), desc(kb, kk), 1);
        }
      } else {
        const uint32_t lo = smem_u32(los + n % 2 * LO);
#pragma unroll
        for (int c = 0; c < FCPS; ++c) {
          const uint32_t qh = hi + c * Q_PIECE, ql = lo + c * Q_PIECE;
          const uint32_t kh = hi + kofs + c * KV_PIECE;
          const uint32_t kl = lo + kofs + c * KV_PIECE;
          if constexpr (NWG == 3) {
            const uint32_t pa = wg == 0 ? ql : qh, pb = wg == 1 ? kl : kh;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_tf32_m64n32k8_ss(s, desc(pa, kk), desc(pb, kk), 1);
          } else {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int kk = wg + 2 * i;
              wgmma_tf32_m64n32k8_ss(s, desc(ql, kk), desc(kh, kk), 1);
              wgmma_tf32_m64n32k8_ss(s, desc(qh, kk), desc(kl, kk), 1);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wgmma_tf32_m64n32k8_ss(s, desc(qh, wg + 2 * i),
                                     desc(kh, wg + 2 * i), 1);
          }
        }
      }
      wgmma_commit();
      issue(n + nslot - 1);
      if (gi + 1 < ngr) {
        landed(n + 1);
        complete(n + 1, gi + 1);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      fence_operand(s);
      __syncthreads();  // group n + 1 complete; group n's slots free
    }
    if constexpr (!EXACT) {
      // the warpgroups' parts, added in warpgroup order (lo products
      // first) by every warpgroup, so each holds the same whole S
#pragma unroll
      for (int i = 0; i < 16; ++i) red[(wg * 16 + i) * 128 + lt] = s[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < NWG; ++w) x += red[(w * 16 + i) * 128 + lt];
        s[i] = x;
      }
    }

    // Scale, bias and mask as in the kernels above (each warpgroup the
    // whole tile: the same values in all): element i is row g + 8
    // ((i / 2) % 2), key 8 (i / 4) + 2 t + i % 2 of the tile.  A masked
    // element becomes -inf, so its probability is exactly 0 while the
    // running max, which starts at the floor NEG, stays finite.  Tiles
    // wholly inside the keys, the rows and the causal triangle, without
    // segment ids, skip the mask.
    const bool whole = !SEG && k0 + BKV <= a.Lk && q0 + 64 <= a.Lq &&
                       (!a.causal || q0 + offset >= k0 + BKV - 1);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = qi[(i >> 1) & 1];
      const int col = (i >> 2) * 8 + 2 * t + (i & 1);
      const int kj = k0 + col;
      float bv = 0.f;
      if constexpr (ROW)
        bv = Bs[col];
      else if (bias != nullptr && (whole || (kj < a.Lk && row < a.Lq)))
        bv = bias[row * a.bs_q + kj * a.bs_k];
      float x = fmaf(s[i], a.scale, bv);
      if (!whole && !(kj < a.Lk && row < a.Lq &&
                      (!a.causal || row + offset >= kj) &&
                      (!SEG || qseg[(i >> 1) & 1] == ksg[kj])))
        x = __int_as_float(0xff800000u);  // -inf
      s[i] = x;
    }
    // The streaming-softmax update per row, exp as exp2 of one FMA.
    constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (((i >> 1) & 1) == hh) mx = fmaxf(mx, s[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[hh], mx);
      const float alpha = exp2f((m[hh] - mnew) * LOG2E);
      const float ml = mnew * LOG2E;
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (((i >> 1) & 1) != hh) continue;
        s[i] = exp2f(fmaf(s[i], LOG2E, -ml));
        rs += s[i];  // l is the denominator before dropout
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[hh] = l[hh] * alpha + rs;
      m[hh] = mnew;
#pragma unroll
      for (int hf = 0; hf < CPW / 64; ++hf)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == hh) o[hf][i] *= alpha;
    }
    if (a.dropout) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int kj = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        s[i] = mix32(rhash[(i >> 1) & 1] ^ keep_k(kj)) >= a.drop_thr
                   ? s[i] * a.inv_keep : 0.f;
      }
    }

    // ---- O += P V over this warpgroup's 64 columns (every warpgroup
    // issues it; one past the head dim stores nothing): P from the S
    // fragment is the register A operand
    if constexpr (EXACT) {
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      const uint32_t vb = smem_u32((qres ? vtile : vs) + wg * KV_PIECE);
      fence_operand(o[0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_m64n64k16_rs<T, 1>(o[0], pa[kk],
                                 desc_b128(vb + kk * 2048, KV_PIECE, 1024),
                                 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(o[0]);
    } else {
      // split into hi and lo, into a fresh accumulator added into O in f32
      uint32_t phi[4][4], plo[4][4];
      zoo_tf32::a_frags(s, phi, plo);
#pragma unroll
      for (int hf = 0; hf < CPW / 64; ++hf)  // 64 columns at a time
        zoo_tf32::accumulate<false>(o[hf], phi, plo, smem_u32(vs),
                                    smem_u32(vs + NWG * CPW * 128),
                                    wg * (CPW / 64) + hf);
    }
  }

  if (c0 + wg * CPW >= D) return;
  T* out = static_cast<T*>(a.out) + b * a.os_b + h * a.os_h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (qi[hh] >= a.Lq) continue;
    const float inv = 1.f / fmaxf(l[hh], 1e-20f);
#pragma unroll
    for (int hf = 0; hf < CPW / 64; ++hf)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        T* p = &out[qi[hh] * a.os_l + c0 + wg * CPW + hf * 64 + c * 8 +
                    2 * t];
        store_as(p, o[hf][4 * c + 2 * hh] * inv);
        store_as(p + 1, o[hf][4 * c + 2 * hh + 1] * inv);
      }
    if (a.m_out != nullptr && slice == 0 && wg == 0 && t == 0) {
      const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Lq + qi[hh];
      a.m_out[row] = m[hh];
      a.l_out[row] = l[hh];
    }
  }
}

}  // namespace zoo_flash
