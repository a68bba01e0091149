// Fused Adam update of a whole tree of f32 leaves in one launch, with a
// plain C interface for ctypes (analytics_zoo_tpu_torch/ops/cuda/
// fused_adam.py).
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
// bytes (BERT-base, ~110 M parameters: 2.6 GB, 0.79 ms at 3.35 TB/s).  What
// the TPU's per-leaf launch costs here is host time: one launch and one
// Python round trip per leaf (152 for BERT-base) took 4-6.5 ms a step for
// ~1.3 ms of device work.  So the design is one launch for the whole tree:
// - A leaf table (the g, mu and nu pointers, the element count and the
//   offset of the leaf's outputs in three flat output buffers) is a
//   __grid_constant__ kernel parameter, up to TABLE_LEAVES leaves (~11 KB;
//   CUDA 12.1 and later take kernel parameters up to 32 KB).  It travels
//   with the launch, so nothing on the host has to outlive the call and a
//   CUDA graph captures it with the launch.  A larger tree takes one launch
//   per TABLE_LEAVES leaves.
// - The work is cut into (leaf, chunk) units of CHUNK elements, numbered by
//   a prefix sum of the leaves' chunk counts; blocks walk the units with a
//   grid stride and find a unit's leaf by binary search in the table.  So
//   a 768-element LayerNorm leaf and the 23 M-element word embedding share
//   the 132 SMs evenly.
// - A chunk is read and written with 16-byte loads and stores where the
//   leaf's pointers are 16-byte aligned (the caller aligns every output
//   offset), with a scalar tail otherwise.
// - Each operation is rounded as written (no fused multiply-add), so the
//   kernel gives the plain PyTorch formula's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int CHUNK = 4096;  // elements a unit: 4 float4 a thread
constexpr int TABLE_LEAVES = 256;

struct Scalars {
  float lr, b1, b2, eps, bc1, bc2, c1, c2;  // c1 = 1 - b1, c2 = 1 - b2
};

struct Leaf {
  const float* g;
  const float* mu;
  const float* nu;
  int64_t off;  // of the leaf's outputs in the flat buffers, in elements
  int64_t n;
};

struct Table {
  Leaf leaf[TABLE_LEAVES];
  int start[TABLE_LEAVES + 1];  // first unit of each leaf; start[n] = units
  int n_leaves;
};

__device__ __forceinline__ void adam(const Scalars& k, float g, float& mu,
                                     float& nu, float& upd) {
  mu = __fadd_rn(__fmul_rn(k.b1, mu), __fmul_rn(k.c1, g));
  nu = __fadd_rn(__fmul_rn(k.b2, nu), __fmul_rn(__fmul_rn(k.c2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, k.bc2)), k.eps);
  upd = __fdiv_rn(__fmul_rn(-k.lr, __fdiv_rn(mu, k.bc1)), den);
}

__global__ void __launch_bounds__(NT)
    adam_multi_kernel(const __grid_constant__ Table t, const float* scalars,
                      float* upd, float* mu_out, float* nu_out) {
  Scalars k;
  k.lr = scalars[0];
  k.b1 = scalars[1];
  k.b2 = scalars[2];
  k.eps = scalars[3];
  k.bc1 = scalars[4];
  k.bc2 = scalars[5];
  k.c1 = __fsub_rn(1.f, k.b1);
  k.c2 = __fsub_rn(1.f, k.b2);
  const int units = t.start[t.n_leaves];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int lo = 0, hi = t.n_leaves - 1;  // the last leaf with start <= u
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.start[mid] <= u) lo = mid;
      else hi = mid - 1;
    }
    const Leaf& f = t.leaf[lo];
    const int64_t c0 = static_cast<int64_t>(u - t.start[lo]) * CHUNK;
    const int64_t len = f.n - c0 < CHUNK ? f.n - c0 : CHUNK;
    const float* g = f.g + c0;
    const float* mu = f.mu + c0;
    const float* nu = f.nu + c0;
    float* up = upd + f.off + c0;
    float* mo = mu_out + f.off + c0;
    float* no = nu_out + f.off + c0;
    const bool vec = ((reinterpret_cast<uintptr_t>(g) |
                       reinterpret_cast<uintptr_t>(mu) |
                       reinterpret_cast<uintptr_t>(nu) |
                       reinterpret_cast<uintptr_t>(up)) & 15) == 0;
    const int64_t n4 = vec ? len / 4 : 0;
    for (int64_t i = threadIdx.x; i < n4; i += NT) {
      const float4 g4 = reinterpret_cast<const float4*>(g)[i];
      float4 m4 = reinterpret_cast<const float4*>(mu)[i];
      float4 v4 = reinterpret_cast<const float4*>(nu)[i];
      float4 u4;
      adam(k, g4.x, m4.x, v4.x, u4.x);
      adam(k, g4.y, m4.y, v4.y, u4.y);
      adam(k, g4.z, m4.z, v4.z, u4.z);
      adam(k, g4.w, m4.w, v4.w, u4.w);
      reinterpret_cast<float4*>(up)[i] = u4;
      reinterpret_cast<float4*>(mo)[i] = m4;
      reinterpret_cast<float4*>(no)[i] = v4;
    }
    for (int64_t i = 4 * n4 + threadIdx.x; i < len; i += NT) {
      float m = mu[i], v = nu[i], r;
      adam(k, g[i], m, v, r);
      up[i] = r;
      mo[i] = m;
      no[i] = v;
    }
  }
}

}  // namespace

// leaves: n_leaves rows of five int64 (g, mu, nu pointers; the offset of
// the leaf's outputs in the flat buffers, in elements, a multiple of 4; the
// element count), host memory, read before the call returns.  upd, mu_out,
// nu_out: flat f32 device buffers, 16-byte aligned.  scalars: a device
// array (lr, b1, b2, eps, bc1, bc2).  Launches one kernel per TABLE_LEAVES
// leaves on `stream`; returns 0 or a cudaError_t.
extern "C" int zoo_fused_adam_multi(const long long* leaves, int n_leaves,
                                    const float* scalars, float* upd,
                                    float* mu_out, float* nu_out,
                                    void* stream) {
  Table t;  // copied into the launch's parameters
  for (int first = 0; first < n_leaves; first += TABLE_LEAVES) {
    const int n = n_leaves - first < TABLE_LEAVES ? n_leaves - first
                                                  : TABLE_LEAVES;
    int units = 0;
    for (int i = 0; i < n; ++i) {
      const long long* row = leaves + 5 * (first + i);
      t.leaf[i] = Leaf{reinterpret_cast<const float*>(row[0]),
                       reinterpret_cast<const float*>(row[1]),
                       reinterpret_cast<const float*>(row[2]), row[3],
                       row[4]};
      t.start[i] = units;
      units += static_cast<int>((row[4] + CHUNK - 1) / CHUNK);
    }
    t.start[n] = units;
    t.n_leaves = n;
    const int blocks = units < 132 * 8 ? units : 132 * 8;
    if (blocks == 0) continue;
    adam_multi_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        t, scalars, upd, mu_out, nu_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}
