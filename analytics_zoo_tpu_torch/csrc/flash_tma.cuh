// Tensor maps for the tensor copies (TMA) of the chunked flash kernels, host
// side, shared by the forward (flash_attention_fwd.cu) and the backward
// (flash_attention_bwd.cu): `cuTensorMapEncodeTiled` reached through the
// runtime (no link to libcuda; int8_conv.cu encodes its weight map with it
// too), the (D, L, H, B) map of one input with
// boxes of 32 columns x 32 rows (the backward), and the map whose boxes are
// several 128-byte column chunks (the forward).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace zoo_tma {

// The tensor-map element type of an input type (f32, bf16 or f16).
template <typename T>
constexpr CUtensorMapDataType map_type() {
  static_assert(std::is_same<T, float>::value ||
                    std::is_same<T, __nv_bfloat16>::value ||
                    std::is_same<T, __half>::value,
                "f32, bf16 or f16");
  return std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The tensor maps of q, k, v and dO (the forward leaves dO unset), passed
// to a kernel as one __grid_constant__ parameter.
struct Maps {
  CUtensorMap q, k, v, g;
};

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda), or null.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The (D, L, H, B) map of one input of type T with boxes of 32 columns x
// 32 rows: f32 into the 128-byte-swizzled layout wgmma reads, bf16 and f16
// as loaded.  Boxes past the tensor's edges read as zeros.  False where
// the tensor copies cannot take it (a base or a stride not a multiple of
// 16 bytes).
template <typename T>
inline bool encode_map(CUtensorMap* map, const void* p, int D, int L, int H,
                       int B, int64_t s_b, int64_t s_h, int64_t s_l) {
  constexpr int esize = sizeof(T);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(p) % 16 != 0 ||
      s_b * esize % 16 != 0 || s_h * esize % 16 != 0 ||
      s_l * esize % 16 != 0 || s_b <= 0 || s_h <= 0)
    return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_l * esize),
                                 static_cast<cuuint64_t>(s_h * esize),
                                 static_cast<cuuint64_t>(s_b * esize)};
  const cuuint32_t box[4] = {32, 32, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, map_type<T>(), 4, const_cast<void*>(p), dims, strides,
            box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            esize == 4 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of one input of type T (f32, bf16 or f16) as (column in chunk,
// row, chunk, head, batch): the head dim cut into chunks of 128 bytes (32
// f32 or 64 16-bit columns), so that one box of `rows` rows x `chunks`
// chunks lands as `chunks` pieces of 128-byte-swizzled rows, one after
// another.  False where the tensor copies cannot take it (a base or a
// stride not a multiple of 16 bytes).
template <typename T>
inline bool encode_chunked_map(CUtensorMap* map, const void* p, int D,
                               int L, int H, int B, int64_t s_b, int64_t s_h,
                               int64_t s_l, int rows, int chunks) {
  constexpr int esize = sizeof(T);
  const EncodeTiled fn = encode_tiled();
  const int cols = 128 / esize;
  if (fn == nullptr || reinterpret_cast<uintptr_t>(p) % 16 != 0 ||
      s_b * esize % 16 != 0 || s_h * esize % 16 != 0 ||
      s_l * esize % 16 != 0 || s_b <= 0 || s_h <= 0 || D % cols != 0)
    return false;
  const cuuint64_t dims[5] = {
      static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(L),
      static_cast<cuuint64_t>(D / cols), static_cast<cuuint64_t>(H),
      static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(s_l * esize), 128,
                                 static_cast<cuuint64_t>(s_h * esize),
                                 static_cast<cuuint64_t>(s_b * esize)};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows),
                             static_cast<cuuint32_t>(chunks), 1, 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return fn(map, map_type<T>(), 5, const_cast<void*>(p), dims, strides,
            box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace zoo_tma
