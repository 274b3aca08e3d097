// Host side of TMA: rank-4 tensor maps over the models' (batch, rows,
// heads, width) bf16 tensors, and a rank-2 f32 map over the fedavg
// kernel's (K, N) client stack, encoded through the libcuda the process has
// already loaded (no link against it at build time).  Header only;
// included by the kernels' .cu files that launch TMA-fed kernels.

#pragma once

#include <cuda.h>
#include <dlfcn.h>

namespace hopper {

// cuTensorMapEncodeTiled from the libcuda the process already loaded.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// Rank-4 map over a (batch, rows, heads, hd) bf16 tensor, innermost first,
// boxes of box_rows rows x 64 columns (128 bytes) of one head in the
// 128-byte swizzle; rows past `rows` read as zeros.
inline bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* base, int hd,
                       int heads, int rows, int batch, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * rows};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Rank-2 map over a row-major (rows, cols) f32 matrix whose rows lie
// row_bytes apart, innermost first: boxes of box_rows x box_cols, no
// swizzle; elements past the extent read as zeros.  TMA needs the base
// and row_bytes on the 16-byte grid, and box_cols * 4 a multiple of 16.
inline bool encode_map_f32_2d(EncodeTiled enc, CUtensorMap* map, const void* base,
                              long long cols, long long rows, long long row_bytes,
                              int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
