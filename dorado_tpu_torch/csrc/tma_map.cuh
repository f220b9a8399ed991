// TMA tensor maps, built on the host for the kernels of this directory that
// load or store tiles by TMA (fused_norm.cu, w8a8_matmul.cu, w8a8_matmul_fq.cu,
// crf_traceback.cu, beam_search.cu). The encoder is looked up at run time through
// cudaGetDriverEntryPoint, so no library links libcuda.
#pragma once

// CUtensorMap and its enums
#include <cuda.h>
#include <cuda_runtime.h>

// cuTensorMapEncodeTiled's signature
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows][cols] tensor of float32 (elem_bytes 4), bf16 (2) or int8 (1), cols contiguous,
// in boxes of box_rows x box_cols, swizzled over the box's row of box_cols *
// elem_bytes bytes (128, 64 or 32); reads past its edges give zeros and
// stores past them are dropped.
inline bool make_map(CUtensorMap* map, const void* base, int elem_bytes, int rows, int cols,
                     int box_rows, int box_cols) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const int span = box_cols * elem_bytes;
  if (span != 128 && span != 64 && span != 32) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUtensorMapDataType type = elem_bytes == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                     : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : (span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B),
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [T][N][R] history of 1- or 4-byte elements (R * elem_bytes a multiple of
// 16), read in boxes of `steps` consecutive t of one n, each landing as a
// dense [steps][R] block in shared memory. R is cut as (min(R, 256), the
// rest) for TMA's limit of 256 elements on a box's side. Reads past t's
// edges (a negative first t included) give zeros.
inline bool make_history_map(CUtensorMap* map, const void* base, int elem_bytes, int T, int N,
                             int R, int steps) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const int inner = R < 256 ? R : 256;
  if (R % inner || (inner * elem_bytes) % 16) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)(R / inner), (cuuint64_t)N,
                              (cuuint64_t)T};
  const cuuint64_t strides[3] = {(cuuint64_t)inner * elem_bytes, (cuuint64_t)R * elem_bytes,
                                 (cuuint64_t)N * R * elem_bytes};
  const cuuint32_t box[4] = {(cuuint32_t)inner, (cuuint32_t)(R / inner), 1, (cuuint32_t)steps};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How many clusters of `cluster` CTAs of `threads` threads and `smem` bytes
// of dynamic shared memory the card runs at once, for `kernel`: asked once
// for each device and shape, then kept (a few shapes a library).
inline cudaError_t active_clusters(const void* kernel, int cluster, int threads, int smem,
                                   int* active) {
  struct Entry {
    const void* kernel;
    int dev, cluster, smem, active;
  };
  static Entry seen[32];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == kernel && seen[i].dev == dev && seen[i].cluster == cluster &&
        seen[i].smem == smem) {
      *active = seen[i].active;
      return cudaSuccess;
    }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (*active < 1) return cudaErrorInvalidConfiguration;
  if (n_seen < 32) seen[n_seen++] = {kernel, dev, cluster, smem, *active};
  return cudaSuccess;
}
