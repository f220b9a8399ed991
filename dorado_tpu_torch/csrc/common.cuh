// Helpers shared by the kernels of this directory. Each .cu file is built
// into its own shared library with a plain C interface (see ops/_cuda.py),
// so every library carries its own copy of dtt_error_string.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DTT_EXPORT extern "C" __attribute__((visibility("default")))

DTT_EXPORT const char* dtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four consecutive bf16 values (8 bytes) of one score row, as floats.
__device__ __forceinline__ void unpack4(uint2 v, float out[4]) {
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&v.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&v.y);
  out[0] = __low2float(lo);
  out[1] = __high2float(lo);
  out[2] = __low2float(hi);
  out[3] = __high2float(hi);
}
