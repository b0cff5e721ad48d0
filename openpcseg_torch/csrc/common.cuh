// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel file exposes a plain C ABI (no PyTorch headers): the Python
// wrappers in openpcseg_torch/ops/ load the shared library with ctypes and
// pass each pointer and the CUDA stream as c_void_p. Each entry point
// returns cudaGetLastError() right after its launch, so a refused launch
// (too many threads, too much shared memory) raises in the wrapper instead
// of silently never running.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define OPCS_API extern "C" __attribute__((visibility("default")))

namespace opcs {

// 8 bf16 values as one 16-byte vector (the widest single load per thread).
union Bf16x8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

}  // namespace opcs
