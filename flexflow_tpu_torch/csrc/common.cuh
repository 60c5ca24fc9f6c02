// Shared helpers for the flexflow_tpu_torch CUDA kernels.
//
// Every kernel source in this directory exposes a plain C entry point
// (no PyTorch headers), is compiled by nvcc for sm_90a into its own
// shared library and is called through ctypes
// (flexflow_tpu_torch/kernels/build.py). Each entry point selects the
// caller's device, launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a launch
// that was refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ff {

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2 };

// the JAX package's masking value (kernels/attention.py NEG_INF): masked
// scores are -1e30, never -inf, so a fully masked row stays finite
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

}  // namespace ff
