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
#include <stdint.h>

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

// Attention dropout: the counter-based keep-mask of the JAX package
// (kernels/attention.py `_mix32`, `_keep_bits`, `_keep_tile`). Score
// element (row, q, k) of a folded (bh, sq, sk) launch hashes its flat
// index (row*sq + q)*sk + k under two seeds and is kept iff the hash is
// >= threshold (round(rate * 2^32), capped at 2^32 - 1). uint32_t wraps
// mod 2^32 exactly as jnp.uint32 does, so the forward, the backward and
// the plain versions all rebuild the same mask from the indices alone.
// threshold 0 means no dropout: the launchers then take the kernels'
// dropout-free variant.
struct Dropout {
  uint32_t s0, s1, threshold;
  float inv_keep;  // 1 / (1 - rate)
};

// What a kernel is launched with: the two seeds stay in device memory
// (a row of the executor's per-step seed table), so a launch captured in
// a CUDA graph reads the seeds of the step being replayed. The rate is
// static: threshold and inv_keep go by value.
struct DropoutArgs {
  const uint32_t* seeds;
  uint32_t threshold;
  float inv_keep;
};

// the seeds read once at the top of a kernel; the dropout-free variant
// never dereferences the pointer
template <bool kDrop>
__device__ __forceinline__ Dropout load_dropout(const DropoutArgs& a) {
  if (!kDrop) return Dropout{0u, 0u, 0u, 1.f};
  return Dropout{__ldg(a.seeds), __ldg(a.seeds + 1), a.threshold, a.inv_keep};
}

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t keep_bits(uint32_t idx, uint32_t s0,
                                              uint32_t s1) {
  return mix32(mix32((idx * 0x9E3779B1u) ^ s0) ^ s1);
}

__device__ __forceinline__ bool keep(const Dropout& dp, long long row, int sq,
                                     int sk, int q, int k) {
  const uint32_t idx =
      (static_cast<uint32_t>(row) * static_cast<uint32_t>(sq) +
       static_cast<uint32_t>(q)) *
          static_cast<uint32_t>(sk) +
      static_cast<uint32_t>(k);
  return keep_bits(idx, dp.s0, dp.s1) >= dp.threshold;
}

// x scaled by 1 / (1 - rate) where (row, q, k) is kept, else 0
__device__ __forceinline__ float dropped(const Dropout& dp, long long row,
                                         int sq, int sk, int q, int k,
                                         float x) {
  return keep(dp, row, sq, sk, q, k) ? x * dp.inv_keep : 0.f;
}

}  // namespace ff
