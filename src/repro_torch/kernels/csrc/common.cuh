// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library has a plain C interface (no PyTorch headers): the
// Python wrapper passes raw device pointers, strides and the current CUDA
// stream through ctypes, and each entry point returns cudaGetLastError() so
// a refused launch surfaces as an exception in the wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Masked-score value; matches NEG_INF of the JAX kernels (kernels/ref.py).
constexpr float kNegInf = -1e30f;

// dtype codes shared with kernels/build.py (DTYPE_CODE)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

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

// Block-wide max / sum over NT threads (NT a multiple of 32).  ``red`` is a
// shared scratch of NT/32 floats; the trailing barrier makes it reusable by
// the next reduction.  The summation order is fixed, so results are
// deterministic run to run.
template <int NT>
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

template <int NT>
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r += red[i];
  __syncthreads();
  return r;
}

}  // namespace repro
