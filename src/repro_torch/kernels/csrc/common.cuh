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

// VEC consecutive elements from ``p`` into ``v`` (and back): one 16-byte
// access when VEC elements fill 16 bytes (``p`` then 16-byte aligned, the
// caller's check), element by element otherwise.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[VEC]) {
  if constexpr (sizeof(T) * VEC == 16) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[VEC]) {
  if constexpr (sizeof(T) * VEC == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

// Asynchronous global -> shared copies (cp.async, sm_80+), in commit groups.
// ``cp_async16`` copies 16 bytes, or writes 16 zero bytes when ``full`` is
// false (src-size 0: nothing is read, so ``src`` need only be a valid
// address); both addresses 16-byte aligned.  ``cp_async4`` copies 4 bytes.
// A thread sees its own copies after ``cp_async_wait<N>`` (at most N of its
// groups still pending); other threads' copies after a barrier as well.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Opt ``Kernel`` into ``bytes`` of dynamic shared memory, once per device (a
// host call outside any stream, so none is made during a graph capture after
// the kernel's first launch).  One flag set per kernel instantiation.
template <auto Kernel>
inline cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
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
