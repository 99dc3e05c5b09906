// K4: block-COO sparse decode (tensor_sparse_dec, the sparse wire codec).
//
// Replaces sparse_dec_pallas (_dec_kernel) of src/repro/kernels/sparse_dec.py.
//
// Contract (bitwise against sparse_dec_xla, the scatter-add of every slot
// into a zeroed dense vector): block b of the output, elements
// [b*512, (b+1)*512), receives the values of slots vals/idx [b, 0:kb].
//
// What bounds it on an H100: bytes (2 KiB written per block, 8 B read per
// slot).  Design: one block of 512 threads per output block; the threads
// zero the block, synchronise, then each stores its slots.  Only slots whose
// value is nonzero are stored.  An empty slot is (0, block base), and block
// base may also hold a real value: a plain store of the empty slot's 0
// would race with it.  Skipping zeros equals the scatter-add bitwise,
// because an encoded value is nonzero (|x| > threshold >= 0) and the real
// indices of a block are unique, so every position receives exactly one
// value or none.  A slot whose index lies outside its block is dropped, as
// the TPU kernel's one-hot over the block drops it.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kB = 512;

template <typename T>
__global__ void __launch_bounds__(kB)
sparse_dec_kernel(const T* __restrict__ vals, const int32_t* __restrict__ idx,
                  T* __restrict__ out, int kb) {
  const int b = blockIdx.x;
  const long long base = (long long)b * kB;
  out[base + threadIdx.x] = repro::from_f32<T>(0.f);
  __syncthreads();
  const long long in = (long long)b * kb;
  for (int s = threadIdx.x; s < kb; s += kB) {
    const T v = vals[in + s];
    const long long local = (long long)idx[in + s] - base;
    if (repro::to_f32(v) != 0.f && local >= 0 && local < kB)
      out[base + local] = v;
  }
}

}  // namespace

// vals [nb, kb] (f32 or bf16), idx int32 [nb, kb] -> out [nb*512] in the
// values' dtype; 1 <= kb (the wrapper checks).
extern "C" int repro_sparse_dec(int dtype, const void* vals, const void* idx,
                                void* out, int nb, int kb, void* stream) {
  if (nb > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == repro::kFloat32)
      sparse_dec_kernel<float><<<nb, kB, 0, s>>>(
          (const float*)vals, (const int32_t*)idx, (float*)out, kb);
    else
      sparse_dec_kernel<__nv_bfloat16><<<nb, kB, 0, s>>>(
          (const __nv_bfloat16*)vals, (const int32_t*)idx,
          (__nv_bfloat16*)out, kb);
  }
  return (int)cudaGetLastError();
}
