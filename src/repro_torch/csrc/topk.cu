// Block-local magnitude top-k on Hopper: for each contiguous block of b
// values keep the k largest |x| (dense output, the rest +0.0).
//
// Replaces the Pallas TPU kernel repro/kernels/topk.py::_topk_block_kernel
// (pallas_call at topk.py:55) and reproduces its selection exactly (first
// index on ties, a NaN keeps nothing, an inf keeps only the first inf): see
// topk_select.cuh, shared with encode.cu's topk_streams.
//
// Bound: latency. A block moves 2*b elements (8 KB at b = 1000, f32); one
// launch of one block sits at a launch's floor unless its dependent steps
// add up. Design: one thread block per vector block; the keys bits(|x|) in
// shared memory (4 bytes a value, b <= topk.MAX_BLOCK), a radix select with
// at most 4 digit passes whatever k is, then each thread writes its
// contiguous chunk: x copied bitwise where kept, +0.0 elsewhere.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

using topk_select::kThreads;

// bits(|x|) as an fp32 pattern (bf16 widens exactly).
__device__ __forceinline__ uint32_t abs_key(float v) { return __float_as_uint(v) & 0x7fffffffu; }
__device__ __forceinline__ uint32_t abs_key(uint16_t bf16_bits) {
  return ((uint32_t)bf16_bits << 16) & 0x7fffffffu;
}

// T = float, or uint16_t holding bf16 bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const T* __restrict__ x, T* __restrict__ out, int b, int k) {
  extern __shared__ uint32_t keys[];  // [b]
  const T* xb = x + (size_t)blockIdx.x * b;
  T* ob = out + (size_t)blockIdx.x * b;

  int flags = 0;
  for (int i = threadIdx.x; i < b; i += kThreads) {
    keys[i] = abs_key(xb[i]);
    flags |= topk_select::key_flags(keys[i]);
  }
  flags = topk_select::block_flags(flags);
  const topk_select::Threshold th = topk_select::find_threshold(keys, b, k, flags);
  topk_select::walk_kept(keys, b, th, [&](int i, bool kept, int) { ob[i] = kept ? xb[i] : T(0); });
}

template <typename T>
int launch(const void* x, void* out, int nblocks, int b, int k, cudaStream_t s) {
  // Set at every launch, even below 48 KB (see l1_subgrad.cu: a launch with
  // 48000 B of dynamic shared memory failed without it).
  const size_t smem = (size_t)b * sizeof(uint32_t);
  const cudaError_t e = cudaFuncSetAttribute(block_topk_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  block_topk_kernel<T><<<nblocks, kThreads, smem, s>>>(static_cast<const T*>(x), static_cast<T*>(out), b, k);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [nblocks * b] contiguous, dtype 0 = f32, 1 = bf16; b < 65536.
// Launches on `stream`, does not synchronise, returns cudaError_t.
extern "C" int block_topk(const void* x, void* out, int dtype, int nblocks, int b, int k,
                          void* stream) {
  if (nblocks <= 0 || b <= 0 || b >= 65536 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, out, nblocks, b, k, s) : launch<uint16_t>(x, out, nblocks, b, k, s);
}
