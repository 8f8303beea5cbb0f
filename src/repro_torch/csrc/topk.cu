// Block-local magnitude top-k on Hopper: for each contiguous block of b
// values keep the k largest |x| (dense output, the rest +0.0).
//
// Replaces the Pallas TPU kernel repro/kernels/topk.py::_topk_block_kernel
// (pallas_call at topk.py:55) and reproduces its arithmetic exactly: the
// selection (k rounds of a NaN-propagating block max, first index on ties, a
// selected inf turns into NaN and stops selection) is topk_select.cuh's,
// shared with encode.cu's topk_streams.
//
// Bound: latency. A block moves only 2*b elements (8 KB at b = 1000, f32) but
// runs k dependent block-wide reductions, each two __syncthreads apart.
// Design: one thread block per vector block; |x| and the keep flags live in
// shared memory (5 bytes per element, so b is limited by the 227 KB opt-in).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

using topk_select::kThreads;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t bf16_bits) {
  return __uint_as_float((uint32_t)bf16_bits << 16);
}

// T = float, or uint16_t holding bf16 bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const T* __restrict__ x, T* __restrict__ out, int b, int k) {
  extern __shared__ float remaining[];  // [b] fp32, then [b] keep flags
  unsigned char* keep = reinterpret_cast<unsigned char*>(remaining + b);
  const T* xb = x + (size_t)blockIdx.x * b;
  T* ob = out + (size_t)blockIdx.x * b;

  for (int i = threadIdx.x; i < b; i += kThreads) {
    remaining[i] = fabsf(to_float(xb[i]));
    keep[i] = 0;
  }
  __syncthreads();

  topk_select::select(remaining, keep, b, k);

  for (int i = threadIdx.x; i < b; i += kThreads) ob[i] = keep[i] ? xb[i] : T(0);
}

}  // namespace

// x, out: [nblocks * b] contiguous, dtype 0 = f32, 1 = bf16.
// Launches on `stream`, does not synchronise, returns cudaError_t.
extern "C" int block_topk(const void* x, void* out, int dtype, int nblocks, int b, int k,
                          void* stream) {
  if (nblocks <= 0 || b <= 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)b * (sizeof(float) + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (dtype == 0) {
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(block_topk_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    block_topk_kernel<float><<<nblocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), b, k);
  } else {
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(block_topk_kernel<uint16_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    block_topk_kernel<uint16_t><<<nblocks, kThreads, smem, s>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), b, k);
  }
  return (int)cudaGetLastError();
}
