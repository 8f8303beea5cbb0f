// Block-local magnitude top-k on Hopper: for each contiguous block of b
// values keep the k largest |x| (dense output, the rest +0.0).
//
// Replaces the Pallas TPU kernel repro/kernels/topk.py::_topk_block_kernel
// (pallas_call at topk.py:55) and reproduces its arithmetic exactly, which
// differs from lax.top_k on non-finite input:
//   remaining = |x| (fp32); k rounds of
//     m     = max(remaining)           -- NaN-propagating, like jnp.max
//     first = min{ i : remaining[i] == m }  (none if m is NaN)
//     remaining[first] = remaining[first] * (1 - 1) - 1,  keep[first] = 1
// so a NaN in the block keeps nothing from then on, and a selected inf turns
// into NaN (inf * 0) and stops selection. fmaxf would drop NaN, so the max is
// a hand-written compare; the build must not use --use_fast_math (FTZ would
// merge denormals with zero and change the selection).
//
// Bound: latency. A block moves only 2*b elements (8 KB at b = 1000, f32) but
// runs k dependent block-wide reductions, each two __syncthreads apart.
// Design: one thread block per vector block; |x| and the keep flags live in
// shared memory (5 bytes per element, so b is limited by the 227 KB opt-in);
// each round is one fused (value, first index, NaN flag) reduction: per-thread
// strided scan, warp shuffles, then one warp over the per-warp results.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t bf16_bits) {
  return __uint_as_float((uint32_t)bf16_bits << 16);
}

struct Best {
  float v;
  int i;
  int nan;
};

// Larger value wins; equal values go to the smaller index. NaN never enters
// the compare: it only sets the flag.
__device__ __forceinline__ Best combine(Best a, Best b) {
  Best r = (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
  r.nan = a.nan | b.nan;
  return r;
}

__device__ __forceinline__ Best shfl(Best a, int off) {
  Best b;
  b.v = __shfl_xor_sync(0xffffffffu, a.v, off);
  b.i = __shfl_xor_sync(0xffffffffu, a.i, off);
  b.nan = __shfl_xor_sync(0xffffffffu, a.nan, off);
  return b;
}

// T = float, or uint16_t holding bf16 bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const T* __restrict__ x, T* __restrict__ out, int b, int k) {
  extern __shared__ float remaining[];  // [b] fp32, then [b] keep flags
  unsigned char* keep = reinterpret_cast<unsigned char*>(remaining + b);
  __shared__ Best warp_best[kWarps];
  __shared__ int chosen;
  const T* xb = x + (size_t)blockIdx.x * b;
  T* ob = out + (size_t)blockIdx.x * b;

  for (int i = threadIdx.x; i < b; i += kThreads) {
    remaining[i] = fabsf(to_float(xb[i]));
    keep[i] = 0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int round = 0; round < k; ++round) {
    Best best = {-INFINITY, INT32_MAX, 0};
    for (int i = threadIdx.x; i < b; i += kThreads) {
      const float r = remaining[i];
      if (r != r) best.nan = 1;
      else if (r > best.v) { best.v = r; best.i = i; }  // ascending i: first index kept on ties
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) best = combine(best, shfl(best, off));
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < kWarps ? warp_best[lane] : Best{-INFINITY, INT32_MAX, 0};
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) best = combine(best, shfl(best, off));
      if (lane == 0) {
        const int first = (best.nan || best.i == INT32_MAX) ? -1 : best.i;
        if (first >= 0) {
          remaining[first] = remaining[first] * (1.f - 1.f) - 1.f;  // inf -> NaN, finite -> -1
          keep[first] = 1;
        }
        chosen = first;
      }
    }
    __syncthreads();
    if (chosen < 0) break;  // NaN max: every later round selects nothing too
  }

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
