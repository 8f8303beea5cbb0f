// Block-local top-k selection shared by csrc/topk.cu (block_topk) and
// csrc/encode.cu (topk_streams).
//
// Reproduces the selection of the Pallas TPU kernels
// repro/kernels/topk.py::_topk_block_kernel and
// repro/kernels/encode.py::_topk_streams_kernel exactly, which differs from
// lax.top_k on non-finite input:
//   remaining = |x| (fp32); k rounds of
//     m     = max(remaining)           -- NaN-propagating, like jnp.max
//     first = min{ i : remaining[i] == m }  (none if m is NaN)
//     remaining[first] = remaining[first] * (1 - 1) - 1,  keep[first] = 1
// so a NaN in the block keeps nothing from then on, and a selected inf turns
// into NaN (inf * 0) and stops selection. fmaxf would drop NaN, so the max is
// a hand-written compare; the build must not use --use_fast_math (FTZ would
// merge denormals with zero and change the selection).
//
// Each round is one fused (value, first index, NaN flag) reduction: a
// per-thread strided scan of shared memory, warp shuffles, then one warp over
// the per-warp results. Rounds are dependent, two __syncthreads apart.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk_select {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Runs up to k selection rounds over remaining[0, b) (fp32 |x| in shared
// memory) and sets keep[i] = 1 for each selected i (keep zeroed by the caller).
// Every thread of a kThreads-wide block calls it; it returns after a
// __syncthreads(), so remaining and keep are final for all threads.
__device__ __forceinline__ void select(float* remaining, unsigned char* keep, int b, int k) {
  __shared__ Best warp_best[kWarps];
  __shared__ int chosen;
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
  __syncthreads();
}

}  // namespace topk_select
