// Block-local top-k selection shared by csrc/topk.cu (block_topk) and
// csrc/encode.cu (topk_streams): an MSB-first radix select on the fp32 bit
// pattern of |x|.
//
// Replaces the selection loop of the Pallas TPU kernels
// repro/kernels/topk.py::_topk_block_kernel and
// repro/kernels/encode.py::_topk_streams_kernel, and keeps their result bit
// for bit (ref._topk_keep_ref is the oracle). Those run k rounds of
//   m = max(remaining) (NaN-propagating), first = min{i : remaining[i] == m},
//   remaining[first] = remaining[first] * 0 - 1, keep[first] = 1,
// which selects:
//   * any NaN in the block: nothing;
//   * no NaN, an inf, k >= 1: only the first inf (it turns into NaN, inf * 0,
//     and no later round selects anything);
//   * finite: the min(k, b) largest |x|, the smallest index first on ties
//     (+-0.0 tie; denormals count).
//
// Bound on this card: latency. A block moves a few KB, so what counts is the
// chain of dependent block-wide steps; k arg-max rounds (the TPU kernel's
// loop) would be 2k barriers. Here that number does not grow with k:
//   key[i] = bits(|x[i]|) & 0x7fffffff (uint32 order == IEEE order for
//   non-negative floats, denormals included; bf16 widens exactly);
//   one pass of block-wide ORs finds NaN and inf;
//   finite case: at most 4 digit passes (bits 30..24, 23..16, 15..8, 7..0).
//   Each builds a 256-bin histogram of the candidates' digit in shared memory
//   (plain integer atomics: grouping a warp's equal digits with
//   __match_any_sync first was slower in a trial build), one warp scans
//   it from the top and fixes the next digit of the threshold T; the passes
//   stop early once the chosen bin holds exactly the values still needed.
//   The result is (T, need): keep key > T, and the first `need` indices with
//   key == T. Every case above is such a pair: NaN (0xffffffff, 0), inf
//   (0x7f800000, 1), k >= b (0, b).
// The kept set is then walked in index order over contiguous per-thread
// chunks with one block scan (counts of key > T and key == T packed in one
// int), which gives each kept value its rank too.
//
// Shared memory: the keys, 4 bytes per value (dynamic), plus 2 KB of
// histograms. The build must not use --use_fast_math (no float compare is
// made here, but the callers copy denormals and -0.0 bitwise).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace topk_select {

constexpr int kThreads = 256;  // also the number of histogram bins
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kInfKey = 0x7f800000u;
constexpr int kNanFlag = 1, kInfFlag = 2;

struct Threshold {
  uint32_t t;  // keep key > t ...
  int need;    // ... and the first `need` indices with key == t
};

// kNanFlag / kInfFlag of one key, to OR into a thread's flags while loading.
__device__ __forceinline__ int key_flags(uint32_t key) {
  return key > kInfKey ? kNanFlag : (key == kInfKey ? kInfFlag : 0);
}

// The block's flags from each thread's; also a barrier, so the keys written
// before it are visible to every thread after it.
__device__ __forceinline__ int block_flags(int local) {
  return (__syncthreads_or(local & kNanFlag) ? kNanFlag : 0) |
         (__syncthreads_or(local & kInfFlag) ? kInfFlag : 0);
}

// Exclusive prefix sum of v over the block's threads; *total gets the sum
// (modulo 2**32).
// Call at most once per kernel (its scratch is not reset).
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint32_t incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  uint32_t base = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) base += warp_sums[w];
    sum += warp_sums[w];
  }
  *total = sum;
  return base + incl - v;
}

// The threshold of the block's keys[0, b) for k (see the header). Every
// thread of a kThreads-wide block calls it with the same arguments, after
// block_flags; it returns the same value to all of them.
__device__ __forceinline__ Threshold find_threshold(const uint32_t* keys, int b, int k, int flags) {
  if (k <= 0 || (flags & kNanFlag)) return {0xffffffffu, 0};
  if (flags & kInfFlag) return {kInfKey, 1};
  if (k >= b) return {0u, b};

  __shared__ __align__(16) int hist[2][kThreads];
  __shared__ uint32_t s_prefix;
  __shared__ int s_need, s_done;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  hist[0][tid] = 0;
  __syncthreads();

  uint32_t prefix = 0;  // the threshold's digits fixed so far
  int need = k;         // values still to keep among the keys matching prefix
#pragma unroll 1
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t hi_mask = pass == 0 ? 0u : (0xffffffffu << (shift + 8));
    int* h = hist[pass & 1];
    for (int i = tid; i < b; i += kThreads) {
      const uint32_t key = keys[i];
      if ((key & hi_mask) == prefix) atomicAdd(&h[(key >> shift) & 0xffu], 1);
    }
    // The other buffer was last read by the previous pass's scan, before
    // its second barrier; it is filled after this pass's first.
    hist[(pass + 1) & 1][tid] = 0;
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins [8l, 8l + 8); find the bin where the count from the
      // top reaches need
      const int4 lo = reinterpret_cast<const int4*>(h)[2 * lane];
      const int4 hi = reinterpret_cast<const int4*>(h)[2 * lane + 1];
      const int c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      int s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += c[j];
      int incl = s;  // candidates in lanes >= this one
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += v;
      }
      int above = incl - s;
      if (above < need && need <= incl) {  // exactly one lane
#pragma unroll
        for (int j = 7; j >= 0; --j) {
          if (above + c[j] >= need) {
            s_prefix = prefix | ((uint32_t)(8 * lane + j) << shift);
            s_need = need - above;
            s_done = c[j] == need - above;
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
    // Every candidate in the chosen bin is kept: keep exactly key >= prefix.
    // prefix > 0 here, since k < b keys are kept and all b keys are >= 0.
    if (s_done) return {prefix - 1u, 0};
  }
  return {prefix, need};
}

// Walks the kept set in index order: the calling thread's contiguous chunk
// of [0, b), calling f(i, kept, slot) for each i in it, in order, where slot
// is i's rank among the block's kept values (valid where kept). Returns the
// block's number of kept values. Every thread of the block calls it once
// (it contains the block scan); b < 65536.
template <class F>
__device__ __forceinline__ int walk_kept(const uint32_t* keys, int b, Threshold th, F f) {
  const int chunk = (b + kThreads - 1) / kThreads;
  const int lo = min(b, (int)threadIdx.x * chunk), hi = min(b, lo + chunk);
  uint32_t gt = 0, eq = 0;
  for (int i = lo; i < hi; ++i) {
    const uint32_t key = keys[i];
    gt += key > th.t;
    eq += key == th.t;
  }
  uint32_t total;
  const uint32_t before = block_exclusive_scan((gt << 16) | eq, &total);
  int eq_rank = (int)(before & 0xffffu);
  int slot = (int)(before >> 16) + min(eq_rank, th.need);
  for (int i = lo; i < hi; ++i) {
    const uint32_t key = keys[i];
    const bool kept = key > th.t || (key == th.t && eq_rank++ < th.need);
    f(i, kept, slot);
    slot += kept;
  }
  return (int)(total >> 16) + min((int)(total & 0xffffu), th.need);
}

}  // namespace topk_select
