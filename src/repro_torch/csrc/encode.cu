// The fused stream kernels of the wire codecs on Hopper: per value, the sign
// bit, the magnitude's bit pattern in the wire dtype and a validity flag (the
// SPARSE codec's three streams), or the value's wire pattern (DENSE).
//
// sparse_streams replaces the Pallas TPU kernel
// repro/kernels/encode.py::_sparse_streams_kernel (pallas_call at
// encode.py:265): the streams of a batch of already sparsified message rows.
// mask_streams replaces ::_mask_streams_kernel (pallas_call at encode.py:287):
// the BernK message of one shared fp32 vector for each row's worker id (a
// device int32 tensor), made from the counter hash (counter_hash.cuh) on the
// global index and scaled as bernk does in f32 (x * float32(1 / keep_prob),
// see randk.cu), then streamed.
// topk_streams replaces ::_topk_streams_kernel (pallas_call at encode.py:311):
// block top-k selection (topk_select.cuh's radix select, shared with
// block_topk), then each kept value written to the slot given by its rank
// inside its block, with its global index; slots past the block's count are
// zero.
// dense_bits replaces ::_dense_bits_kernel (pallas_call at encode.py:328): the
// value's bit pattern in the wire dtype, sign kept.
//
// The streams are computed on bit patterns, never with float casts or
// compares, as the host codec does (repro_torch/wire/sparse.py):
//   sign  = bits >> 31,  magbits = bits & 0x7fffffff,  valid = magbits != 0
// (fp32 denormals are kept and -0.0 is elided, flush-to-zero or not), with
// fp16/bf16 by float_bits.cuh's host rules.
//
// Bound: bytes (4 bytes in, 12 or 4 bytes out per value, a few integer
// operations); at the main path's 10 x 1000 values a launch's latency
// dominates. topk_streams is bound by its selection's dependent block-wide
// steps: the radix select takes at most 4 digit passes whatever k is (k
// arg-max rounds would take 2k barriers). Design: one thread per value,
// grid (ceil(d / 256), rows); topk_streams one thread block per vector block,
// the keys bits(|x|) in shared memory (4 bytes a value), the kept set and its
// ranks from one block scan over contiguous per-thread chunks.
// Outputs are uint32 so that the compaction and the packing that follow read
// them without conversion.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "float_bits.cuh"
#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;

// The three SPARSE streams of one fp32 bit pattern at flat position i.
__device__ __forceinline__ void emit_streams(uint32_t b, long long i, int mag,
                                             uint32_t* __restrict__ sign,
                                             uint32_t* __restrict__ magbits,
                                             uint32_t* __restrict__ valid) {
  const uint32_t mb = b & 0x7fffffffu;
  sign[i] = b >> 31;
  magbits[i] = wire_bits(mb, mag);
  valid[i] = mb != 0u;
}

__global__ void __launch_bounds__(kThreads)
sparse_streams_kernel(const uint32_t* __restrict__ x, int d, int mag,
                      uint32_t* __restrict__ sign, uint32_t* __restrict__ magbits,
                      uint32_t* __restrict__ valid) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  const long long i = (long long)blockIdx.y * d + j;
  emit_streams(x[i], i, mag, sign, magbits, valid);
}

__global__ void __launch_bounds__(kThreads)
dense_bits_kernel(const uint32_t* __restrict__ x, int d, int mag, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < d) out[i] = wire_bits(x[i], mag);
}

__global__ void __launch_bounds__(kThreads)
mask_streams_kernel(const float* __restrict__ x, const uint32_t* __restrict__ workers, int d,
                    uint32_t seed32, float kp, float recip, int mag,
                    uint32_t* __restrict__ sign, uint32_t* __restrict__ magbits,
                    uint32_t* __restrict__ valid) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  const float u = hash_uniform((uint32_t)j, hash_salt(seed32, workers[blockIdx.y]));
  const float v = u < kp ? __fmul_rn(x[j], recip) : 0.0f;
  emit_streams(__float_as_uint(v), (long long)blockIdx.y * d + j, mag, sign, magbits, valid);
}

__global__ void __launch_bounds__(topk_select::kThreads)
topk_streams_kernel(const float* __restrict__ x, int b, int ks, int mag,
                    uint32_t* __restrict__ idx, uint32_t* __restrict__ sign,
                    uint32_t* __restrict__ magbits, uint32_t* __restrict__ valid) {
  constexpr int kT = topk_select::kThreads;
  extern __shared__ uint32_t keys[];  // [b] bits(|x|)
  const float* xb = x + (size_t)blockIdx.x * b;
  int flags = 0;
  for (int i = threadIdx.x; i < b; i += kT) {
    keys[i] = __float_as_uint(xb[i]) & 0x7fffffffu;
    flags |= topk_select::key_flags(keys[i]);
  }
  flags = topk_select::block_flags(flags);
  const topk_select::Threshold th = topk_select::find_threshold(keys, b, ks, flags);

  // Each kept value goes to the slot of its rank (ascending index) in the block.
  const long long base = (long long)blockIdx.x * ks;
  const int total = topk_select::walk_kept(keys, b, th, [&](int i, bool kept, int slot) {
    if (!kept) return;
    const long long o = base + slot;
    idx[o] = (uint32_t)((long long)blockIdx.x * b + i);
    emit_streams(__float_as_uint(xb[i]), o, mag, sign, magbits, valid);
  });
  for (int s = total + threadIdx.x; s < ks; s += kT) {
    const long long o = base + s;
    idx[o] = sign[o] = magbits[o] = valid[o] = 0u;
  }
}

}  // namespace

// x, sign, magbits, valid: rows x d contiguous (x fp32, outputs uint32).
// Launches on `stream`, does not synchronise, returns cudaError_t.
extern "C" int sparse_streams(const void* x, int rows, int d, int mag, void* sign,
                              void* magbits, void* valid, void* stream) {
  if (rows < 0 || rows > 65535 || d < 0 || mag < 0 || mag > 2) return (int)cudaErrorInvalidValue;
  if (rows == 0 || d == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)(((long long)d + kThreads - 1) / kThreads), (unsigned)rows);
  sparse_streams_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), d, mag, static_cast<uint32_t*>(sign),
      static_cast<uint32_t*>(magbits), static_cast<uint32_t*>(valid));
  return (int)cudaGetLastError();
}

// x: d fp32, out: d uint32, both contiguous.
extern "C" int dense_bits(const void* x, int d, int mag, void* out, void* stream) {
  if (d < 0 || mag < 0 || mag > 2) return (int)cudaErrorInvalidValue;
  if (d == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)(((long long)d + kThreads - 1) / kThreads);
  dense_bits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), d, mag, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// x: d fp32; workers: rows int32 worker ids; sign, magbits, valid: rows x d
// uint32, all contiguous. seed32 = seed mod 2**32; kp = float32(keep_prob);
// recip = float32(1) / kp.
extern "C" int mask_streams(const void* x, const void* workers, int rows, int d,
                            unsigned int seed32, float kp, float recip, int mag, void* sign,
                            void* magbits, void* valid, void* stream) {
  if (rows < 0 || rows > 65535 || d < 0 || mag < 0 || mag > 2) return (int)cudaErrorInvalidValue;
  if (rows == 0 || d == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)(((long long)d + kThreads - 1) / kThreads), (unsigned)rows);
  mask_streams_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(workers), d, seed32, kp, recip,
      mag, static_cast<uint32_t*>(sign), static_cast<uint32_t*>(magbits),
      static_cast<uint32_t*>(valid));
  return (int)cudaGetLastError();
}

// x: nblocks * b fp32 contiguous; idx, sign, magbits, valid: nblocks x ks
// uint32 contiguous, ks = min(k, b) slots per block; b < 65536.
extern "C" int topk_streams(const void* x, int nblocks, int b, int k, int mag, void* idx,
                            void* sign, void* magbits, void* valid, void* stream) {
  if (nblocks < 0 || b <= 0 || b >= 65536 || k < 1 || mag < 0 || mag > 2)
    return (int)cudaErrorInvalidValue;
  if (nblocks == 0) return (int)cudaSuccess;
  const int ks = k < b ? k : b;
  const size_t smem = (size_t)b * sizeof(uint32_t);  // set at every launch, as in topk.cu
  const cudaError_t e = cudaFuncSetAttribute(
      topk_streams_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  topk_streams_kernel<<<nblocks, topk_select::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), b, ks, mag, static_cast<uint32_t*>(idx),
      static_cast<uint32_t*>(sign), static_cast<uint32_t*>(magbits),
      static_cast<uint32_t*>(valid));
  return (int)cudaGetLastError();
}
