// Counter-hash Bernoulli sparsification (BernK) on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/randk.py::_bernk_kernel
// (pallas_call at randk.py:54): keep x[j] where hash_uniform(j, seed, worker)
// < keep_prob and scale it, else +0.0. The hash (counter_hash.cuh) runs on the
// global index, so the output does not depend on any tiling.
//
// The scaling follows what the reference kernel computes, not its oracle:
//   f32:  x * r with r = float32(1) / float32(keep_prob), computed once on the
//         host. The Pallas body writes x / keep_prob, but XLA folds a division
//         by that constant into this multiplication; ref.bernk_ref and the
//         SEED codec's BERN decode divide, and differ from it in the last bit
//         for keep probabilities that are not powers of two.
//   bf16: bf16(float32(x) / kpb) with kpb = float32(bf16(keep_prob)), an IEEE
//         division (__fdiv_rn) rounded to bf16 on bit patterns
//         (float_bits.cuh: nearest even, NaN -> sign | 0x7fc0).
// The keep test is u < float32(keep_prob) in both. No fast-math: denormal
// inputs are kept as IEEE numbers (XLA on the CPU flushes them).
//
// Bound: bytes (read x, write out: 8 bytes a value in f32); a few integer
// operations a value. Design: one thread per value, grid ceil(d / 256).
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "float_bits.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bernk_f32_kernel(const float* __restrict__ x, float* __restrict__ out, long long d,
                 uint32_t salt, float kp, float recip) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  const float u = hash_uniform((uint32_t)j, salt);
  out[j] = u < kp ? __fmul_rn(x[j], recip) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
bernk_bf16_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out, long long d,
                  uint32_t salt, float kp, float kpb) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  const float u = hash_uniform((uint32_t)j, salt);
  const float q = __fdiv_rn(__uint_as_float((uint32_t)x[j] << 16), kpb);
  out[j] = u < kp ? (uint16_t)f32_to_bf16_bits(__float_as_uint(q)) : (uint16_t)0;
}

}  // namespace

// x, out: [d] contiguous, dtype 0 = f32, 1 = bf16. salt = seed mod 2**32 +
// worker * M2 (uint32). scale: float32(1 / keep_prob) for f32, float32 of
// bf16(keep_prob) for bf16. Launches on `stream`, does not synchronise,
// returns cudaError_t.
extern "C" int bernk(const void* x, void* out, int dtype, long long d, unsigned int salt,
                     float kp, float scale, void* stream) {
  if (d < 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  if (d == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((d + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    bernk_f32_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<float*>(out), d, salt, kp, scale);
  else
    bernk_bf16_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint16_t*>(x),
                                                static_cast<uint16_t*>(out), d, salt, kp, scale);
  return (int)cudaGetLastError();
}
