// RotK apply (the cyclic-partition PermK update) on Hopper, in fp32, fp16
// and bf16.
//
// Replaces the Pallas TPU kernel repro/kernels/permk.py::_rotk_apply_kernel
// (pallas_call at permk.py:39):
//   out[j] = w[j] + (j mod n == (worker + r) mod n ? delta[j] * n : +0.0)
// with r a device int32 scalar, read here on the card (no host sync).
//
// Exactness, as the reference computes it on XLA:
//   * (worker + r) mod n is a floor mod (r may be negative): C's % is
//     truncated, so a negative remainder is moved up by n;
//   * delta * n is rounded, then added: __fmul_rn / __fadd_rn keep nvcc from
//     contracting the two into an FMA (which it does by default for a*b + c);
//   * a coordinate not kept is w + (+0.0), which turns -0.0 into +0.0;
//   * fp16 / bf16: XLA computes each 16-bit operation in fp32 and rounds its
//     result, so the product is rounded to T before the sum:
//     q = T(f32(delta) * n), out = T(f32(w) + f32(q)). The widening is exact
//     (__half2float / __bfloat162float, as torch widens on the card); the
//     narrowing is on bit patterns (float_bits.cuh: nearest even, NaNs as
//     numpy / ml_dtypes make them), so that it equals ref.rotk_apply_ref's.
//
// Bound: bytes (read w and delta, write out: 12 bytes a value in fp32, 6 in
// fp16 / bf16). Design: one thread per value, grid ceil(d / 256).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float_bits.cuh"

namespace {

constexpr int kThreads = 256;

struct F32 {
  using T = float;
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
};

struct F16 {
  using T = uint16_t;
  static __device__ __forceinline__ float widen(uint16_t v) { return __half2float(__ushort_as_half(v)); }
  static __device__ __forceinline__ uint16_t narrow(float v) {
    return (uint16_t)f32_to_f16_bits(__float_as_uint(v));
  }
};

struct BF16 {
  using T = uint16_t;
  static __device__ __forceinline__ float widen(uint16_t v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  static __device__ __forceinline__ uint16_t narrow(float v) {
    return (uint16_t)f32_to_bf16_bits(__float_as_uint(v));
  }
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
rotk_apply_kernel(const typename V::T* __restrict__ w, const typename V::T* __restrict__ delta,
                  const int* __restrict__ rotation, typename V::T* __restrict__ out, long long d,
                  int n, int worker) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  const int t = (int)((unsigned)worker + (unsigned)*rotation);  // int32 wrap, as XLA's add
  int s = t % n;
  if (s < 0) s += n;
  float q = 0.0f;
  if ((int)(j % n) == s) q = V::widen(V::narrow(__fmul_rn(V::widen(delta[j]), (float)n)));
  out[j] = V::narrow(__fadd_rn(V::widen(w[j]), q));
}

template <typename V>
void launch(const void* w, const void* delta, const void* rotation, void* out, long long d, int n,
            int worker, cudaStream_t stream) {
  using T = typename V::T;
  const unsigned grid = (unsigned)((d + kThreads - 1) / kThreads);
  rotk_apply_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(delta), static_cast<const int*>(rotation),
      static_cast<T*>(out), d, n, worker);
}

}  // namespace

// w, delta, out: [d] contiguous, dtype 0 = f32, 1 = f16, 2 = bf16; rotation:
// one int32 on the card; n >= 1. Launches on `stream`, does not synchronise,
// returns cudaError_t.
extern "C" int rotk_apply(const void* w, const void* delta, const void* rotation, void* out,
                          int dtype, long long d, int n, int worker, void* stream) {
  if (d < 0 || n < 1 || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  if (d == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<F32>(w, delta, rotation, out, d, n, worker, s);
  else if (dtype == 1)
    launch<F16>(w, delta, rotation, out, d, n, worker, s);
  else
    launch<BF16>(w, delta, rotation, out, d, n, worker, s);
  return (int)cudaGetLastError();
}
