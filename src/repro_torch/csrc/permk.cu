// RotK apply (the cyclic-partition PermK update) on Hopper.
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
//   * a coordinate not kept is w + (+0.0), which turns -0.0 into +0.0.
//
// Bound: bytes (read w and delta, write out: 12 bytes a value). Design: one
// thread per value, grid ceil(d / 256).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rotk_apply_kernel(const float* __restrict__ w, const float* __restrict__ delta,
                  const int* __restrict__ rotation, float* __restrict__ out, long long d, int n,
                  int worker) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  const int t = (int)((unsigned)worker + (unsigned)*rotation);  // int32 wrap, as XLA's add
  int s = t % n;
  if (s < 0) s += n;
  const float q = (int)(j % n) == s ? __fmul_rn(delta[j], (float)n) : 0.0f;
  out[j] = __fadd_rn(w[j], q);
}

}  // namespace

// w, delta, out: [d] f32 contiguous; rotation: one int32 on the card; n >= 1.
// Launches on `stream`, does not synchronise, returns cudaError_t.
extern "C" int rotk_apply(const void* w, const void* delta, const void* rotation, void* out,
                          long long d, int n, int worker, void* stream) {
  if (d < 0 || n < 1) return (int)cudaErrorInvalidValue;
  if (d == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((d + kThreads - 1) / kThreads);
  rotk_apply_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(delta),
      static_cast<const int*>(rotation), static_cast<float*>(out), d, n, worker);
  return (int)cudaGetLastError();
}
