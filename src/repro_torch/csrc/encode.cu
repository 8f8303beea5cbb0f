// Stream extraction of the SPARSE and DENSE wire codecs on Hopper.
//
// sparse_streams replaces the Pallas TPU kernel
// repro/kernels/encode.py::_sparse_streams_kernel (pallas_call at
// encode.py:265): per value of a batch of message rows, the sign bit, the
// magnitude's bit pattern in the wire dtype and a validity flag.
// dense_bits replaces ::_dense_bits_kernel (pallas_call at encode.py:328): the
// value's bit pattern in the wire dtype, sign kept.
//
// Everything is computed on bit patterns, never with float arithmetic, casts
// or compares, as the host codec does (repro_torch/wire/sparse.py):
//   sign  = bits >> 31,  magbits = bits & 0x7fffffff,  valid = magbits != 0
// (fp32 denormals are kept and -0.0 is elided, flush-to-zero or not), and
//   fp16  = numpy's npy_floatbits_to_halfbits: round to nearest even, NaN ->
//           0x7c00 + (mantissa >> 13) (0x7c01 if that is 0x7c00), sign kept;
//   bf16  = ml_dtypes: (bits + 0x7fff + ((bits >> 16) & 1)) >> 16, NaN ->
//           sign | 0x7fc0.
// __float2half_rn / __float2bfloat16_rn / cvt would canonicalise NaNs and are
// not used.
//
// Bound: bytes (4 bytes in, 12 or 4 bytes out per value, a few integer
// operations); at the main path's 10 x 1000 values a launch's latency
// dominates. Design: one thread per value, grid (ceil(d / 256), rows);
// outputs are uint32 so that the compaction and the packing that follow read
// them without conversion.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t f32_to_f16_bits(uint32_t f) {
  const uint32_t sgn = (f >> 16) & 0x8000u;
  const uint32_t fexp = f & 0x7f800000u, fsig = f & 0x007fffffu;
  if (fexp >= 0x47800000u) {  // overflow to inf, inf, NaN
    if (fexp == 0x7f800000u && fsig != 0) {
      uint32_t r = 0x7c00u + (fsig >> 13);
      if (r == 0x7c00u) r = 0x7c01u;  // keep it a NaN
      return sgn + r;
    }
    return sgn + 0x7c00u;
  }
  if (fexp <= 0x38000000u) {  // a subnormal half or a signed zero
    if (fexp < 0x33000000u) return sgn;
    uint32_t s = (0x00800000u + fsig) >> (113u - (fexp >> 23));
    if ((s & 0x3fffu) != 0x1000u || (f & 0x7ffu) != 0) s += 0x1000u;
    return sgn + (s >> 13);
  }
  uint32_t s = fsig;  // normal; a carry out of the mantissa bumps the exponent
  if ((s & 0x3fffu) != 0x1000u) s += 0x1000u;
  return sgn + ((fexp - 0x38000000u) >> 13) + (s >> 13);
}

__device__ __forceinline__ uint32_t f32_to_bf16_bits(uint32_t f) {
  if ((f & 0x7fffffffu) > 0x7f800000u) return ((f >> 16) & 0x8000u) | 0x7fc0u;
  return (f + 0x7fffu + ((f >> 16) & 1u)) >> 16;
}

// mag: 0 = fp32, 1 = fp16, 2 = bf16 (wire MagDType)
__device__ __forceinline__ uint32_t wire_bits(uint32_t f, int mag) {
  return mag == 0 ? f : (mag == 1 ? f32_to_f16_bits(f) : f32_to_bf16_bits(f));
}

__global__ void __launch_bounds__(kThreads)
sparse_streams_kernel(const uint32_t* __restrict__ x, int d, int mag,
                      uint32_t* __restrict__ sign, uint32_t* __restrict__ magbits,
                      uint32_t* __restrict__ valid) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  const long long i = (long long)blockIdx.y * d + j;
  const uint32_t b = x[i];
  const uint32_t mb = b & 0x7fffffffu;
  sign[i] = b >> 31;
  magbits[i] = wire_bits(mb, mag);
  valid[i] = mb != 0u;
}

__global__ void __launch_bounds__(kThreads)
dense_bits_kernel(const uint32_t* __restrict__ x, int d, int mag, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < d) out[i] = wire_bits(x[i], mag);
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
