// Bit packing of the wire format on Hopper: width-w values, LSB-first, into
// little-endian uint32 words (value i occupies bits [i*w, (i+1)*w); bit b
// lives in word b / 32 at offset b % 32), and its inverse.
//
// Replaces the Pallas TPU kernels repro/kernels/pack.py::_pack_kernel
// (pallas_call at pack.py:88) and ::_unpack_kernel (pallas_call at
// pack.py:107). The layout is the one of wire/bitstream.py; the TPU kernels'
// broadcast compare-and-sum over word-aligned blocks was a VPU choice and is
// not carried over.
//
// Bound: bytes (w/32 of a word moved per value, no arithmetic to speak of);
// on the main path a stream is at most a few KB, so a launch's latency
// dominates. Design, deterministic and free of atomics:
//   pack   - one thread per output word j gathers the values that touch it,
//            floor(32j/w) .. floor((32j+31)/w), and ORs in each one's low part
//            (value starts in word j) or high part (value straddles from j-1);
//   unpack - one thread per value reads its word and the next (0 past the end).
// Each value is masked to w bits first, as the host codec asserts values are
// below 2^w. Shifts go through 64 bits, so w = 32 (a shift by 32 is undefined
// in C++) needs no special case. Both kernels take a batch of rows
// (blockIdx.y) with explicit row strides, so one launch packs one stream of
// every message of a round.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t low_mask(int width) {
  return width == 32 ? 0xffffffffu : ((1u << width) - 1u);
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ vals, long long in_stride, int n, int width,
            uint32_t* __restrict__ words, long long out_stride, int nwords) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= nwords) return;
  const uint32_t* v = vals + (long long)blockIdx.y * in_stride;
  const uint32_t mask = low_mask(width);
  const long long first = (32 * j) / width;
  long long last = (32 * j + 31) / width;
  if (last > n - 1) last = n - 1;
  uint32_t acc = 0;
  for (long long i = first; i <= last; ++i) {
    const long long pos = i * width;
    const uint64_t s = (uint64_t)(v[i] & mask) << (pos & 31);
    acc |= (pos >> 5) == j ? (uint32_t)s : (uint32_t)(s >> 32);
  }
  words[(long long)blockIdx.y * out_stride + j] = acc;
}

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint32_t* __restrict__ words, long long in_stride, int nwords, int width,
              uint32_t* __restrict__ vals, long long out_stride, int count) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  const uint32_t* w = words + (long long)blockIdx.y * in_stride;
  const long long pos = i * width;
  const long long k = pos >> 5;
  const uint64_t lo = k < nwords ? w[k] : 0u;
  const uint64_t hi = k + 1 < nwords ? w[k + 1] : 0u;
  vals[(long long)blockIdx.y * out_stride + i] =
      (uint32_t)(((hi << 32) | lo) >> (pos & 31)) & low_mask(width);
}

}  // namespace

// vals: rows x n (row stride in_stride, in elements); words: rows x nwords
// (row stride out_stride), nwords = ceil(n * width / 32). Launches on
// `stream`, does not synchronise, returns cudaError_t.
extern "C" int pack_bits(const void* vals, long long in_stride, int n, int width, void* words,
                         long long out_stride, int nwords, int rows, void* stream) {
  if (width < 1 || width > 32 || n < 0 || nwords < 0 || rows < 0 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  if (nwords == 0 || rows == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((nwords + kThreads - 1) / kThreads), (unsigned)rows);
  pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vals), in_stride, n, width, static_cast<uint32_t*>(words),
      out_stride, nwords);
  return (int)cudaGetLastError();
}

// words: rows x nwords (row stride in_stride); vals: rows x count (row
// stride out_stride). Words past nwords read as 0.
extern "C" int unpack_bits(const void* words, long long in_stride, int nwords, int width,
                           void* vals, long long out_stride, int count, int rows, void* stream) {
  if (width < 1 || width > 32 || nwords < 0 || count < 0 || rows < 0 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  if (count == 0 || rows == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((count + kThreads - 1) / kThreads), (unsigned)rows);
  unpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), in_stride, nwords, width, static_cast<uint32_t*>(vals),
      out_stride, count);
  return (int)cudaGetLastError();
}
