// The BernK counter hash, shared by csrc/randk.cu (bernk) and csrc/encode.cu
// (mask_streams). Bit-equal to repro/kernels/randk.py::hash_uniform and to
// repro_torch/kernels/randk.py::hash_uniform (numpy), which the SEED codec's
// BERN decode uses to rematerialize the mask on the receiver.
//
// salt = seed mod 2**32 + worker * M2 (uint32, wrapping); then a 3-round
// xorshift-multiply of the global index, converted as float32(h) * 2**-32
// (round to nearest even, then an exact scaling).
#pragma once

#include <stdint.h>

constexpr uint32_t kHashM1 = 2654435761u;
constexpr uint32_t kHashM2 = 2246822519u;

__device__ __forceinline__ uint32_t hash_salt(uint32_t seed32, uint32_t worker) {
  return seed32 + worker * kHashM2;
}

__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t salt) {
  uint32_t h = idx * kHashM1;
  h ^= salt;
  h ^= h >> 15;
  h *= kHashM2;
  h ^= h >> 13;
  h *= kHashM1;
  h ^= h >> 16;
  return __fmul_rn(__uint2float_rn(h), 2.3283064365386963e-10f);  // 2**-32
}
