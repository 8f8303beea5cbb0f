// fp32 -> fp16 / bf16 conversion on bit patterns, shared by csrc/encode.cu
// (the wire's magnitude streams) and csrc/randk.cu (bernk's bf16 output).
//
// No float arithmetic, cast or compare, so that the result is the host
// codec's (repro_torch/wire/sparse.py) on every input, NaN payloads and
// denormals included:
//   fp16 = numpy's npy_floatbits_to_halfbits: round to nearest even, NaN ->
//          0x7c00 + (mantissa >> 13) (0x7c01 if that is 0x7c00), sign kept;
//   bf16 = ml_dtypes: (bits + 0x7fff + ((bits >> 16) & 1)) >> 16, NaN ->
//          sign | 0x7fc0.
// __float2half_rn / __float2bfloat16_rn / cvt would canonicalise NaNs and are
// not used.
#pragma once

#include <stdint.h>

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
