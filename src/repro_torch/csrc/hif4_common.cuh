// Shared device helpers of the HiF4 Hopper kernels.
//
// Every helper reproduces one step of the JAX reference bit for bit:
// bf16 rounding is __float2bfloat16_rn (round to nearest even), powers of two
// are built in the float32 exponent field (never exp2), and max/min propagate
// NaN the way jnp.maximum/jnp.minimum do. Build without --use_fast_math: it
// would make divisions approximate and flush subnormals.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HIF4_FULL_MASK 0xffffffffu

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// exact 2^e for e in the normal float32 range
__device__ __forceinline__ float pow2i(int e) {
  return __uint_as_float(static_cast<uint32_t>(e + 127) << 23);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// Absorbed group scale E6M2 / 4 of a packed meta word (hif4.expand_meta_km);
// the E6M2 code 0xFF decodes to NaN.
__device__ __forceinline__ float meta_scale(uint32_t meta) {
  const uint32_t code = meta >> 24;
  const float s = pow2i(static_cast<int>(code >> 2) - 48) *
                  (1.0f + static_cast<float>(code & 3u) * 0.25f) * 0.25f;
  return code == 0xFFu ? qnan() : s;
}

// Absorbed-shift integer of element r (0..63) of a group: the 4-bit
// sign-magnitude S1P2 code in quarters, shifted left by E1_8[r/8] + E1_16[r/4]
// (|q| <= 28, hif4.absorbed_int_km).
__device__ __forceinline__ int absorbed_int(uint32_t nibble, uint32_t meta,
                                            int r) {
  const int mag = static_cast<int>(nibble & 7u);
  const int shift = static_cast<int>(((meta >> (16 + (r >> 3))) & 1u) +
                                     ((meta >> (r >> 2)) & 1u));
  const int q = mag << shift;
  return (nibble & 8u) ? -q : q;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
