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
  // 2^(E - 50) * (1 + M/4): the mantissa bits placed in 1.0f's fraction
  const float s = pow2i(static_cast<int>(code >> 2) - 50) *
                  __uint_as_float(0x3F800000u | ((code & 3u) << 21));
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

// ---------------------------------------------------------------------------
// Algorithm 1 on one 64-group held by 8 lanes (kernel 1's body, also the
// prologue of the decode form of kernel 2, so the two cannot drift apart)
// ---------------------------------------------------------------------------

constexpr float kHif4Recip7Bf16 = 0.142578125f;  // (1/7) rounded to bf16
constexpr float kHif4E6m2Max = 49152.0f;         // 2^15 * 1.5

// 8 neighbouring elements from 16-byte aligned memory
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// round_e6m2 (rounding.py): clamp to [2^-48, 1.5*2^15] on the E6M2 grid.
// ax >= 2^-48 is a normal float, so its exponent field is frexp's exponent-1.
__device__ __forceinline__ float round_e6m2(float x) {
  const float kE6m2Min = pow2i(-48);
  const float ax = nan_max(fabsf(x), kE6m2Min);
  int eb = static_cast<int>((__float_as_uint(ax) >> 23) & 0xFFu) - 127;
  eb = min(max(eb, -48), 15);
  const float quantum = pow2i(eb - 2);
  const float q = rintf(__fdiv_rn(ax, quantum)) * quantum;
  return nan_min(nan_max(q, kE6m2Min), kHif4E6m2Max);
}

__device__ __forceinline__ uint32_t absorb(float v, float rec,
                                           float shift_scale, int shift) {
  const float scaled = rbf(v * rec) * shift_scale;
  const float q = fminf(fmaxf(rintf(scaled * 4.0f), -7.0f), 7.0f);
  return static_cast<uint32_t>(static_cast<int>(q) * (1 << shift)) & 0xFFu;
}

// A 64-group is held by 8 consecutive lanes (lane % 8 = its E1_8 block),
// each with its block's 8 elements in v; all 32 lanes of the warp call this
// together (4 groups per warp). Returns the lane's 8 absorbed ints packed
// little-endian (element 0 in the low byte); `scale` gets the group's
// E6M2 / 4 on every lane. Algorithm 1's three-level tree max is a lane's own
// two E1_16 blocks of 4 and its E1_8 block, then three shuffle levels across
// the group's 8 lanes. Every bf16 step of the reference is an explicit
// __float2bfloat16_rn, the reciprocal an IEEE division, rounding rintf (half
// to even), and the micro-exponent scales the exact constants 1, 0.5, 0.25.
__device__ __forceinline__ uint2 hif4_quantize_group(const float (&v)[8],
                                                     float& scale) {
  // Stage 1: tree max (lines 1-7)
  const float v16a = nan_max(nan_max(fabsf(v[0]), fabsf(v[1])),
                             nan_max(fabsf(v[2]), fabsf(v[3])));
  const float v16b = nan_max(nan_max(fabsf(v[4]), fabsf(v[5])),
                             nan_max(fabsf(v[6]), fabsf(v[7])));
  const float v8 = nan_max(v16a, v16b);
  float vmax = v8;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    vmax = nan_max(vmax, __shfl_xor_sync(HIF4_FULL_MASK, vmax, o));

  // Stage 2: hierarchical scaling metadata (lines 8-14)
  const float sf = rbf(rbf(vmax) * kHif4Recip7Bf16);
  const float e6m2 = round_e6m2(sf);
  const float rec = rbf(__fdiv_rn(1.0f, e6m2));
  const int e1_8 = rbf(v8 * rec) > 4.0f ? 1 : 0;
  const float half = e1_8 ? 0.5f : 1.0f;
  const int sa = e1_8 + (rbf(v16a * rec) * half >= 2.0f ? 1 : 0);
  const int sb = e1_8 + (rbf(v16b * rec) * half >= 2.0f ? 1 : 0);

  // Stage 3: scale, round to S1P2 quarters, absorb shifts (lines 15-18)
  const float ka = sa == 0 ? 1.0f : (sa == 1 ? 0.5f : 0.25f);
  const float kb = sb == 0 ? 1.0f : (sb == 1 ? 0.5f : 0.25f);
  uint2 out;
  out.x = absorb(v[0], rec, ka, sa) | absorb(v[1], rec, ka, sa) << 8 |
          absorb(v[2], rec, ka, sa) << 16 | absorb(v[3], rec, ka, sa) << 24;
  out.y = absorb(v[4], rec, kb, sb) | absorb(v[5], rec, kb, sb) << 8 |
          absorb(v[6], rec, kb, sb) << 16 | absorb(v[7], rec, kb, sb) << 24;
  scale = e6m2 * 0.25f;
  return out;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
