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

// nan_max of two magnitudes (never -0): max.NaN gives the same value, and a
// canonical NaN where nan_max passes one through (every NaN meets a bf16
// rounding, which makes it canonical, before it reaches an output)
__device__ __forceinline__ float nan_max_abs(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
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
// Algorithm 1 on 64-groups held by 8 lanes each (kernel 1's body, also the
// prologue of the decode form of kernel 2 and the weight loader of kernel
// 5's decode form)
// ---------------------------------------------------------------------------

constexpr float kHif4Recip7Bf16 = 0.142578125f;  // (1/7) rounded to bf16
constexpr float kHif4E6m2Max = 49152.0f;         // 2^15 * 1.5

// 8 neighbouring bf16 elements of one 16-byte word (element 0 in the low
// half of w.x) as floats
__device__ __forceinline__ void unpack8(const uint4& w, float (&v)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

// 8 neighbouring elements from 16-byte aligned memory
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
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
  // ax / quantum is exact: a multiply by the power of two 2^(2 - eb)
  const float q = rintf(ax * pow2i(2 - eb)) * quantum;
  return nan_min(nan_max(q, kE6m2Min), kHif4E6m2Max);
}

// One element's absorbed int: S1P2 quarters of rbf(v * rec) shifted right by
// the block's micro-exponent, then left (shift_scale4 = 4 * 2^-shift: the
// reference's * 2^-shift * 4 in one exact multiply; only values below
// 2^-124, which round to 0 either way, could differ between the two).
__device__ __forceinline__ uint32_t absorb(float v, float rec,
                                           float shift_scale4, int shift) {
  const float q =
      fminf(fmaxf(rintf(rbf(v * rec) * shift_scale4), -7.0f), 7.0f);
  return static_cast<uint32_t>(static_cast<int>(q) * (1 << shift)) & 0xFFu;
}

// Algorithm 1 in three pieces, composed by hif4_quantize_group (kernel 1,
// the prologue of kernel 2's decode form), hif4_quantize_pass4 (the
// loader of kernel 5's decode form) and, with the packing epilogue below,
// the per-token KV append, so none of them can drift apart. Every
// bf16 step of the reference is an explicit __float2bfloat16_rn, the
// reciprocal correctly rounded (__frcp_rn, as 1.0f / x), rounding rintf
// (half to even), and the micro-exponent scales exact powers of two.

// Stage 1 (lines 1-7): a lane's two E1_16 blocks of 4, its E1_8 block, and
// the group max over its 8 lanes (three shuffle levels).
struct Hif4Max {
  float v16a, v16b, v8, vmax;
};

__device__ __forceinline__ Hif4Max hif4_group_max(const float (&v)[8]) {
  Hif4Max m;
  m.v16a = nan_max_abs(nan_max_abs(fabsf(v[0]), fabsf(v[1])),
                       nan_max_abs(fabsf(v[2]), fabsf(v[3])));
  m.v16b = nan_max_abs(nan_max_abs(fabsf(v[4]), fabsf(v[5])),
                       nan_max_abs(fabsf(v[6]), fabsf(v[7])));
  m.v8 = nan_max_abs(m.v16a, m.v16b);
  m.vmax = m.v8;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    m.vmax = nan_max_abs(m.vmax, __shfl_xor_sync(HIF4_FULL_MASK, m.vmax, o));
  return m;
}

// Stage 2, the group's part (lines 8-10): E6M2 and its bf16 reciprocal.
__device__ __forceinline__ void hif4_group_scale(float vmax, float& e6m2,
                                                 float& rec) {
  e6m2 = round_e6m2(rbf(rbf(vmax) * kHif4Recip7Bf16));
  rec = rbf(__frcp_rn(e6m2));
}

// Stage 2, the lane's part (lines 11-14): the micro-exponent bits of the
// lane's E1_8 block and of its two E1_16 blocks (elements 0-3, 4-7).
struct Hif4Shifts {
  int e1_8, e1_16a, e1_16b;
};

__device__ __forceinline__ Hif4Shifts hif4_block_shifts(const Hif4Max& m,
                                                        float rec) {
  Hif4Shifts s;
  s.e1_8 = rbf(m.v8 * rec) > 4.0f ? 1 : 0;
  const float half = s.e1_8 ? 0.5f : 1.0f;
  s.e1_16a = rbf(m.v16a * rec) * half >= 2.0f ? 1 : 0;
  s.e1_16b = rbf(m.v16b * rec) * half >= 2.0f ? 1 : 0;
  return s;
}

// 4 * 2^-shift for a shift of 0, 1 or 2: element quarters at that shift
__device__ __forceinline__ float hif4_shift_scale4(int shift) {
  return shift == 0 ? 4.0f : (shift == 1 ? 2.0f : 1.0f);
}

// Stage 2's lane part, then stage 3 (lines 15-18): the lane's 8 absorbed
// ints packed little-endian (element 0 in the low byte).
__device__ __forceinline__ uint2 hif4_absorb_block(const float (&v)[8],
                                                   const Hif4Max& m,
                                                   float rec) {
  const Hif4Shifts s = hif4_block_shifts(m, rec);
  const int sa = s.e1_8 + s.e1_16a;
  const int sb = s.e1_8 + s.e1_16b;
  const float ka = hif4_shift_scale4(sa);
  const float kb = hif4_shift_scale4(sb);
  uint2 out;
  out.x = absorb(v[0], rec, ka, sa) | absorb(v[1], rec, ka, sa) << 8 |
          absorb(v[2], rec, ka, sa) << 16 | absorb(v[3], rec, ka, sa) << 24;
  out.y = absorb(v[4], rec, kb, sb) | absorb(v[5], rec, kb, sb) << 8 |
          absorb(v[6], rec, kb, sb) << 16 | absorb(v[7], rec, kb, sb) << 24;
  return out;
}

// A 64-group is held by 8 consecutive lanes (lane % 8 = its E1_8 block),
// each with its block's 8 elements in v; all 32 lanes of the warp call this
// together (4 groups per warp). Returns the lane's 8 absorbed ints; `scale`
// gets the group's E6M2 / 4 on every lane.
__device__ __forceinline__ uint2 hif4_quantize_group(const float (&v)[8],
                                                     float& scale) {
  const Hif4Max m = hif4_group_max(v);
  float e6m2, rec;
  hif4_group_scale(m.vmax, e6m2, rec);
  scale = e6m2 * 0.25f;
  return hif4_absorb_block(v, m, rec);
}

// ---------------------------------------------------------------------------
// The packing epilogue (core/hif4.py::pack_groups): the stored form of a
// group instead of its absorbed ints, for the per-token KV append
// (kv_append.cu). It takes stage 1's max and stage 2's scale of the same
// pieces, so the append and kernels 1, 2 and 5 quantize alike.
// ---------------------------------------------------------------------------

// encode_s1p2 of one element of stage 3: sign << 3 | quarters, a -0 keeping
// its sign bit. |rint(t * 4 * 2^-shift)| is the magnitude the absorbed int
// carries before its shift (rint is symmetric), clamped to 7.
__device__ __forceinline__ uint32_t s1p2_nibble(float v, float rec,
                                                float shift_scale4) {
  const float t = rbf(v * rec);
  const float q = fminf(rintf(fabsf(t) * shift_scale4), 7.0f);
  return (signbit(t) ? 8u : 0u) | static_cast<uint32_t>(q);
}

// encode_e6m2 of a scale on the E6M2 grid (a normal float in [2^-48,
// 1.5 * 2^15]): (exponent + 48) << 2 | the two mantissa bits. A group
// holding a NaN has a NaN scale, which the plain version packs as frexp's
// exponent 0 (so -1 + 48 = 47) with its NaN mantissa cast to 0: 0xBC.
__device__ __forceinline__ uint32_t e6m2_code(float e6m2) {
  const uint32_t b = __float_as_uint(e6m2);
  const int e = static_cast<int>((b >> 23) & 0xFFu) - 127;
  const uint32_t code = (static_cast<uint32_t>(e + 48) << 2) | ((b >> 21) & 3u);
  return isnan(e6m2) ? 0xBCu : code;
}

// A lane's packed block and its group's meta word.
struct Hif4PackedBlock {
  uint32_t codes;  // the block's 8 S1P2 codes, element 2i in the low nibble
                   // of byte i (bytes 4 * blk .. 4 * blk + 3 of the group)
  uint32_t meta;   // E6M2 code << 24 | E1_8 bits << 16 | E1_16 bits, on
                   // every lane of the group
};

// The lane holding block ``blk`` (0..7) of a 64-group, laid out as for
// hif4_quantize_group; all 32 lanes of the warp call this together. A group
// holding a NaN packs as the plain version packs it: every code 0, no
// micro-exponent bit set (a NaN compares false), E6M2 code 0xBC.
__device__ __forceinline__ Hif4PackedBlock hif4_pack_block(const float (&v)[8],
                                                           const Hif4Max& m,
                                                           float e6m2,
                                                           float rec,
                                                           int blk) {
  const Hif4Shifts s = hif4_block_shifts(m, rec);
  const float ka = hif4_shift_scale4(s.e1_8 + s.e1_16a);
  const float kb = hif4_shift_scale4(s.e1_8 + s.e1_16b);
  uint32_t codes = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    codes |= s1p2_nibble(v[i], rec, ka) << (4 * i);
    codes |= s1p2_nibble(v[4 + i], rec, kb) << (4 * (4 + i));
  }
  uint32_t bits = (static_cast<uint32_t>(s.e1_8) << (16 + blk)) |
                  (static_cast<uint32_t>(s.e1_16a) << (2 * blk)) |
                  (static_cast<uint32_t>(s.e1_16b) << (2 * blk + 1));
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    bits |= __shfl_xor_sync(HIF4_FULL_MASK, bits, o);
  Hif4PackedBlock out;
  out.codes = isnan(m.vmax) ? 0u : codes;
  out.meta = (e6m2_code(e6m2) << 24) | bits;
  return out;
}

// Four passes of hif4_quantize_group at once (pass p: lane 8 * slot + blk
// holds block blk of group 4p + slot, its values from values(p, v)), with
// each group's scale worked out once instead of on all 8 of its lanes: lane
// L computes group (pass L / 8, slot L / 2 % 4) from the max it is handed,
// and the group's lanes take its E6M2 and reciprocal back. The values are
// asked for twice (for the max, then for the ints) to keep registers free.
template <class Values>
__device__ __forceinline__ void hif4_quantize_pass4(int lane, Values values,
                                                    uint2 (&out)[4],
                                                    float (&scale)[4]) {
  Hif4Max m[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float v[8];
    values(p, v);
    m[p] = hif4_group_max(v);
  }
  const int src = 8 * ((lane >> 1) & 3);
  float vmax = 0.0f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float x = __shfl_sync(HIF4_FULL_MASK, m[p].vmax, src);
    if ((lane >> 3) == p) vmax = x;
  }
  float e6m2, rec;
  hif4_group_scale(vmax, e6m2, rec);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int own = 8 * p + 2 * (lane >> 3);
    const float rp = __shfl_sync(HIF4_FULL_MASK, rec, own);
    scale[p] = __shfl_sync(HIF4_FULL_MASK, e6m2, own) * 0.25f;
    float v[8];
    values(p, v);
    out[p] = hif4_absorb_block(v, m[p], rp);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
