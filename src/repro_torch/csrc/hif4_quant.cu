// hif4_quantize: BF16/F32 -> HiF4 absorbed-shift ints (paper Algorithm 1).
//
// Replaces the TPU Pallas kernel src/repro/kernels/hif4_quant.py::hif4_quantize
// (body _quant_kernel). x (M, K) -> ints (M, K) int8 = S1P2 quarters shifted
// left by E1_8 + E1_16 (|q| <= 28), scales (M, K/64) f32 = E6M2 / 4.
//
// What bounds it on the H100: memory. It reads 2 B (bf16) and writes
// 1 B + 4/64 B per value with a few dozen flops each, far below the card's
// ops-per-byte balance; at decode shapes (M = batch) it is launch-bound.
//
// Design: one warp per 64-group, two neighbouring elements per lane, so a
// warp reads one contiguous 128 B (bf16) line and writes 64 B. The three-level
// tree max of Algorithm 1 is three warp-shuffle levels (lane pairs = the 4
// elements of an E1_16 block, lane quads = the 8 of an E1_8 block, the whole
// warp = the group). The per-group metadata is computed redundantly by every
// lane (no shared memory, no barrier). Every bf16 step of the reference is an
// explicit __float2bfloat16_rn, the reciprocal is an IEEE division, rounding
// is rintf (half to even), and the micro-exponent scales are the exact
// constants 1, 0.5 and 0.25, so the output is bitwise the reference's.
#include "hif4_common.cuh"

namespace {

constexpr float kRecip7Bf16 = 0.142578125f;  // (1/7) rounded to bf16
constexpr float kE6m2Max = 49152.0f;                 // 2^15 * 1.5
constexpr int kThreads = 256;                        // 8 groups per block

__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
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
  return nan_min(nan_max(q, kE6m2Min), kE6m2Max);
}

__device__ __forceinline__ int8_t absorb(float v, float rec, float shift_scale,
                                         int shift) {
  const float scaled = rbf(v * rec) * shift_scale;
  const float q = fminf(fmaxf(rintf(scaled * 4.0f), -7.0f), 7.0f);
  return static_cast<int8_t>(static_cast<int>(q) * (1 << shift));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    hif4_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ ints,
                         float* __restrict__ scales, long long n_groups) {
  const long long grp =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (grp >= n_groups) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;

  float x0, x1;
  load2(x + grp * 64 + 2 * lane, x0, x1);

  // Stage 1: tree max (lines 1-7)
  float v16 = nan_max(fabsf(x0), fabsf(x1));
  v16 = nan_max(v16, __shfl_xor_sync(HIF4_FULL_MASK, v16, 1));
  const float v8 = nan_max(v16, __shfl_xor_sync(HIF4_FULL_MASK, v16, 2));
  float vmax = v8;
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
    vmax = nan_max(vmax, __shfl_xor_sync(HIF4_FULL_MASK, vmax, o));

  // Stage 2: hierarchical scaling metadata (lines 8-14)
  const float sf = rbf(rbf(vmax) * kRecip7Bf16);
  const float e6m2 = round_e6m2(sf);
  const float rec = rbf(__fdiv_rn(1.0f, e6m2));
  const int e1_8 = rbf(v8 * rec) > 4.0f ? 1 : 0;
  const float t16 = rbf(v16 * rec) * (e1_8 ? 0.5f : 1.0f);
  const int e1_16 = t16 >= 2.0f ? 1 : 0;

  // Stage 3: scale, round to S1P2 quarters, absorb shifts (lines 15-18)
  const int shift = e1_8 + e1_16;
  const float shift_scale = shift == 0 ? 1.0f : (shift == 1 ? 0.5f : 0.25f);
  char2 out;
  out.x = absorb(x0, rec, shift_scale, shift);
  out.y = absorb(x1, rec, shift_scale, shift);
  *reinterpret_cast<char2*>(ints + grp * 64 + 2 * lane) = out;
  if (lane == 0) scales[grp] = e6m2 * 0.25f;
}

template <typename T>
int launch(const void* x, void* ints, void* scales, long long n_groups,
           void* stream) {
  if (n_groups <= 0) return 0;
  const long long blocks = (n_groups + kThreads / 32 - 1) / (kThreads / 32);
  hif4_quantize_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(ints),
      static_cast<float*>(scales), n_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hif4_quantize_bf16(const void* x, void* ints, void* scales,
                                  long long n_groups, void* stream) {
  return launch<__nv_bfloat16>(x, ints, scales, n_groups, stream);
}

extern "C" int hif4_quantize_f32(const void* x, void* ints, void* scales,
                                 long long n_groups, void* stream) {
  return launch<float>(x, ints, scales, n_groups, stream);
}
