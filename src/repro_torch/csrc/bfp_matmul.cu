// bfp_matmul_quantized: group-scaled int8 x int8 matmul on pre-quantized
// HiF4 operands (paper §III.B fixed-point flow).
//
// Replaces the TPU Pallas kernel
// src/repro/kernels/bfp_matmul.py::bfp_matmul_quantized (body
// _bfp_matmul_kernel -> _tile_group_dot). a_ints (M, K) int8 with a_scales
// (M, K/64) f32, b_ints (K, N) int8 with b_scales (K/64, N) f32 -> (M, N)
// f32 = sum over 64-groups g of float(int32 dot_g) * a_scale * b_scale.
//
// B arrives K-contiguous per output column: b[n * K + k] and
// b_scales[n * (K/64) + g], which is the storage of the transposed views
// (wi.T, wsc.T) of hif4_quantize(w.T) that the engine passes, so the tied LM
// head never copies its (151 936 x 1 024) int8 operand.
//
// What bounds it on the H100: at decode (M <= 32, the LM head) the bytes of
// the int8 weight (1 B/value, plus 1/16 B of scales); at prefill M the int8
// operations. The CTA bodies are group_matmul.cuh's (M <= 32) and
// group_matmul_sm90.cuh's (M > 32, int8 tensor cores), shared with kernel
// 2, so kernel 5 on packed_to_absorbed(pw) is bitwise kernel 2 on pw; this
// file adds the loader that reads B's int8 words and f32 scales (the
// prefill body copies them into its B tile as they are). At decode the N
// axis alone gives N/32 CTAs (4 748 for the LM head).
#include "group_matmul.cuh"

namespace {

struct Int8B {
  const int8_t* b;                    // b[n * K + k]
  const float* scales;                // scales[n * (K/64) + g]

  // the prefill body: columns arrive in the B tile as they are
  static constexpr int kRawBytes = 0;
  static constexpr bool kExpands = false;

  // cp.async of group g's 64 bytes of each column (16-byte pieces into the
  // swizzled tile) and its scale, zero past the N edge
  __device__ __forceinline__ void issue(uint8_t*, uint8_t* btile, float* bs,
                                        int n0, int g, int N, int K,
                                        int t) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = t + 128 * j, c = i >> 2, ch = i & 3, n = n0 + c;
      sm90::cp_async16(
          btile + sm90::sw64(c, ch),
          b + static_cast<size_t>(min(n, N - 1)) * K + g * 64 + ch * 16,
          n < N ? 16 : 0);
    }
    const int n = n0 + t;
    sm90::cp_async4(bs + t,
                    scales + static_cast<size_t>(min(n, N - 1)) * (K / 64) + g,
                    n < N ? 4 : 0);
  }

  template <int BN, int GPI, int kThreads, int kStride>
  __device__ __forceinline__ void stage(int32_t (*s_b)[kStride],
                                        float (*s_bs)[BN], int n0, int g0,
                                        int gc, int N, int K, int tid) const {
    constexpr int kWords = GPI * 16;
    const int groups = K / 64;
    for (int i = tid; i < GPI * BN; i += kThreads) {
      const int gi = i / BN, c = i % BN, n = n0 + c;
      s_bs[gi][c] = (gi < gc && n < N)
                        ? scales[static_cast<size_t>(n) * groups + g0 + gi]
                        : 0.0f;
    }
    for (int i = tid; i < BN * kWords; i += kThreads) {
      const int c = i / kWords, wd = i % kWords, n = n0 + c;
      s_b[c][wd] = (n < N && wd < gc * 16)
                       ? reinterpret_cast<const int32_t*>(
                             b + static_cast<size_t>(n) * K + g0 * 64)[wd]
                       : 0;
    }
  }
};

}  // namespace

extern "C" int bfp_matmul_quantized(const void* a, const void* a_scales,
                                    const void* b, const void* b_scales,
                                    void* out, int M, int N, int K, int regime,
                                    const int* plan, void* stream) {
  const Int8B loader{static_cast<const int8_t*>(b),
                     static_cast<const float*>(b_scales)};
  return launch_group_matmul(loader, a, a_scales, out, M, N, K, regime,
                             plan, 0, stream);
}
