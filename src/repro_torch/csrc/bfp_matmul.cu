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
// operations. The CTA bodies are group_matmul_decode.cuh's (M <= 32: a
// persistent grid whose warps stream whole columns once through per-warp
// cp.async rings, the activation words in registers) and
// group_matmul_sm90.cuh's (M > 32, int8 tensor cores, shared with kernel 2,
// so kernel 5 on packed_to_absorbed(pw) is bitwise kernel 2 on pw); this
// file adds the loader that reads B's int8 words and f32 scales for both.
// The decode body's other loader (bfp_decode_matmul.cu) quantizes a
// bf16/f32 weight on the fly: kernel 5's decode form.
#include "group_matmul_decode.cuh"

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

  // the decode body: a stage is a chunk of column n (1024 ints: lane l's
  // 32 bytes as two 16-byte halves, swapped on lanes 4-7 of every 8) and
  // the scales of its 16 groups, zero past K; lane l copies pieces l and
  // l + 32 of the chunk (a warp instruction copies 512 contiguous bytes)
  static constexpr int kStageBytes = dec::kChunk + 64;
  static constexpr int kStages = 5;
  static constexpr int kCtasPerSm = 2;
  static constexpr int kStagingBytes = 0;

  static __device__ __forceinline__ int half_at(int l, int h) {
    return 32 * l + 16 * (h ^ ((l >> 2) & 1));
  }

  __device__ __forceinline__ void issue(unsigned char* st, int n, int chunk,
                                        int lane, int N, int K) const {
    const size_t col = static_cast<size_t>(min(n, N - 1)) * K;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = lane + 32 * j, k = chunk * dec::kChunk + 16 * i;
      const bool ok = n < N && k < K;
      sm90::cp_async16(st + half_at(i >> 1, i & 1), b + col + (ok ? k : 0),
                       ok ? 16 : 0);
    }
    if (lane < 16) {
      const int g = chunk * (dec::kChunk / 64) + lane;
      const bool ok = n < N && g < K / 64;
      sm90::cp_async4(st + dec::kChunk + 4 * lane,
                      scales + static_cast<size_t>(min(n, N - 1)) * (K / 64) +
                          (ok ? g : 0),
                      ok ? 4 : 0);
    }
  }

  __device__ __forceinline__ void words(const unsigned char* st,
                                        unsigned char*, int lane, int (&w)[8],
                                        float& scale) const {
    const uint4 lo = *reinterpret_cast<const uint4*>(st + half_at(lane, 0));
    const uint4 hi = *reinterpret_cast<const uint4*>(st + half_at(lane, 1));
    w[0] = static_cast<int>(lo.x);
    w[1] = static_cast<int>(lo.y);
    w[2] = static_cast<int>(lo.z);
    w[3] = static_cast<int>(lo.w);
    w[4] = static_cast<int>(hi.x);
    w[5] = static_cast<int>(hi.y);
    w[6] = static_cast<int>(hi.z);
    w[7] = static_cast<int>(hi.w);
    scale = reinterpret_cast<const float*>(st + dec::kChunk)[lane / 2];
  }
};

}  // namespace

// regime 0 = decode (M <= 32: group_matmul_decode.cuh, whose plan is
// dec::kPlanFields ints), regime 1 = prefill (M > 32: the tensor-core body,
// sm90::kPlanFields ints); a regime that does not fit M is refused.
extern "C" int bfp_matmul_quantized(const void* a, const void* a_scales,
                                    const void* b, const void* b_scales,
                                    void* out, int M, int N, int K, int regime,
                                    const int* plan, void* stream) {
  const Int8B loader{static_cast<const int8_t*>(b),
                     static_cast<const float*>(b_scales)};
  if (M <= 0 || N <= 0 || K <= 0 || K % 64 || regime != (M > 32 ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (regime == 0)
    return dec::launch(loader, a, a_scales, out, M, N, K, plan, stream);
  return sm90::launch<Int8B, float>(loader, a, a_scales, out, M, N, K, plan,
                                    stream);
}
