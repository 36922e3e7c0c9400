// bfp_decode_matmul: the decode form of kernel 5 (bfp_matmul_quantized),
// with the weight's Algorithm 1 (kernel 1, hif4_quantize) folded into its
// loader.
//
// Replaces, for M <= 32 rows (the LM head at decode), the pair of TPU
// Pallas kernels src/repro/kernels/hif4_quant.py::hif4_quantize (on the
// weight) -> src/repro/kernels/bfp_matmul.py::bfp_matmul_quantized:
// a_ints (M, K) int8 with a_scales (M, K/64) f32 (kernel 1 on the
// activations), and w (K, N) bf16/f32 stored K-contiguous per column
// (w[n * K + k]: the tied embedding handed over as embed.T) -> (M, N) f32 =
//     sum over 64-groups g, in group order from 0.0f, of
//     (float(int32 dot_g(a[m], q(w)[:, n])) * a_scale[m, g]) * w_scale[g, n]
// bit for bit what kernel 1 on w.T followed by kernel 5 gives: the same
// Algorithm 1 (hif4_quantize_pass4, built from the pieces of kernel 1's
// hif4_quantize_group, hif4_common.cuh) on the same 64-groups, and the same
// order per output.
//
// What bounds it on the H100: Algorithm 1's instructions on CUDA cores, on
// every element of the weight on every call (the reference's dynamic A-W
// flow); the bf16 weight's 311 MB at the LM head take 0.0943 ms at
// 3.35 TB/s. The pair it replaces also wrote the 165 MB of int8 ints and
// scales and read them back. The CTA body is group_matmul_decode.cuh's
// (kernel 5's decode regime); this file adds the loader: a warp copies a
// chunk of 1024 elements of a column into its ring in kernel 1's layout (a
// lane's 8 elements of a group as one 16-byte word of bf16 or two of f32),
// quantizes its 4 passes with each group's other 7 lanes (each group's
// E6M2 worked out once, not on all 8 lanes), and passes the ints through a
// staging row in shared memory to the body's layout.
#include "group_matmul_decode.cuh"

namespace {

// Algorithm 1 on a chunk of a column in kernel 1's layout
// (hif4_quantize_pass4): pass p (of 4) gives lane 8 * slot + blk the 8
// values of group 4p + slot, block blk (elements 256 p + 8 lane ..); the
// pass's ints go to the staging row at the same offsets and the group's
// scale beside them; then lane l reads ints 32 l .. 32 l + 31 and the scale
// of their group.
template <class Values>
__device__ __forceinline__ void quantize_chunk(unsigned char* staging,
                                               int lane, int (&w)[8],
                                               float& scale, Values values) {
  float* scales = reinterpret_cast<float*>(staging + dec::kChunk);
  uint2 q[4];
  float sc[4];
  hif4_quantize_pass4(lane, values, q, sc);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    *reinterpret_cast<uint2*>(staging + 256 * p + 8 * lane) = q[p];
    if ((lane & 7) == 0) scales[4 * p + (lane >> 3)] = sc[p];
  }
  __syncwarp();
  const uint4* row = reinterpret_cast<const uint4*>(staging + 32 * lane);
  const uint4 lo = row[0], hi = row[1];
  w[0] = static_cast<int>(lo.x);
  w[1] = static_cast<int>(lo.y);
  w[2] = static_cast<int>(lo.z);
  w[3] = static_cast<int>(lo.w);
  w[4] = static_cast<int>(hi.x);
  w[5] = static_cast<int>(hi.y);
  w[6] = static_cast<int>(hi.z);
  w[7] = static_cast<int>(hi.w);
  scale = scales[lane / 2];
}

// A stage is a chunk of a bf16 column, pass p's 512 bytes at 512 p (lane l
// copies and reads the 16 bytes at 16 l of each pass), zero past K.
struct QuantBf16B {
  const __nv_bfloat16* w;             // w[n * K + k]
  static constexpr int kStageBytes = 2 * dec::kChunk;
  static constexpr int kStages = 3;
  static constexpr int kCtasPerSm = 2;
  static constexpr int kStagingBytes = dec::kChunk + 64;

  __device__ __forceinline__ void issue(unsigned char* st, int n, int chunk,
                                        int lane, int N, int K) const {
    const int k0 = chunk * dec::kChunk + 8 * lane;
    const __nv_bfloat16* src = w + static_cast<size_t>(min(n, N - 1)) * K;
    unsigned char* dst = st + 16 * lane;
    if (n < N && chunk * dec::kChunk + dec::kChunk <= K) {  // a whole chunk
#pragma unroll
      for (int p = 0; p < 4; ++p)
        sm90::cp_async16(dst + 512 * p, src + k0 + 256 * p, 16);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const bool ok = n < N && k0 + 256 * p < K;
        sm90::cp_async16(dst + 512 * p, src + (ok ? k0 + 256 * p : 0),
                         ok ? 16 : 0);
      }
    }
  }

  __device__ __forceinline__ void words(const unsigned char* st,
                                        unsigned char* staging, int lane,
                                        int (&w)[8], float& scale) const {
    const unsigned char* mine = st + 16 * lane;
    quantize_chunk(staging, lane, w, scale, [mine](int p, float (&v)[8]) {
      unpack8(*reinterpret_cast<const uint4*>(mine + 512 * p), v);
    });
  }
};

// A stage is a chunk of an f32 column, pass p's 1024 bytes at 1024 p (lane
// l copies and reads the 32 bytes at 32 l of each pass), zero past K.
struct QuantF32B {
  const float* w;                     // w[n * K + k]
  static constexpr int kStageBytes = 4 * dec::kChunk;
  static constexpr int kStages = 3;
  static constexpr int kCtasPerSm = 2;
  static constexpr int kStagingBytes = dec::kChunk + 64;

  __device__ __forceinline__ void issue(unsigned char* st, int n, int chunk,
                                        int lane, int N, int K) const {
    const size_t col = static_cast<size_t>(min(n, N - 1)) * K;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = chunk * dec::kChunk + 256 * p + 8 * lane + 4 * h;
        const bool ok = n < N && k < K;
        sm90::cp_async16(st + 1024 * p + 32 * lane + 16 * h,
                         w + col + (ok ? k : 0), ok ? 16 : 0);
      }
    }
  }

  __device__ __forceinline__ void words(const unsigned char* st,
                                        unsigned char* staging, int lane,
                                        int (&w)[8], float& scale) const {
    const unsigned char* mine = st + 32 * lane;
    quantize_chunk(staging, lane, w, scale, [mine](int p, float (&v)[8]) {
      const float4* q = reinterpret_cast<const float4*>(mine + 1024 * p);
      const float4 lo = q[0], hi = q[1];
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    });
  }
};

}  // namespace

// plan: dec::kPlanFields ints (kernels/bfp_matmul.py::decode_matmul_plan);
// empty work, M > 32, K % 64 != 0 and a plan unlike the body's are refused.
extern "C" int bfp_decode_matmul(const void* a, const void* a_scales,
                                 const void* w, void* out, int M, int N, int K,
                                 const int* plan, int w_bf16, void* stream) {
  if (w_bf16)
    return dec::launch(QuantBf16B{static_cast<const __nv_bfloat16*>(w)}, a,
                       a_scales, out, M, N, K, plan, stream);
  return dec::launch(QuantF32B{static_cast<const float*>(w)}, a, a_scales,
                     out, M, N, K, plan, stream);
}
