// fused_packed_matmul: absorbed int8 activation x K-major HiF4 packed weight.
//
// Replaces the TPU Pallas kernel
// src/repro/kernels/fused_matmul.py::fused_packed_matmul (body
// _fused_packed_kernel). a_ints (M, K) int8 with a_scales (M, K/64) f32, and
// the 4.5-bit weight codes_km (K/2, N) uint8 + meta_km (K/64, N) uint32
// -> (M, N) f32 = sum over 64-groups g of
//    float(int32 dot_g) * a_scale[m, g] * b_scale[g, n].
//
// What bounds it on the H100: in decode (M = batch <= 32) the bytes of the
// packed weight (0.5625 B/value), far below the int8 ops-per-byte balance;
// in prefill (M = batch x prompt) the integer operations. The engine's decode
// linears take the decode form instead (fused_decode_matmul.cu: kernel 1
// folded in, one launch); this entry point's decode regime serves callers
// that hand it quantized activations.
//
// The CTA body is group_matmul.cuh's, shared with kernel 5; this file adds
// the B-tile loader that expands the weight's code bytes and meta words to
// absorbed int8 in shared memory (low nibble = even K row, scale 2^eb from
// the exponent field, 0xFF -> NaN; hif4.absorbed_int_km). Every weight byte
// is read from device memory once per M-tile, and decode takes all M in one
// tile, so in decode each weight byte is read once.
#include "group_matmul.cuh"

namespace {

struct PackedB {
  const uint8_t* codes;               // (K/2, N)
  const uint32_t* meta;               // (K/64, N)

  template <int BN, int GPI, int kThreads, int kStride>
  __device__ __forceinline__ void stage(int32_t (*s_b)[kStride],
                                        float (*s_bs)[BN], int n0, int g0,
                                        int gc, int N, int K, int tid) const {
    __shared__ uint32_t s_meta[GPI][BN];
    for (int i = tid; i < GPI * BN; i += kThreads) {
      const int gi = i / BN, c = i % BN, n = n0 + c;
      const bool ok = gi < gc && n < N;
      const uint32_t w = ok ? meta[static_cast<size_t>(g0 + gi) * N + n] : 0u;
      s_meta[gi][c] = w;
      s_bs[gi][c] = ok ? meta_scale(w) : 0.0f;
    }
    __syncthreads();
    // code bytes -> absorbed int8, K contiguous per column
    for (int i = tid; i < GPI * 32 * BN; i += kThreads) {
      const int row = i / BN, c = i % BN, n = n0 + c;
      const int gi = row / 32, r = row % 32;
      const uint32_t byte =
          (gi < gc && n < N)
              ? codes[static_cast<size_t>(g0 * 32 + row) * N + n]
              : 0u;
      const uint32_t w = s_meta[gi][c];
      const int lo = absorbed_int(byte & 0xFu, w, 2 * r);
      const int hi = absorbed_int(byte >> 4, w, 2 * r + 1);
      reinterpret_cast<int16_t*>(&s_b[c][0])[gi * 32 + r] =
          static_cast<int16_t>((lo & 0xFF) | ((hi & 0xFF) << 8));
    }
  }
};

}  // namespace

extern "C" int fused_packed_matmul(const void* a, const void* a_scales,
                                   const void* codes, const void* meta,
                                   void* out, int M, int N, int K, int regime,
                                   void* stream) {
  const PackedB b{static_cast<const uint8_t*>(codes),
                  static_cast<const uint32_t*>(meta)};
  return launch_group_matmul(b, a, a_scales, out, M, N, K, regime, stream);
}
