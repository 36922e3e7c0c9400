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
// The CTA bodies are group_matmul.cuh's (M <= 32) and group_matmul_sm90.cuh's
// (M > 32, int8 tensor cores, shared with kernel 5); this file adds the
// B-tile loader that expands the weight's code bytes and meta words to
// absorbed int8 in shared memory (low nibble = even K row, scale 2^eb from
// the exponent field, 0xFF -> NaN; hif4.absorbed_int_km). Every weight byte
// is read from device memory once per M-tile, and decode takes all M in one
// tile, so in decode each weight byte is read once. The prefill body takes
// the output in f32 or bf16 (rounded from the same f32 value).
#include "group_matmul.cuh"

namespace {

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Four absorbed ints of one quad of a group (all under one shift s, E1_16
// and E1_8 being per 4 and per 8 elements), from the four sign-magnitude
// codes in the low 16 bits of `codes` (first element in the lowest nibble):
// prmt's table lookup gives mag for a positive code and 0 for a negative
// one (a selector nibble with bit 3 set replicates the table byte's clear
// sign bit), the same lookup on the flipped sign bits the reverse, and
// 0x80 + p - n per byte, all below 0x80 + 28, is the signed difference.
__device__ __forceinline__ uint32_t absorbed_quad(uint32_t codes, int s) {
  const uint32_t p = prmt(0x03020100u, 0x07060504u, codes);
  const uint32_t n = prmt(0x03020100u, 0x07060504u, codes ^ 0x8888u);
  return ((p << s) + 0x80808080u - (n << s)) ^ 0x80808080u;
}

struct PackedB {
  const uint8_t* codes;               // (K/2, N)
  const uint32_t* meta;               // (K/64, N)

  // the prefill body's raw stage: 32 code rows of the tile's columns, then
  // their meta words; kept in the stage until expand() writes the B tile
  static constexpr int kCodeRow = sm90::kTileN;
  static constexpr int kRawBytes = 32 * kCodeRow + 4 * sm90::kTileN;
  static constexpr bool kExpands = true;

  // cp.async of group g's code rows (16-byte pieces when N % 16 == 0, else
  // bytes through registers) and meta words, zero past the N edge
  __device__ __forceinline__ void issue(uint8_t* raw, uint8_t*, float*, int n0,
                                        int g, int N, int, int t) const {
    if ((N & 15) == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = t + 128 * j, r = i >> 3, ch = i & 7, n = n0 + 16 * ch;
        sm90::cp_async16(
            raw + r * kCodeRow + 16 * ch,
            codes + static_cast<size_t>(g * 32 + r) * N + min(n, N - 16),
            n < N ? 16 : 0);
      }
    } else {
      for (int r = 0; r < 32; ++r) {
        const int n = n0 + t;
        raw[r * kCodeRow + t] =
            n < N ? codes[static_cast<size_t>(g * 32 + r) * N + n] : 0;
      }
    }
    const int n = n0 + t;
    sm90::cp_async4(raw + 32 * kCodeRow + 4 * t,
                    meta + static_cast<size_t>(g) * N + min(n, N - 1),
                    n < N ? 4 : 0);
  }

  // thread t: columns 4q..4q+3 (q = t % 32) over code rows 8rb..8rb+7 (rb =
  // t / 32: K 16rb..16rb+15, the B tile's 16-byte chunk rb). It takes the
  // four columns in an order rotated by q / 2, so that a warp's 16-byte
  // stores land on every bank (the swizzle keys on the column's bits 1-2);
  // thread t also writes column t's scale.
  __device__ __forceinline__ void expand(const uint8_t* raw, uint8_t* btile,
                                         float* bs, int t) const {
    const int q = t & 31, rb = t >> 5;
    const uint32_t* mw = reinterpret_cast<const uint32_t*>(raw + 32 * kCodeRow);
    uint32_t w[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      w[r] = *reinterpret_cast<const uint32_t*>(raw + (8 * rb + r) * kCodeRow +
                                                4 * q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = (i + (q >> 1)) & 3, c = 4 * q + x;
      const uint32_t sel = x | ((x + 4) << 4);    // byte x of two words
      const uint32_t w0 = __byte_perm(__byte_perm(w[0], w[1], sel),
                                      __byte_perm(w[2], w[3], sel), 0x5410);
      const uint32_t w1 = __byte_perm(__byte_perm(w[4], w[5], sel),
                                      __byte_perm(w[6], w[7], sel), 0x5410);
      const uint32_t m = mw[c];
      const uint32_t e16 = m >> (4 * rb), e8 = m >> (16 + 2 * rb);
      uint4 o;
      o.x = absorbed_quad(w0, (e16 & 1) + (e8 & 1));
      o.y = absorbed_quad(w0 >> 16, ((e16 >> 1) & 1) + (e8 & 1));
      o.z = absorbed_quad(w1, ((e16 >> 2) & 1) + ((e8 >> 1) & 1));
      o.w = absorbed_quad(w1 >> 16, ((e16 >> 3) & 1) + ((e8 >> 1) & 1));
      *reinterpret_cast<uint4*>(btile + sm90::sw64(c, rb)) = o;
    }
    bs[t] = meta_scale(mw[t]);
  }

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
                                   const int* plan, int out_bf16,
                                   void* stream) {
  const PackedB b{static_cast<const uint8_t*>(codes),
                  static_cast<const uint32_t*>(meta)};
  return launch_group_matmul(b, a, a_scales, out, M, N, K, regime, plan,
                             out_bf16, stream);
}
