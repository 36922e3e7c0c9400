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
// in prefill (M = batch x prompt) the integer operations.
//
// Design: one CTA per (BM x BN) output tile walks the whole K axis in a loop
// (the TPU's sequential K grid axis with its revisited output block becomes
// registers that live across the loop). Per step it stages GPI 64-groups:
// the A rows as int32 words, and the weight's code bytes and meta words
// expanded to absorbed int8 in shared memory (low nibble = even K row, scale
// 2^eb from the exponent field, 0xFF -> NaN; hif4.absorbed_int_km). Each
// 64-group dot is exact in int32 via __dp4a (|sum| <= 64*28*28); the one f32
// rescale per (row, col, group) is applied in group order. Every weight byte
// is read from device memory once per M-tile, and decode takes all M in one
// tile, so in decode each weight byte is read once. Shared rows are padded
// to an odd number of words so the column-wise reads do not conflict.
// Simple and right first: no TMA, no tensor cores, no multi-stage pipeline.
#include "hif4_common.cuh"

namespace {

template <int BM, int BN, int TM, int TN, int GPI>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    fused_packed_matmul_kernel(const int8_t* __restrict__ a,
                               const float* __restrict__ a_scales,
                               const uint8_t* __restrict__ codes,
                               const uint32_t* __restrict__ meta,
                               float* __restrict__ out, int M, int N, int K) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kTX = BN / TN;         // threads along N
  constexpr int kRowM = BM / TM;       // row stride of a thread's outputs
  constexpr int kWords = GPI * 16;     // int32 words of GPI 64-groups
  constexpr int kStride = kWords + 1;  // odd: conflict-free column reads

  __shared__ int32_t s_a[BM][kStride];
  __shared__ int32_t s_b[BN][kStride];
  __shared__ float s_as[GPI][BM];
  __shared__ float s_bs[GPI][BN];
  __shared__ uint32_t s_meta[GPI][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int groups = K / 64;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int g0 = 0; g0 < groups; g0 += GPI) {
    const int gc = min(GPI, groups - g0);
    // weight metadata and absorbed scales, activation scales
    for (int i = tid; i < GPI * BN; i += kThreads) {
      const int gi = i / BN, c = i % BN, n = n0 + c;
      const bool ok = gi < gc && n < N;
      const uint32_t w = ok ? meta[static_cast<size_t>(g0 + gi) * N + n] : 0u;
      s_meta[gi][c] = w;
      s_bs[gi][c] = ok ? meta_scale(w) : 0.0f;
    }
    for (int i = tid; i < GPI * BM; i += kThreads) {
      const int gi = i / BM, r = i % BM, m = m0 + r;
      s_as[gi][r] = (gi < gc && m < M)
                        ? a_scales[static_cast<size_t>(m) * groups + g0 + gi]
                        : 0.0f;
    }
    // activation rows as int32 words (K % 64 == 0 keeps them aligned)
    for (int i = tid; i < BM * kWords; i += kThreads) {
      const int r = i / kWords, wd = i % kWords, m = m0 + r;
      s_a[r][wd] = (m < M && wd < gc * 16)
                       ? reinterpret_cast<const int32_t*>(
                             a + static_cast<size_t>(m) * K + g0 * 64)[wd]
                       : 0;
    }
    __syncthreads();
    // weight codes -> absorbed int8, K contiguous per column
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
    __syncthreads();

    for (int gi = 0; gi < gc; ++gi) {
      int dot[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) dot[i][j] = 0;
#pragma unroll
      for (int wd = 0; wd < 16; ++wd) {
        int av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = s_a[ty + i * kRowM][gi * 16 + wd];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = s_b[tx + j * kTX][gi * 16 + wd];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) dot[i][j] = __dp4a(av[i], bv[j], dot[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += (static_cast<float>(dot[i][j]) * s_as[gi][ty + i * kRowM]) *
                       s_bs[gi][tx + j * kTX];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * kRowM;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * kTX;
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

template <int BM, int BN, int TM, int TN, int GPI>
int launch(const void* a, const void* a_scales, const void* codes,
           const void* meta, void* out, int M, int N, int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_packed_matmul_kernel<BM, BN, TM, TN, GPI>
      <<<grid, (BM / TM) * (BN / TN), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(a), static_cast<const float*>(a_scales),
          static_cast<const uint8_t*>(codes),
          static_cast<const uint32_t*>(meta), static_cast<float*>(out), M, N,
          K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// regime 0 = decode (M <= 32: one M-tile, narrow N-tiles so the weight
// streams through many CTAs), regime 1 = prefill (square 64 x 64 tiles).
extern "C" int fused_packed_matmul(const void* a, const void* a_scales,
                                   const void* codes, const void* meta,
                                   void* out, int M, int N, int K, int regime,
                                   void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (regime == 0) {
    if (M <= 16)
      return launch<16, 32, 1, 2, 4>(a, a_scales, codes, meta, out, M, N, K,
                                     stream);
    return launch<32, 32, 2, 2, 4>(a, a_scales, codes, meta, out, M, N, K,
                                   stream);
  }
  return launch<64, 64, 4, 4, 2>(a, a_scales, codes, meta, out, M, N, K,
                                 stream);
}
