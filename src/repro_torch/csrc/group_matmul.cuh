// The decode CTA body of kernel 2 (fused_packed_matmul, fused_matmul.cu)
// when it is called directly with at most 32 rows: a group-scaled int8
// matmul, templated over the loader of the B tile and the output type.
//
//   out (M, N) = sum over 64-groups g, in group order, of
//       (float(int32 dot_g(a[m], b[:, n])) * a_scale[m, g]) * b_scale[g, n]
//
// a (M, K) int8 row-major with a_scales (M, K/64) f32. The loader stages,
// for GPI groups from g0 on, the B columns n0..n0+BN-1 as absorbed int8
// words (K contiguous per column) into s_b and their scales into s_bs;
// kernel 2's loader expands 4.5-bit codes + meta words. Kernel 5 on the
// absorbed expansion of a packed weight is bitwise kernel 2 on it, in any
// of the bodies, because all compute each output in one order: exact int32
// group dots, then (dot * a_scale) * b_scale rounded to f32, summed in
// group order from 0.0f with no contracted multiply-add. Kernel 5's own
// decode body is group_matmul_decode.cuh (its weight columns are K
// contiguous; kernel 2's code rows are N contiguous, so its loader would
// need a design of its own there), and the engine's decode linears take
// kernel 2's decode form (fused_decode_matmul.cu: its own body, kernel 1 as
// its prologue), which keeps the same order per output.
//
// One CTA per (BM x BN) output tile walks the whole K axis in a loop (the
// TPU's sequential K grid axis with its revisited output block becomes
// registers that live across the loop). Each 64-group dot is exact in int32
// via __dp4a (|q| <= 28, |sum| <= 64*28*28); the rescale and the sum over
// groups use __fmul_rn / __fadd_rn, so no multiply-add is contracted and
// the plain PyTorch version (kernels/bfp_matmul.py) gives the same bits.
// A NaN scale reaches exactly the outputs whose row or column uses it: no
// group is skipped. Shared rows are padded to an odd number of words so the
// column-wise reads do not conflict. This body serves regime 0 (M <= 32);
// regime 1 (M > 32, prefill) runs group_matmul_sm90.cuh's body on the int8
// tensor cores, in the same order per output. Loaders give both bodies
// their B tiles: `stage` here, `issue` / `expand` there.
#pragma once

#include "group_matmul_sm90.cuh"
#include "hif4_common.cuh"

namespace {

template <int BM, int BN, int TM, int TN, int GPI, class Loader, typename TOut>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    group_matmul_kernel(Loader b, const int8_t* __restrict__ a,
                        const float* __restrict__ a_scales,
                        TOut* __restrict__ out, int M, int N, int K) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kTX = BN / TN;         // threads along N
  constexpr int kRowM = BM / TM;       // row stride of a thread's outputs
  constexpr int kWords = GPI * 16;     // int32 words of GPI 64-groups
  constexpr int kStride = kWords + 1;  // odd: conflict-free column reads

  __shared__ int32_t s_a[BM][kStride];
  __shared__ int32_t s_b[BN][kStride];
  __shared__ float s_as[GPI][BM];
  __shared__ float s_bs[GPI][BN];

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
    b.template stage<BN, GPI, kThreads, kStride>(s_b, s_bs, n0, g0, gc, N, K,
                                                  tid);
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
          acc[i][j] = __fadd_rn(
              acc[i][j],
              __fmul_rn(__fmul_rn(static_cast<float>(dot[i][j]),
                                  s_as[gi][ty + i * kRowM]),
                        s_bs[gi][tx + j * kTX]));
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
      if (n < N) sm90::store1(out + static_cast<size_t>(m) * N + n, acc[i][j]);
    }
  }
}

template <int BM, int BN, int TM, int TN, int GPI, class Loader, typename TOut>
int launch_tiles(const Loader& b, const void* a, const void* a_scales,
                 void* out, int M, int N, int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  group_matmul_kernel<BM, BN, TM, TN, GPI, Loader, TOut>
      <<<grid, (BM / TM) * (BN / TN), 0, static_cast<cudaStream_t>(stream)>>>(
          b, static_cast<const int8_t*>(a), static_cast<const float*>(a_scales),
          static_cast<TOut*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <class Loader, typename TOut>
int launch_regime(const Loader& b, const void* a, const void* a_scales,
                  void* out, int M, int N, int K, int regime, const int* plan,
                  void* stream) {
  if (regime == 0) {
    if (M <= 16)
      return launch_tiles<16, 32, 1, 2, 4, Loader, TOut>(b, a, a_scales, out,
                                                         M, N, K, stream);
    return launch_tiles<32, 32, 2, 2, 4, Loader, TOut>(b, a, a_scales, out, M,
                                                       N, K, stream);
  }
  return sm90::launch<Loader, TOut>(b, a, a_scales, out, M, N, K, plan,
                                    stream);
}

// regime 0 = decode (M <= 32: one M-tile, narrow N-tiles so the weight
// streams through many CTAs, the __dp4a body above), regime 1 = prefill
// (M > 32: the tensor-core body, whose launch plan the caller passes as
// sm90::kPlanFields ints, NULL for regime 0). The output is f32, or bf16 rounded from the same f32 value.
// Empty work and a regime that does not fit M are refused (the wrappers
// raise before it gets here).
template <class Loader>
int launch_group_matmul(const Loader& b, const void* a, const void* a_scales,
                        void* out, int M, int N, int K, int regime,
                        const int* plan, int out_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 64 || regime != (M > 32 ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16)
    return launch_regime<Loader, __nv_bfloat16>(b, a, a_scales, out, M, N, K,
                                                regime, plan, stream);
  return launch_regime<Loader, float>(b, a, a_scales, out, M, N, K, regime,
                                      plan, stream);
}

}  // namespace
