// Regime 0 (M <= 32 rows: decode, the LM head) of kernel 5
// (bfp_matmul_quantized): a group-scaled int8 matmul in which each warp
// streams whole weight columns once, templated over the loader of the
// weight.
//
//   out (M, N) f32 = sum over 64-groups g, in group order from 0.0f, of
//       (float(int32 dot_g(a[m], w[:, n])) * a_scale[m, g]) * b_scale[g, n]
//
// the order per output of the plain version (kernels/bfp_matmul.py) and of
// the prefill body (group_matmul_sm90.cuh), so every output is bitwise
// theirs. Two loaders give the body its weight, K contiguous per column:
// Int8B (bfp_matmul.cu: pre-quantized int8 words and f32 scales) and
// QuantB (bfp_decode_matmul.cu: bf16 or f32 values, quantized on the fly by
// hif4_quantize_pass4, built from the pieces of kernel 1's own body, so the
// decode form of kernel 5 is bitwise kernel 1 on w.T followed by kernel 5).
//
// What bounds it on the H100: for Int8B the weight's bytes (156 MB at the
// LM head, M=8, K=1024, N=151 936: 0.0508 ms at 3.35 TB/s); for QuantB the
// instructions of Algorithm 1 on every weight element (the bf16 weight's
// 311 MB take 0.0943 ms), then the dots, M __dp4a per weight word. So every
// warp reads whole columns, contiguously (a column of K=1024 is 1 KB of
// int8, 2 KB of bf16), several columns ahead, and the work that is neither
// a dot nor Algorithm 1 is a few instructions per group:
//
// * Warp w of the persistent grid (ctas_per_sm CTAs of kWarps warps per
//   SM) walks the columns w, w + warps, ... A column is cut into chunks of
//   kChunk = 1024 elements: lane l holds ints 32 l .. 32 l + 31 of the chunk
//   (half of 64-group l / 2) as 8 words, and the lane's activation words are
//   the same for every column, so at 8 row slots and one chunk (K <= 1024)
//   they live in registers (64 words); otherwise they are read through L1
//   for every column, which makes M > 8 several times slower per weight
//   byte than M <= 8.
// * Each warp owns a ring of Loader::kStages chunks in shared memory: the
//   loader's cp.async copies (16 bytes a lane, 512 contiguous bytes a warp
//   instruction, zero-filled past K) of item q + kStages - 1 are issued
//   before item q's arithmetic, and a warp waits only on its own copies
//   (cp.async.wait_group, __syncwarp): no CTA barrier, and no register holds
//   a weight in flight.
// * Int8B's stage is the chunk's ints (lane l's 32 bytes as two 16-byte
//   halves, swapped on lanes 4-7 of every 8, so a lane's 16-byte reads are
//   free of bank conflicts) and its 16 scales. QuantB's stage is the chunk's
//   values in kernel 1's layout (8 lanes per group, 4 groups per pass of
//   256 elements); the warp runs Algorithm 1 on them and passes the ints
//   through a per-warp staging row to the layout above.
// * Dots: 8 __dp4a per row give a lane its half-group dot, exact in int32
//   (rows past M are not loaded, their words are zero: a branch per row kept
//   the rows from overlapping); one shuffle level over the lane pair leaves
//   the even lane with the whole group dots of rows 0 .. R/2-1 and the odd
//   one with rows R/2 .. R-1 (R = M rounded up to 8).
// * Terms and the sum: the lane rescales its dots with __fmul_rn (float of
//   the dot, times a_scale, times b_scale) into a per-warp term tile in
//   shared memory, and lane r then adds row r's terms of the chunk's 16
//   groups, in group order, with __fadd_rn to the row's running sum, which
//   starts at 0.0f; after the column's last chunk it stores the sum. No
//   contracted multiply-add, no --use_fast_math; a NaN scale reaches
//   exactly its row or column.
//
// The launch plan (row slots, stages, warps, CTAs per SM, grid, shared
// bytes) is mirrored by kernels/bfp_matmul.py::decode_matmul_plan; the
// launcher refuses a plan that differs from its own in any field.
#pragma once

#include "group_matmul_sm90.cuh"

namespace dec {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 1024;         // K elements per chunk: 32 lanes x 32
constexpr int kTermStride = 20;      // floats per row of the term tile: 16
                                     // groups + 4 (conflict-free 16-B reads)
constexpr int kSms = 132;            // H100 SXM
constexpr int kPlanFields = 6;

// row slots: M rounded up to a multiple of 8
__host__ __device__ constexpr int row_slots(int m) { return (m + 7) / 8 * 8; }

// shared bytes of a warp: its ring, staging row and term tile
template <class Loader>
__host__ __device__ constexpr int warp_bytes(int rows) {
  return Loader::kStages * Loader::kStageBytes + Loader::kStagingBytes +
         rows * kTermStride * 4;
}

template <class Loader>
__host__ __device__ constexpr int smem_bytes(int rows) {
  return kWarps * warp_bytes<Loader>(rows);
}

// CTAs per SM: the loader's, or as many as the SM's 228 KB of shared memory
// hold (1 KB of it reserved per CTA)
template <class Loader>
__host__ __device__ constexpr int ctas_per_sm(int rows) {
  const int fit = 233472 / (smem_bytes<Loader>(rows) + 1024);
  return Loader::kCtasPerSm < fit ? Loader::kCtasPerSm : fit;
}

// The item a loader loads or the body works on: chunk `chunk` of column
// `n`, walked column by column and chunk by chunk.
struct Cursor {
  int n, chunk;
  __device__ __forceinline__ void next(int chunks, int warps) {
    if (++chunk == chunks) {
      chunk = 0;
      n += warps;
    }
  }
};

template <class Loader, int R, bool kARegs>
__global__ void __launch_bounds__(kThreads, ctas_per_sm<Loader>(R))
    decode_kernel(Loader b, const int8_t* __restrict__ a,
                  const float* __restrict__ a_scales, float* __restrict__ out,
                  int M, int N, int K) {
  constexpr int S = Loader::kStages;
  constexpr int H = R / 2;                  // rows per lane after the fold
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31;
  const int G = K / 64;
  const int chunks = (K + kChunk - 1) / kChunk;
  const int warps = gridDim.x * kWarps;
  const int w0 = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w0 >= N) return;                      // the whole warp
  const int items = ((N - 1 - w0) / warps + 1) * chunks;
  unsigned char* ring = smem + (threadIdx.x >> 5) * warp_bytes<Loader>(R);
  unsigned char* staging = ring + S * Loader::kStageBytes;
  float* terms = reinterpret_cast<float*>(staging + Loader::kStagingBytes);
  const int odd = lane & 1;

  // the lane's activation words and scales when they are the same for
  // every item (one chunk, 8 row slots)
  uint4 areg[kARegs ? R : 1][2];
  float sreg[kARegs ? H : 1];
  if constexpr (kARegs) {
    const bool live = 32 * lane < K;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint4* p = reinterpret_cast<const uint4*>(
          a + static_cast<size_t>(r) * K + 32 * lane);
      areg[r][0] = (r < M && live) ? __ldg(p) : make_uint4(0u, 0u, 0u, 0u);
      areg[r][1] = (r < M && live) ? __ldg(p + 1) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int row = odd * H + i;
      sreg[i] = (row < M && live)
                    ? __ldg(a_scales + static_cast<size_t>(row) * G + lane / 2)
                    : 0.0f;
    }
  }

  // copies of the next item into its stage; a commit group per item,
  // empty past the last
  Cursor ld{w0, 0}, cur{w0, 0};
  int iq = 0, is = 0;
  auto issue = [&]() {
    if (iq < items) b.issue(ring + is * Loader::kStageBytes, ld.n, ld.chunk,
                            lane, N, K);
    sm90::cp_async_commit();
    ld.next(chunks, warps);
    ++iq;
    if (++is == S) is = 0;
  };
#pragma unroll
  for (int q = 0; q < S - 1; ++q) issue();

  float acc = 0.0f;                         // lane r: row r's running sum
  int cs = 0;
  for (int q = 0; q < items; ++q) {
    sm90::cp_async_wait<S - 2>();         // this lane's copies of item q
    __syncwarp();                         // every lane's; item q-1 read
    issue();                              // item q+S-1, into q-1's stage
    int w[8];
    float bs;
    b.words(ring + cs * Loader::kStageBytes, staging, lane, w, bs);
    if (++cs == S) cs = 0;
    const int g = cur.chunk * (kChunk / 64) + lane / 2;
    const bool live = g < G;
    int dot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint4 a0 = make_uint4(0u, 0u, 0u, 0u), a1 = a0;
      if constexpr (kARegs) {
        a0 = areg[r][0];
        a1 = areg[r][1];
      } else if (r < M && live) {
        const uint4* p = reinterpret_cast<const uint4*>(
            a + static_cast<size_t>(r) * K + cur.chunk * kChunk + 32 * lane);
        a0 = __ldg(p);
        a1 = __ldg(p + 1);
      }
      int s = __dp4a(static_cast<int>(a0.x), w[0], 0);
      s = __dp4a(static_cast<int>(a0.y), w[1], s);
      s = __dp4a(static_cast<int>(a0.z), w[2], s);
      s = __dp4a(static_cast<int>(a0.w), w[3], s);
      s = __dp4a(static_cast<int>(a1.x), w[4], s);
      s = __dp4a(static_cast<int>(a1.y), w[5], s);
      s = __dp4a(static_cast<int>(a1.z), w[6], s);
      dot[r] = __dp4a(static_cast<int>(a1.w), w[7], s);
    }
    // the lane pair's fold: the even lane keeps rows 0 .. H-1, the odd
    // lane rows H .. R-1, each with the partner's half added (exact)
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int send = odd ? dot[i] : dot[i + H];
      const int keep = odd ? dot[i + H] : dot[i];
      dot[i] = keep + __shfl_xor_sync(HIF4_FULL_MASK, send, 1);
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int row = odd * H + i;
      float as;
      if constexpr (kARegs)
        as = sreg[i];
      else
        as = (row < M && live)
                 ? __ldg(a_scales + static_cast<size_t>(row) * G + g)
                 : 0.0f;
      terms[row * kTermStride + lane / 2] =
          __fmul_rn(__fmul_rn(__int2float_rn(dot[i]), as), bs);
    }
    __syncwarp();                         // the terms are in place
    // lane r: row r's terms of the chunk's groups, in group order
    if (lane < M) {
      const int left = G - cur.chunk * (kChunk / 64);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 t =
            reinterpret_cast<const float4*>(terms + lane * kTermStride)[j];
        if (4 * j < left) acc = __fadd_rn(acc, t.x);
        if (4 * j + 1 < left) acc = __fadd_rn(acc, t.y);
        if (4 * j + 2 < left) acc = __fadd_rn(acc, t.z);
        if (4 * j + 3 < left) acc = __fadd_rn(acc, t.w);
      }
    }
    if (cur.chunk == chunks - 1) {        // the column's sums are complete
      if (lane < M) out[static_cast<size_t>(lane) * N + cur.n] = acc;
      acc = 0.0f;
    }
    cur.next(chunks, warps);
  }
  sm90::cp_async_wait<0>();                 // no copy outlives the kernel
}

// The plan as the host mirrors it: {row slots, stages, warps per CTA, CTAs
// per SM, grid, shared bytes}.
template <class Loader>
void plan_of(int M, int N, int* want) {
  const int rows = row_slots(M);
  const int grid = (N + kWarps - 1) / kWarps;
  const int full = kSms * ctas_per_sm<Loader>(rows);
  want[0] = rows;
  want[1] = Loader::kStages;
  want[2] = kWarps;
  want[3] = ctas_per_sm<Loader>(rows);
  want[4] = grid < full ? grid : full;
  want[5] = smem_bytes<Loader>(rows);
}

template <class Loader, int R, bool kARegs>
int launch_rows(const Loader& b, const void* a, const void* a_scales,
                void* out, int M, int N, int K, int grid, void* stream) {
  constexpr int kSmem = smem_bytes<Loader>(R);
  void (*kernel)(Loader, const int8_t*, const float*, float*, int, int, int) =
      decode_kernel<Loader, R, kARegs>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      b, static_cast<const int8_t*>(a), static_cast<const float*>(a_scales),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// Empty work, M > 32, K % 64 != 0 and a plan unlike plan_of's are refused.
// The activation words live in registers at 8 row slots and one chunk.
template <class Loader>
int launch(const Loader& b, const void* a, const void* a_scales, void* out,
           int M, int N, int K, const int* plan, void* stream) {
  if (M <= 0 || M > 32 || N <= 0 || K <= 0 || K % 64 || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int want[kPlanFields];
  plan_of<Loader>(M, N, want);
  for (int i = 0; i < kPlanFields; ++i)
    if (plan[i] != want[i]) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = want[4];
  switch (want[0]) {
    case 8:
      if (K <= kChunk)
        return launch_rows<Loader, 8, true>(b, a, a_scales, out, M, N, K, grid,
                                            stream);
      return launch_rows<Loader, 8, false>(b, a, a_scales, out, M, N, K, grid,
                                           stream);
    case 16:
      return launch_rows<Loader, 16, false>(b, a, a_scales, out, M, N, K, grid,
                                            stream);
    case 24:
      return launch_rows<Loader, 24, false>(b, a, a_scales, out, M, N, K, grid,
                                            stream);
    default:
      return launch_rows<Loader, 32, false>(b, a, a_scales, out, M, N, K, grid,
                                            stream);
  }
}

}  // namespace dec
