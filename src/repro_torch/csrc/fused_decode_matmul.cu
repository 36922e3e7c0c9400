// fused_decode_matmul: the decode form of kernel 2 (fused_packed_matmul),
// with kernel 1 (hif4_quantize) folded in as its prologue.
//
// Replaces, for M <= 32 rows (a decode batch), the pair of TPU Pallas kernels
// src/repro/kernels/hif4_quant.py::hif4_quantize ->
// src/repro/kernels/fused_matmul.py::fused_packed_matmul and the cast of
// their f32 result: x (M, K) bf16/f32 with codes_km (K/2, N) uint8 and
// meta_km (K/64, N) uint32 -> out (M, N) bf16/f32 =
//     cast(sum over 64-groups g, in group order from 0.0f, of
//          (float(int32 dot_g(q(x)[m], w[:, n])) * a_scale[m, g]) * b_scale[g, n])
// bit for bit what hif4_quantize -> fused_packed_matmul -> .to(out) gives.
//
// What bounds it on the H100: the bytes of the packed weight (0.5625 B per
// value: 0.6-1.7 MB at qwen1.5-0.5b's decode shapes, 0.2-0.5 us at
// 3.35 TB/s), less than a launch's own latency; so the design is about
// latency: one launch instead of three, every load in flight at once. What
// is left is latency (the weight's DRAM round trip, barriers) and, as M
// grows, the prologue's instructions: every column tile quantizes the
// activations again.
//
// * Column tiles of 32 (two 16-byte pieces of each code row), and the K
//   axis split across the `split` CTAs of a thread block cluster (1-8,
//   chosen on the host by kernels/fused_matmul.py::decode_plan for ~2 CTAs
//   per SM: 256 CTAs at N = 1024, 352 at N = 2816). CTA `rank` of a
//   cluster owns the 64-groups [rank*G/split, (rank+1)*G/split).
// * Every cp.async copy of the CTA's codes and meta words is issued up
//   front in one commit group, waited on once. A pipeline of 4 commit
//   groups (expanding and dotting the first groups while the later ones are
//   in flight) and column tiles of 16 were measured slower on the H100 at
//   every decode shape (PERF.md §6).
// * Prologue, while the weight streams in: the CTA quantizes its K slice of
//   all M activation rows into shared memory with hif4_quantize_group
//   (kernel 1's body, hif4_common.cuh), 8 lanes per 64-group.
// * Pass 1 expands codes + meta to absorbed int8 words (a thread per
//   (group, column, word)); pass 2 takes a (group, row, column) per
//   thread: 16 __dp4a give the exact int32 dot, then the f32 term
//   (dot * a_scale) * b_scale with __fmul_rn. M is taken as it is (no
//   padding of 8 rows to 16).
// * The sum over groups stays sequential in group order. Output o's sum
//   belongs to CTA o % split of the cluster: pass 2 stores each term into
//   that CTA's shared memory (distributed shared memory), and after one
//   cluster barrier the owner adds its outputs' terms in group order
//   (__fadd_rn from 0.0f) and writes the output in the caller's dtype
//   (__float2bfloat16_rn, the rounding of PyTorch's .to(bfloat16)). A
//   relaxed cluster arrive at the start, waited on before the first remote
//   store, makes sure every CTA of the cluster has started.
// A NaN scale (E6M2 0xFF) reaches exactly the column that uses it: no group
// is skipped. Rows that are not 16-byte aligned (N % 16 != 0) take plain
// masked loads instead of cp.async, and a 16-byte piece past the ragged N
// edge is zero; outputs past it are not written. No --use_fast_math and no
// contracted multiply-add.
#include <cooperative_groups.h>

#include "hif4_common.cuh"

namespace cg = cooperative_groups;

// Phase timestamps for tools/torch_decode_trace.py: built only with
// -DREPRO_DECODE_TRACE, where thread 0 of each CTA records the global timer
// after a block barrier at each phase boundary.
#ifdef REPRO_DECODE_TRACE
__device__ unsigned long long repro_decode_trace[8192 * 8];
#define TRACE(i)                                                            \
  do {                                                                      \
    __syncthreads();                                                        \
    unsigned long long t_;                                                  \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \
    if (threadIdx.x == 0 && blockIdx.x < 8192)                              \
      repro_decode_trace[blockIdx.x * 8 + (i)] = t_;                        \
  } while (0)
extern "C" int repro_decode_trace_read(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, repro_decode_trace, static_cast<size_t>(n) * 8));
}
#else
#define TRACE(i) \
  do {           \
  } while (0)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 32;       // columns per CTA: 16-byte code row pieces
constexpr int kBStride = 17;     // words per expanded column (odd: no conflicts)

// The shared memory of a CTA, in bytes from the base; decode_plan in
// kernels/fused_matmul.py computes the same total.
struct Layout {
  int a_words;                   // int32 words per quantized activation row
  int per;                       // outputs whose group sum this CTA owns
  int codes, meta, a, as, b, t, total;
};

__host__ __device__ inline int round16(int b) { return (b + 15) & ~15; }

__host__ __device__ inline Layout layout(int M, int G, int split, int gm) {
  Layout l;
  l.a_words = gm * 16 + 2;       // rows 8-byte aligned, neighbours 2 banks apart
  l.per = (M * kTileN + split - 1) / split;
  int off = 0;
  l.codes = off;  off += round16(gm * 32 * kTileN);          // u8 [row][tile]
  l.meta = off;   off += round16(gm * kTileN * 4);           // u32 [g][tile]
  l.a = off;      off += round16(M * l.a_words * 4);         // int8 rows
  l.as = off;     off += round16(M * gm * 4);                // f32 [m][g]
  l.b = off;      off += round16(gm * kTileN * kBStride * 4);
  l.t = off;      off += round16(G * l.per * 4);             // f32 [g][owned]
  l.total = off;
  return l;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    fused_decode_matmul_kernel(const TIn* __restrict__ x,
                               const uint8_t* __restrict__ codes,
                               const uint32_t* __restrict__ meta,
                               TOut* __restrict__ out, int M, int N, int K,
                               int split, int gm) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = static_cast<int>(blockIdx.x) / split * kTileN;
  const int G = K / 64;
  const int g_lo = rank * G / split;
  const int gr = (rank + 1) * G / split - g_lo;   // this CTA's groups
  const Layout L = layout(M, G, split, gm);
  uint8_t* s_codes = smem + L.codes;
  uint32_t* s_meta = reinterpret_cast<uint32_t*>(smem + L.meta);
  int8_t* s_a = reinterpret_cast<int8_t*>(smem + L.a);
  float* s_as = reinterpret_cast<float*>(smem + L.as);
  int32_t* s_b = reinterpret_cast<int32_t*>(smem + L.b);
  float* s_t = reinterpret_cast<float*>(smem + L.t);
  const int tid = threadIdx.x;
  cluster_arrive_relaxed();  // this CTA has started (waited on before DSMEM)
  TRACE(0);

  // 1. the weight slice: code rows [32 g_lo, 32 g_hi), meta rows [g_lo, g_hi)
  // in 16-byte pieces (16 code columns, 4 meta columns); a piece past the
  // ragged N edge is zero
  if (N % 16 == 0) {
    constexpr int kCodePieces = kTileN / 16, kMetaPieces = kTileN / 4;
    for (int i = tid; i < gr * 32 * kCodePieces; i += kThreads) {
      const int row = i / kCodePieces, c = 16 * (i % kCodePieces);
      uint8_t* dst = s_codes + row * kTileN + c;
      if (n0 + c < N)
        cp_async16(dst, codes + static_cast<size_t>(g_lo * 32 + row) * N + n0 + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = tid; i < gr * kMetaPieces; i += kThreads) {
      const int gl = i / kMetaPieces, c = 4 * (i % kMetaPieces);
      uint32_t* dst = s_meta + gl * kTileN + c;
      if (n0 + c < N)
        cp_async16(dst, meta + static_cast<size_t>(g_lo + gl) * N + n0 + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < gr * 32 * kTileN; i += kThreads) {
      const int row = i / kTileN, n = n0 + i % kTileN;
      s_codes[i] = n < N ? codes[static_cast<size_t>(g_lo * 32 + row) * N + n]
                         : static_cast<uint8_t>(0);
    }
    for (int i = tid; i < gr * kTileN; i += kThreads) {
      const int gl = i / kTileN, n = n0 + i % kTileN;
      s_meta[i] = n < N ? meta[static_cast<size_t>(g_lo + gl) * N + n] : 0u;
    }
  }

  TRACE(1);
  // 2. prologue: Algorithm 1 on the CTA's K slice of every activation row,
  // 8 lanes per 64-group (32 groups per pass of the CTA)
  const int blk = tid % 8;
  const int q_total = M * gr;
  for (int q0 = 0; q0 < q_total; q0 += kThreads / 8) {
    const int q = q0 + tid / 8;
    const bool live = q < q_total;
    const int m = live ? q / gr : 0, gl = live ? q % gr : 0;
    float v[8];
    if (live) {
      load8(x + static_cast<size_t>(m) * K + (g_lo + gl) * 64 + 8 * blk, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.0f;
    }
    float scale;
    const uint2 qv = hif4_quantize_group(v, scale);  // the whole warp
    if (live) {
      *reinterpret_cast<uint2*>(s_a + m * L.a_words * 4 + gl * 64 + 8 * blk) = qv;
      if (blk == 0) s_as[m * gm + gl] = scale;
    }
  }

  TRACE(2);
  // 3. expand the weight, then the group dots; each term goes to the CTA of
  // the cluster that owns its output's sum
  cp_async_wait_all();
  cluster_wait();   // every CTA of the cluster has started
  __syncthreads();  // every thread's copies, the quantized rows
  for (int i = tid; i < gr * kTileN * 16; i += kThreads) {
    const int w = i % 16, c = (i / 16) % kTileN, gl = i / (16 * kTileN);
    const uint32_t mw = s_meta[gl * kTileN + c];
    const uint32_t b0 = s_codes[(gl * 32 + 2 * w) * kTileN + c];
    const uint32_t b1 = s_codes[(gl * 32 + 2 * w + 1) * kTileN + c];
    const uint32_t e0 = static_cast<uint32_t>(absorbed_int(b0 & 0xFu, mw, 4 * w));
    const uint32_t e1 = static_cast<uint32_t>(absorbed_int(b0 >> 4, mw, 4 * w + 1));
    const uint32_t e2 = static_cast<uint32_t>(absorbed_int(b1 & 0xFu, mw, 4 * w + 2));
    const uint32_t e3 = static_cast<uint32_t>(absorbed_int(b1 >> 4, mw, 4 * w + 3));
    s_b[(gl * kTileN + c) * kBStride + w] = static_cast<int32_t>(
        (e0 & 0xFFu) | ((e1 & 0xFFu) << 8) | ((e2 & 0xFFu) << 16) |
        ((e3 & 0xFFu) << 24));
  }
  __syncthreads();
  const int outs = M * kTileN;
  for (int i = tid; i < gr * outs; i += kThreads) {
    const int o = i % outs, gl = i / outs;
    const int m = o / kTileN, c = o % kTileN;
    const int32_t* av =
        reinterpret_cast<const int32_t*>(s_a) + m * L.a_words + gl * 16;
    const int32_t* bv = s_b + (gl * kTileN + c) * kBStride;
    int dot = 0;
#pragma unroll
    for (int w = 0; w < 16; ++w) dot = __dp4a(av[w], bv[w], dot);
    const float term =
        __fmul_rn(__fmul_rn(static_cast<float>(dot), s_as[m * gm + gl]),
                  meta_scale(s_meta[gl * kTileN + c]));
    cluster.map_shared_rank(s_t, o % split)[(g_lo + gl) * L.per + o / split] =
        term;
  }

  // 4. after the cluster barrier every term is in place: each owned output
  // is the sum of its terms in group order, from 0.0f
  TRACE(3);
  cluster.sync();
  TRACE(4);
  for (int j = tid; rank + split * j < outs; j += kThreads) {
    const int o = rank + split * j;
    float acc = 0.0f;
#pragma unroll 8
    for (int g = 0; g < G; ++g) acc = __fadd_rn(acc, s_t[g * L.per + j]);
    const int n = n0 + o % kTileN;
    if (n < N) store(out + static_cast<size_t>(o / kTileN) * N + n, acc);
  }
  TRACE(5);
}

template <typename TIn, typename TOut>
int launch(const void* x, const void* codes, const void* meta, void* out,
           int M, int N, int K, int split, int smem_bytes, void* stream) {
  if (M < 1 || M > 32 || N < 1 || K < 64 || K % 64 ||
      !(split == 1 || split == 2 || split == 4 || split == 8) ||
      split > K / 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gm = (K / 64 + split - 1) / split;
  if (layout(M, K / 64, split, gm).total != smem_bytes)  // the host plan disagrees
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const TIn*, const uint8_t*, const uint32_t*, TOut*, int, int,
                 int, int, int) = fused_decode_matmul_kernel<TIn, TOut>;
  static int attr_bytes = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem_bytes > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_bytes = smem_bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((N + kTileN - 1) / kTileN * split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TIn*>(x),
      static_cast<const uint8_t*>(codes), static_cast<const uint32_t*>(meta),
      static_cast<TOut*>(out), M, N, K, split, gm);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_decode_matmul(const void* x, const void* codes,
                                   const void* meta, void* out, int M, int N,
                                   int K, int split, int smem_bytes,
                                   int x_bf16, int out_bf16, void* stream) {
  if (x_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, codes, meta, out, M, N, K,
                                                split, smem_bytes, stream);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, codes, meta, out, M, N, K, split,
                                        smem_bytes, stream);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(x, codes, meta, out, M, N, K, split,
                                        smem_bytes, stream);
  return launch<float, float>(x, codes, meta, out, M, N, K, split, smem_bytes,
                              stream);
}
