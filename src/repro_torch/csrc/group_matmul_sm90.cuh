// Regime 1 (M > 32 rows: prefill) of the group-scaled int8 matmul shared by
// kernel 2 (fused_packed_matmul, fused_matmul.cu) and kernel 5
// (bfp_matmul_quantized, bfp_matmul.cu), on Hopper's int8 tensor cores.
//
//   out (M, N) = cast(sum over 64-groups g, in group order from 0.0f, of
//       (float(int32 dot_g(a[m], b[:, n])) * a_scale[m, g]) * b_scale[g, n])
//
// the same order per output as the regime-0 body (group_matmul.cuh) and the
// plain version (kernels/bfp_matmul.py), so every output is bitwise theirs.
//
// What bounds it on the H100: not the tensor cores. At M=3840, K=1024,
// N=2816 the int8 products are 22 G operations (0.011 ms at 1 979 TOP/s)
// and the bytes 0.015 ms, but every (row, column, group) needs its own f32
// promotion: convert, two multiplies, one add, each rounded: 173 M
// promotions, 0.02-0.03 ms of CUDA-core instructions on 132 SMs. Kernel 2
// also expands its 4.5-bit codes to int8 once per CTA and group.
//
// * One CTA of 384 threads per 128 x 128 output tile walks the K axis one
//   64-group at a time. Warpgroups 0 and 1 consume (64 rows each, one
//   m64n128 fragment), warpgroup 2 produces; setmaxnreg gives the consumers
//   200 registers and the producers 104.
// * Products: wgmma.mma_async m64n128k32 s8 x s8 -> s32, both operands
//   K-major from shared memory in the 64-byte swizzle (64 int8 per row or
//   column: one group). A group is two k32 steps into a FRESH int32
//   fragment (the first with scale-d = 0), so each group's dot is exact in
//   int32 (|q| <= 28, |dot| <= 64 * 28 * 28 = 50 176).
// * Promotion in group order, once the group's products are done:
//   acc = acc + (float(dot) * a_scale) * b_scale with __fmul_rn /
//   __fadd_rn (no contracted multiply-add); float(dot) is __int2float_rn,
//   exact as |dot| < 2^24.
// * A ring of kStages stages, each one group: the A tile (128 x 64 int8),
//   the B tile (128 x 64 int8, K contiguous per column), their scales, and
//   the loader's raw bytes. The producers keep kLookahead groups of
//   cp.async copies in flight (16-byte pieces, zero-filled past the M and N
//   edges); when a group has landed they finish its B tile (kernel 2
//   expands its codes and meta words here, the Loader's expand; kernel 5's
//   int8 columns arrive as they are), fence the shared writes for the async
//   proxy and arrive on the stage's full mbarrier. Consumers wait on it, and
//   arrive on the stage's empty mbarrier when its products and scales are
//   used up.
// * The epilogue rounds to the caller's dtype (__float2bfloat16_rn is
//   PyTorch's .to(bfloat16) of the f32 value) and writes pairs of columns.
//
// Each warpgroup runs a group's products, then its promotion; the products
// of the next group do not overlap it. Variants that tried to overlap them
// (two fragment sets, turns between warpgroups, four warpgroups, 256 x 64
// tiles, the expansion moved to the consumers) measured no faster on the
// H100 (PERF.md §6); that overlap is the way to the promotion's floor.
//
// A NaN scale reaches exactly the outputs of its row or column (no group is
// skipped); an E6M2 0xFF meta word gives NaN in its column only. The launch
// plan (tiles, stages, lookahead, shared bytes) is mirrored by
// kernels/bfp_matmul.py::prefill_plan, and the launcher refuses a plan
// that differs from its own in any field.
#pragma once

#include "hif4_common.cuh"

namespace sm90 {

constexpr int kTileM = 128;          // rows per CTA: two consumer warpgroups
constexpr int kTileN = 128;          // columns per CTA: one m64n128 fragment
constexpr int kStages = 6;           // ring stages, one 64-group each
constexpr int kLookahead = 4;        // groups of copies in flight (<= stages - 2)
constexpr int kConsumers = 256;
constexpr int kThreads = 384;
constexpr int kConsumerRegs = 200;   // 2 x 128 x 200 + 128 x 104 = 64 512
constexpr int kProducerRegs = 104;

// one stage: A tile, B tile (64 B per row, swizzled), a and b scales, then
// the loader's raw bytes; stages 1024-byte aligned (the swizzle repeats
// every 512 B and is taken from the address bits)
constexpr int kAOff = 0;
constexpr int kBOff = kAOff + kTileM * 64;
constexpr int kAsOff = kBOff + kTileN * 64;
constexpr int kBsOff = kAsOff + kTileM * 4;
constexpr int kRawOff = kBsOff + kTileN * 4;

__host__ __device__ constexpr int stage_bytes(int raw) {
  return (kRawOff + raw + 1023) / 1024 * 1024;
}
// + 1024 to align the dynamic base, + the full and empty mbarriers
__host__ __device__ constexpr int smem_bytes(int raw) {
  return 1024 + kStages * stage_bytes(raw) + (2 * kStages * 8 + 127) / 128 * 128;
}

// byte of (row, 16-byte chunk) in a tile of 64-byte rows under the 64-byte
// swizzle: chunk bits [4, 6) xor address bits [7, 9)
__device__ __forceinline__ int sw64(int row, int chunk) {
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global memory, zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy shared writes (cp.async, st.shared) made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a K-major tile of 64-byte rows, 64-byte swizzle: 8-row
// core groups 512 B apart (SBO), the leading offset unused (1)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads of a fragment across a wait
__device__ __forceinline__ void fence_frag(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 s32 over the warpgroup) = (scale_d ? d : 0) + A (64 x 32 s8)
// x B (32 x 128 s8), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// columns n, n+1 of an output row, those below N; one paired store when N
// is even (n is, so n < N means n + 1 < N)
template <typename TOut>
__device__ __forceinline__ void store_cols(TOut* row, int n, int N, bool pairs,
                                           float x, float y) {
  if (pairs) {
    if (n < N) store2(row + n, x, y);
  } else {
    if (n < N) store1(row + n, x);
    if (n + 1 < N) store1(row + n + 1, y);
  }
}

// the A tile (rows m0.., group g) and its scales into a stage, by the 128
// producer threads: 16-byte pieces, rows past M zero
__device__ __forceinline__ void stage_a(uint8_t* st, const int8_t* a,
                                        const float* a_scales, int m0, int g,
                                        int M, int K, int t) {
  const int G = K / 64;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = t + 128 * j, r = i >> 2, ch = i & 3, m = m0 + r;
    cp_async16(st + kAOff + sw64(r, ch),
               a + static_cast<size_t>(min(m, M - 1)) * K + g * 64 + ch * 16,
               m < M ? 16 : 0);
  }
  const int m = m0 + t;
  cp_async4(st + kAsOff + 4 * t,
            a_scales + static_cast<size_t>(min(m, M - 1)) * G + g,
            m < M ? 4 : 0);
}

template <class Loader>
__device__ __forceinline__ void stage_group(uint8_t* st, const Loader& b,
                                            const int8_t* a,
                                            const float* a_scales, int m0,
                                            int n0, int g, int M, int N, int K,
                                            int t) {
  stage_a(st, a, a_scales, m0, g, M, K, t);
  b.issue(st + kRawOff, st + kBOff, reinterpret_cast<float*>(st + kBsOff), n0,
          g, N, K, t);
}

// (float(dot) * a_scale) * b_scale added to acc in group order; the
// fragment's d[4j + {0,1,2,3}] are (row r0, col c), (r0, c+1), (r0+8, c),
// (r0+8, c+1) with c = 8j + cq
__device__ __forceinline__ void promote(float (&acc)[64], const int (&d)[64],
                                        const uint8_t* st, int r0, int cq) {
  const float* as = reinterpret_cast<const float*>(st + kAsOff);
  const float* bs = reinterpret_cast<const float*>(st + kBsOff);
  const float a0 = as[r0], a1 = as[r0 + 8];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * j + cq);
    acc[4 * j] = __fadd_rn(
        acc[4 * j], __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j]), a0), bb.x));
    acc[4 * j + 1] = __fadd_rn(
        acc[4 * j + 1],
        __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 1]), a0), bb.y));
    acc[4 * j + 2] = __fadd_rn(
        acc[4 * j + 2],
        __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 2]), a1), bb.x));
    acc[4 * j + 3] = __fadd_rn(
        acc[4 * j + 3],
        __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 3]), a1), bb.y));
  }
}

// both k32 steps of group g into d (fresh: scale-d 0 on the first), once
// the stage is full
__device__ __forceinline__ void issue_group(int (&d)[64], uint8_t* smem,
                                            int stage_stride, uint64_t* full,
                                            int g, int wg) {
  const int s = g % kStages;
  mbar_wait(&full[s], (g / kStages) & 1);
  __syncwarp();                        // wgmma is .aligned: converge first
  const uint8_t* st = smem + s * stage_stride;
  const uint32_t sa = smem_u32(st + kAOff + wg * 64 * 64);
  const uint32_t sb = smem_u32(st + kBOff);
  wgmma_fence();
  wgmma_s8_n128(d, desc_sw64(sa), desc_sw64(sb), 0);
  wgmma_s8_n128(d, desc_sw64(sa + 32), desc_sw64(sb + 32), 1);
  wgmma_commit();
}

__device__ __forceinline__ void release(uint64_t* empty, int g, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[g % kStages]);
}

template <class Loader, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
    group_matmul_sm90_kernel(const Loader b, const int8_t* __restrict__ a,
                             const float* __restrict__ a_scales,
                             TOut* __restrict__ out, int M, int N, int K) {
  constexpr int kStage = stage_bytes(Loader::kRawBytes);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int G = K / 64;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);        // every producer thread
      mbar_init(&empty[s], kConsumers / 32);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producers: copies kLookahead groups ahead, then finish B tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int t = tid - kConsumers;
    for (int g = 0; g < kLookahead; ++g) {
      if (g < G)
        stage_group(smem + g * kStage, b, a, a_scales, m0, n0, g, M, N, K, t);
      cp_async_commit();
    }
    for (int g = 0; g < G; ++g) {
      const int gn = g + kLookahead;
      if (gn < G) {
        const int s = gn % kStages;
        if (gn >= kStages) mbar_wait(&empty[s], (gn / kStages - 1) & 1);
        stage_group(smem + s * kStage, b, a, a_scales, m0, n0, gn, M, N, K, t);
      }
      cp_async_commit();
      cp_async_wait<kLookahead>();     // this thread's copies of group g
      uint8_t* st = smem + (g % kStages) * kStage;
      if constexpr (Loader::kExpands) {
        asm volatile("bar.sync 1, 128;\n" ::: "memory");   // everyone's
        b.expand(st + kRawOff, st + kBOff,
                 reinterpret_cast<float*>(st + kBsOff), t);
      }
      fence_proxy_async();
      mbar_arrive(&full[g % kStages]);
    }
  } else {
    // ---- consumers: a group's products, then its promotion in order
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = tid >> 7, lane = tid & 31;
    const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
    float acc[64];
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.0f;
      d[i] = 0;
    }
    for (int g = 0; g < G; ++g) {
      issue_group(d, smem, kStage, full, g, wg);
      wgmma_wait<0>();
      fence_frag(d);
      promote(acc, d, smem + (g % kStages) * kStage, r0, cq);
      release(empty, g, lane);
    }
    const bool pairs = (N & 1) == 0;   // column pairs stay 8-byte aligned
    const int m = m0 + r0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + cq;
      if (m < M)
        store_cols(out + static_cast<size_t>(m) * N, n, N, pairs, acc[4 * j],
                   acc[4 * j + 1]);
      if (m + 8 < M)
        store_cols(out + static_cast<size_t>(m + 8) * N, n, N, pairs,
                   acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// Regime 1's launch: a (ceil(N/128), ceil(M/128)) grid of 384 threads.
// plan is the host's launch plan (kernels/bfp_matmul.py::prefill_plan),
// kPlanFields ints: tile_m, tile_n, stages, lookahead, stage_bytes,
// smem_bytes; a plan that differs from this body's constants for the loader
// is refused. The shared-memory attribute is set on every launch (it is
// per device, and cheap).
constexpr int kPlanFields = 6;

template <class Loader, typename TOut>
int launch(const Loader& b, const void* a, const void* a_scales, void* out,
           int M, int N, int K, const int* plan, void* stream) {
  constexpr int kSmem = sm90::smem_bytes(Loader::kRawBytes);
  const int want[kPlanFields] = {kTileM, kTileN, kStages, kLookahead,
                                 sm90::stage_bytes(Loader::kRawBytes), kSmem};
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < kPlanFields; ++i)
    if (plan[i] != want[i]) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const Loader, const int8_t*, const float*, TOut*, int, int,
                 int) = group_matmul_sm90_kernel<Loader, TOut>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      b, static_cast<const int8_t*>(a), static_cast<const float*>(a_scales),
      static_cast<TOut*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
