// hif4_quantize: BF16/F32 -> HiF4 absorbed-shift ints (paper Algorithm 1).
//
// Replaces the TPU Pallas kernel src/repro/kernels/hif4_quant.py::hif4_quantize
// (body _quant_kernel). x (M, K) -> ints (M, K) int8 = S1P2 quarters shifted
// left by E1_8 + E1_16 (|q| <= 28), scales (M, K/64) f32 = E6M2 / 4.
//
// What bounds it on the H100: memory. It reads 2 B (bf16) and writes
// 1 B + 4/64 B per value with a few dozen flops each, far below the card's
// ops-per-byte balance; at decode shapes (M = batch) it is launch-bound.
//
// Design: 8 lanes per 64-group (each lane one E1_8 block of 8 elements, 4
// groups per warp), so a lane reads 16 bytes (bf16) and writes 8, and a warp
// reads 512 contiguous bytes. The group's arithmetic is hif4_quantize_group
// (hif4_common.cuh), which the decode form of kernel 2
// (fused_decode_matmul.cu) runs as its prologue and whose pieces the decode
// form of kernel 5 (bfp_decode_matmul.cu) runs in its loader: here the
// per-group metadata is computed redundantly by the group's 8 lanes (no
// shared memory, no barrier), and the output is bitwise the reference's. An input that is not
// 16-byte aligned takes element loads instead of vector loads.
#include "hif4_common.cuh"

namespace {

constexpr int kThreads = 256;  // 32 groups per block

__device__ __forceinline__ float to_float(__nv_bfloat16 h) {
  return __bfloat162float(h);
}

__device__ __forceinline__ float to_float(float f) { return f; }

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    hif4_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ ints,
                         float* __restrict__ scales, long long n_groups) {
  const long long grp = static_cast<long long>(blockIdx.x) * (kThreads / 8) +
                        threadIdx.x / 8;
  if (grp - threadIdx.x % 32 / 8 >= n_groups) return;  // the whole warp
  const int blk = threadIdx.x % 8;                     // E1_8 block
  const bool live = grp < n_groups;
  const T* p = x + grp * 64 + 8 * blk;
  float v[8];
  if (!live) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.0f;
  } else if (kVec) {
    load8(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = to_float(p[i]);
  }
  float scale;
  const uint2 out = hif4_quantize_group(v, scale);
  if (!live) return;
  *reinterpret_cast<uint2*>(ints + grp * 64 + 8 * blk) = out;
  if (blk == 0) scales[grp] = scale;
}

template <typename T>
int launch(const void* x, void* ints, void* scales, long long n_groups,
           void* stream) {
  if (n_groups <= 0) return 0;
  const long long blocks = (n_groups + kThreads / 8 - 1) / (kThreads / 8);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0)
    hif4_quantize_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                    s>>>(xt, static_cast<int8_t*>(ints),
                                         static_cast<float*>(scales), n_groups);
  else
    hif4_quantize_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads,
                                     0, s>>>(xt, static_cast<int8_t*>(ints),
                                             static_cast<float*>(scales),
                                             n_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hif4_quantize_bf16(const void* x, void* ints, void* scales,
                                  long long n_groups, void* stream) {
  return launch<__nv_bfloat16>(x, ints, scales, n_groups, stream);
}

extern "C" int hif4_quantize_f32(const void* x, void* ints, void* scales,
                                 long long n_groups, void* stream) {
  return launch<float>(x, ints, scales, n_groups, stream);
}
