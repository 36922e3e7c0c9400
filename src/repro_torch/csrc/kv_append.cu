// kv_append: the per-token HiF4 KV-cache append, K and V of one layer in one
// launch (Algorithm 1 and the bit packing of docs/FORMATS.md's packed KV
// cache, then the token's bytes written into the cache in place).
//
// Replaces no TPU kernel: the reference runs repro/core/kvcache.py's
// append_token and append_token_paged under jit, where XLA fuses Algorithm 1,
// the packing and the indexed writes into a few fusions. Eager PyTorch runs
// them as about a hundred dispatched ops per tensor (the plain versions,
// core/kvcache.py::append_token_plain / append_token_paged_plain), and a
// decode step was bound by that dispatch. This kernel is the port's
// counterpart of XLA's fusion and adds no feature the reference lacks.
//
// What bounds it on the H100: a launch's latency. At qwen1.5-0.5b's decode
// shape (B 8, Hkv 16, Dh 64) it reads 2 x 8 x 1 024 bf16 values and writes
// 2 x 8 x 16 x 36 bytes, about 42 KB, some 13 ns at 3.35 TB/s.
//
// Design: kernel 1's layout, 8 lanes per 64-group (each lane one E1_8 block
// of 8 elements), 16 groups a block of 128 threads. The group's arithmetic is
// hif4_group_max and hif4_group_scale, the pieces kernels 1, 2 and 5 run, and
// the packing epilogue hif4_pack_block (hif4_common.cuh), so the bytes are
// the plain version's bit for bit, NaN and Inf groups included. The blocks
// after the groups' copy the F % 64 tail features as bf16. Every leaf is
// addressed through (row, feature, token) element strides: one body writes
// the kernel-tile layout (B, R, S), the artifact layout (B, S, ...) and the
// paged pool's per-layer view (NP, R, P). Positions (int64) and page ids
// (int32 or int64) are read on the device, so the host never waits:
// contiguous, slot b writes row b at column min(pos_b, S - 1); paged, page
// pages[b, min(pos_b / P, max_pages - 1)] at column pos_b % P. Page ids are
// not checked, as kernel 4 reads them: an id outside the pool writes outside
// it. Positions are >= 0. Slots that write the same column (retired slots
// in the scratch page 0) race; which bytes land there is undefined, as in
// the plain version's indexed write.
#include "hif4_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroupsPerBlock = kThreads / 8;

}  // namespace

// One packed tensor (K or V) of the cache and its new token rows; mirrored
// field for field by kernels/kv_append.py::KvLeaf.
struct KvLeaf {
  const void* x;        // (B, F) new token rows, bf16 or f32
  long long x_row;      // elements between batch rows of x
  uint8_t* codes;       // (row, G * 32, token) bytes
  int32_t* meta;        // (row, G, token) words (uint32 bits)
  __nv_bfloat16* tail;  // (row, T, token)
  long long codes_st[3], meta_st[3], tail_st[3];  // element strides
};

// Mirrored by kernels/kv_append.py::KvAppendArgs.
struct KvAppendArgs {
  KvLeaf leaf[2];
  const long long* pos;  // (B,) slot positions
  long long pos_st;
  const void* pages;     // (B, max_pages) page table; null: contiguous cache
  long long pages_row;   // elements between table rows
  int pages_64;          // the table holds int64 ids (else int32)
  int max_pages, page_tokens;
  int capacity;          // contiguous: token slots S
  int batch, groups, tail, n_leaves;
  int x_f32;             // the new rows are f32 (else bf16)
};

namespace {

// (row, token column) slot b writes
__device__ __forceinline__ void slot_of(const KvAppendArgs& a, int b,
                                        long long& row, long long& col) {
  const long long pos = a.pos[b * a.pos_st];
  if (a.pages != nullptr) {
    const long long idx =
        min(pos / a.page_tokens, static_cast<long long>(a.max_pages - 1));
    const long long e = b * a.pages_row + idx;
    row = a.pages_64 ? static_cast<const long long*>(a.pages)[e]
                     : static_cast<long long>(static_cast<const int*>(a.pages)[e]);
    col = pos % a.page_tokens;
  } else {
    row = b;
    col = min(pos, static_cast<long long>(a.capacity - 1));
  }
}

// element i of a row as the plain version sees it: bf16, or f32 rounded to
// bf16 (quantize_kv casts the rows to bf16 first)
template <typename T>
__device__ __forceinline__ float element(const T* p, long long i);

template <>
__device__ __forceinline__ float element(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <>
__device__ __forceinline__ float element(const float* p, long long i) {
  return rbf(p[i]);
}

// a tail feature as the plain version stores it: bf16 rows keep their bits
// (a NaN's payload too), f32 rows round as PyTorch's cast does on the card
__device__ __forceinline__ __nv_bfloat16 tail_value(__nv_bfloat16 v) {
  return v;
}

__device__ __forceinline__ __nv_bfloat16 tail_value(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    kv_append_kernel(const KvAppendArgs a, int group_blocks) {
  if (static_cast<int>(blockIdx.x) >= group_blocks) {
    // the bf16 tail features, one thread each
    const long long i =
        static_cast<long long>(blockIdx.x - group_blocks) * kThreads +
        threadIdx.x;
    if (i >= static_cast<long long>(a.n_leaves) * a.batch * a.tail) return;
    const int j = static_cast<int>(i % a.tail);
    const int b = static_cast<int>(i / a.tail % a.batch);
    const KvLeaf& L = a.leaf[i / a.tail / a.batch];
    long long row, col;
    slot_of(a, b, row, col);
    const T* x = static_cast<const T*>(L.x) + b * L.x_row +
                 static_cast<long long>(a.groups) * 64;
    L.tail[row * L.tail_st[0] + j * L.tail_st[1] + col * L.tail_st[2]] =
        tail_value(x[j]);
    return;
  }
  const long long n_groups = static_cast<long long>(a.n_leaves) * a.batch *
                             a.groups;
  const long long gi =
      static_cast<long long>(blockIdx.x) * kGroupsPerBlock + threadIdx.x / 8;
  if (gi - threadIdx.x % 32 / 8 >= n_groups) return;  // the whole warp
  const int blk = threadIdx.x % 8;                     // E1_8 block
  const bool live = gi < n_groups;
  const int g = live ? static_cast<int>(gi % a.groups) : 0;
  const int b = live ? static_cast<int>(gi / a.groups % a.batch) : 0;
  const KvLeaf& L = a.leaf[live ? gi / a.groups / a.batch : 0];
  float v[8];
  const T* x = static_cast<const T*>(L.x) + b * L.x_row + g * 64 + 8 * blk;
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = live ? element(x, i) : 0.0f;
  const Hif4Max m = hif4_group_max(v);
  float e6m2, rec;
  hif4_group_scale(m.vmax, e6m2, rec);
  const Hif4PackedBlock p = hif4_pack_block(v, m, e6m2, rec, blk);
  if (!live) return;
  long long row, col;
  slot_of(a, b, row, col);
  uint8_t* c = L.codes + row * L.codes_st[0] +
               static_cast<long long>(g * 32 + 4 * blk) * L.codes_st[1] +
               col * L.codes_st[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[i * L.codes_st[1]] = static_cast<uint8_t>(p.codes >> (8 * i));
  if (blk == 0)
    L.meta[row * L.meta_st[0] + g * L.meta_st[1] + col * L.meta_st[2]] =
        static_cast<int32_t>(p.meta);
}

}  // namespace

extern "C" int kv_append(const KvAppendArgs* args, void* stream) {
  const KvAppendArgs& a = *args;
  const long long n_groups = static_cast<long long>(a.n_leaves) * a.batch *
                             a.groups;
  const long long n_tail = static_cast<long long>(a.n_leaves) * a.batch * a.tail;
  const long long group_blocks =
      (n_groups + kGroupsPerBlock - 1) / kGroupsPerBlock;
  const long long blocks = group_blocks + (n_tail + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.x_f32)
    kv_append_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a, static_cast<int>(group_blocks));
  else
    kv_append_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            a, static_cast<int>(group_blocks));
  return static_cast<int>(cudaGetLastError());
}
