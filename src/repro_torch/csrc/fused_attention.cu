// fused_decode_attention and fused_paged_decode_attention: Sq=1 flash decode
// straight off the HiF4 KV cache, contiguous or paged.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/fused_attention.py:
//   fused_decode_attention (body _fused_decode_kernel): q (B, H, D) bf16; K
//     and V each codes (B, F/2, S) uint8 + meta (B, G, S) uint32 in the
//     kernel-tile layout (F = Hkv*D, tokens innermost, no bf16 staging
//     tail); length (B,) int32 -> (B, H, D) bf16;
//   fused_paged_decode_attention (body _fused_paged_kernel): the same q and
//     length; per-layer pool leaves codes (NP, F/2, P) + meta (NP, G, P);
//     pages (B, max_pages) int32, tile k of slot b is pool page pages[b, k].
//
// Both kernels run ONE CTA body (decode_body), templated over its tile
// loader: the contiguous loader addresses token columns ki*ck.. of the
// slot's cache, the paged loader reads the page id from the table in device
// memory and addresses that page's columns (ck = P). Same ops in the same
// order, so paged at page size P is bitwise equal to contiguous at
// block_kv = P. Trailing table entries (0, the scratch page) are walked like
// any tile: fully masked, they are exact no-ops (corr = 1, e = 0,
// acc * (l/l) = acc), which keeps the op order the reference's.
//
// What bounds it on the H100: the bytes of the packed cache (4.5 bits/value,
// read once per step); the flops per byte are tiny.
//
// Design: one CTA per (slot, block of hb = lcm(D, 64)/D KV heads, so a head
// block holds whole 64-groups). The KV tiles (or pages) are walked in
// a loop inside the CTA, so the softmax state (m, l) and the normalized
// accumulator live in shared memory across tiles instead of in scratch
// carried between grid steps. Per tile, K and V are dequantized from codes +
// meta to bf16 in shared memory (hif4.dequantize_km: the product is exact);
// consecutive threads take consecutive tokens, so the code and meta loads
// coalesce. K is kept feature-major (a thread scores one token), V
// token-major with a padded row (a thread accumulates one output feature).
// The op order is the reference's: f32 scores from the bf16 q.k, / sqrt(D),
// the length mask to NEG_INF = -1e30, m_new, corr = exp(m_prev - m_new),
// e = exp(s - m_new), l_new, p = (e / l_new) rounded to bf16, pv in f32,
// acc = acc * (l_prev*corr / l_new) + pv; the output is acc cast to bf16.
// Only the order of the f32 sums differs. NaN metadata (E6M2 0xFF) reaches
// the output of its slot as it does in the reference.
#include "hif4_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ float block_reduce(float v, bool is_max, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(HIF4_FULL_MASK, v, o);
    v = is_max ? nan_max(v, other) : v + other;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : (is_max ? -INFINITY : 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float other = __shfl_xor_sync(HIF4_FULL_MASK, v, o);
      v = is_max ? nan_max(v, other) : v + other;
    }
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  v = red[kWarps];
  __syncthreads();
  return v;
}

struct Geometry {
  int hkv, rep, d, ck, hb;
  __host__ __device__ int fb() const { return hb * d; }      // features per head block
  __host__ __device__ int rows() const { return hb * rep; }  // query rows per head block
};

// Where tile ki of (slot b, head block hblk) lives: code row r of the tile,
// token t, is codes[code + r*stride + t]; its meta word is
// meta[meta + (r/32)*stride + t].
struct TileAddr {
  size_t code, meta;
  int stride;
};

// contiguous cache (B, F/2, S): tile ki is token columns [ki*ck, (ki+1)*ck)
struct ContiguousTiles {
  int s;
  __device__ TileAddr operator()(int b, int hblk, int ki, const Geometry& g) const {
    const int F = g.hkv * g.d, G = F / 64;
    const size_t t0 = static_cast<size_t>(ki) * g.ck;
    return {(static_cast<size_t>(b) * (F / 2) + hblk * (g.fb() / 2)) * s + t0,
            (static_cast<size_t>(b) * G + hblk * (g.fb() / 64)) * s + t0, s};
  }
};

// page pool (NP, F/2, P): tile ki is pool page pages[b*max_pages + ki], ck = P
struct PagedTiles {
  const int* __restrict__ pages;
  int max_pages;
  __device__ TileAddr operator()(int b, int hblk, int ki, const Geometry& g) const {
    const int F = g.hkv * g.d, G = F / 64, P = g.ck;
    const size_t pid = static_cast<size_t>(pages[static_cast<size_t>(b) * max_pages + ki]);
    return {(pid * (F / 2) + hblk * (g.fb() / 2)) * P,
            (pid * G + hblk * (g.fb() / 64)) * P, P};
  }
};

__host__ __device__ inline size_t smem_bytes(int rows, int d, int fb, int ck) {
  const int rd = rows * d;
  const int parts = rd >= kThreads ? 1 : kThreads / rd;
  return sizeof(float) * (rd /*q*/ + rows * ck /*p*/ + parts * rd /*pv*/ +
                          rd /*acc*/ + 3 * rows /*m,l,fac*/ + kWarps + 1) +
         sizeof(__nv_bfloat16) * (static_cast<size_t>(fb) * ck /*K*/ +
                                  static_cast<size_t>(ck) * (fb + 2) /*V*/);
}

template <class Tiles>
__device__ void decode_body(const __nv_bfloat16* __restrict__ q,
                            const uint8_t* __restrict__ kc,
                            const uint32_t* __restrict__ km,
                            const uint8_t* __restrict__ vc,
                            const uint32_t* __restrict__ vm,
                            const int* __restrict__ length,
                            __nv_bfloat16* __restrict__ out, const Geometry& geo,
                            float sqrt_d, int n_tiles, const Tiles& tiles) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int hblk = blockIdx.x, b = blockIdx.y;
  const int D = geo.d, rep = geo.rep, ck = geo.ck;
  const int fb = geo.fb(), rows = geo.rows(), rd = rows * D;
  const int parts = rd >= kThreads ? 1 : kThreads / rd;
  const int vstride = fb + 2;  // odd word count per V row

  float* s_q = smem;                       // [rows][D]
  float* s_p = s_q + rd;                   // [rows][ck]
  float* s_pv = s_p + rows * ck;           // [parts][rows*D]
  float* s_acc = s_pv + parts * rd;        // [rows*D]
  float* s_m = s_acc + rd;                 // [rows]
  float* s_l = s_m + rows;                 // [rows]
  float* s_fac = s_l + rows;               // [rows]
  float* s_red = s_fac + rows;             // [kWarps + 1]
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(s_red + kWarps + 1);
  __nv_bfloat16* s_v = s_k + static_cast<size_t>(fb) * ck;  // [ck][vstride]

  const int len = length[b];
  // q rows of this head block: head (hblk*hb + h), repeat r -> row h*rep + r
  const size_t q_base = (static_cast<size_t>(b) * geo.hkv + hblk * geo.hb) * rep * D;
  for (int i = tid; i < rd; i += kThreads) {
    s_q[i] = __bfloat162float(q[q_base + i]);
    s_acc[i] = 0.0f;
  }
  for (int i = tid; i < rows; i += kThreads) {
    s_m[i] = kNegInf;
    s_l[i] = 0.0f;
  }
  __syncthreads();

  for (int ki = 0; ki < n_tiles; ++ki) {
    const int t0 = ki * ck;
    const TileAddr at = tiles(b, hblk, ki, geo);
    // dequantize the K and V tiles into shared memory
    for (int i = tid; i < (fb / 2) * ck; i += kThreads) {
      const int r = i / ck, t = i % ck;  // code row r holds features 2r, 2r+1
      const size_t ci = at.code + static_cast<size_t>(r) * at.stride + t;
      const size_t mi = at.meta + static_cast<size_t>(r / 32) * at.stride + t;
      const int e = 2 * (r % 32);        // element index inside the 64-group
      const uint32_t kw = km[mi], vw = vm[mi];
      const uint32_t kb = kc[ci], vb = vc[ci];
      const float ks = meta_scale(kw), vs = meta_scale(vw);
      s_k[static_cast<size_t>(2 * r) * ck + t] =
          __float2bfloat16_rn(ks * static_cast<float>(absorbed_int(kb & 0xFu, kw, e)));
      s_k[static_cast<size_t>(2 * r + 1) * ck + t] =
          __float2bfloat16_rn(ks * static_cast<float>(absorbed_int(kb >> 4, kw, e + 1)));
      __nv_bfloat162 v2;
      v2.x = __float2bfloat16_rn(vs * static_cast<float>(absorbed_int(vb & 0xFu, vw, e)));
      v2.y = __float2bfloat16_rn(vs * static_cast<float>(absorbed_int(vb >> 4, vw, e + 1)));
      *reinterpret_cast<__nv_bfloat162*>(s_v + static_cast<size_t>(t) * vstride + 2 * r) = v2;
    }
    __syncthreads();

    // masked f32 scores, one token per thread
    for (int t = tid; t < ck; t += kThreads) {
      const bool valid = t0 + t < len;
      for (int row = 0; row < rows; ++row) {
        const int h = row / rep;
        const float* qr = s_q + row * D;
        const __nv_bfloat16* kcol = s_k + static_cast<size_t>(h * D) * ck + t;
        float acc = 0.0f;
        for (int d = 0; d < D; ++d)
          acc = fmaf(qr[d], __bfloat162float(kcol[static_cast<size_t>(d) * ck]), acc);
        s_p[row * ck + t] = valid ? acc / sqrt_d : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, normalized at every tile
    for (int row = 0; row < rows; ++row) {
      float* p = s_p + row * ck;
      float mx = -INFINITY;
      for (int t = tid; t < ck; t += kThreads) mx = nan_max(mx, p[t]);
      mx = block_reduce(mx, true, s_red);
      const float m_prev = s_m[row], l_prev = s_l[row];
      const float m_new = nan_max(m_prev, mx);
      float sum = 0.0f;
      for (int t = tid; t < ck; t += kThreads) {
        const float e = expf(p[t] - m_new);
        p[t] = e;
        sum += e;
      }
      sum = block_reduce(sum, false, s_red);
      const float corr = expf(m_prev - m_new);
      const float l_new = l_prev * corr + sum;
      for (int t = tid; t < ck; t += kThreads) p[t] = rbf(p[t] / l_new);
      if (tid == 0) {
        s_m[row] = m_new;
        s_l[row] = l_new;
        s_fac[row] = l_prev * corr / l_new;
      }
    }
    __syncthreads();

    // pv = p @ V in f32; tokens split over `parts` thread groups
    if (parts > 1 ? tid < parts * rd : true) {
      const int part = parts > 1 ? tid / rd : 0;
      for (int o = parts > 1 ? tid % rd : tid; o < rd; o += parts > 1 ? rd : kThreads) {
        const int row = o / D, d = o % D, h = row / rep;
        const float* p = s_p + row * ck;
        const __nv_bfloat16* vcol = s_v + h * D + d;
        float acc = 0.0f;
        for (int t = part; t < ck; t += parts)
          acc = fmaf(p[t], __bfloat162float(vcol[static_cast<size_t>(t) * vstride]), acc);
        s_pv[part * rd + o] = acc;
      }
    }
    __syncthreads();
    for (int o = tid; o < rd; o += kThreads) {
      float pv = 0.0f;
      for (int part = 0; part < parts; ++part) pv += s_pv[part * rd + o];
      s_acc[o] = s_acc[o] * s_fac[o / D] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < rd; i += kThreads)
    out[q_base + i] = __float2bfloat16_rn(s_acc[i]);
}

__global__ void __launch_bounds__(kThreads)
    fused_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                  const uint8_t* __restrict__ kc,
                                  const uint32_t* __restrict__ km,
                                  const uint8_t* __restrict__ vc,
                                  const uint32_t* __restrict__ vm,
                                  const int* __restrict__ length,
                                  __nv_bfloat16* __restrict__ out, Geometry geo,
                                  float sqrt_d, int s) {
  decode_body(q, kc, km, vc, vm, length, out, geo, sqrt_d, s / geo.ck,
              ContiguousTiles{s});
}

__global__ void __launch_bounds__(kThreads)
    fused_paged_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                        const uint8_t* __restrict__ kc,
                                        const uint32_t* __restrict__ km,
                                        const uint8_t* __restrict__ vc,
                                        const uint32_t* __restrict__ vm,
                                        const int* __restrict__ pages,
                                        const int* __restrict__ length,
                                        __nv_bfloat16* __restrict__ out,
                                        Geometry geo, float sqrt_d,
                                        int max_pages) {
  decode_body(q, kc, km, vc, vm, length, out, geo, sqrt_d, max_pages,
              PagedTiles{pages, max_pages});
}

template <class Kernel, class... Args>
int launch(Kernel kernel, const Geometry& geo, int B, void* stream, Args... args) {
  const size_t smem = smem_bytes(geo.rows(), geo.d, geo.fb(), geo.ck);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(geo.hkv / geo.hb, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long fused_decode_attention_smem(int rows, int d, int fb,
                                                 int ck) {
  return static_cast<long long>(smem_bytes(rows, d, fb, ck));
}

extern "C" int fused_decode_attention(const void* q, const void* kc,
                                      const void* km, const void* vc,
                                      const void* vm, const void* length,
                                      void* out, int B, int hkv, int rep,
                                      int d, int s, int ck, int hb,
                                      float sqrt_d, void* stream) {
  const Geometry geo{hkv, rep, d, ck, hb};
  return launch(fused_decode_attention_kernel, geo, B, stream,
                static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kc),
                static_cast<const uint32_t*>(km), static_cast<const uint8_t*>(vc),
                static_cast<const uint32_t*>(vm), static_cast<const int*>(length),
                static_cast<__nv_bfloat16*>(out), geo, sqrt_d, s);
}

extern "C" int fused_paged_decode_attention(const void* q, const void* kc,
                                            const void* km, const void* vc,
                                            const void* vm, const void* pages,
                                            const void* length, void* out,
                                            int B, int hkv, int rep, int d,
                                            int page_tokens, int max_pages,
                                            int hb, float sqrt_d, void* stream) {
  const Geometry geo{hkv, rep, d, page_tokens, hb};
  return launch(fused_paged_decode_attention_kernel, geo, B, stream,
                static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kc),
                static_cast<const uint32_t*>(km), static_cast<const uint8_t*>(vc),
                static_cast<const uint32_t*>(vm), static_cast<const int*>(pages),
                static_cast<const int*>(length), static_cast<__nv_bfloat16*>(out),
                geo, sqrt_d, max_pages);
}
