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
// block_kv = P.
//
// What bounds it on the H100: the bytes of the packed cache (4.5 bits/value,
// read once per step; 4.6 MB at batch 8, 16 KV heads, 512 tokens: 1.4 us at
// 3.35 TB/s); the flops per byte are tiny. So the design is about latency:
// every load in flight at once, then short parallel steps.
//
// Design: one CTA of 512 threads per (slot, block of hb = lcm(D, 64)/D KV
// heads, so a head block holds whole 64-groups). The reference's recurrence
// over KV tiles k of ck tokens,
//   m_k = nan_max(m_{k-1}, max_t s_kt)     corr_k = exp(m_{k-1} - m_k)
//   e_kt = exp(s_kt - m_k)                 l_k = l_{k-1}*corr_k + sum_t e_kt
//   p_kt = bf16(e_kt / l_k)                fac_k = l_{k-1}*corr_k / l_k
//   acc_k = acc_{k-1}*fac_k + p_k.V_k,
// is sequential only in acc and the scalars m, l. So the CTA stages a wave of
// tiles at once and runs each step over all of the wave's tiles in parallel:
// 1. staging: every packed byte of the wave (K and V codes and meta words) is
//    copied into shared memory with cp.async, all issued up front (code rows
//    padded by 4 bytes, so 32 code rows sit in 32 banks; rows that are not
//    word-aligned by aligned 32-bit loads, realigned by a funnel shift and
//    8 in flight a thread). A cache longer
//    than one wave runs a ring of two stages: the next wave's copies fly
//    while this one computes.
// 2. scores, on the quad path (heads of 16, 32, ..., 512 features; a tile
//    of ck % 4 != 0 tokens padded to a multiple of 4 with absent tokens,
//    score -inf and V scale 0, so they weigh nothing): a thread per (tile,
//    head, 4 tokens, 16 features) dequantizes its K slice from 32-bit code
//    words (offset binary, one fused multiply-add per element, exact) and
//    dots it with the head's query rows; the D/16 slices (adjacent lanes)
//    are added by an xor tree. It stores the V scale of each of its blocks
//    of 4 features for p.V, and the tile max through a shared atomicMax
//    (exact in any order). Other heads (D = 40, 80, 96, 192, ...) take a
//    thread per (tile, token, head).
// 3. softmax: a thread per (tile, row, token) folds the prefix max over the
//    wave's tiles in tile order and takes e, where ck % 32 == 0 summing each
//    warp's 32 tokens by an xor tree (else a warp per (tile, row) sums
//    afterwards); a thread per (tile, row, token) folds the l chain in tile
//    order (l_step) and takes p. The scalar chain is recomputed where it is
//    needed, by the same inline code.
// 4. p.V: a thread per (tile, part of 32 tokens, code row) sums its part,
//    on the quad path in 4 chains (token t to chain t % 4); each tile's parts
//    are added in part order, and a thread per (row, feature) folds the
//    tiles in tile order: acc = acc*fac_k + pv_k.
// Every reduction inside a tile is laid out by ck and D alone, never by the
// tile count, the wave split or the kernel, so kernel 4 at page size P is
// bitwise kernel 3 at block_kv = P whatever their table and capacity
// (kernels/fused_attention.py::tile_layout states the layout).
//
// Every tile is walked, those wholly past the length too (the trailing
// scratch entries of a page table, a solo serve's unused capacity), as in
// the reference: there e = 0, corr = 1, fac = 1, and such a tile changes
// nothing but through 0 * NaN (a V meta word with E6M2 code 0xFF puts NaN
// into every feature of its 64-group), which the walk keeps by itself.
// Skipping such tiles, reading only their V meta words for that rule, was
// timed against this walk on an H100 and lost at 512 tokens. Page table
// entries are read as before: every entry, unchecked.
//
// The launch constants (geometry, plan, shared-memory layout) are one
// __grid_constant__ parameter read in place, and the kernels are templated on
// the query rows a thread accumulates (1, 2 or 4), so that each keeps its
// own registers. No --use_fast_math; the recurrence's multiplies, adds and
// divisions are __fmul_rn / __fadd_rn / __fdiv_rn (no contraction), expf is
// the accurate one. The f32 order inside a dot product and inside a tile's
// sums is all that differs from the plain version. NaN metadata (E6M2 0xFF)
// reaches the output of its slot as it does in the reference.
#include "hif4_common.cuh"

// Phase clock for tools/torch_decode_attention.py: built only with
// -DREPRO_ATTN_TRACE. Thread 0 of each CTA reads the global timer after a
// block barrier at each phase boundary and adds the time since the last
// boundary to that phase's total (phases recur per wave); slot 0 of a CTA's
// record is its start, slots 1..kTracePhases the totals, the last slot its
// end.
#ifdef REPRO_ATTN_TRACE
constexpr int kTracePhases = 7;
constexpr int kTraceSlots = kTracePhases + 2;
constexpr int kTraceCtas = 4096;
__device__ unsigned long long repro_attn_trace[kTraceCtas * kTraceSlots];
struct PhaseClock {
  unsigned long long start, last, total[kTracePhases];
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ PhaseClock() {
    __syncthreads();
    start = last = now();
    for (int i = 0; i < kTracePhases; ++i) total[i] = 0;
  }
  __device__ void mark(int phase) {
    __syncthreads();
    const unsigned long long t = now();
    total[phase] += t - last;
    last = t;
  }
  __device__ void finish() {
    __syncthreads();
    const unsigned cta = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0 && cta < kTraceCtas) {
      unsigned long long* rec = repro_attn_trace + cta * kTraceSlots;
      rec[0] = start;
      for (int i = 0; i < kTracePhases; ++i) rec[1 + i] = total[i];
      rec[kTraceSlots - 1] = now();
    }
  }
};
extern "C" int repro_attn_trace_read(void* host, int ctas) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, repro_attn_trace,
      static_cast<size_t>(ctas) * kTraceSlots * sizeof(unsigned long long)));
}
extern "C" int repro_attn_trace_slots() { return kTraceSlots; }
#else
struct PhaseClock {
  __device__ void mark(int) {}
  __device__ void finish() {}
};
#endif

// Phases of the trace (PhaseClock totals), in the order of the tool's table.
enum Phase { kSetup, kLoadsIssued, kStaged, kScores, kSoftmax, kPv, kOrderedSum };

// the dynamic shared memory of a CTA (Layout below)
extern __shared__ __align__(16) unsigned char attn_smem[];

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kPartTokens = 32;   // tokens per p.V partial sum of a tile
constexpr int kRowsPerPass = 4;   // query rows a thread accumulates at once
constexpr int kWordBatch = 8;     // code words in flight a thread (ck % 4 != 0)

struct Geometry {
  int hkv, rep, d, ck, hb;
  __host__ __device__ int fb() const { return hb * d; }      // features per head block
  __host__ __device__ int rows() const { return hb * rep; }  // query rows per head block
  __host__ __device__ int groups() const { return fb() / 64; }
};

// Where tile ki of (slot b, head block hblk) lives: code row r of the tile,
// token t, is codes[code + r*stride + t]; the meta word of group g is
// meta[meta + g*stride + t].
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
            (static_cast<size_t>(b) * G + hblk * g.groups()) * s + t0, s};
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
            (pid * G + hblk * g.groups()) * P, P};
  }
};

// n / d for 0 <= n < 2^31 by a multiply and a shift, the magic number
// computed on the host: the index math divides by launch constants.
struct FastDiv {
  uint32_t d, m, s;
  __host__ __device__ FastDiv() : d(1), m(1), s(0) {}
  __host__ explicit FastDiv(uint32_t div) : d(div), s(0) {
    while ((1u << s) < div) ++s;
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << s) - div)) / div + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>((__umulhi(static_cast<uint32_t>(n), m) +
                             static_cast<uint32_t>(n)) >> s);
  }
};

// How a launch stages its tiles (kernels/fused_attention.py::attention_plan
// picks wave and stages): waves of `wave` tiles through `stages` buffers (1
// when one wave holds every tile, else 2); 4-byte code words and 16-byte
// meta pieces where the operands' alignment allows (else bytes and words).
struct Plan {
  int wave, stages, code_words, meta_pieces;
  FastDiv ck4, rows, d, slices, quads, hb, code_rows, parts, rd;
};

__host__ __device__ inline int round16(int b) { return (b + 15) & ~15; }

// The shared memory of a CTA, in bytes from the base; attention_plan in
// kernels/fused_attention.py computes the same total.
struct Layout {
  int pitch;  // bytes per staged code row: ck rounded up to 4, plus 4 (an odd
              // word count when ck % 8 == 0, so 32 code rows sit in 32 banks)
  int parts;  // p.V partial sums per tile
  int ck4;    // ck rounded up to 4: the row pitch of meta words and scores
  int vpitch; // floats per row of V block scales (quad path: ck4 + 4)
  int kc, vc, km, vm, tile;  // offsets inside a staged tile, and its size
  int stage, addr, q, acc, carry, p, vks, part, scal, total;
  int rows, wr;  // query rows per head block, wave * rows
};

// A tile's sum of e: 32-token chunks (a warp's xor tree each), added in
// chunk order, where ck % 32 == 0; else one sum per tile (below).
__host__ __device__ inline int sum_chunks(const Geometry& g) {
  return g.ck % 32 == 0 ? g.ck / 32 : 1;
}

// The quad path (4 tokens per thread, 16-feature slices) takes heads of
// D = 16 * ns features with ns a power of two up to 32: the xor tree that
// adds a head's slices pairs lanes inside aligned groups of ns, which holds
// only then (ns = 5, 6 or 12 would mix tokens and heads). A tile of
// ck % 4 != 0 tokens is padded to ck4 with absent tokens (score -inf, so
// e = p = 0, and V scale 0). A function of D alone, so kernels 3 and 4 take
// the same path.
__host__ __device__ inline bool quad_path(const Geometry& g) {
  const int ns = g.d / 16;
  return g.d % 16 == 0 && ns <= 32 && (ns & (ns - 1)) == 0;
}

__host__ __device__ inline Layout layout(const Geometry& g, int wave, int stages) {
  Layout l;
  const int rows = g.rows(), ck = g.ck, ngr = g.groups(), rd = rows * g.d;
  l.ck4 = (ck + 3) / 4 * 4;
  l.pitch = l.ck4 + 4;
  l.parts = (ck + kPartTokens - 1) / kPartTokens;
  l.vpitch = l.ck4 + 4;
  int off = 0;
  l.kc = off;     off += round16(g.fb() / 2 * l.pitch);     // u8 [row][pitch]
  l.vc = off;     off += round16(g.fb() / 2 * l.pitch);
  l.km = off;     off += round16(ngr * l.ck4 * 4);          // u32 [group][ck4]
  l.vm = off;     off += round16(ngr * l.ck4 * 4);
  l.tile = off;
  off = 0;
  l.stage = off;  off += stages * wave * l.tile;
  l.addr = off;   off += round16(2 * wave * static_cast<int>(sizeof(TileAddr)));
  l.q = off;      off += round16(rd * 4);                   // f32 [row][D]
  l.acc = off;    off += round16(rd * 4);
  l.carry = off;  off += round16(2 * rows * 4);             // m, l after a wave
  l.p = off;      off += round16(wave * rows * l.ck4 * 4);  // f32 [tile][row][ck4]
  l.vks = off;    off += round16(quad_path(g)                // V scales:
                                 ? wave * ngr * 16 * l.vpitch * 4   // [tile][group][block][vpitch]
                                 : wave * ngr * ck * 4);            // [tile][group][ck]
  l.part = off;   off += round16(wave * l.parts * rd * 4);  // f32 [tile][part][row][D]
  l.scal = off;   off += round16((5 + sum_chunks(g)) * wave * rows * 4);
                                          // mx m corr l fac, chunk sums of e
  l.total = off;
  l.rows = rows;
  l.wr = wave * rows;
  return l;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The n (1..4) bytes at codes + at, little-endian in a word (the rest 0),
// from the aligned words that hold them: no byte outside those words is
// read.
__device__ __forceinline__ uint32_t unaligned_word(const uint8_t* codes, size_t at, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(codes + at);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  const int shift = static_cast<int>(a & 3u);
  const uint32_t lo = w[0];
  const uint32_t hi = shift + n > 4 ? w[1] : 0u;
  const uint32_t v = __funnelshift_r(lo, hi, 8 * shift);
  return n == 4 ? v : v & ((1u << (8 * n)) - 1u);
}

// ±magnitude of a sign-magnitude S1P2 nibble as a float. Magnitude 0 with
// the sign bit gives -0.0f, which adds like +0.0f into every sum here (each
// starts at +0.0f, and x + -0 = x).
__device__ __forceinline__ float code_value(uint32_t n) {
  const float m = __int_as_float(0x4B000000u | (n & 7u)) - 8388608.0f;
  return __int_as_float(__float_as_uint(m) | ((n & 8u) << 28));
}

// The scale of elements e, e+1 (e even) of a 64-group: its E6M2/4 scale
// times 2^(E1_8[e/8] + E1_16[e/4]); exact, so scale * code equals
// hif4.dequantize_km's product (NaN for E6M2 0xFF).
__device__ __forceinline__ float pair_scale(float group_scale, uint32_t meta, int e) {
  const int shift = static_cast<int>(((meta >> (16 + (e >> 3))) & 1u) +
                                     ((meta >> (e >> 2)) & 1u));
  return group_scale * pow2i(shift);
}

// The 8 sign-magnitude nibbles of a code word in offset binary: nibble n
// (sign s, magnitude m) becomes u = 8 + (s ? -m : m), in 1..15, with no
// carry between nibbles.
__device__ __forceinline__ uint32_t offset_nibbles(uint32_t w) {
  const uint32_t s = (w >> 3) & 0x11111111u;
  const uint32_t s7 = (s << 3) - s;
  return ((w & 0x77777777u) ^ s7) + (0x88888888u - s7);
}

// (u - 8) * sc for byte `which` of a word of offset values u: 2^23 + u as a
// float, then one fused multiply-add with nc = -(2^23 + 8) * sc. Its exact
// result (u - 8) * sc is a float, so it is the value itself: the element
// of hif4.dequantize_km (+0 for magnitude 0, NaN for a NaN scale).
__device__ __forceinline__ float offset_value(uint32_t u_bytes, int which,
                                              float sc, float nc) {
  const float big = __uint_as_float(__byte_perm(u_bytes, 0x4B000000u, 0x7650u | which));
  return __fmaf_rn(big, sc, nc);
}

__device__ __forceinline__ float offset_bias(float sc) {
  return __fmul_rn(sc, -8388616.0f);  // -(2^23 + 8) * sc, exact
}

// A float as an int whose signed order is the float's (every NaN above
// +inf), for the tile max by atomicMax; and back.
__device__ __forceinline__ int ordered_int(float f) {
  const int b = __float_as_int(f);
  return isnan(f) ? 0x7FFFFFFF : (b >= 0 ? b : b ^ 0x7FFFFFFF);
}

__device__ __forceinline__ float ordered_float(int o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7FFFFFFF);
}

// The scale of block j0 + k of a 64-group, from its meta word pre-shifted
// (e16 = meta >> j0, e8 = meta >> (16 + j0/2)): 2^(E1_16 + E1_8) as a float
// built in the exponent field, times the E6M2/4 scale; exact.
__device__ __forceinline__ float slice_block_scale(float group_scale, uint32_t e16,
                                                   uint32_t e8, int k) {
  const uint32_t two_pow = 0x3F800000u + (((e16 >> k) & 1u) << 23) +
                           (((e8 >> (k >> 1)) & 1u) << 23);
  return group_scale * __uint_as_float(two_pow);
}

// One step of the l chain: l_{k-1} * corr_k, then + sum_k (two roundings,
// as the reference's l * corr + sum).
__device__ __forceinline__ float l_step(float l, float corr, float sum) {
  return __fadd_rn(__fmul_rn(l, corr), sum);
}

// Shared-memory views of a CTA, computed from the layout where they are
// used (the layout is a kernel parameter, so they hold no registers).
struct Smem {
  const Layout& L;
  __device__ unsigned char* stage() const { return attn_smem + L.stage; }
  __device__ TileAddr* addr() const { return reinterpret_cast<TileAddr*>(attn_smem + L.addr); }
  __device__ float* f32(int off) const { return reinterpret_cast<float*>(attn_smem + off); }
  __device__ float* q() const { return f32(L.q); }
  __device__ float* acc() const { return f32(L.acc); }
  __device__ float* carry_m() const { return f32(L.carry); }          // m, l after a wave
  __device__ float* carry_l() const { return f32(L.carry) + L.rows; }
  __device__ float* p() const { return f32(L.p); }
  __device__ float* vks() const { return f32(L.vks); }
  __device__ float* part() const { return f32(L.part); }
  __device__ int* mx() const { return reinterpret_cast<int*>(attn_smem + L.scal); }  // ordered_int
  __device__ float* m() const { return f32(L.scal) + L.wr; }          // [tile][row]
  __device__ float* corr() const { return f32(L.scal) + 2 * L.wr; }
  __device__ float* l() const { return f32(L.scal) + 3 * L.wr; }
  __device__ float* fac() const { return f32(L.scal) + 4 * L.wr; }
  __device__ float* csum() const { return f32(L.scal) + 5 * L.wr; }   // [tile][row][chunk]
};

// Everything a launch passes, one __grid_constant__ kernel parameter that
// the body reads in place.
struct Params {
  const __nv_bfloat16* q;
  const uint8_t* kc;
  const uint32_t* km;
  const uint8_t* vc;
  const uint32_t* vm;
  const int* pages;
  const int* length;
  __nv_bfloat16* out;
  float sqrt_d;
  int s, max_pages, n_tiles;
  Geometry geo;
  Plan plan;
  Layout L;
};

// R: query rows a quad-path thread accumulates at once (1, 2 or 4: rep 1,
// rep 2, else passes of 4), a template parameter of the kernels so that
// each keeps its own registers.
template <class Tiles, int R>
struct Body {
  const Params& P;
  const Geometry& geo;
  const Plan& plan;
  const Layout& L;
  Smem s;
  Tiles tiles;
  int b, hblk, len, tid;
  PhaseClock* clock;

  // the addresses of tiles [k0, k0 + nt) into address slot `slot`
  __device__ void prepare(int k0, int nt, int slot) {
    for (int i = tid; i < nt; i += kThreads)
      s.addr()[slot * plan.wave + i] = tiles(b, hblk, k0 + i, geo);
  }

  // 1. copy the packed bytes of nt tiles (addresses in `slot`) into a stage
  __device__ void issue(int nt, int slot, int stage) {
    const int ck = geo.ck, code_rows = geo.fb() / 2, ngr = geo.groups();
    unsigned char* st = s.stage() + static_cast<size_t>(stage) * plan.wave * L.tile;
    const TileAddr* at = s.addr() + slot * plan.wave;
    if (plan.code_words) {
      const int wpr = ck / 4;
      for (int idx = tid; idx < code_rows * wpr; idx += kThreads) {
        const int r = idx / wpr, c = 4 * (idx % wpr);
        for (int i = 0; i < nt; ++i) {
          const size_t src = at[i].code + static_cast<size_t>(r) * at[i].stride + c;
          unsigned char* dst = st + i * L.tile + r * L.pitch + c;
          cp_async4(dst + L.kc, P.kc + src);
          cp_async4(dst + L.vc, P.vc + src);
        }
      }
    } else {  // rows not word-aligned: aligned words, realigned in registers
      const int wpr = L.ck4 / 4, total = nt * code_rows * wpr;
      for (int base = 0; base < total; base += kThreads * kWordBatch) {
        uint32_t kw[kWordBatch], vw[kWordBatch];
#pragma unroll
        for (int u = 0; u < kWordBatch; ++u) {
          const int idx = base + u * kThreads + tid;
          if (idx < total) {
            const int i = idx / (code_rows * wpr), r = (idx / wpr) % code_rows;
            const int c = 4 * (idx % wpr);
            const size_t src = at[i].code + static_cast<size_t>(r) * at[i].stride + c;
            kw[u] = unaligned_word(P.kc, src, min(4, ck - c));
            vw[u] = unaligned_word(P.vc, src, min(4, ck - c));
          }
        }
#pragma unroll
        for (int u = 0; u < kWordBatch; ++u) {
          const int idx = base + u * kThreads + tid;
          if (idx < total) {
            const int i = idx / (code_rows * wpr), r = (idx / wpr) % code_rows;
            unsigned char* dst = st + i * L.tile + r * L.pitch + 4 * (idx % wpr);
            *reinterpret_cast<uint32_t*>(dst + L.kc) = kw[u];
            *reinterpret_cast<uint32_t*>(dst + L.vc) = vw[u];
          }
        }
      }
    }
    const int step = plan.meta_pieces ? 4 : 1, per_row = ck / step;
    for (int idx = tid; idx < ngr * per_row; idx += kThreads) {
      const int g = idx / per_row, c = step * (idx % per_row);
      for (int i = 0; i < nt; ++i) {
        const size_t src = at[i].meta + static_cast<size_t>(g) * at[i].stride + c;
        unsigned char* dst = st + i * L.tile + (g * L.ck4 + c) * 4;
        if (plan.meta_pieces) {
          cp_async16(dst + L.km, P.km + src);
          cp_async16(dst + L.vm, P.vm + src);
        } else {
          cp_async4(dst + L.km, P.km + src);
          cp_async4(dst + L.vm, P.vm + src);
        }
      }
    }
    cp_async_commit();
  }

  // 2. the masked scores of the wave's tiles, and its V scales
  __device__ void scores(const unsigned char* st, int k0, int nt) {
    const int D = geo.d, rep = geo.rep, ck = geo.ck, rows = geo.rows();
    const int ngr = geo.groups();
    for (int it = tid; it < nt * ck * geo.hb; it += kThreads) {
      const int t = it % ck, i = (it / ck) % nt, h = it / (ck * nt), ck4 = L.ck4;
      const unsigned char* tile = st + i * L.tile;
      const uint8_t* kcs = tile + L.kc;
      const uint32_t* kms = reinterpret_cast<const uint32_t*>(tile + L.km);
      const uint32_t* vms = reinterpret_cast<const uint32_t*>(tile + L.vm);
      // the V scale of each group this head starts, for every walked token
      for (int g = (h * D + 63) / 64; g * 64 < (h + 1) * D; ++g)
        s.vks()[(i * ngr + g) * ck + t] = meta_scale(vms[g * ck4 + t]);
      float* sp = s.p() + (i * rows + h * rep) * ck4 + t;
      int* mx = s.mx() + i * rows + h * rep;
      if ((k0 + i) * ck + t >= len) {
        for (int r = 0; r < rep; ++r) {
          sp[r * ck4] = kNegInf;
          atomicMax(mx + r, ordered_int(kNegInf));
        }
        continue;
      }
      for (int r0 = 0; r0 < rep; r0 += kRowsPerPass) {
        const float* qr = s.q() + (h * rep + r0) * D;
        float a[kRowsPerPass] = {0.0f, 0.0f, 0.0f, 0.0f};
        uint32_t mw = 0u;
        float ks = 0.0f;
        for (int d = 0; d < D; d += 2) {
          const int f = h * D + d, e = f & 63;
          if (d == 0 || e == 0) {
            mw = kms[(f >> 6) * ck4 + t];
            ks = meta_scale(mw);
          }
          const uint32_t byte = kcs[(f >> 1) * L.pitch + t];
          const float sc = pair_scale(ks, mw, e);
          const float k0v = code_value(byte & 0xFu) * sc;
          const float k1v = code_value(byte >> 4) * sc;
#pragma unroll
          for (int j = 0; j < kRowsPerPass; ++j) {
            if (r0 + j < rep) {
              const float2 qq = *reinterpret_cast<const float2*>(qr + j * D + d);
              a[j] = __fmaf_rn(qq.x, k0v, a[j]);
              a[j] = __fmaf_rn(qq.y, k1v, a[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kRowsPerPass; ++j) {
          if (r0 + j < rep) {
            const float sc = __fdiv_rn(a[j], P.sqrt_d);
            sp[(r0 + j) * ck4] = sc;
            atomicMax(mx + r0 + j, ordered_int(sc));
          }
        }
      }
    }
  }

  // 2 on the quad path: a thread per (tile, head, quad of 4 tokens, slice of
  // 16 features): 4 u32 code words per block of 4 features (one per code
  // row and 4 tokens), each dequantized by offset_value; the slice's partial
  // dot is an __fmaf_rn chain in feature order, the ns = D/16 slices
  // (adjacent lanes, an aligned group of a power of two, so inside one warp
  // and one pass of the loop) are added by an xor tree; the V scales of the
  // slice's blocks are stored for p.V.
  __device__ void scores_quads(const unsigned char* st, int k0, int nt) {
    const int D = geo.d, rep = geo.rep, ck = geo.ck, rows = geo.rows();
    const int ngr = geo.groups(), hb = geo.hb, ns = D / 16, ck4 = L.ck4, nq = ck4 / 4;
    const int total = nt * hb * nq * ns;
    for (int base = 0; base < total; base += kThreads) {   // whole warps
      const bool live = base + tid < total;
      const int it = live ? base + tid : 0;
      const int q1 = plan.slices.div(it), q2 = plan.quads.div(q1);
      const int i = plan.hb.div(q2), h = q2 - i * hb;
      const int sl = it - q1 * ns, tq = q1 - q2 * nq, t = 4 * tq;
      const int f0 = h * D + 16 * sl, g = f0 >> 6, j0 = (f0 & 63) >> 2;
      const unsigned char* tile = st + i * L.tile;
      const uint8_t* kcs = tile + L.kc;
      const uint4 kw4 = *reinterpret_cast<const uint4*>(tile + L.km + (g * ck4 + t) * 4);
      const uint4 vw4 = *reinterpret_cast<const uint4*>(tile + L.vm + (g * ck4 + t) * 4);
      const uint32_t kw[4] = {kw4.x, kw4.y, kw4.z, kw4.w};
      const uint32_t vw[4] = {vw4.x, vw4.y, vw4.z, vw4.w};
      float ks[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) ks[u] = meta_scale(kw[u]);
      uint32_t k16[4], k8[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        k16[u] = kw[u] >> j0;
        k8[u] = kw[u] >> (16 + (j0 >> 1));
      }
      if (live) {
        float vs[4];
        uint32_t v16[4], v8[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          vs[u] = meta_scale(vw[u]);
          v16[u] = vw[u] >> j0;
          v8[u] = vw[u] >> (16 + (j0 >> 1));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)   // an absent token's V weighs 0
          if (t + u >= ck) vs[u] = 0.0f;
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) {
          float4 sc;
          sc.x = slice_block_scale(vs[0], v16[0], v8[0], k2);
          sc.y = slice_block_scale(vs[1], v16[1], v8[1], k2);
          sc.z = slice_block_scale(vs[2], v16[2], v8[2], k2);
          sc.w = slice_block_scale(vs[3], v16[3], v8[3], k2);
          *reinterpret_cast<float4*>(
              s.vks() + ((i * ngr + g) * 16 + j0 + k2) * L.vpitch + t) = sc;
        }
      }
      for (int r0 = 0; r0 < rep; r0 += R) {
        float a[R][4];
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
#pragma unroll
          for (int u = 0; u < 4; ++u) a[jj][u] = 0.0f;
        const float* qr = s.q() + (h * rep + r0) * D - h * D;  // indexed by f
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) {
          float sc[4], nc[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            sc[u] = slice_block_scale(ks[u], k16[u], k8[u], k2);
            nc[u] = offset_bias(sc[u]);
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int f = f0 + 4 * k2 + 2 * half;       // code row f/2: f, f+1
            const uint32_t w = offset_nibbles(
                *reinterpret_cast<const uint32_t*>(kcs + (f >> 1) * L.pitch + t));
            const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
            float v0[4], v1[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              v0[u] = offset_value(lo, u, sc[u], nc[u]);
              v1[u] = offset_value(hi, u, sc[u], nc[u]);
            }
#pragma unroll
            for (int jj = 0; jj < R; ++jj) {
              if (r0 + jj < rep) {
                const float2 qq = *reinterpret_cast<const float2*>(qr + jj * D + f);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  a[jj][u] = __fmaf_rn(qq.x, v0[u], a[jj][u]);
                  a[jj][u] = __fmaf_rn(qq.y, v1[u], a[jj][u]);
                }
              }
            }
          }
        }
        for (int o = 1; o < ns; o <<= 1)
#pragma unroll
          for (int jj = 0; jj < R; ++jj)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              a[jj][u] = __fadd_rn(a[jj][u], __shfl_xor_sync(HIF4_FULL_MASK, a[jj][u], o));
        if (live && sl == 0) {
#pragma unroll
          for (int jj = 0; jj < R; ++jj) {
            if (r0 + jj < rep) {
              float o4[4];
#pragma unroll
              for (int u = 0; u < 4; ++u)
                o4[u] = t + u >= ck ? -INFINITY             // absent
                        : (k0 + i) * ck + t + u < len ? __fdiv_rn(a[jj][u], P.sqrt_d)
                                                      : kNegInf;
              *reinterpret_cast<float4*>(s.p() + (i * rows + h * rep + r0 + jj) * ck4 + t) =
                  make_float4(o4[0], o4[1], o4[2], o4[3]);
              atomicMax(s.mx() + i * rows + h * rep + r0 + jj,
                        ordered_int(nan_max(nan_max(o4[0], o4[1]),
                                            nan_max(o4[2], o4[3]))));
            }
          }
        }
      }
    }
  }

  // the running max before and after tile i of the wave, in tile order
  __device__ void prefix_max(int i, int row, float& m_prev, float& m_new) const {
    const int rows = geo.rows();
    float m = s.carry_m()[row];
    for (int j = 0; j < i; ++j) m = nan_max(m, ordered_float(s.mx()[j * rows + row]));
    m_prev = m;
    m_new = nan_max(m, ordered_float(s.mx()[i * rows + row]));
  }

  // a tile's sum of e from its chunk sums, in chunk order
  __device__ float tile_sum(int item, int chunks) const {
    const float* c = s.csum() + item * chunks;
    float sum = c[0];
    for (int k = 1; k < chunks; ++k) sum = __fadd_rn(sum, c[k]);
    return sum;
  }

  // 3. the softmax steps of the wave, in the reference's op order (the
  // tile maxima came with the scores)
  __device__ void softmax(int nt) {
    const int ck = geo.ck, ck4 = L.ck4, rows = geo.rows(), items = nt * rows;
    const int lane = tid & 31, warp = tid >> 5, chunks = sum_chunks(geo);
    const bool chunked = ck % 32 == 0;
    for (int it = tid; it < items * ck4; it += kThreads) {    // e (0 if absent)
      const int item = plan.ck4.div(it), t = it - item * ck4;
      const int i = plan.rows.div(item);
      float m_prev, m_new;
      prefix_max(i, item - i * rows, m_prev, m_new);
      const float e = t < ck ? expf(__fsub_rn(s.p()[it], m_new)) : 0.0f;
      s.p()[it] = e;
      if (t == 0) {
        s.m()[item] = m_new;
        s.corr()[item] = expf(__fsub_rn(m_prev, m_new));
      }
      if (chunked) {          // a warp holds 32 consecutive tokens of a tile
        float sum = e;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum = __fadd_rn(sum, __shfl_xor_sync(HIF4_FULL_MASK, sum, o));
        if (lane == 0) s.csum()[item * chunks + t / 32] = sum;
      }
    }
    __syncthreads();
    if (!chunked) {
      for (int item = warp; item < items; item += kWarps) {   // the sum of e
        const float* sp = s.p() + item * ck4;
        float sum = 0.0f;
        for (int t = lane; t < ck; t += 32) sum = __fadd_rn(sum, sp[t]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum = __fadd_rn(sum, __shfl_xor_sync(HIF4_FULL_MASK, sum, o));
        if (lane == 0) s.csum()[item] = sum;
      }
      __syncthreads();
    }
    for (int it = tid; it < items * ck4; it += kThreads) {    // p
      const int item = plan.ck4.div(it), i = plan.rows.div(item);
      const int row = item - i * rows;
      float l = s.carry_l()[row];
      for (int j = 0; j < i; ++j)
        l = l_step(l, s.corr()[j * rows + row], tile_sum(j * rows + row, chunks));
      const float lc = __fmul_rn(l, s.corr()[item]);
      const float l_new = __fadd_rn(lc, tile_sum(item, chunks));
      s.p()[it] = rbf(__fdiv_rn(s.p()[it], l_new));
      if (it == item * ck4) {
        s.l()[item] = l_new;
        s.fac()[item] = __fdiv_rn(lc, l_new);
      }
    }
  }

  // 4a. the p.V partial sums: a thread per (tile, part, code row)
  __device__ void pv(const unsigned char* st, int nt) {
    const int D = geo.d, rep = geo.rep, ck = geo.ck, rows = geo.rows();
    const int ngr = geo.groups(), rd = rows * D, code_rows = geo.fb() / 2;
    for (int it = tid; it < nt * L.parts * code_rows; it += kThreads) {
      const int cr = it % code_rows, j = (it / code_rows) % L.parts;
      const int i = it / (code_rows * L.parts);
      const int f = 2 * cr, g = f >> 6, e = f & 63, h = f / D, dd = f % D;
      const unsigned char* tile = st + i * L.tile;
      const uint8_t* vcs = tile + L.vc + cr * L.pitch;
      const uint32_t* vms = reinterpret_cast<const uint32_t*>(tile + L.vm) + g * L.ck4;
      const float* vks = s.vks() + (i * ngr + g) * ck;
      const int t0 = j * kPartTokens, t1 = min(ck, t0 + kPartTokens);
      for (int r0 = 0; r0 < rep; r0 += kRowsPerPass) {
        const float* pr = s.p() + (i * rows + h * rep + r0) * L.ck4;
        float a0[kRowsPerPass] = {0.0f, 0.0f, 0.0f, 0.0f};
        float a1[kRowsPerPass] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int t = t0; t < t1; ++t) {
          const uint32_t byte = vcs[t];
          const float sc = pair_scale(vks[t], vms[t], e);
          const float v0 = code_value(byte & 0xFu) * sc;
          const float v1 = code_value(byte >> 4) * sc;
#pragma unroll
          for (int jj = 0; jj < kRowsPerPass; ++jj) {
            if (r0 + jj < rep) {
              a0[jj] = __fmaf_rn(pr[jj * L.ck4 + t], v0, a0[jj]);
              a1[jj] = __fmaf_rn(pr[jj * L.ck4 + t], v1, a1[jj]);
            }
          }
        }
        float* part = s.part() + (i * L.parts + j) * rd + (h * rep + r0) * D + dd;
#pragma unroll
        for (int jj = 0; jj < kRowsPerPass; ++jj) {
          if (r0 + jj < rep) {
            part[jj * D] = a0[jj];
            part[jj * D + 1] = a1[jj];
          }
        }
      }
    }
  }

  // 4a on the quad path: a thread per (tile, part, code row) reads 4 tokens
  // per shared-memory load (codes, V block scales, p); token u of each quad
  // feeds chain u, and the part's sum is (c0 + c1) + (c2 + c3).
  __device__ void pv_quads(const unsigned char* st, int nt) {
    const int D = geo.d, rep = geo.rep, rows = geo.rows();
    const int ngr = geo.groups(), rd = rows * D, code_rows = geo.fb() / 2;
    for (int it = tid; it < nt * L.parts * code_rows; it += kThreads) {
      const int q1 = plan.code_rows.div(it), i = plan.parts.div(q1);
      const int cr = it - q1 * code_rows, j = q1 - i * L.parts;
      const int f = 2 * cr, g = f >> 6, h = plan.d.div(f), dd = f - h * D;
      const uint8_t* vcs = st + i * L.tile + L.vc + cr * L.pitch;
      const float* vsc = s.vks() + ((i * ngr + g) * 16 + ((f & 63) >> 2)) * L.vpitch;
      const int t0 = j * kPartTokens, t1 = min(L.ck4, t0 + kPartTokens);
      for (int r0 = 0; r0 < rep; r0 += R) {
        const float* pr = s.p() + (i * rows + h * rep + r0) * L.ck4;
        float c0[R][4], c1[R][4];
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
#pragma unroll
          for (int u = 0; u < 4; ++u) c0[jj][u] = c1[jj][u] = 0.0f;
        for (int t = t0; t < t1; t += 4) {
          const uint32_t w = offset_nibbles(*reinterpret_cast<const uint32_t*>(vcs + t));
          const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
          const float4 sc4 = *reinterpret_cast<const float4*>(vsc + t);
          const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
          float v0[4], v1[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float nc = offset_bias(sc[u]);
            v0[u] = offset_value(lo, u, sc[u], nc);
            v1[u] = offset_value(hi, u, sc[u], nc);
          }
#pragma unroll
          for (int jj = 0; jj < R; ++jj) {
            if (r0 + jj < rep) {
              const float4 p4 = *reinterpret_cast<const float4*>(pr + jj * L.ck4 + t);
              const float ps[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                c0[jj][u] = __fmaf_rn(ps[u], v0[u], c0[jj][u]);
                c1[jj][u] = __fmaf_rn(ps[u], v1[u], c1[jj][u]);
              }
            }
          }
        }
        float* part = s.part() + (i * L.parts + j) * rd + (h * rep + r0) * D + dd;
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          if (r0 + jj < rep) {
            part[jj * D] = __fadd_rn(__fadd_rn(c0[jj][0], c0[jj][1]),
                                     __fadd_rn(c0[jj][2], c0[jj][3]));
            part[jj * D + 1] = __fadd_rn(__fadd_rn(c1[jj][0], c1[jj][1]),
                                         __fadd_rn(c1[jj][2], c1[jj][3]));
          }
        }
      }
    }
  }

  // 4b. the ordered sum: a tile's parts in part order, tiles in tile order
  __device__ void ordered_sum(int nt) {
    const int D = geo.d, rows = geo.rows(), rd = rows * D;
    float* part = s.part();
    if (L.parts > 1) {        // each tile's parts, in part order, into part 0
      for (int it = tid; it < nt * rd; it += kThreads) {
        const int i = plan.rd.div(it), o = it - i * rd;
        const float* pi = part + i * L.parts * rd + o;
        float pv = 0.0f;
        for (int j = 0; j < L.parts; ++j) pv = __fadd_rn(pv, pi[j * rd]);
        part[i * L.parts * rd + o] = pv;
      }
      __syncthreads();
    }
    for (int o = tid; o < rd; o += kThreads) {
      const int row = plan.d.div(o);
      float acc = s.acc()[o];
#pragma unroll 4
      for (int i = 0; i < nt; ++i)
        acc = __fadd_rn(__fmul_rn(acc, s.fac()[i * rows + row]),
                        part[i * L.parts * rd + o]);
      s.acc()[o] = acc;
    }
    for (int row = tid; row < rows; row += kThreads) {
      s.carry_m()[row] = s.m()[(nt - 1) * rows + row];
      s.carry_l()[row] = s.l()[(nt - 1) * rows + row];
    }
  }

  // walk every tile in waves; the first wave's addresses are in address
  // slot 0 already
  __device__ void walk() {
    const int n = P.n_tiles, wave = plan.wave, n_waves = (n + wave - 1) / wave;
    issue(min(wave, n), 0, 0);
    for (int w = 0; w < n_waves; ++w) {
      const int k0 = w * wave, nt = min(wave, n - k0);
      if (w + 1 < n_waves) {      // the next wave's copies fly during this one
        const int nt1 = min(wave, n - k0 - wave);
        prepare(k0 + wave, nt1, (w + 1) & 1);
        __syncthreads();
        issue(nt1, (w + 1) & 1, (w + 1) % plan.stages);
        clock->mark(kLoadsIssued);
        cp_async_wait<1>();
      } else {
        clock->mark(kLoadsIssued);
        cp_async_wait<0>();
      }
      for (int i = tid; i < nt * geo.rows(); i += kThreads)
        s.mx()[i] = ordered_int(-INFINITY);
      __syncthreads();
      clock->mark(kStaged);
      const unsigned char* st =
          s.stage() + static_cast<size_t>(w % plan.stages) * wave * L.tile;
      if (quad_path(geo))
        scores_quads(st, k0, nt);
      else
        scores(st, k0, nt);
      __syncthreads();
      clock->mark(kScores);
      softmax(nt);
      __syncthreads();
      clock->mark(kSoftmax);
      if (quad_path(geo))
        pv_quads(st, nt);
      else
        pv(st, nt);
      __syncthreads();
      clock->mark(kPv);
      ordered_sum(nt);
      __syncthreads();
      clock->mark(kOrderedSum);
    }
  }
};

template <int R, class Tiles>
__device__ void decode_body(const Params& P, const Tiles& tiles) {
  PhaseClock clock;
  const int tid = threadIdx.x;
  const Geometry& geo = P.geo;
  const int rows = geo.rows(), rd = rows * geo.d, wave = P.plan.wave;
  const int b = blockIdx.y, hblk = blockIdx.x;
  const int len = P.length[b];
  Body<Tiles, R> body{P, P.geo, P.plan, P.L, Smem{P.L}, tiles, b, hblk, len, tid,
                      &clock};
  const Smem& s = body.s;
  // q rows of this head block: head (hblk*hb + h), repeat r -> row h*rep + r
  const size_t q_base = (static_cast<size_t>(b) * geo.hkv + hblk * geo.hb) * geo.rep * geo.d;
  for (int i = tid; i < rd; i += kThreads) {
    s.q()[i] = __bfloat162float(P.q[q_base + i]);
    s.acc()[i] = 0.0f;
  }
  for (int i = tid; i < rows; i += kThreads) {
    s.carry_m()[i] = kNegInf;
    s.carry_l()[i] = 0.0f;
  }
  body.prepare(0, min(wave, P.n_tiles), 0);  // in flight beside q and the length
  __syncthreads();
  clock.mark(kSetup);
  body.walk();
  for (int i = tid; i < rd; i += kThreads)
    P.out[q_base + i] = __float2bfloat16_rn(s.acc()[i]);
  clock.finish();
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    fused_decode_attention_kernel(const __grid_constant__ Params P) {
  decode_body<R>(P, ContiguousTiles{P.s});
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    fused_paged_decode_attention_kernel(const __grid_constant__ Params P) {
  decode_body<R>(P, PagedTiles{P.pages, P.max_pages});
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The kernel instance for rep query rows per KV head, and its slot in a
// launcher's table of shared-memory attributes.
inline int rows_slot(int rep) { return rep == 1 ? 0 : (rep == 2 ? 1 : 2); }

// Checks the host plan's wave, stages and shared bytes against this file's
// own layout, picks the copy widths from the operands' alignment, launches
// one CTA per (head block, slot) of the kernel instance for rep.
template <class Kernel>
int launch(const Kernel (&kernels)[3], int (&attr_bytes)[3], Params P, int B,
           int wave, int stages, int smem_bytes, int stride, void* stream) {
  const Geometry& geo = P.geo;
  if (B < 1 || P.n_tiles < 1 || geo.ck < 1 || geo.rep < 1 || geo.hb < 1 ||
      geo.rows() > kThreads || geo.d < 2 || geo.d % 2 || geo.fb() % 64 ||
      geo.hkv % geo.hb || wave < 1 || wave > P.n_tiles ||
      !(stages == 1 || stages == 2) || (stages == 1 && wave != P.n_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  P.L = layout(geo, wave, stages);
  if (P.L.total != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  const bool quads = geo.ck % 4 == 0 && stride % 4 == 0;
  P.plan = Plan{wave, stages,
                quads && aligned(P.kc, 4) && aligned(P.vc, 4) ? 1 : 0,
                quads && aligned(P.km, 16) && aligned(P.vm, 16) ? 1 : 0,
                FastDiv(P.L.ck4), FastDiv(geo.rows()), FastDiv(geo.d),
                FastDiv(geo.d / 16 > 0 ? geo.d / 16 : 1), FastDiv(P.L.ck4 / 4),
                FastDiv(geo.hb),
                FastDiv(geo.fb() / 2), FastDiv(P.L.parts),
                FastDiv(geo.rows() * geo.d)};
  const int slot = rows_slot(geo.rep);
  if (smem_bytes > attr_bytes[slot]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernels[slot], cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_bytes[slot] = smem_bytes;
  }
  const dim3 grid(geo.hkv / geo.hb, B);
  kernels[slot]<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

using KernelFn = void (*)(Params);

}  // namespace

extern "C" int fused_decode_attention(const void* q, const void* kc,
                                      const void* km, const void* vc,
                                      const void* vm, const void* length,
                                      void* out, int B, int hkv, int rep,
                                      int d, int s, int ck, int hb, int wave,
                                      int stages, int smem_bytes, float sqrt_d,
                                      void* stream) {
  static const KernelFn kernels[3] = {fused_decode_attention_kernel<1>,
                                      fused_decode_attention_kernel<2>,
                                      fused_decode_attention_kernel<4>};
  static int attr_bytes[3] = {48 * 1024, 48 * 1024, 48 * 1024};  // allowed so far
  if (ck < 1 || s < ck || s % ck) return static_cast<int>(cudaErrorInvalidValue);
  Params P = {};
  P.q = static_cast<const __nv_bfloat16*>(q);
  P.kc = static_cast<const uint8_t*>(kc);
  P.km = static_cast<const uint32_t*>(km);
  P.vc = static_cast<const uint8_t*>(vc);
  P.vm = static_cast<const uint32_t*>(vm);
  P.length = static_cast<const int*>(length);
  P.out = static_cast<__nv_bfloat16*>(out);
  P.sqrt_d = sqrt_d;
  P.s = s;
  P.n_tiles = s / ck;
  P.geo = Geometry{hkv, rep, d, ck, hb};
  return launch(kernels, attr_bytes, P, B, wave, stages, smem_bytes, s, stream);
}

extern "C" int fused_paged_decode_attention(const void* q, const void* kc,
                                            const void* km, const void* vc,
                                            const void* vm, const void* pages,
                                            const void* length, void* out,
                                            int B, int hkv, int rep, int d,
                                            int page_tokens, int max_pages,
                                            int hb, int wave, int stages,
                                            int smem_bytes, float sqrt_d,
                                            void* stream) {
  static const KernelFn kernels[3] = {fused_paged_decode_attention_kernel<1>,
                                      fused_paged_decode_attention_kernel<2>,
                                      fused_paged_decode_attention_kernel<4>};
  static int attr_bytes[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  Params P = {};
  P.q = static_cast<const __nv_bfloat16*>(q);
  P.kc = static_cast<const uint8_t*>(kc);
  P.km = static_cast<const uint32_t*>(km);
  P.vc = static_cast<const uint8_t*>(vc);
  P.vm = static_cast<const uint32_t*>(vm);
  P.pages = static_cast<const int*>(pages);
  P.length = static_cast<const int*>(length);
  P.out = static_cast<__nv_bfloat16*>(out);
  P.sqrt_d = sqrt_d;
  P.max_pages = max_pages;
  P.n_tiles = max_pages;
  P.geo = Geometry{hkv, rep, d, page_tokens, hb};
  return launch(kernels, attr_bytes, P, B, wave, stages, smem_bytes, page_tokens,
                stream);
}
