"""Kernels 3 and 4: fused HiF4 flash decode-attention over the packed KV
cache, contiguous and paged.

Ports of the TPU Pallas kernels ``repro/kernels/fused_attention.py::
fused_decode_attention`` (contiguous cache) and
``fused_paged_decode_attention`` (page pool) as the CUDA kernels of
``csrc/fused_attention.cu``: one CTA per (slot, KV-head block) stages waves
of KV tiles into shared memory and runs each step of the recurrence over all
of a wave's tiles at once, the scalar chain and the accumulator in tile
order (:func:`attention_plan` is its launch plan). Both kernels share one CTA
body; only the tile loader differs (a token slice of the slot's cache, or
pool page ``pages[b, k]``), and every reduction inside a tile is laid out by
the tile and head widths alone (:func:`tile_layout`), so paged attention at
page size P is bitwise equal to the contiguous kernel at ``block_kv = P`` by
construction. Every tile is walked, as in the reference, those wholly past
a slot's length too.

  contiguous: q (B, H, D) bf16; K and V each codes (B, F/2, S) uint8, meta
              (B, G, S) int32 (uint32 bits), no staging tail; length (B,)
  paged:      the same q and length; per-layer pool leaves codes (NP, F/2, P)
              uint8, meta (NP, G, P) int32; pages (B, max_pages) int32
  -> (B, H, D) bf16

The recurrence keeps the accumulator normalized at every tile
(``acc <- acc * (l*corr/l_new) + (e/l_new)_bf16 @ V``), so at one KV tile it
is exactly the flat masked softmax, and a fully masked tile (a trailing
scratch-page entry of a page table) is an exact no-op: corr = 1, e = 0,
acc * (l/l). :func:`fused_decode_attention_plain` and
:func:`fused_paged_decode_attention_plain` are the plain PyTorch versions
(transcriptions of the reference's ``*_xla`` twins, sharing one tile step;
the contiguous one also serves the layouts the kernel cannot tile: artifact
layout, staging tail); the wrappers take them only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import kvcache
from repro_torch.kernels import build
from repro_torch.kernels.bfp_matmul import _fit
from repro_torch.kernels.fused_matmul import SMEM_PER_CTA_MAX, _r16

NEG_INF = -1e30   # masked-score value (repro_torch.models.attention.NEG_INF)

# Decode KV tiles: deep tiles for payload per step; caches of at most one
# tile take a single tile (where the recurrence IS the flat softmax).
_KV_TILE = 256
# csrc/fused_attention.cu: threads per CTA, tokens per p.V partial sum,
# bytes of a staged tile address (two size_t and an int)
ATTN_THREADS = 512
_PART_TOKENS = 32
_TILE_ADDR_BYTES = 24


def select_kv_block(seq: int, block_kv: Optional[int] = None) -> int:
    """Whole cache when it fits one tile, else a divisor of ``seq`` near the
    tile target; a degenerate best divisor (< 1/4 of the target) gives way to
    the smallest divisor at or above it."""
    want = min(block_kv or _KV_TILE, seq)
    best = _fit(seq, want, 1)
    if best * 4 < want:
        best = next(d for d in range(want, seq + 1) if seq % d == 0)
    return best


def heads_per_block(d_head: int) -> int:
    """KV heads per block so head blocks hold whole 64-groups."""
    return math.lcm(d_head, 64) // d_head


def kernel_compatible(k_cache: dict, n_kv_heads: int, d_head: int) -> bool:
    """Kernel-tile layout, no partial-group staging tail, head blocks that
    divide the head count (the reference's rule); a page pool's leaves
    qualify the same way. The CUDA kernels also need an even head width (a
    head of whole code bytes): :func:`attention_plan` refuses an odd one,
    so on the card it raises rather than taking the plain version."""
    return (
        kvcache.is_kernel_layout(k_cache)
        and k_cache["tail"].shape[-2] == 0
        and n_kv_heads % heads_per_block(d_head) == 0
    )


# ---------------------------------------------------------------------------
# the kernels' launch plan
# ---------------------------------------------------------------------------


def quad_path(d_head: int) -> bool:
    """The kernels' quad path (4 tokens per thread, 16-feature slices of a
    head) takes heads of D = 16 * ns features with ns a power of two up to
    32 (its xor tree adds a head's ns slices on aligned groups of lanes),
    and tiles of any width (padded to a multiple of 4 with absent tokens);
    the scalar path the rest (D = 40, 80, 96, 192, ...)."""
    ns = d_head // 16
    return d_head % 16 == 0 and ns <= 32 and ns & (ns - 1) == 0


def tile_layout(ck: int, d_head: int) -> tuple:
    """How the kernels lay out the reductions of one KV tile of ``ck``
    tokens, a function of the tile and head widths alone (never of the tile
    count, the batch or the kernel): (staged code row pitch in bytes, p.V
    partial sums, tokens per partial sum, p.V chains per partial sum,
    slices per dot product, chunks of the sum of e).

    q.k: on the quad path D/16 slices of 16 features, each an FMA chain in
    feature order, added by an xor tree; else one chain in feature order.
    The tile max is exact in any order. The sum of e: where ck % 32 == 0,
    chunks of 32 consecutive tokens (an xor tree each) added in chunk
    order; else lane l of a warp takes tokens l, l+32, ... in order, then an
    xor tree over the 32 lanes. p.V: part j sums tokens [32j, 32j+32), on
    the quad path in 4 chains (token t to chain t % 4, then (c0 + c1) +
    (c2 + c3)), else in token order; the parts are added in part order."""
    quads = quad_path(d_head)
    return (-(-ck // 4) * 4 + 4, -(-ck // _PART_TOKENS), _PART_TOKENS,
            4 if quads else 1, d_head // 16 if quads else 1,
            ck // 32 if ck % 32 == 0 else 1)


def _smem_bytes(rows: int, d_head: int, fb: int, ck: int, wave: int,
                stages: int) -> int:
    """csrc/fused_attention.cu's ``layout``: the staged tiles (K and V code
    rows at the padded pitch, K and V meta words in rows of ck rounded up to
    4) times wave and stages, the wave's tile addresses (two slots), q, acc,
    the carried (m, l), the scores, the V scales (per block of 4 features on
    the quad path, per 64-group else), the p.V parts, and five scalars and
    the chunk sums of e per (tile, row)."""
    pitch, parts, _, _, _, chunks = tile_layout(ck, d_head)
    ngr, rd, ck4 = fb // 64, rows * d_head, pitch - 4
    tile = 2 * _r16(fb // 2 * pitch) + 2 * _r16(ngr * ck4 * 4)
    v_scales = (wave * ngr * 16 * (ck4 + 4) * 4 if quad_path(d_head)
                else wave * ngr * ck * 4)
    return (stages * wave * tile + _r16(2 * wave * _TILE_ADDR_BYTES)
            + 2 * _r16(rd * 4) + _r16(2 * rows * 4) + _r16(wave * rows * ck4 * 4)
            + _r16(v_scales) + _r16(wave * parts * rd * 4)
            + _r16((5 + chunks) * wave * rows * 4))


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """The launch of kernels 3 and 4: ``grid`` = (head blocks, slots), one
    CTA of ``threads`` per (slot, head block) and no cluster, so no tile is
    ever split across CTAs; a CTA walks its tiles in waves of ``wave``
    through ``stages`` shared-memory buffers (1 when one wave holds every
    tile, else a ring of 2), with ``smem_bytes`` of dynamic shared memory.
    ``pitch`` and ``parts`` are :func:`tile_layout`'s."""

    grid: tuple
    threads: int
    wave: int
    stages: int
    pitch: int
    parts: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def attention_plan(batch: int, n_kv_heads: int, rep: int, d_head: int,
                   ck: int, n_tiles: int) -> AttentionPlan:
    """Every tile in one wave when that fits in 227 KB of shared memory;
    else the widest wave of a two-stage ring that fits. Raises when one
    tile does not fit, and for an odd ``d_head``."""
    hb = heads_per_block(d_head)
    rows, fb = hb * rep, hb * d_head
    if d_head % 2:
        raise ValueError(f"the decode-attention kernels need an even d_head (a "
                         f"head of whole code bytes), got {d_head}")
    if batch < 1 or n_tiles < 1 or ck < 1 or n_kv_heads % hb \
            or rows > ATTN_THREADS:
        raise ValueError(f"no decode-attention launch for batch={batch}, "
                         f"n_kv_heads={n_kv_heads}, rep={rep}, d_head={d_head}, "
                         f"ck={ck}, n_tiles={n_tiles}")
    pitch, parts = tile_layout(ck, d_head)[:2]
    grid = (n_kv_heads // hb, batch)

    def plan(wave, stages):
        return AttentionPlan(grid, ATTN_THREADS, wave, stages, pitch, parts,
                             _smem_bytes(rows, d_head, fb, ck, wave, stages))

    if _smem_bytes(rows, d_head, fb, ck, n_tiles, 1) <= SMEM_PER_CTA_MAX:
        return plan(n_tiles, 1)
    lo, hi = 0, n_tiles - 1                 # the widest two-stage wave that fits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _smem_bytes(rows, d_head, fb, ck, mid, 2) <= SMEM_PER_CTA_MAX:
            lo = mid
        else:
            hi = mid - 1
    if lo < 1:
        raise ValueError(f"a KV tile of {ck} tokens needs "
                         f"{_smem_bytes(rows, d_head, fb, ck, 1, 2)} B of shared "
                         f"memory in a two-stage ring (> {SMEM_PER_CTA_MAX})")
    return plan(lo, 2)


def _sqrt_d(d_head: int) -> float:
    """sqrt(d_head) as the float32 the scores are divided by."""
    return float(np.float32(d_head ** 0.5))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _init_state(B: int, n_kv_heads: int, rep: int, D: int, device):
    return (torch.full((B, n_kv_heads, rep, 1), NEG_INF, device=device),
            torch.zeros((B, n_kv_heads, rep, 1), device=device),
            torch.zeros((B, n_kv_heads, rep, D), device=device))


def _tile_step(state, qf, kblk, vblk, valid, sqrt_d: float):
    """Fold one KV tile into the normalized online-softmax state: kblk/vblk
    (B, ck, Hkv, D) bf16, valid (B, ck) bool. Both plain versions run every
    tile through this one function, so paged and contiguous agree bitwise
    on the same tile partition."""
    m, l, acc = state
    s = torch.einsum("bgrd,bkgd->bgrk", qf, kblk.to(torch.float32)) / sqrt_d
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    e = torch.exp(s - m_new)
    l_new = l * corr + torch.sum(e, dim=-1, keepdim=True)
    p = (e / l_new).to(torch.bfloat16)
    pv = torch.einsum("bgrk,bkgd->bgrd", p.to(torch.float32),
                      vblk.to(torch.float32))
    return m_new, l_new, acc * (l * corr / l_new) + pv


def fused_decode_attention_plain(q, k_cache: dict, v_cache: dict, length,
                                 n_kv_heads: int, d_head: int, *,
                                 block_kv: Optional[int] = None) -> torch.Tensor:
    """Plain version: the recurrence as a loop over KV tiles, each tile
    sliced from the packed leaves (either layout) and dequantized through the
    shared K-major decode. The bf16 working set is one tile."""
    B, H, D = q.shape
    if D != d_head:
        raise ValueError(f"q has d_head {D}, expected {d_head}")
    S = kvcache.seq_capacity(k_cache)
    rep = H // n_kv_heads
    ck = select_kv_block(S, block_kv)
    qf = q.reshape(B, n_kv_heads, rep, D).to(torch.float32)
    positions = torch.arange(ck, device=q.device)
    length = length.to(q.device)
    sqrt_d = _sqrt_d(d_head)
    state = _init_state(B, n_kv_heads, rep, D, q.device)
    for ki in range(S // ck):
        kblk = kvcache.dequantize_kv(
            kvcache.slice_tokens(k_cache, ki * ck, ck), n_kv_heads, d_head)
        vblk = kvcache.dequantize_kv(
            kvcache.slice_tokens(v_cache, ki * ck, ck), n_kv_heads, d_head)
        valid = (ki * ck + positions)[None, :] < length[:, None]     # (B, ck)
        state = _tile_step(state, qf, kblk, vblk, valid, sqrt_d)
    return state[2].reshape(B, H, D).to(q.dtype)


def fused_paged_decode_attention_plain(q, k_pool: dict, v_pool: dict, pages,
                                       length, n_kv_heads: int,
                                       d_head: int) -> torch.Tensor:
    """Plain version of the paged kernel: the same recurrence, the tile
    loader GATHERS tile k's pool page per slot (``pool[pages[:, k]]``)
    instead of slicing a token axis; per-layer pool leaves (NP, F, P)."""
    B, H, D = q.shape
    if D != d_head:
        raise ValueError(f"q has d_head {D}, expected {d_head}")
    P = kvcache.pool_page_tokens(k_pool)
    rep = H // n_kv_heads
    qf = q.reshape(B, n_kv_heads, rep, D).to(torch.float32)
    positions = torch.arange(P, device=q.device)
    length = length.to(q.device)
    pages = pages.to(device=q.device, dtype=torch.long)
    sqrt_d = _sqrt_d(d_head)
    state = _init_state(B, n_kv_heads, rep, D, q.device)

    def gather(pool_t, pids):
        return {key: a.index_select(0, pids) for key, a in pool_t.items()}

    for ki in range(pages.shape[1]):
        pids = pages[:, ki]
        kblk = kvcache.dequantize_kv(gather(k_pool, pids), n_kv_heads, d_head)
        vblk = kvcache.dequantize_kv(gather(v_pool, pids), n_kv_heads, d_head)
        valid = (ki * P + positions)[None, :] < length[:, None]      # (B, P)
        state = _tile_step(state, qf, kblk, vblk, valid, sqrt_d)
    return state[2].reshape(B, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check_head_geometry(name: str, q, n_kv_heads: int, d_head: int, k, v):
    B, H, D = q.shape
    if D != d_head or H % n_kv_heads:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit n_kv_heads="
                         f"{n_kv_heads}, d_head={d_head}")
    if not (kernel_compatible(k, n_kv_heads, d_head)
            and kernel_compatible(v, n_kv_heads, d_head)):
        raise ValueError(f"{name} needs kernel-tile leaves without a staging "
                         "tail")


def _check_cuda_operands(name: str, q, length, caches, want: dict) -> torch.Tensor:
    """Device, dtype, shape and contiguity of every operand the kernel
    reads; returns ``length`` as a contiguous int32 (B,) tensor on q's
    device."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    for cache in caches:
        for key, (shape, dt) in want.items():
            t = cache[key]
            if tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous() \
                    or t.device != q.device:
                raise ValueError(f"{name}: {key} must be a contiguous {dt} "
                                 f"{shape} on {q.device}")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise TypeError(f"{name} takes a contiguous bf16 q")
    if q.shape[0] == 0:
        raise ValueError(f"{name}: an empty batch launches no kernel")
    length = length.to(device=q.device, dtype=torch.int32).contiguous()
    if tuple(length.shape) != (q.shape[0],):
        raise ValueError(f"{name}: length must be ({q.shape[0]},), got "
                         f"{tuple(length.shape)}")
    return length


def fused_decode_attention(q, k_cache: dict, v_cache: dict, length, *,
                           n_kv_heads: int, d_head: int,
                           block_kv: Optional[int] = None) -> torch.Tensor:
    """Flash decode-attention straight off the 4.5-bit cache -> (B, H, D):
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors.
    Requires :func:`kernel_compatible` geometry; ``block_kv`` overrides the
    KV tile (:func:`select_kv_block`)."""
    _check_head_geometry("fused_decode_attention", q, n_kv_heads, d_head,
                         k_cache, v_cache)
    if q.device.type == "cpu":
        return fused_decode_attention_plain(q, k_cache, v_cache, length,
                                            n_kv_heads, d_head, block_kv=block_kv)
    B, H, D = q.shape
    S = kvcache.seq_capacity(k_cache)
    g = n_kv_heads * d_head // 64
    length = _check_cuda_operands(
        "fused_decode_attention", q, length, (k_cache, v_cache),
        {"codes": ((B, g * 32, S), torch.uint8), "meta": ((B, g, S), torch.int32)})
    rep = H // n_kv_heads
    ck = select_kv_block(S, block_kv)
    plan = attention_plan(B, n_kv_heads, rep, d_head, ck, S // ck)
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("fused_attention", "fused_decode_attention",
                        [p] * 7 + [i] * 10 + [ctypes.c_float, p])
    rc = fn(q.data_ptr(), k_cache["codes"].data_ptr(), k_cache["meta"].data_ptr(),
            v_cache["codes"].data_ptr(), v_cache["meta"].data_ptr(),
            length.data_ptr(), out.data_ptr(), B, n_kv_heads, rep, d_head, S,
            ck, heads_per_block(d_head), plan.wave, plan.stages,
            plan.smem_bytes, _sqrt_d(d_head), build.stream_ptr(q.device))
    build.check("fused_attention", "fused_decode_attention", rc)
    return out


def fused_paged_decode_attention(q, k_pool: dict, v_pool: dict, pages, length,
                                 *, n_kv_heads: int, d_head: int) -> torch.Tensor:
    """Flash decode-attention off the PAGED 4.5-bit pool -> (B, H, D): the
    CUDA kernel on CUDA tensors, the plain version on CPU tensors.

    ``k_pool``/``v_pool`` are per-layer pool leaves (NP, F, P); tile k of
    slot b is pool page ``pages[b, k]``. The tile width is the page size,
    and trailing zero entries (the scratch page) are fully masked no-ops, so
    the result is bitwise equal to :func:`fused_decode_attention` at
    ``block_kv = P`` on the same bytes laid out contiguously. Page ids must
    lie in [0, NP): the kernel reads them from device memory unchecked."""
    _check_head_geometry("fused_paged_decode_attention", q, n_kv_heads, d_head,
                         k_pool, v_pool)
    if pages.dim() != 2 or pages.shape[0] != q.shape[0]:
        raise ValueError(f"fused_paged_decode_attention: pages must be "
                         f"({q.shape[0]}, max_pages), got {tuple(pages.shape)}")
    if q.device.type == "cpu":
        return fused_paged_decode_attention_plain(q, k_pool, v_pool, pages,
                                                  length, n_kv_heads, d_head)
    B, H, D = q.shape
    n_pages, _, P = k_pool["codes"].shape
    g = n_kv_heads * d_head // 64
    length = _check_cuda_operands(
        "fused_paged_decode_attention", q, length, (k_pool, v_pool),
        {"codes": ((n_pages, g * 32, P), torch.uint8),
         "meta": ((n_pages, g, P), torch.int32)})
    if pages.dtype != torch.int32 or not pages.is_contiguous() \
            or pages.device != q.device or pages.shape[1] == 0:
        raise ValueError(f"fused_paged_decode_attention: pages must be a "
                         f"contiguous int32 tensor on {q.device} with at least "
                         f"one entry per slot")
    rep = H // n_kv_heads
    plan = attention_plan(B, n_kv_heads, rep, d_head, P, pages.shape[1])
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("fused_attention", "fused_paged_decode_attention",
                        [p] * 8 + [i] * 10 + [ctypes.c_float, p])
    rc = fn(q.data_ptr(), k_pool["codes"].data_ptr(), k_pool["meta"].data_ptr(),
            v_pool["codes"].data_ptr(), v_pool["meta"].data_ptr(),
            pages.data_ptr(), length.data_ptr(), out.data_ptr(), B, n_kv_heads,
            rep, d_head, P, pages.shape[1], heads_per_block(d_head), plan.wave,
            plan.stages, plan.smem_bytes, _sqrt_d(d_head),
            build.stream_ptr(q.device))
    build.check("fused_attention", "fused_paged_decode_attention", rc)
    return out
