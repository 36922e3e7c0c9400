"""Kernels 3 and 4: fused HiF4 flash decode-attention over the packed KV
cache, contiguous and paged.

Ports of the TPU Pallas kernels ``repro/kernels/fused_attention.py::
fused_decode_attention`` (contiguous cache) and
``fused_paged_decode_attention`` (page pool) as the CUDA kernels of
``csrc/fused_attention.cu``: one CTA per (slot, KV-head block), the KV tiles
walked in a loop inside it. Both kernels share one CTA body; only the tile
loader differs (a token slice of the slot's cache, or pool page
``pages[b, k]``), so paged attention at page size P is bitwise equal to the
contiguous kernel at ``block_kv = P`` by construction.

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
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import kvcache
from repro_torch.kernels import build
from repro_torch.kernels.bfp_matmul import _fit

NEG_INF = -1e30   # masked-score value (repro_torch.models.attention.NEG_INF)

# Decode KV tiles: deep tiles for payload per step; caches of at most one
# tile take a single tile (where the recurrence IS the flat softmax).
_KV_TILE = 256
# shared memory a block may use on Hopper
_SMEM_MAX = 232_448


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
    divide the head count (a page pool's leaves qualify the same way)."""
    return (
        kvcache.is_kernel_layout(k_cache)
        and k_cache["tail"].shape[-2] == 0
        and n_kv_heads % heads_per_block(d_head) == 0
    )


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


def _check_smem(name: str, rows: int, d_head: int, fb: int, ck: int) -> None:
    i = ctypes.c_int
    smem = build.function("fused_attention", "fused_decode_attention_smem",
                          [i, i, i, i], ctypes.c_longlong)(rows, d_head, fb, ck)
    if smem > _SMEM_MAX:
        raise ValueError(f"{name}: KV tile {ck} needs {smem} B of shared "
                         f"memory (> {_SMEM_MAX})")


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
    hb = heads_per_block(d_head)
    rep = H // n_kv_heads
    ck = select_kv_block(S, block_kv)
    _check_smem("fused_decode_attention", hb * rep, d_head, hb * d_head, ck)
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("fused_attention", "fused_decode_attention",
                        [p] * 7 + [i] * 7 + [ctypes.c_float, p])
    rc = fn(q.data_ptr(), k_cache["codes"].data_ptr(), k_cache["meta"].data_ptr(),
            v_cache["codes"].data_ptr(), v_cache["meta"].data_ptr(),
            length.data_ptr(), out.data_ptr(), B, n_kv_heads, rep, d_head, S,
            ck, hb, _sqrt_d(d_head), build.stream_ptr(q.device))
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
    hb = heads_per_block(d_head)
    rep = H // n_kv_heads
    _check_smem("fused_paged_decode_attention", hb * rep, d_head, hb * d_head, P)
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("fused_attention", "fused_paged_decode_attention",
                        [p] * 8 + [i] * 7 + [ctypes.c_float, p])
    rc = fn(q.data_ptr(), k_pool["codes"].data_ptr(), k_pool["meta"].data_ptr(),
            v_pool["codes"].data_ptr(), v_pool["meta"].data_ptr(),
            pages.data_ptr(), length.data_ptr(), out.data_ptr(), B, n_kv_heads,
            rep, d_head, P, pages.shape[1], hb, _sqrt_d(d_head),
            build.stream_ptr(q.device))
    build.check("fused_attention", "fused_paged_decode_attention", rc)
    return out
