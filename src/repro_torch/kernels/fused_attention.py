"""Kernel 3: fused HiF4 flash decode-attention over the packed KV cache.

Port of the TPU Pallas kernel ``repro/kernels/fused_attention.py::
fused_decode_attention`` (contiguous cache) as the CUDA kernel
``csrc/fused_attention.cu``: one CTA per (slot, KV-head block), the KV tiles
of :func:`select_kv_block` walked in a loop inside it.

  q (B, H, D) bf16; K and V each kernel-tile leaves codes (B, F/2, S) uint8,
  meta (B, G, S) int32 (uint32 bits), no staging tail; length (B,) -> (B, H, D)

The recurrence keeps the accumulator normalized at every tile
(``acc <- acc * (l*corr/l_new) + (e/l_new)_bf16 @ V``), so at one KV tile it
is exactly the flat masked softmax. :func:`fused_decode_attention_plain` is
the plain PyTorch version (a transcription of the reference's
``fused_decode_attention_xla``; it also serves the layouts the kernel cannot
tile: artifact layout, staging tail); :func:`fused_decode_attention` takes it
only for CPU tensors. The paged variant comes with the page pool.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import kvcache
from repro_torch.kernels import build
from repro_torch.kernels.fused_matmul import _fit

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
    divide the head count."""
    return (
        kvcache.is_kernel_layout(k_cache)
        and k_cache["tail"].shape[-2] == 0
        and n_kv_heads % heads_per_block(d_head) == 0
    )


def _sqrt_d(d_head: int) -> float:
    """sqrt(d_head) as the float32 the scores are divided by."""
    return float(np.float32(d_head ** 0.5))


def fused_decode_attention_plain(q, k_cache: dict, v_cache: dict, length,
                                 n_kv_heads: int, d_head: int, *,
                                 block_kv: Optional[int] = None) -> torch.Tensor:
    """Plain version: the same recurrence as a loop over KV tiles, each tile
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
    m = torch.full((B, n_kv_heads, rep, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, n_kv_heads, rep, 1), device=q.device)
    acc = torch.zeros((B, n_kv_heads, rep, D), device=q.device)
    for ki in range(S // ck):
        kblk = kvcache.dequantize_kv(
            kvcache.slice_tokens(k_cache, ki * ck, ck), n_kv_heads, d_head)
        vblk = kvcache.dequantize_kv(
            kvcache.slice_tokens(v_cache, ki * ck, ck), n_kv_heads, d_head)
        s = torch.einsum("bgrd,bkgd->bgrk", qf, kblk.to(torch.float32)) / sqrt_d
        valid = (ki * ck + positions)[None, :] < length[:, None]     # (B, ck)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l_new = l * corr + torch.sum(e, dim=-1, keepdim=True)
        p = (e / l_new).to(torch.bfloat16)
        pv = torch.einsum("bgrk,bkgd->bgrd", p.to(torch.float32),
                          vblk.to(torch.float32))
        acc = acc * (l * corr / l_new) + pv
        m, l = m_new, l_new
    return acc.reshape(B, H, D).to(q.dtype)


def fused_decode_attention(q, k_cache: dict, v_cache: dict, length, *,
                           n_kv_heads: int, d_head: int) -> torch.Tensor:
    """Flash decode-attention straight off the 4.5-bit cache -> (B, H, D):
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors.
    Requires :func:`kernel_compatible` geometry."""
    B, H, D = q.shape
    if D != d_head or H % n_kv_heads:
        raise ValueError(f"q {tuple(q.shape)} does not fit n_kv_heads="
                         f"{n_kv_heads}, d_head={d_head}")
    if not (kernel_compatible(k_cache, n_kv_heads, d_head)
            and kernel_compatible(v_cache, n_kv_heads, d_head)):
        raise ValueError("fused_decode_attention needs kernel-tile caches "
                         "without a staging tail")
    if q.device.type == "cpu":
        return fused_decode_attention_plain(q, k_cache, v_cache, length,
                                            n_kv_heads, d_head)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_attention: unsupported device {q.device}")
    S = kvcache.seq_capacity(k_cache)
    g = n_kv_heads * d_head // 64
    want = {"codes": ((B, g * 32, S), torch.uint8), "meta": ((B, g, S), torch.int32)}
    for cache in (k_cache, v_cache):
        for key, (shape, dt) in want.items():
            t = cache[key]
            if tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous() \
                    or t.device != q.device:
                raise ValueError(f"fused_decode_attention: {key} must be a "
                                 f"contiguous {dt} {shape} on {q.device}")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise TypeError("fused_decode_attention takes a contiguous bf16 q")
    length = length.to(device=q.device, dtype=torch.int32).contiguous()
    if tuple(length.shape) != (B,):
        raise ValueError(f"length must be ({B},), got {tuple(length.shape)}")
    hb = heads_per_block(d_head)
    rep = H // n_kv_heads
    ck = select_kv_block(S)
    p, i = ctypes.c_void_p, ctypes.c_int
    smem = build.function("fused_attention", "fused_decode_attention_smem",
                          [i, i, i, i], ctypes.c_longlong)(
        hb * rep, d_head, hb * d_head, ck)
    if smem > _SMEM_MAX:
        raise ValueError(f"fused_decode_attention: KV tile {ck} needs {smem} B "
                         f"of shared memory (> {_SMEM_MAX})")
    out = torch.empty_like(q)
    fn = build.function("fused_attention", "fused_decode_attention",
                        [p] * 7 + [i] * 7 + [ctypes.c_float, p])
    rc = fn(q.data_ptr(), k_cache["codes"].data_ptr(), k_cache["meta"].data_ptr(),
            v_cache["codes"].data_ptr(), v_cache["meta"].data_ptr(),
            length.data_ptr(), out.data_ptr(), B, n_kv_heads, rep, d_head, S,
            ck, hb, _sqrt_d(d_head), build.stream_ptr(q.device))
    build.check("fused_attention", "fused_decode_attention", rc)
    return out
