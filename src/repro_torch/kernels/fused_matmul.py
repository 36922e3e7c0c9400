"""Kernel 2: fused dequantize-in-kernel packed matmul (the 4.5-bit hot path).

Port of the TPU Pallas kernel ``repro/kernels/fused_matmul.py::
fused_packed_matmul`` as the CUDA kernel ``csrc/fused_matmul.cu``:

  a_ints (M, K) int8, a_scales (M, K/64) f32,
  codes_km (K/2, N) uint8, meta_km (K/64, N) int32 (uint32 bits) -> (M, N) f32

The CTA bodies expand the packed tile to absorbed int8 in shared memory:
``csrc/group_matmul.cuh`` (``__dp4a``) for at most ``DECODE_M_MAX`` rows,
``csrc/group_matmul_sm90.cuh`` (int8 ``wgmma``, kernel 5's body above 32
rows too; launch plan ``bfp_matmul.prefill_plan``) above. Each 64-group's
dot is exact in int32 and rescaled in f32 by ``a_scale * b_scale``, summed
in group order, and written in ``out_dtype`` (f32, or bf16 rounded from
the f32 value as ``.to()`` rounds it). :func:`fused_packed_matmul_plain` is
the plain PyTorch version: the weight expanded by ``hif4.absorbed_int_km``
(the reference's in-kernel unpack), then kernel 5's plain version, then the
cast, so kernel and plain version agree bitwise; :func:`fused_packed_matmul`
takes it only for CPU tensors.

The decode form (M <= ``DECODE_M_MAX`` rows) is the CUDA kernel
``csrc/fused_decode_matmul.cu``, with kernel 1 folded in as its prologue:

  x (M, K) bf16/f32, codes_km, meta_km -> (M, N) bf16/f32

one launch computing bit for bit ``hif4_quantize`` -> ``fused_packed_matmul``
-> ``.to(out_dtype)`` (:func:`fused_decode_matmul_plain`, its plain version).
:func:`decode_plan` is its launch plan (column tile, K split across the
CTAs of a cluster, shared bytes), which the wrapper passes to the kernel and
the kernel checks against its own carve-up of shared memory. A CTA holds its
whole K range in shared memory, so at a K too long for a cluster of 8
(nemotron-4-340b's FFN down-projection, K = 73 728) the plan names the two
launches that replace it: kernel 1, then kernel 2's ``__dp4a`` body, which
walks any K in steps of four 64-groups, bitwise the same function.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import hif4
from repro_torch.kernels import build
from repro_torch.kernels.bfp_matmul import (
    DECODE_M_MAX,
    GROUP,
    H100_SMS,
    SMEM_PER_CTA_MAX,
    bfp_matmul_quantized_plain,
    cuda_tiles,
    prefill_plan,
)
from repro_torch.kernels.hif4_quant import absorbed_activation


_FLOATS = (torch.bfloat16, torch.float32)


def fused_packed_matmul_plain(a_ints, a_scales, codes_km, meta_km,
                              out_dtype=torch.float32):
    """Plain version: unpack the packed weight, then kernel 5's plain
    version, then the cast to ``out_dtype``."""
    return bfp_matmul_quantized_plain(
        a_ints, a_scales, *hif4.absorbed_int_km(codes_km, meta_km)
    ).to(out_dtype)


def _check(a_ints, a_scales, codes_km, meta_km):
    if a_ints.ndim != 2 or codes_km.ndim != 2:
        raise ValueError("fused_packed_matmul takes 2-D operands")
    M, K = a_ints.shape
    half, N = codes_km.shape
    if 2 * half != K or K % GROUP:
        raise ValueError(f"a_ints {tuple(a_ints.shape)} does not match codes "
                         f"{tuple(codes_km.shape)} (K % 64 == 0 required)")
    if tuple(a_scales.shape) != (M, K // GROUP) or \
            tuple(meta_km.shape) != (K // GROUP, N):
        raise ValueError(f"scales {tuple(a_scales.shape)} / meta "
                         f"{tuple(meta_km.shape)} do not match (M, K, N) = "
                         f"{(M, K, N)}")
    want = {"a_ints": (a_ints, torch.int8), "a_scales": (a_scales, torch.float32),
            "codes_km": (codes_km, torch.uint8), "meta_km": (meta_km, torch.int32)}
    for name, (t, dt) in want.items():
        if t.dtype != dt:
            raise TypeError(f"fused_packed_matmul: {name} must be {dt}, got {t.dtype}")
    devices = {t.device for t in (a_ints, a_scales, codes_km, meta_km)}
    if len(devices) != 1:
        raise ValueError(f"fused_packed_matmul: operands on {devices}")
    return M, K, N


def fused_packed_matmul(a_ints, a_scales, codes_km, meta_km,
                        out_dtype=torch.float32) -> torch.Tensor:
    """(M, N) in ``out_dtype`` (f32 or bf16): the CUDA kernel on CUDA
    tensors (M > ``DECODE_M_MAX``: the tensor-core body), the plain version
    on CPU tensors."""
    M, K, N = _check(a_ints, a_scales, codes_km, meta_km)
    if out_dtype not in _FLOATS:
        raise TypeError(f"fused_packed_matmul gives bf16/f32, not {out_dtype}")
    dev = a_ints.device
    if dev.type == "cpu":
        return fused_packed_matmul_plain(a_ints, a_scales, codes_km, meta_km,
                                         out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_packed_matmul: unsupported device {dev}")
    if M == 0 or N == 0:
        raise ValueError(f"fused_packed_matmul: no work for (M, K, N) = "
                         f"{(M, K, N)}")
    for t in (a_ints, a_scales, codes_km, meta_km):
        if not t.is_contiguous():
            raise ValueError("fused_packed_matmul needs contiguous operands")
    regime = 0 if M <= DECODE_M_MAX else 1
    if regime and (a_ints.data_ptr() % 16 or codes_km.data_ptr() % 16):
        raise ValueError("fused_packed_matmul: a_ints and codes_km must be "
                         "16-byte aligned")
    plan = prefill_plan(M, K, N, "packed").c_plan() if regime else None
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("fused_matmul", "fused_packed_matmul",
                        [p, p, p, p, p, i, i, i, i, ctypes.POINTER(i), i, p])
    rc = fn(a_ints.data_ptr(), a_scales.data_ptr(), codes_km.data_ptr(),
            meta_km.data_ptr(), out.data_ptr(), M, N, K, regime, plan,
            int(out_dtype == torch.bfloat16), build.stream_ptr(dev))
    build.check("fused_matmul", "fused_packed_matmul", rc, (M, K, N))
    return out


# ---------------------------------------------------------------------------
# the decode form, with kernel 1 as its prologue
# ---------------------------------------------------------------------------

DECODE_TILE_N = 32          # columns per CTA: 16-byte code row pieces
DECODE_MAX_SPLIT = 8        # the largest portable thread block cluster
_DECODE_B_STRIDE = 17       # int32 words per expanded column


# the launches of a decode linear: the decode form, or where its K range does
# not fit a CTA's shared memory, kernel 1 then kernel 2's __dp4a body
DECODE_FORM = ("fused_decode_matmul",)
DECODE_TWO_LAUNCHES = ("hif4_quantize", "fused_packed_matmul")


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How a linear of at most ``DECODE_M_MAX`` rows launches. ``kernels``
    ``DECODE_FORM``: :func:`fused_decode_matmul`, ``grid`` CTAs in clusters
    of ``split`` that share one column tile of ``tile_n`` and split its K
    axis, each with ``smem_bytes`` of dynamic shared memory.
    ``DECODE_TWO_LAUNCHES``: kernel 1, then kernel 2's ``__dp4a`` body with
    ``grid`` column tiles of ``tile_n`` (``split`` 1, static shared memory
    only, so ``smem_bytes`` 0)."""

    tile_n: int
    split: int
    grid: int
    smem_bytes: int
    kernels: tuple = DECODE_FORM

    @property
    def one_launch(self) -> bool:
        return self.kernels == DECODE_FORM


def _r16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _decode_smem_bytes(m: int, groups: int, split: int, gm: int) -> int:
    """csrc/fused_decode_matmul.cu's ``layout``: code rows, meta words, the
    quantized rows (two padding words each), their scales, the expanded
    columns, and the f32 terms of the outputs whose sum the CTA owns (every
    group's)."""
    t = DECODE_TILE_N
    per = -(-m * t // split)
    return (_r16(gm * 32 * t) + _r16(gm * t * 4) + _r16(m * (gm * 16 + 2) * 4)
            + _r16(m * gm * 4) + _r16(gm * t * _DECODE_B_STRIDE * 4)
            + _r16(groups * per * 4))


@functools.lru_cache(maxsize=None)
def decode_plan(m: int, k: int, n: int) -> DecodePlan:
    """Column tiles of 32; the K split doubles (up to 8 CTAs per cluster, at
    least one 64-group each) until the grid holds two CTAs per SM of the
    H100 (at N = 1024 the cluster of 8 stops it at 256 CTAs), and further
    while a CTA's shared memory exceeds 227 KB. Where even the largest split
    does not fit, the plan is ``DECODE_TWO_LAUNCHES``."""
    if not 1 <= m <= DECODE_M_MAX or k < GROUP or k % GROUP or n < 1:
        raise ValueError(f"the decode form takes 1 <= M <= {DECODE_M_MAX}, "
                         f"K % 64 == 0 and N >= 1, got (M, K, N) = {(m, k, n)}")
    groups = k // GROUP
    tiles = -(-n // DECODE_TILE_N)
    split = 1
    while (split < DECODE_MAX_SPLIT and 2 * split <= groups
           and tiles * split < 2 * H100_SMS):
        split *= 2
    while True:
        smem = _decode_smem_bytes(m, groups, split, -(-groups // split))
        if smem <= SMEM_PER_CTA_MAX:
            return DecodePlan(DECODE_TILE_N, split, tiles * split, smem)
        if split == DECODE_MAX_SPLIT or 2 * split > groups:
            tile_n = cuda_tiles(m)[1]
            return DecodePlan(tile_n, 1, -(-n // tile_n), 0,
                              DECODE_TWO_LAUNCHES)
        split *= 2


def fused_decode_matmul_plain(x, codes_km, meta_km, out_dtype=None):
    """Plain version: kernel 1's and kernel 2's plain versions, then the
    cast to ``out_dtype`` (default x.dtype)."""
    ai, asc = absorbed_activation(x)
    y = fused_packed_matmul_plain(ai, asc, codes_km, meta_km)
    return y.to(out_dtype or x.dtype)


def fused_decode_matmul(x, codes_km, meta_km, out_dtype=None) -> torch.Tensor:
    """(M, N) in ``out_dtype`` (default x.dtype): the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. Counted as a launch of
    ``fused_packed_matmul`` (kernel 2 in either form) and of
    ``fused_decode_matmul``."""
    out_dtype = out_dtype or x.dtype
    if x.ndim != 2 or codes_km.ndim != 2 or meta_km.ndim != 2:
        raise ValueError("fused_decode_matmul takes 2-D operands")
    M, K = x.shape
    half, N = codes_km.shape
    if 2 * half != K or K % GROUP or meta_km.shape != (K // GROUP, N):
        raise ValueError(f"x {tuple(x.shape)} does not match codes "
                         f"{tuple(codes_km.shape)} / meta {tuple(meta_km.shape)}"
                         f" (K % 64 == 0 required)")
    if x.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise TypeError(f"fused_decode_matmul takes and gives bf16/f32, got "
                        f"{x.dtype} -> {out_dtype}")
    if codes_km.dtype != torch.uint8 or meta_km.dtype != torch.int32:
        raise TypeError(f"fused_decode_matmul: codes_km must be uint8 and "
                        f"meta_km int32, got {codes_km.dtype}, {meta_km.dtype}")
    if not x.device == codes_km.device == meta_km.device:
        raise ValueError(f"fused_decode_matmul: operands on {x.device}, "
                         f"{codes_km.device}, {meta_km.device}")
    dev = x.device
    if dev.type == "cpu":
        return fused_decode_matmul_plain(x, codes_km, meta_km, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_decode_matmul: unsupported device {dev}")
    if M == 0 or N == 0:
        raise ValueError(f"fused_decode_matmul: no work for (M, K, N) = "
                         f"{(M, K, N)}")
    for t in (x, codes_km, meta_km):
        if not t.is_contiguous():
            raise ValueError("fused_decode_matmul needs contiguous operands")
        if t.data_ptr() % 16:
            raise ValueError("fused_decode_matmul: operands must be 16-byte "
                             "aligned")
    plan = decode_plan(M, K, N)
    if not plan.one_launch:
        raise ValueError(f"the decode form does not fit (M, K, N) = "
                         f"{(M, K, N)} in {SMEM_PER_CTA_MAX} B of shared memory "
                         f"per CTA; its route is {' then '.join(plan.kernels)}")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("fused_decode_matmul", "fused_decode_matmul",
                        [p, p, p, p, i, i, i, i, i, i, i, p])
    rc = fn(x.data_ptr(), codes_km.data_ptr(), meta_km.data_ptr(),
            out.data_ptr(), M, N, K, plan.split, plan.smem_bytes,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            build.stream_ptr(dev))
    build.check("fused_decode_matmul", "fused_decode_matmul", rc, (M, K, N))
    build.count_launch("fused_packed_matmul")
    return out
