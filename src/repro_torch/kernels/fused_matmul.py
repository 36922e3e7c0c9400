"""Kernel 2: fused dequantize-in-kernel packed matmul (the 4.5-bit hot path).

Port of the TPU Pallas kernel ``repro/kernels/fused_matmul.py::
fused_packed_matmul`` as the CUDA kernel ``csrc/fused_matmul.cu``:

  a_ints (M, K) int8, a_scales (M, K/64) f32,
  codes_km (K/2, N) uint8, meta_km (K/64, N) int32 (uint32 bits) -> (M, N) f32

Each 64-group's dot is exact in int32 and rescaled once in f32 by
``a_scale * b_scale``; only the f32 sum over groups may take another order.
:func:`fused_packed_matmul_plain` is the plain PyTorch version (a
transcription of the reference's ``fused_packed_matmul_xla``: one
group-batched float32 GEMM of the exact integers, then the rescale summed
over groups); :func:`fused_packed_matmul` takes it only for CPU tensors.
:func:`select_block_sizes` keeps the reference's per-regime tiles (decode
M <= 32 vs prefill) for the dispatch report; :func:`cuda_tiles` names the
tiles the CUDA kernel uses in each regime.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hif4
from repro_torch.kernels import build

GROUP = 64
# Decode M (a batch of single-token rows) vs prefill M regime boundary.
DECODE_M_MAX = 32


def _fit(dim: int, want: int, quantum: int) -> int:
    """Largest block <= want that divides dim and is a multiple of quantum."""
    b = (want // quantum) * quantum
    while b > quantum and dim % b != 0:
        b -= quantum
    b = max(b, quantum)
    if dim % b:
        raise ValueError(f"no block for dim={dim} (want {want}, quantum {quantum})")
    return b


def select_block_sizes(M: int, N: int, K: int) -> tuple[int, int, int]:
    """The reference's (bm, bn, bk) per regime: decode takes all of M with
    deep-K / wide-N tiles, prefill square-ish 256/256/512 tiles."""
    if M <= DECODE_M_MAX:
        return M, _fit(N, min(512, N), 1), _fit(K, min(1024, K), GROUP)
    return (_fit(M, min(256, M), 1), _fit(N, min(256, N), 1),
            _fit(K, min(512, K), GROUP))


def cuda_tiles(M: int) -> tuple[int, int, int]:
    """(BM, BN, 64-groups staged per step) of the CUDA kernel for this M."""
    if M <= 16:
        return 16, 32, 4
    if M <= DECODE_M_MAX:
        return 32, 32, 4
    return 64, 64, 2


def _tile_group_dot(a, asc, b, bsc):
    """All 64-groups in one batched contraction (reference
    ``bfp_matmul._tile_group_dot``): a (M, K) int8, asc (M, K/64) f32,
    b (K, N) int8, bsc (K/64, N) f32 -> (M, N) f32. The group dots run as a
    float32 GEMM of integers (|product| <= 784, group sums < 2^24: exact)."""
    M, K = a.shape
    g = K // GROUP
    a3 = a.reshape(M, g, GROUP).to(torch.float32).transpose(0, 1)  # (g, M, 64)
    b3 = b.reshape(g, GROUP, -1).to(torch.float32)                 # (g, 64, N)
    part = torch.bmm(a3, b3)                                       # (g, M, N)
    scaled = part * asc.T[:, :, None] * bsc[:, None, :]
    return torch.sum(scaled, dim=0)


def group_partials(a_ints: torch.Tensor, codes_km: torch.Tensor,
                   meta_km: torch.Tensor) -> torch.Tensor:
    """(K/64, M, N) int32: the exact integer dot of every 64-group."""
    M, K = a_ints.shape
    b_ints, _ = hif4.absorbed_int_km(codes_km, meta_km)
    g = K // GROUP
    a3 = a_ints.reshape(M, g, GROUP).to(torch.float32).transpose(0, 1)
    part = torch.bmm(a3, b_ints.reshape(g, GROUP, -1).to(torch.float32))
    return part.to(torch.int32)


def fused_packed_matmul_plain(a_ints, a_scales, codes_km, meta_km):
    """Plain version: unpack the packed weight, then :func:`_tile_group_dot`."""
    b_ints, b_scales = hif4.absorbed_int_km(codes_km, meta_km)
    return _tile_group_dot(a_ints, a_scales, b_ints, b_scales)


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


def fused_packed_matmul(a_ints, a_scales, codes_km, meta_km) -> torch.Tensor:
    """(M, N) f32: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    M, K, N = _check(a_ints, a_scales, codes_km, meta_km)
    dev = a_ints.device
    if dev.type == "cpu":
        return fused_packed_matmul_plain(a_ints, a_scales, codes_km, meta_km)
    if dev.type != "cuda":
        raise ValueError(f"fused_packed_matmul: unsupported device {dev}")
    for t in (a_ints, a_scales, codes_km, meta_km):
        if not t.is_contiguous():
            raise ValueError("fused_packed_matmul needs contiguous operands")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("fused_matmul", "fused_packed_matmul",
                        [p, p, p, p, p, i, i, i, i, p])
    regime = 0 if M <= DECODE_M_MAX else 1
    rc = fn(a_ints.data_ptr(), a_scales.data_ptr(), codes_km.data_ptr(),
            meta_km.data_ptr(), out.data_ptr(), M, N, K, regime,
            build.stream_ptr(dev))
    build.check("fused_matmul", "fused_packed_matmul", rc)
    return out
