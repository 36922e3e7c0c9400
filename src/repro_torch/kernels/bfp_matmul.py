"""Kernel 5: group-scaled int8 x int8 matmul on pre-quantized HiF4 operands
(paper §III.B: the micro-exponents are left shifts, so a 64-length dot is
integer work with one float multiply per group).

Port of the TPU Pallas kernel ``repro/kernels/bfp_matmul.py::
bfp_matmul_quantized`` as the CUDA kernel ``csrc/bfp_matmul.cu``:

  a_ints (M, K) int8, a_scales (M, K/64) f32,
  b_ints (K, N) int8, b_scales (K/64, N) f32 -> (M, N) f32
      = sum over 64-groups g of float(int32 dot_g) * a_scale * b_scale

The CUDA body (``csrc/group_matmul.cuh``) is kernel 2's, with a loader that
reads int8 words instead of expanding packed codes, so kernel 5 on the
absorbed expansion of a packed weight is bitwise kernel 2 on it. The kernel
reads B K-contiguous per column: a transposed view of a contiguous (N, K)
tensor (what the engine passes: ``hif4_quantize(w.T)`` transposed back)
launches on its storage without a copy; a row-major (K, N) operand is
copied once into that layout.

:func:`bfp_matmul_quantized_plain` is the plain PyTorch version (the
reference's ``_tile_group_dot``: exact int32 group dots, then the f32
rescale), summed in group order with the kernel's rounding steps, so kernel
and plain version agree bitwise; :func:`bfp_matmul_quantized` takes it only
for CPU tensors. The plain version of kernel 2 is this one on the expanded
weight. :func:`select_block_sizes` keeps the reference's per-regime tiles for
the dispatch report; :func:`cuda_tiles` names the CUDA kernels' tiles.
"""
from __future__ import annotations

import ctypes

import torch

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
    """(BM, BN, 64-groups staged per step) of kernels 2 and 5 for this M."""
    if M <= 16:
        return 16, 32, 4
    if M <= DECODE_M_MAX:
        return 32, 32, 4
    return 64, 64, 2


def _group_dot(a_ints: torch.Tensor, b_ints: torch.Tensor, g: int
               ) -> torch.Tensor:
    """(M, N) float32 holding the exact int32 dot of 64-group ``g``: a
    float32 GEMM of integers (|product| <= 784, sums < 2^24: exact in any
    order)."""
    k = slice(g * GROUP, (g + 1) * GROUP)
    return a_ints[:, k].to(torch.float32) @ b_ints[k].to(torch.float32)


def group_partials(a_ints: torch.Tensor, b_ints: torch.Tensor) -> torch.Tensor:
    """(K/64, M, N) int32: the exact integer dot of every 64-group."""
    return torch.stack([_group_dot(a_ints, b_ints, g).to(torch.int32)
                        for g in range(a_ints.shape[1] // GROUP)])


def bfp_matmul_quantized_plain(a_ints, a_scales, b_ints, b_scales):
    """Plain version: ``acc += (dot_g * a_scale) * b_scale`` over the groups
    in order, each product and sum rounded to float32 (the kernel's
    ``__fmul_rn`` / ``__fadd_rn``)."""
    M, K = a_ints.shape
    acc = torch.zeros((M, b_ints.shape[1]), dtype=torch.float32,
                      device=a_ints.device)
    for g in range(K // GROUP):
        part = _group_dot(a_ints, b_ints, g)
        acc = acc + (part * a_scales[:, g, None]) * b_scales[None, g, :]
    return acc


def _check(a_ints, a_scales, b_ints, b_scales):
    if a_ints.ndim != 2 or b_ints.ndim != 2:
        raise ValueError("bfp_matmul_quantized takes 2-D operands")
    M, K = a_ints.shape
    K2, N = b_ints.shape
    if K2 != K or K % GROUP:
        raise ValueError(f"a_ints {tuple(a_ints.shape)} does not match b_ints "
                         f"{tuple(b_ints.shape)} (K % 64 == 0 required)")
    if tuple(a_scales.shape) != (M, K // GROUP) or \
            tuple(b_scales.shape) != (K // GROUP, N):
        raise ValueError(f"scales {tuple(a_scales.shape)} / "
                         f"{tuple(b_scales.shape)} do not match (M, K, N) = "
                         f"{(M, K, N)}")
    want = {"a_ints": (a_ints, torch.int8), "a_scales": (a_scales, torch.float32),
            "b_ints": (b_ints, torch.int8), "b_scales": (b_scales, torch.float32)}
    for name, (t, dt) in want.items():
        if t.dtype != dt:
            raise TypeError(f"bfp_matmul_quantized: {name} must be {dt}, got {t.dtype}")
    devices = {t.device for t in (a_ints, a_scales, b_ints, b_scales)}
    if len(devices) != 1:
        raise ValueError(f"bfp_matmul_quantized: operands on {devices}")
    return M, K, N


def _k_contiguous(t: torch.Tensor, name: str) -> torch.Tensor:
    """A (K, N) operand as (N, K) storage, K contiguous per column: a
    transposed view of a contiguous tensor as it is, a row-major one copied."""
    if t.T.is_contiguous():
        return t.T
    if t.is_contiguous():
        return t.T.contiguous()
    raise ValueError(f"bfp_matmul_quantized: {name} must be row-major or the "
                     f"transpose of a contiguous tensor, got strides {t.stride()}")


def bfp_matmul_quantized(a_ints, a_scales, b_ints, b_scales) -> torch.Tensor:
    """(M, N) f32: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    M, K, N = _check(a_ints, a_scales, b_ints, b_scales)
    dev = a_ints.device
    if dev.type == "cpu":
        return bfp_matmul_quantized_plain(a_ints, a_scales, b_ints, b_scales)
    if dev.type != "cuda":
        raise ValueError(f"bfp_matmul_quantized: unsupported device {dev}")
    if M == 0 or N == 0 or K == 0:
        raise ValueError(f"bfp_matmul_quantized: no work for (M, K, N) = "
                         f"{(M, K, N)}")
    if not (a_ints.is_contiguous() and a_scales.is_contiguous()):
        raise ValueError("bfp_matmul_quantized needs contiguous a_ints, a_scales")
    b_nk = _k_contiguous(b_ints, "b_ints")
    bs_nk = _k_contiguous(b_scales, "b_scales")
    if a_ints.data_ptr() % 4 or b_nk.data_ptr() % 4:
        raise ValueError("bfp_matmul_quantized: int8 operands must be 4-byte aligned")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("bfp_matmul", "bfp_matmul_quantized",
                        [p, p, p, p, p, i, i, i, i, p])
    regime = 0 if M <= DECODE_M_MAX else 1
    rc = fn(a_ints.data_ptr(), a_scales.data_ptr(), b_nk.data_ptr(),
            bs_nk.data_ptr(), out.data_ptr(), M, N, K, regime,
            build.stream_ptr(dev))
    build.check("bfp_matmul", "bfp_matmul_quantized", rc)
    return out
