"""Kernel 2: fused dequantize-in-kernel packed matmul (the 4.5-bit hot path).

Port of the TPU Pallas kernel ``repro/kernels/fused_matmul.py::
fused_packed_matmul`` as the CUDA kernel ``csrc/fused_matmul.cu``:

  a_ints (M, K) int8, a_scales (M, K/64) f32,
  codes_km (K/2, N) uint8, meta_km (K/64, N) int32 (uint32 bits) -> (M, N) f32

The CTA body (``csrc/group_matmul.cuh``) is kernel 5's, with a loader that
expands the packed tile to absorbed int8 in shared memory. Each 64-group's
dot is exact in int32 and rescaled in f32 by ``a_scale * b_scale``, summed
in group order. :func:`fused_packed_matmul_plain` is the plain PyTorch
version: the weight expanded by ``hif4.absorbed_int_km`` (the reference's
in-kernel unpack), then kernel 5's plain version, so kernel and plain
version agree bitwise; :func:`fused_packed_matmul` takes it only for CPU
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hif4
from repro_torch.kernels import build
from repro_torch.kernels.bfp_matmul import (
    DECODE_M_MAX,
    GROUP,
    bfp_matmul_quantized_plain,
)


def fused_packed_matmul_plain(a_ints, a_scales, codes_km, meta_km):
    """Plain version: unpack the packed weight, then kernel 5's plain version."""
    return bfp_matmul_quantized_plain(a_ints, a_scales,
                                      *hif4.absorbed_int_km(codes_km, meta_km))


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
