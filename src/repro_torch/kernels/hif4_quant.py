"""Kernel 1: BF16/F32 -> HiF4 absorbed-shift ints (paper Algorithm 1).

Port of the TPU Pallas kernel ``repro/kernels/hif4_quant.py::hif4_quantize``
as the CUDA kernel ``csrc/hif4_quant.cu`` (8 lanes per 64-group; the same
body is the prologue of kernel 2's decode form):

  x (M, K) bf16/f32, K % 64 == 0 -> ints (M, K) int8   S1P2 quarters shifted
                                                       by E1_8 + E1_16 (|q| <= 28)
                                    scales (M, K/64) f32  E6M2 / 4

:func:`absorbed_activation` is its plain PyTorch version (a transcription of
the reference's ``fused_matmul.absorbed_activation``), bitwise equal to it;
:func:`hif4_quantize` takes it only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hif4
from repro_torch.kernels import build

GROUP = 64


def absorbed_activation(x2d: torch.Tensor):
    """Plain version: (M, K) -> (ints (M, K) int8, scales (M, K/64) f32)."""
    M, K = x2d.shape
    g = hif4.quantize_groups(x2d.reshape(M, K // GROUP, GROUP))
    ints, scales = hif4.to_absorbed_int(g)
    return ints.reshape(M, K), scales


def hif4_quantize(x: torch.Tensor):
    """x (M, K) -> (ints, scales): the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.ndim != 2 or x.shape[1] % GROUP:
        raise ValueError(f"hif4_quantize needs (M, K) with K % 64 == 0, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"hif4_quantize takes bf16/f32, got {x.dtype}")
    if x.device.type == "cpu":
        return absorbed_activation(x)
    if x.device.type != "cuda":
        raise ValueError(f"hif4_quantize: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("hif4_quantize needs a contiguous input")
    M, K = x.shape
    ints = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scales = torch.empty((M, K // GROUP), dtype=torch.float32, device=x.device)
    name = "hif4_quantize_bf16" if x.dtype == torch.bfloat16 else "hif4_quantize_f32"
    p = ctypes.c_void_p
    fn = build.function("hif4_quant", name,
                        [p, p, p, ctypes.c_longlong, p])
    rc = fn(x.data_ptr(), ints.data_ptr(), scales.data_ptr(),
            M * K // GROUP, build.stream_ptr(x.device))
    build.check("hif4_quant", "hif4_quantize", rc, (M, K))
    return ints, scales
