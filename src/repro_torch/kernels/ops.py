"""User-facing HiF4 A-W quantized matmul over the kernels (port of
``repro/kernels/ops.py``): kernel 1 quantizes the activations; at most
``DECODE_M_MAX`` rows the decode form of kernel 5 quantizes the weight in
its loader and contracts (two launches), above kernel 1 quantizes the
weight too and kernel 5 contracts (three). On CPU tensors their plain
versions run, bitwise the same."""
from __future__ import annotations

import torch

from repro_torch.kernels.bfp_matmul import (
    DECODE_M_MAX,
    bfp_decode_matmul,
    bfp_matmul_quantized,
)
from repro_torch.kernels.hif4_quant import hif4_quantize


def quantize(x: torch.Tensor):
    """BF16/F32 (M, K) -> HiF4 absorbed layout (ints int8, scales f32)."""
    return hif4_quantize(x.contiguous())


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) f32: both operands quantized along K
    (Algorithm 1), contracted by the fixed-point kernel (§III.B). ``w`` is
    quantized through its transpose; when ``w`` is itself a transposed view
    (the tied LM head's ``embed.T``) neither quantization nor contraction
    copies it. Which route a call takes depends on M alone: the decode form
    for at most ``DECODE_M_MAX`` rows, kernels 1 and 5 above."""
    ai, ascale = hif4_quantize(x.contiguous())
    if x.shape[0] <= DECODE_M_MAX:
        return bfp_decode_matmul(ai, ascale, w)
    wi, wscale = hif4_quantize(w.T.contiguous())
    return bfp_matmul_quantized(ai, ascale, wi.T, wscale.T)


def matmul_prequantized(x: torch.Tensor, wi: torch.Tensor,
                        wscale: torch.Tensor) -> torch.Tensor:
    """Dynamic activation quantization x an offline-quantized weight
    (wi (K, N) int8, wscale (K/64, N) f32)."""
    ai, ascale = hif4_quantize(x.contiguous())
    return bfp_matmul_quantized(ai, ascale, wi, wscale)
