"""NVFP4 baseline format (port of ``repro/core/nvfp4.py``).

Group of 16 E2M1 elements + one FP8-E4M3 per-group scale = 4.5 bits/value.
The scale normalizes each group's peak magnitude to 6 (E2M1 max). E4M3
covers only ~22 binades, so direct-cast fails on wide-distribution tensors;
the "+PTS" variant first applies a software per-tensor scale mapping the
tensor peak to 2688 = 448 * 6.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rounding as R
from repro_torch.core.grouping import apply_grouped

GROUP_SIZE = 16
BITS_PER_VALUE = 4.5
MAX_POS = 448.0 * 6.0          # = 2^11 * 1.3125 (Table II)
MIN_POS = 2.0 ** -10           # min subnormal scale * min element (Table II)
PTS_TARGET = 2688.0            # per-tensor scaling target (448 * 6)


class NVFP4Groups(NamedTuple):
    scale: torch.Tensor   # (...,)    f32 on the E4M3 grid
    e2m1: torch.Tensor    # (..., 16) f32 on the E2M1 grid


def quantize_groups(v: torch.Tensor) -> NVFP4Groups:
    v = v.to(torch.float32)
    amax = torch.amax(torch.abs(v), dim=-1)
    scale = R.round_e4m3(amax / R.E2M1_MAX)
    # multiply by the reciprocal, as the reference does (not v / scale)
    inv = torch.where(scale > 0, 1.0 / scale, 0.0)
    e2m1 = R.quantize_e2m1(v * inv[..., None])
    return NVFP4Groups(scale=scale, e2m1=e2m1)


def dequantize_groups(g: NVFP4Groups) -> torch.Tensor:
    return g.scale[..., None] * g.e2m1


def to_absorbed_int(g: NVFP4Groups) -> tuple[torch.Tensor, torch.Tensor]:
    """S3P1 integer view (paper Fig. 4): halves in [-12, 12], scale/2."""
    return R.e2m1_to_int(g.e2m1), g.scale * 0.5


def qdq(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return apply_grouped(lambda v: dequantize_groups(quantize_groups(v)), x,
                         axis, GROUP_SIZE)


def qdq_pts(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """NVFP4 with software per-tensor scaling (the paper's NVFP4+PTS). The
    scale is computed in ``x``'s dtype, then taken to float32, as the
    reference computes it. (``PTS_TARGET / amax`` with a Python float would
    run as ``reciprocal(amax) * PTS_TARGET`` in PyTorch, two roundings: the
    division is spelled tensor / tensor.)"""
    amax = torch.amax(torch.abs(x))
    s = torch.where(amax > 0, torch.full_like(amax, PTS_TARGET) / amax,
                    1.0).to(torch.float32)
    y = qdq(x.to(torch.float32) * s, axis)
    return (y / s).to(x.dtype)
