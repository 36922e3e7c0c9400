"""OCP-MXFP4 baseline format (port of ``repro/core/mxfp4.py``).

Group of 32 E2M1 elements + one shared power-of-two E8M0 scale
= 4.25 bits/value. Shared exponent = floor(log2(amax)) - emax(E2M1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rounding as R
from repro_torch.core.grouping import apply_grouped

GROUP_SIZE = 32
BITS_PER_VALUE = 4.25


class MXFP4Groups(NamedTuple):
    scale: torch.Tensor   # (...,)    f32, power of two
    e2m1: torch.Tensor    # (..., 32) f32 on the E2M1 grid


def quantize_groups(v: torch.Tensor) -> MXFP4Groups:
    v = v.to(torch.float32)
    amax = torch.amax(torch.abs(v), dim=-1)
    scale = R.e8m0_scale_from_amax(amax, element_emax=2)
    e2m1 = R.quantize_e2m1(v / scale[..., None])
    return MXFP4Groups(scale=scale, e2m1=e2m1)


def dequantize_groups(g: MXFP4Groups) -> torch.Tensor:
    return g.scale[..., None] * g.e2m1


def qdq(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return apply_grouped(lambda v: dequantize_groups(quantize_groups(v)), x,
                         axis, GROUP_SIZE)
