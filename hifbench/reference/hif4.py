"""HiF4 quantize-dequantize, frozen for the reference (plain PyTorch).

A copy of the format's Algorithm 1 (BF16 -> HiF4, every bf16 rounding of
the hardware emulated in float32) and its dequantization, as the paper
defines them. It is kept here, apart from the program, so that a change to
the program's format code cannot move the yardstick that judges it.

A HiF4 group is 64 values: an E6M2 scale, 8 level-2 and 16 level-3
micro-exponents and 64 S1P2 elements (sign, 1 integer and 2 fraction bits).
"""
from __future__ import annotations

import torch

GROUP = 64
RECIP7_BF16 = 0.142578125          # (1/7) rounded to bf16
E6M2_BIAS = 48
E6M2_MIN = 2.0 ** -48
E6M2_MAX = (2.0 ** 15) * 1.50


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2**e in float32 for integer e in [-126, 127]."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _binade(ax: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(ax)
    return e.to(torch.int32) - 1


def round_e6m2(x: torch.Tensor) -> torch.Tensor:
    ax = torch.clamp_min(torch.abs(x), E6M2_MIN)
    eb = torch.clamp(_binade(ax), -E6M2_BIAS, 15)
    quantum = pow2(eb - 2)
    q = torch.round(ax / quantum) * quantum
    return torch.clamp(q, E6M2_MIN, E6M2_MAX)


def qdq_groups(v: torch.Tensor) -> torch.Tensor:
    """(..., 64) float32 values -> their HiF4 values (float32)."""
    v = v.to(torch.float32)
    av = torch.abs(v)
    lead = v.shape[:-1]
    v16 = torch.amax(av.reshape(lead + (16, 4)), dim=-1)
    v8 = torch.amax(v16.reshape(lead + (8, 2)), dim=-1)
    vmax = torch.amax(v8, dim=-1)
    sf = round_bf16(round_bf16(vmax) * RECIP7_BF16)
    e6m2 = round_e6m2(sf)
    rec = round_bf16(1.0 / e6m2)[..., None]
    e1_8 = (round_bf16(v8 * rec) > 4.0).to(torch.int32)
    t16 = round_bf16(v16 * rec) * pow2(-torch.repeat_interleave(e1_8, 2, dim=-1))
    e1_16 = (t16 >= 2.0).to(torch.int32)
    shift = (torch.repeat_interleave(e1_8, 8, dim=-1)
             + torch.repeat_interleave(e1_16, 4, dim=-1))
    scaled = round_bf16(v * rec) * pow2(-shift)
    s1p2 = torch.clamp(torch.round(scaled / 0.25) * 0.25, -1.75, 1.75)
    return e6m2[..., None] * pow2(shift) * s1p2


def qdq(x: torch.Tensor, axis: int = -1, rows: int = 1 << 16) -> torch.Tensor:
    """QDQ ``x`` along ``axis`` in groups of 64 (its length a multiple of
    64), in float32, ``rows`` groups' worth of rows at a time."""
    x = torch.movedim(x.to(torch.float32), axis, -1)
    k = x.shape[-1]
    if k % GROUP:
        raise ValueError(f"HiF4 groups: axis of {k} is not a multiple of 64")
    flat = x.reshape(-1, k)
    out = torch.empty_like(flat)
    step = max(1, rows * GROUP // k)
    for r in range(0, flat.shape[0], step):
        part = flat[r:r + step]
        out[r:r + step] = qdq_groups(
            part.reshape(part.shape[0], k // GROUP, GROUP)).reshape(part.shape)
    return torch.movedim(out.reshape(x.shape), -1, axis)


def qdq_kv(x: torch.Tensor) -> torch.Tensor:
    """The HiF4 KV cache's values of (T, Hkv, Dh) keys or values: each
    token's Hkv * Dh features in groups of 64, the remainder held in bf16."""
    t = x.shape[0]
    flat = x.reshape(t, -1).to(torch.float32)
    g = flat.shape[1] // GROUP * GROUP
    body = qdq(flat[:, :g]) if g else flat[:, :0]
    return torch.cat([body, round_bf16(flat[:, g:])], dim=1).reshape(x.shape)
