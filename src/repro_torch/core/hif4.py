"""HiFloat4 (HiF4) block floating-point format (port of ``repro/core/hif4.py``).

A HiF4 unit = 64 S1P2 elements + 32-bit metadata:
    [ E6M2 scale : 8b | E1_8 micro-exps : 8b | E1_16 micro-exps : 16b ]
Value of element i (1-based):
    V_i = E6M2 * 2^(E1_8[ceil(i/8)] + E1_16[ceil(i/4)]) * S1P2_i

Algorithm 1 (BF16 -> HiF4) with every bf16 hardware rounding emulated in
float32, dequantization, bit-packing (4.5 bits/value) and the integer
"absorbed shift" view of the paper's §III.B, plus the K-major tile helpers
the fused kernels' plain versions use.

Metadata words are held in ``torch.int32`` tensors that carry the uint32 bit
pattern (PyTorch's uint32 supports few operations, on the GPU least of all):
every field is read with a shift AND a mask, so the sign of the int32 never
leaks in. :mod:`repro_torch.interop` converts to and from numpy ``uint32``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rounding as R

GROUP_SIZE = 64
N_E1_8 = 8    # level-2 micro-exponents: one per 8 elements
N_E1_16 = 16  # level-3 micro-exponents: one per 4 elements
BITS_PER_VALUE = 4.5
# E6M2 code 0xFF decodes to NaN on every path; Algorithm 1 never produces
# it, so its presence in packed metadata is corruption.
META_NAN = 0xFF
MAX_POS = (2.0 ** 15 * 1.5) * 4.0 * 1.75   # = 2^18 * 1.3125  (Table II)
MIN_POS = 2.0 ** -48 * 0.25                # = 2^-50           (Table II)
INTRA_MAX = 7.0                            # 2^(1+1) * 1.75 (Alg. 1 line 8)

RECIP7_BF16 = 0.142578125                  # (1/7) rounded to bf16


class HiF4Groups(NamedTuple):
    """Value-level (unpacked) HiF4 representation of shape (..., 64) data."""

    e6m2: torch.Tensor    # (...,)     f32, value on the E6M2 grid
    e1_8: torch.Tensor    # (..., 8)   int32 in {0, 1}
    e1_16: torch.Tensor   # (..., 16)  int32 in {0, 1}
    s1p2: torch.Tensor    # (..., 64)  f32 (bf16 for bf16 input), S1P2 grid


class HiF4Packed(NamedTuple):
    """Bit-packed HiF4: 4.5 bits/value storage (deployment artifact)."""

    codes: torch.Tensor   # (..., 32) uint8 — two 4-bit S1P2 codes per byte
    meta: torch.Tensor    # (...,)    int32 bits of e6m2<<24 | e1_8<<16 | e1_16


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def quantize_groups(v: torch.Tensor) -> HiF4Groups:
    """Algorithm 1: convert (..., 64) bf16/f32 values to HiF4 components.

    Every bf16 step of the hardware is an explicit ``round_bf16`` on float32
    (bf16 x bf16 products are exact in float32, so one rounding equals the
    native bf16 multiply). bf16 inputs return ``s1p2`` in bf16, as the
    reference's native-bf16 path does; the bits agree with the f32 path.
    """
    native_bf16 = v.dtype == torch.bfloat16
    v = v.to(torch.float32)
    av = torch.abs(v)
    lead = v.shape[:-1]

    # Stage 1: three-level tree max reduction (lines 1-7).
    v16 = torch.amax(av.reshape(lead + (16, 4)), dim=-1)        # (..., 16)
    v8 = torch.amax(v16.reshape(lead + (8, 2)), dim=-1)         # (..., 8)
    vmax = torch.amax(v8, dim=-1)                               # (...,)

    # Stage 2: hierarchical scaling metadata (lines 8-14).
    sf = R.round_bf16(R.round_bf16(vmax) * RECIP7_BF16)         # line 8
    e6m2 = R.round_e6m2(sf)                                     # line 9
    rec = R.e6m2_reciprocal_bf16(e6m2)[..., None]               # line 10
    e1_8 = (R.round_bf16(v8 * rec) > 4.0).to(torch.int32)       # line 11
    shift2 = torch.repeat_interleave(e1_8, 2, dim=-1)           # (..., 16)
    t16 = R.round_bf16(v16 * rec) * R.pow2(-shift2)
    e1_16 = (t16 >= 2.0).to(torch.int32)                        # line 13

    # Stage 3: scale and round the 64 elements (lines 15-18).
    shift = (torch.repeat_interleave(e1_8, 8, dim=-1)
             + torch.repeat_interleave(e1_16, 4, dim=-1))       # (..., 64)
    scaled = R.round_bf16(v * rec) * R.pow2(-shift)
    s1p2 = R.quantize_s1p2(scaled)                              # line 18
    if native_bf16:
        s1p2 = s1p2.to(torch.bfloat16)                          # exact
    return HiF4Groups(e6m2=e6m2, e1_8=e1_8, e1_16=e1_16, s1p2=s1p2)


def _element_shift(e1_8: torch.Tensor, e1_16: torch.Tensor) -> torch.Tensor:
    return (torch.repeat_interleave(e1_8, 8, dim=-1)
            + torch.repeat_interleave(e1_16, 4, dim=-1))


def dequantize_groups(g: HiF4Groups) -> torch.Tensor:
    """Equation 2: reconstruct (..., 64) values, exact in the s1p2 dtype
    (the product carries at most 2+3 significant bits)."""
    dt = g.s1p2.dtype
    shift = _element_shift(g.e1_8, g.e1_16)
    scale = g.e6m2.to(dt)[..., None] * R.pow2(shift).to(dt)
    return scale * g.s1p2


def meta_nan_mask(meta: torch.Tensor) -> torch.Tensor:
    """Elementwise True where a packed meta word carries the E6M2 NaN
    sentinel (scale byte == :data:`META_NAN`)."""
    return ((meta >> 24) & 0xFF) == META_NAN


# ---------------------------------------------------------------------------
# Fixed-point ("absorbed shift") view — paper §III.B
# ---------------------------------------------------------------------------


def to_absorbed_int(g: HiF4Groups) -> tuple[torch.Tensor, torch.Tensor]:
    """(ints (..., 64) int8 = S1P2 quarters << (E1_8 + E1_16), |q| <= 28;
    scale (...,) f32 = E6M2 / 4)."""
    quarters = R.s1p2_to_int(g.s1p2).to(torch.int32)
    ints = (quarters << _element_shift(g.e1_8, g.e1_16)).to(torch.int8)
    return ints, g.e6m2 * 0.25


# ---------------------------------------------------------------------------
# K-major ("kernel-tile") bit-layout helpers
# ---------------------------------------------------------------------------
#
#     codes_km (..., K/2, N) uint8   row k2 holds elements 2*k2 (low nibble)
#                                    and 2*k2+1 (high nibble) of column n
#     meta_km  (..., K/64, N) int32  one group record per 64 contraction rows
#
# Leading axes are batch axes (the reference vmaps the 2-D helpers).


def expand_codes_km(codes_km: torch.Tensor) -> torch.Tensor:
    """(..., bk/2, bn) uint8 K-major code bytes -> (..., bk, bn) int32 S1P2
    quarters. Low nibble is the even contraction row."""
    lo = (codes_km & 0xF).to(torch.int32)
    hi = (codes_km >> 4).to(torch.int32)
    *lead, half, bn = codes_km.shape
    c4 = torch.stack([lo, hi], dim=-2).reshape(*lead, half * 2, bn)
    mag = c4 & 0x7
    return torch.where(((c4 >> 3) & 1).bool(), -mag, mag)


def expand_meta_km(meta_km: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., bg, bn) K-major group metadata -> (shift (..., bg*64, bn) int32,
    scale (..., bg, bn) f32 = E6M2 / 4, NaN for the 0xFF code)."""
    *lead, bg, bn = meta_km.shape
    r = torch.arange(GROUP_SIZE, device=meta_km.device, dtype=torch.int32)
    m = meta_km[..., :, None, :]                              # (.., bg, 1, bn)
    s8 = (m >> (16 + r // 8)[:, None]) & 1
    s4 = (m >> (r // 4)[:, None]) & 1
    shift = (s8 + s4).reshape(*lead, bg * GROUP_SIZE, bn)
    code = (meta_km >> 24) & 0xFF
    eb = (code >> 2) - R.E6M2_BIAS
    m2 = (code & 0x3).to(torch.float32)
    scale = R.pow2(eb) * (1.0 + m2 * 0.25) * 0.25
    scale = torch.where(code == META_NAN, torch.nan, scale)
    return shift, scale


def absorbed_int_km(codes_km: torch.Tensor, meta_km: torch.Tensor):
    """K-major packed tile -> (ints (..., bk, bn) int8, scale (..., bk/64, bn)
    f32), bitwise ``to_absorbed_int(unpack_groups(...))`` laid out K-major."""
    quarters = expand_codes_km(codes_km)
    shift, scale = expand_meta_km(meta_km)
    return (quarters << shift).to(torch.int8), scale


def dequantize_km(codes_km: torch.Tensor, meta_km: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """K-major packed buffers -> (..., K, N) dense values (exact in bf16)."""
    ints, scale = absorbed_int_km(codes_km, meta_km)
    scale_k = torch.repeat_interleave(scale, GROUP_SIZE, dim=-2)
    return (scale_k * ints.to(torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# Bit packing (storage at 4.5 bits/value)
# ---------------------------------------------------------------------------


def pack_groups(g: HiF4Groups) -> HiF4Packed:
    codes4 = R.encode_s1p2(g.s1p2)                               # (..., 64)
    codes = codes4[..., 0::2] | (codes4[..., 1::2] << 4)         # (..., 32)
    dev = g.e1_8.device
    e6_bits = R.encode_e6m2(g.e6m2).to(torch.int64)
    w8 = torch.sum(g.e1_8.to(torch.int64)
                   << torch.arange(N_E1_8, device=dev), dim=-1)
    w16 = torch.sum(g.e1_16.to(torch.int64)
                    << torch.arange(N_E1_16, device=dev), dim=-1)
    meta = u32_to_i32((e6_bits << 24) | (w8 << 16) | w16)
    return HiF4Packed(codes=codes, meta=meta)


def quantize_packed(v: torch.Tensor) -> HiF4Packed:
    """Algorithm 1 + bit packing: (..., 64) values -> 4.5-bit storage."""
    return pack_groups(quantize_groups(v))


def unpack_groups(p: HiF4Packed) -> HiF4Groups:
    lo = p.codes & 0xF
    hi = p.codes >> 4
    codes4 = torch.stack([lo, hi], dim=-1).reshape(
        p.codes.shape[:-1] + (GROUP_SIZE,))
    s1p2 = R.decode_s1p2(codes4)
    e6m2 = R.decode_e6m2((p.meta >> 24) & 0xFF)
    dev = p.meta.device
    w8 = (p.meta >> 16) & 0xFF
    w16 = p.meta & 0xFFFF
    e1_8 = (w8[..., None] >> torch.arange(N_E1_8, device=dev,
                                          dtype=torch.int32)) & 1
    e1_16 = (w16[..., None] >> torch.arange(N_E1_16, device=dev,
                                            dtype=torch.int32)) & 1
    return HiF4Groups(e6m2=e6m2, e1_8=e1_8.to(torch.int32),
                      e1_16=e1_16.to(torch.int32), s1p2=s1p2)


def dequantize_packed(p: HiF4Packed) -> torch.Tensor:
    return dequantize_groups(unpack_groups(p))


# ---------------------------------------------------------------------------
# Tensor-level QDQ entry point (axis -> groups of 64)
# ---------------------------------------------------------------------------


def qdq(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Quantize-dequantize ("fake quant") along ``axis`` in groups of 64."""
    from repro_torch.core.grouping import apply_grouped

    return apply_grouped(lambda v: dequantize_groups(quantize_groups(v)),
                         x, axis, GROUP_SIZE)
