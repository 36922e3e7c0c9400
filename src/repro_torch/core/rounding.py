"""Low-level rounding/encoding primitives for the HiF4 format (S1P2, E6M2).

Port of ``repro/core/rounding.py``. Everything rounds to nearest even
(``torch.round`` is RNE). Quantizers take float32 tensors and return float32
tensors holding the exact representable value of the target format; the
encode/decode helpers map values <-> bit patterns for the packed path.

Powers of two are built from the float32 exponent field (:func:`pow2`), never
with ``exp2`` or a float power: the scales must sit exactly on the
power-of-two grid. The E2M1, E4M3 and E8M0 helpers come with the NVFP4/MXFP4
formats.
"""
from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# Generic helpers
# ---------------------------------------------------------------------------


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 -> nearest bfloat16 (RNE), returned as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _binade_exponent(ax: torch.Tensor) -> torch.Tensor:
    """floor(log2(ax)) computed exactly via frexp; ax must be > 0 where used."""
    _, e = torch.frexp(ax)          # ax = m * 2**e, m in [0.5, 1)
    return e.to(torch.int32) - 1


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2**e (float32) for integer e in the normal range [-126, 127],
    built by writing the exponent field."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _rne_on_quantum(ax: torch.Tensor, quantum: torch.Tensor) -> torch.Tensor:
    """Round |x| to the nearest multiple of ``quantum`` (RNE)."""
    return torch.round(ax / quantum) * quantum


# ---------------------------------------------------------------------------
# S1P2 (HiF4 in-group element: sign-magnitude, 1 integer + 2 fraction bits)
# grid: +-{0.00, 0.25, ..., 1.75}
# ---------------------------------------------------------------------------

S1P2_MAX = 1.75
S1P2_STEP = 0.25


def quantize_s1p2(x: torch.Tensor) -> torch.Tensor:
    q = torch.round(x / S1P2_STEP) * S1P2_STEP
    return torch.clamp(q, -S1P2_MAX, S1P2_MAX)


def encode_s1p2(v: torch.Tensor) -> torch.Tensor:
    """Value on the S1P2 grid -> 4-bit code (uint8): sign<<3 | quarters.
    A negative zero keeps its sign bit, as in the reference."""
    sign = (v < 0) | ((v == 0) & torch.signbit(v))
    mag = torch.round(torch.abs(v) / S1P2_STEP).to(torch.uint8)
    return (sign.to(torch.uint8) << 3) | mag


def decode_s1p2(code: torch.Tensor) -> torch.Tensor:
    neg = ((code >> 3) & 1).bool()
    sign = torch.where(neg, -1.0, 1.0)
    mag = (code & 0x7).to(torch.float32) * S1P2_STEP
    return sign * mag


def s1p2_to_int(v: torch.Tensor) -> torch.Tensor:
    """Value on the S1P2 grid -> signed integer quarters in [-7, 7]."""
    return torch.round(v / S1P2_STEP).to(torch.int8)


# ---------------------------------------------------------------------------
# Unsigned FP8 E6M2 (HiF4 level-1 scale)
# bias 48, exponent in [-48, 15], hidden bit 1, no zero/inf/subnormals.
# Encoding 0b111111_11 is NaN, so the max *value* is 2^15 * 1.50.
# ---------------------------------------------------------------------------

E6M2_BIAS = 48
E6M2_MIN = 2.0 ** -48            # 000000_00
E6M2_MAX = (2.0 ** 15) * 1.50    # 111111_10 (111111_11 is NaN)
E6M2_NAN_BITS = 0xFF


def round_e6m2(x: torch.Tensor) -> torch.Tensor:
    """Round positive float32 -> nearest representable E6M2 value.

    Values below the minimum clamp to 2^-48 (the format has no zero); values
    above the max clamp to 2^15*1.5 (the all-ones pattern is NaN, never
    produced here).
    """
    ax = torch.clamp_min(torch.abs(x), E6M2_MIN)
    eb = torch.clamp(_binade_exponent(ax), -E6M2_BIAS, 15)
    q = _rne_on_quantum(ax, pow2(eb - 2))
    return torch.clamp(q, E6M2_MIN, E6M2_MAX)


def encode_e6m2(v: torch.Tensor) -> torch.Tensor:
    """Value on the E6M2 grid -> 8-bit code (uint8): (e+48)<<2 | m."""
    eb = _binade_exponent(v)
    m = torch.round((v / pow2(eb) - 1.0) * 4.0)
    return (((eb + E6M2_BIAS) << 2) | m.to(torch.int32)).to(torch.uint8)


def decode_e6m2(code: torch.Tensor) -> torch.Tensor:
    c = code.to(torch.int32)
    eb = (c >> 2) - E6M2_BIAS
    m = (c & 0x3).to(torch.float32)
    val = pow2(eb) * (1.0 + m * 0.25)
    return torch.where(c == E6M2_NAN_BITS, torch.nan, val)


def e6m2_reciprocal_bf16(v: torch.Tensor) -> torch.Tensor:
    """The paper's E6M2_REC_to_BF16 instruction: RNE(1/v) in bf16."""
    return round_bf16(1.0 / v)
