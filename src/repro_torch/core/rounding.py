"""Low-level rounding/encoding primitives for the HiF4 format (S1P2, E6M2).

Port of ``repro/core/rounding.py``. Everything rounds to nearest even
(``torch.round`` is RNE). Quantizers take float32 tensors and return float32
tensors holding the exact representable value of the target format; the
encode/decode helpers map values <-> bit patterns for the packed path.

Powers of two are built from the float32 exponent field (:func:`pow2`,
:func:`pow2_subnormal`), never with ``exp2`` or a float power: the scales
must sit exactly on the power-of-two grid, on the CPU and on the card alike
(the reference's ``ldexp(1, e)`` is the same exact value).

Subnormals are kept, as IEEE float32 and PyTorch on both devices keep them.
XLA's CPU backend flushes them (inputs and results), so the reference's
E8M0 scale for an amax below 2^-124 differs from this one (ROADMAP §3).
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


def pow2_subnormal(e: torch.Tensor) -> torch.Tensor:
    """Exact 2**e (float32) for integer e in [-149, 127]: below -126 the
    result is the subnormal 2**-126 * 2**(e + 126), exact."""
    e = e.to(torch.int32)
    hi = torch.clamp(e, min=-126)
    return pow2(hi) * pow2(torch.clamp(e - hi, min=-126))


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
# E2M1 (MXFP4 / NVFP4 in-group element)
# grid: +-{0, 0.5, 1, 1.5, 2, 3, 4, 6}
# ---------------------------------------------------------------------------

E2M1_MAX = 6.0
E2M1_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)


def quantize_e2m1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    safe = torch.clamp_min(ax, 2.0 ** -20)      # avoid frexp(0); result unaffected
    eb = torch.clamp(_binade_exponent(safe), 0, 2)
    q = torch.clamp_max(_rne_on_quantum(ax, pow2(eb - 1)), E2M1_MAX)
    return torch.where(x < 0, -q, q)


def encode_e2m1(v: torch.Tensor) -> torch.Tensor:
    """Value on the E2M1 grid -> 4-bit code (uint8): sign<<3 | index 0..7."""
    av = torch.abs(v)
    idx = torch.zeros(v.shape, dtype=torch.uint8, device=v.device)
    for i, val in enumerate(E2M1_VALUES):
        idx = torch.where(av == val, i, idx).to(torch.uint8)
    return ((v < 0).to(torch.uint8) << 3) | idx


def decode_e2m1(code: torch.Tensor) -> torch.Tensor:
    table = torch.tensor(E2M1_VALUES, dtype=torch.float32, device=code.device)
    mag = table[(code & 0x7).long()]
    return torch.where(((code >> 3) & 1).bool(), -mag, mag)


def e2m1_to_int(v: torch.Tensor) -> torch.Tensor:
    """Value on the E2M1 grid -> signed integer halves in [-12, 12]."""
    return torch.round(v / 0.5).to(torch.int8)


# ---------------------------------------------------------------------------
# FP8 E4M3 (OCP "FN" variant used by NVFP4 scales)
# bias 7, normals 2^-6..448, subnormals down to 2^-9, no inf, NaN = S.1111.111
# ---------------------------------------------------------------------------

E4M3_MAX = 448.0
E4M3_MIN_NORMAL = 2.0 ** -6
E4M3_MIN_SUBNORMAL = 2.0 ** -9


def round_e4m3(x: torch.Tensor, saturate: bool = True) -> torch.Tensor:
    ax = torch.abs(x)
    safe = torch.clamp_min(ax, 2.0 ** -40)
    eb = torch.clamp(_binade_exponent(safe), -6, 8)
    q = _rne_on_quantum(ax, pow2(eb - 3))
    if saturate:
        q = torch.clamp_max(q, E4M3_MAX)
    return torch.where(x < 0, -q, q)


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


# ---------------------------------------------------------------------------
# E8M0 power-of-two scale (MXFP4 shared exponent, OCP MX spec)
# ---------------------------------------------------------------------------

E8M0_EXP_MIN = -127
E8M0_EXP_MAX = 127


def e8m0_scale_from_amax(amax: torch.Tensor, element_emax: int = 2
                         ) -> torch.Tensor:
    """OCP MX shared scale: 2^(floor(log2(amax)) - emax_elem), clamped.

    ``element_emax`` is the exponent of the element format's max value
    (E2M1 max = 6 -> emax 2). amax == 0 maps to scale 1. The clamp reaches
    2^-127, a float32 subnormal (:func:`pow2_subnormal`).
    """
    safe = torch.clamp_min(amax, 2.0 ** -126)
    e = torch.clamp(_binade_exponent(safe) - element_emax, E8M0_EXP_MIN,
                    E8M0_EXP_MAX)
    return torch.where(amax > 0, pow2_subnormal(e), 1.0)
