"""Operations and bytes of the served models' work, from the configuration's
shapes alone, and the card's published peaks.

Whatever implements a piece of work, the same shapes give the same counts,
so a kernel's roofline share and the whole step's share of the peak read
the same work before and after a change to the program. Each input byte is
counted read once and each output byte written once. A family's own work
(its HiF4 linears, its attention or scan, its cache or state) lives in a
module of its own, found by the configuration's ``family`` (``dense.py``,
``ssm.py``), so a new family arrives as a new file.

Peaks: NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): 1 979 TOP/s
int8, 989 TFLOP/s bf16, 3.35 TB/s HBM3.
"""
from __future__ import annotations

import importlib

PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
HIF4_BYTES_PER_VALUE = 0.5625        # 4 bits + 32 bits of metadata per 64


def family(m: dict):
    """The counts module of the model's family: ``packed_linears``,
    ``decode_work``, ``prefill_work``."""
    try:
        return importlib.import_module(f"{__name__}.{m['family']}")
    except ModuleNotFoundError:
        raise ValueError(f"no counts for family {m['family']!r}") from None


def packed_linears(m: dict) -> list:
    """[(site, K, N)] of one layer's HiF4 linears (policy paper-iv)."""
    return family(m).packed_linears(m)


def linear_work(M: int, K: int, N: int) -> tuple:
    """(operations, bytes) of one HiF4 linear of M rows: x bf16 read, the
    packed weight read at 0.5625 B a value, y bf16 written."""
    return 2 * M * K * N, 2 * M * K + HIF4_BYTES_PER_VALUE * K * N + 2 * M * N


def bound_s(ops: float, nbytes: float, peak_ops: float) -> float:
    return max(ops / peak_ops, nbytes / PEAK_BYTES)


def packed_matmul_bound_s(m: dict, M: int) -> float:
    """Least time of every layer's HiF4 linears at M rows, each linear's
    bound taken alone."""
    one = sum(bound_s(*linear_work(M, K, N), PEAK_INT8_OPS)
              for _, K, N in packed_linears(m))
    return m["n_layers"] * one


def _weight_bytes(m: dict, B: int) -> float:
    """Weights read once: the packed linears at their stored size, the bf16
    head (the tied embedding when tied), the B embedding rows gathered."""
    d, V = m["d_model"], m["vocab"]
    lin = sum(HIF4_BYTES_PER_VALUE * K * N for _, K, N in packed_linears(m))
    return m["n_layers"] * lin + 2 * d * V + 2 * B * d


def decode_step(m: dict, B: int, length: int) -> dict:
    """One decode step of a batch of B at ``length`` valid cache tokens
    (after the append)."""
    L, d, V = m["n_layers"], m["d_model"], m["vocab"]
    packed_ops = L * sum(2 * B * K * N for _, K, N in packed_linears(m))
    ops, nbytes = family(m).decode_work(m, B, length)
    return {"packed_ops": packed_ops, "other_ops": 2 * B * d * V + ops,
            "bytes": _weight_bytes(m, B) + nbytes}


def prefill(m: dict, B: int, S: int) -> dict:
    """The prefill of B prompts of S tokens (logits of the last position)."""
    L, d, V = m["n_layers"], m["d_model"], m["vocab"]
    packed_ops = L * sum(2 * B * S * K * N for _, K, N in packed_linears(m))
    ops, nbytes = family(m).prefill_work(m, B, S)
    return {"packed_ops": packed_ops, "other_ops": 2 * B * d * V + ops,
            "bytes": _weight_bytes(m, B * S) + nbytes}


def least_time_s(work: dict) -> float:
    """The larger of the operations' time (HiF4 linears at the int8 peak,
    the rest at the bf16 peak) and the bytes' time."""
    return max(work["packed_ops"] / PEAK_INT8_OPS
               + work["other_ops"] / PEAK_BF16_FLOPS,
               work["bytes"] / PEAK_BYTES)
