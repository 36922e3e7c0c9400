"""The SSM family's counts (Mamba-2): its HiF4 linears, the scan and the
conv, the recurrent state."""
from __future__ import annotations


def packed_linears(m: dict) -> list:
    """[(site, K, N)] of one layer's HiF4 linears (policy paper-iv)."""
    d = m["d_model"]
    di = m["expand"] * d
    gn = m["n_groups"] * m["d_state"]
    return [("w_z", d, di), ("w_x", d, di), ("w_b", d, gn), ("w_c", d, gn),
            ("w_dt", d, di // m["head_dim"]), ("w_out", di, d)]


def per_token(m: dict) -> tuple:
    """(operations, state bytes) of one token's scan and conv in one layer:
    the state update and readout (5 H P N) and the conv (2 K C); the state
    in float32, the conv window in bf16."""
    di = m["expand"] * m["d_model"]
    H = di // m["head_dim"]
    C = di + 2 * m["n_groups"] * m["d_state"]
    ops = 5 * H * m["head_dim"] * m["d_state"] + 2 * m["conv_kernel"] * C
    state = 4 * H * m["head_dim"] * m["d_state"] + 2 * (m["conv_kernel"] - 1) * C
    return ops, state


def decode_work(m: dict, B: int, length: int) -> tuple:
    """(operations, bytes) of one decode step's layers besides the linears:
    each sequence's state read and written."""
    ops, state = per_token(m)
    return m["n_layers"] * B * ops, m["n_layers"] * 2 * B * state


def prefill_work(m: dict, B: int, S: int) -> tuple:
    """(operations, bytes) of a prefill's layers besides the linears: the
    scan over every token, the state written."""
    ops, state = per_token(m)
    return m["n_layers"] * B * S * ops, m["n_layers"] * B * state
