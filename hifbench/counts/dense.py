"""The dense family's counts: its HiF4 linears, the HiF4 KV cache and
attention."""
from __future__ import annotations

GROUP = 64


def packed_linears(m: dict) -> list:
    """[(site, K, N)] of one layer's HiF4 linears (policy paper-iv)."""
    d = m["d_model"]
    H, Hkv, Dh, f = m["n_heads"], m["n_kv_heads"], m["d_head"], m["d_ff"]
    out = [("attn.wq", d, H * Dh), ("attn.wk", d, Hkv * Dh),
           ("attn.wv", d, Hkv * Dh), ("attn.wo", H * Dh, d)]
    if m["activation"] == "swiglu":
        return out + [("mlp.wg", d, f), ("mlp.wu", d, f), ("mlp.wo", f, d)]
    return out + [("mlp.wi", d, f), ("mlp.wo", f, d)]


def kv_bytes_per_token(m: dict) -> float:
    """HiF4 KV bytes a token a layer, K and V: 36 B a 64-group, the rest in
    bf16."""
    g, t = divmod(m["n_kv_heads"] * m["d_head"], GROUP)
    return 2 * (g * (32 + 4) + t * 2)


def attention_decode_work(m: dict, B: int, length: int) -> tuple:
    """(operations, bytes) of one layer's decode attention over ``length``
    valid tokens: the packed prefix read once, q read and out written in
    bf16."""
    H, Dh = m["n_heads"], m["d_head"]
    return 4 * B * H * Dh * length, length * B * kv_bytes_per_token(m) + 4 * B * H * Dh


def decode_work(m: dict, B: int, length: int) -> tuple:
    """(operations, bytes) of one decode step's layers besides the linears:
    attention over the cache and the new token's K and V appended."""
    ops, kv = attention_decode_work(m, B, length)
    return m["n_layers"] * ops, m["n_layers"] * (kv + B * kv_bytes_per_token(m))


def prefill_work(m: dict, B: int, S: int) -> tuple:
    """(operations, bytes) of a prefill's layers besides the linears: causal
    attention and the cache written."""
    L = m["n_layers"]
    return (L * 4 * B * m["n_heads"] * m["d_head"] * S * (S + 1) // 2,
            L * B * S * kv_bytes_per_token(m))
