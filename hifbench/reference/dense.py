"""The dense family's block in the reference: pre-norm attention (RoPE on
the whole head, grouped KV) and an MLP (SwiGLU, squared ReLU or GELU), every
linear HiF4. A prompt's queries see its unquantized keys and values (the
prefill); a served token's query sees HiF4 keys and values (the packed KV
cache, its remainder of Hkv * Dh mod 64 features in bf16)."""
from __future__ import annotations

import torch

from .hif4 import qdq_kv
from .ops import decode_attention, lin, prefill_attention, qdq_w, rms, rope, silu

ROWS = 8192                          # rows of the FFN at a time


def block_leaves(m: dict) -> list:
    """(name, per-layer shape[, init[, std[, dtype]]]) of one block's leaves."""
    if m.get("qkv_bias") or m.get("qk_norm"):
        raise ValueError("the dense reference has no QKV bias or qk-norm")
    d, H, Hkv, Dh, f = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                        m["d_head"], m["d_ff"])
    out = [("attn.wq", (d, H, Dh)), ("attn.wk", (d, Hkv, Dh)),
           ("attn.wv", (d, Hkv, Dh)), ("attn.wo", (H, Dh, d)),
           ("norm1.w", (d,), "ones"), ("norm2.w", (d,), "ones")]
    if m["activation"] == "swiglu":
        return out + [("mlp.wg", (d, f)), ("mlp.wu", (d, f)), ("mlp.wo", (f, d))]
    return out + [("mlp.wi", (d, f)), ("mlp.wo", (f, d))]


def weights(m: dict, raw: dict) -> dict:
    """One layer's drawn leaves, the linears quantized along K."""
    d, H, Dh = m["d_model"], m["n_heads"], m["d_head"]
    w = {"blocks.norm1.w": raw["blocks.norm1.w"],
         "blocks.norm2.w": raw["blocks.norm2.w"]}
    for name in ("wq", "wk", "wv"):
        w[name] = qdq_w(raw["blocks.attn." + name], d)
    w["wo"] = qdq_w(raw["blocks.attn.wo"], H * Dh)
    for name in ("wi", "wg", "wu", "wo"):
        t = raw.get("blocks.mlp." + name)
        if t is not None:
            w["mlp." + name] = qdq_w(t, t.shape[0])
    return w


def block(m, w, x, seqs, r):
    H, Hkv, Dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    eps = m["norm_eps"]
    h = r(rms(x, w["blocks.norm1.w"], eps))
    q = r(lin(h, w["wq"])).view(-1, H, Dh)
    k = r(lin(h, w["wk"])).view(-1, Hkv, Dh)
    v = r(lin(h, w["wv"])).view(-1, Hkv, Dh)
    o = torch.empty_like(q)
    for s in seqs:
        r0, n, S = s["row"], s["n"], s["prompt_len"]
        qs = r(rope(q[r0:r0 + n], m["rope_theta"]))
        ks = r(rope(k[r0:r0 + n], m["rope_theta"]))
        vs = v[r0:r0 + n]
        o[r0:r0 + S] = prefill_attention(qs[:S], ks[:S], vs[:S], r, m["attn_tiles"])
        if n > S:                    # served tokens read the HiF4 KV cache
            o[r0 + S:r0 + n] = decode_attention(qs[S:], qdq_kv(ks), qdq_kv(vs), S,
                                                S + s["served"], r)
    x = r(x + r(lin(r(o).view(-1, H * Dh), w["wo"])))
    return torch.cat([_mlp(m, w, x[a:a + ROWS], r)
                      for a in range(0, x.shape[0], ROWS)])


def _mlp(m, w, x, r):
    h = r(rms(x, w["blocks.norm2.w"], m["norm_eps"]))
    if m["activation"] == "swiglu":
        g = r(lin(h, w["mlp.wg"]))
        f = r(silu(g) * r(lin(h, w["mlp.wu"])))
    else:
        f = r(lin(h, w["mlp.wi"]))
        if m["activation"] == "squared_relu":
            f = r(torch.square(torch.relu(f)))
        else:
            f = r(torch.nn.functional.gelu(f, approximate="tanh"))
    return r(x + r(lin(f, w["mlp.wo"])))
