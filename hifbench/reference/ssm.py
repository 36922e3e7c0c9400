"""The SSM family's block in the reference (Mamba-2): pre-norm, HiF4 input
projections, the causal conv, the SSD recurrence in float32 over the whole
sequence (the prompt in chunks of the configuration's length, served tokens
one step at a time, as the program's chunked prefill and recurrent steps
compute the same sums), the gated norm and the HiF4 output projection."""
from __future__ import annotations

import torch

from .ops import F32, causal_conv, lin, qdq_w, rms, silu, ssd


def block_leaves(m: dict) -> list:
    """(name, per-layer shape[, init[, std[, dtype]]]) of one block's leaves."""
    d = m["d_model"]
    di = m["expand"] * d
    H = di // m["head_dim"]
    gn = m["n_groups"] * m["d_state"]
    K = m["conv_kernel"]
    return [("pre_norm", (d,), "ones"), ("w_z", (d, di)), ("w_x", (d, di)),
            ("w_b", (d, gn)), ("w_c", (d, gn)), ("w_dt", (d, H)),
            ("conv_w_x", (K, di), "normal", 0.2),
            ("conv_b_x", (di,), "zeros"),
            ("conv_w_bc", (K, 2 * gn), "normal", 0.2),
            ("conv_b_bc", (2 * gn,), "zeros"),
            ("a_log", (H,), "zeros", 0.02, "float32"),
            ("dt_bias", (H,), "zeros", 0.02, "float32"),
            ("d_skip", (H,), "ones", 0.02, "float32"),
            ("gate_norm", (di,), "ones"), ("w_out", (di, d))]


def weights(m: dict, raw: dict) -> dict:
    """One layer's drawn leaves, the linears quantized along K."""
    w = {k: v for k, v in raw.items() if not k.startswith("blocks.w_")}
    for name in ("w_z", "w_x", "w_b", "w_c", "w_dt", "w_out"):
        t = raw["blocks." + name]
        w[name] = qdq_w(t, t.shape[0])
    return w


def block(m, w, x, seqs, r):
    d, N = m["d_model"], m["d_state"]
    di = m["expand"] * d
    P = m["head_dim"]
    H = di // P
    eps = m["norm_eps"]
    h = r(rms(x, w["blocks.pre_norm"], eps))
    z = r(lin(h, w["w_z"]))
    xin = r(lin(h, w["w_x"]))
    bc = torch.cat([r(lin(h, w["w_b"])), r(lin(h, w["w_c"]))], dim=-1)
    dt = r(lin(h, w["w_dt"])) + w["blocks.dt_bias"].to(F32)
    dt = torch.logaddexp(dt, torch.zeros((), device=dt.device))   # softplus
    a = -torch.exp(w["blocks.a_log"].to(F32))
    y = torch.empty(x.shape[0], H, P, dtype=F32, device=x.device)
    groups = {}
    for s in seqs:                      # requests of one shape run together
        groups.setdefault((s["n"], s["prompt_len"]), []).append(s["row"])
    for (n, S), starts in groups.items():
        idx = (torch.tensor(starts, device=x.device)[:, None]
               + torch.arange(n, device=x.device)[None, :])     # (G, n)
        xc = causal_conv(xin[idx], w["blocks.conv_w_x"], w["blocks.conv_b_x"], r, S)
        bcc = causal_conv(bc[idx], w["blocks.conv_w_bc"], w["blocks.conv_b_bc"], r, S)
        y[idx] = r(ssd(xc.view(len(starts), n, H, P), dt[idx], a, bcc[..., :N],
                       bcc[..., N:], w["blocks.d_skip"].to(F32), m["chunk"], S))
    g = r(y.view(-1, di) * silu(z))
    return r(x + r(lin(r(rms(g, w["blocks.gate_norm"], eps)), w["w_out"])))
