"""The pieces of the plain reference: roundings, the HiF4 linear, RoPE, the
two attention forms, the causal conv and the SSD recurrence. Float32 with
TF32 off; ``r`` rounds to the stored precision where a piece stores.
Nothing here imports the program."""
from __future__ import annotations

import torch

from .hif4 import qdq

F32 = torch.float32


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")



def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even), kept in float32."""
    return x.to(torch.bfloat16).to(F32)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """Round to fp8 e4m3 with one scale per row (the last axis), kept in
    float32."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.to(F32)


def lin(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A HiF4 linear: the activations quantized along K; ``w`` (K, N) is
    already quantized along K. Products are exact in float32 and summed
    there."""
    return qdq(x) @ w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (n, heads, D) at positions 0 .. n-1 (the rotate-half form)."""
    n, _, D = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=F32, device=x.device) / D))
    ang = torch.arange(n, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


NEG = -1e30                          # a masked score


def prefill_attention(q, k, v, r, chunk: tuple) -> torch.Tensor:
    """Causal attention of a prompt, q (S, H, D) over k, v (S, Hkv, D), as
    the configuration's flash tiles compute it: query tiles of ``chunk[0]``
    over key tiles of ``chunk[1]`` (each cut to S), an online softmax whose
    unnormalized weights are held in the stored precision ``r`` before they
    weigh the values; sums in float32."""
    S, H, D = q.shape
    rep = H // k.shape[1]
    cq, ck = min(chunk[0], S), min(chunk[1], S)
    if S % cq or S % ck:
        raise ValueError(f"prompt of {S} does not split into tiles {chunk}")
    kk = k.repeat_interleave(rep, dim=1)
    vv = v.repeat_interleave(rep, dim=1)
    scale = 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    for a in range(0, S, cq):
        qb = q[a:a + cq]
        qpos = torch.arange(a, a + cq, device=q.device)
        m = torch.full((H, cq), NEG, device=q.device)
        l = torch.zeros(H, cq, device=q.device)
        acc = torch.zeros(H, cq, D, device=q.device)
        for b in range(0, min(a + cq, S), ck):
            s = torch.einsum("qhd,khd->hqk", qb, kk[b:b + ck]) * scale
            kpos = torch.arange(b, b + ck, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("hqk,khd->hqd", r(p),
                                                       vv[b:b + ck])
            m = m_new
        out[a:a + cq] = (acc / torch.clamp_min(l, 1e-30)[..., None]).transpose(0, 1)
    return out


def kv_tile(seq: int, want: int = 256) -> int:
    """The decode attention's key tile over a cache of ``seq`` slots: the
    whole cache when it fits one tile, else the largest divisor at most the
    tile target, or, when that is below a quarter of it, the smallest
    divisor above."""
    want = min(want, seq)
    best = next(b for b in range(want, 0, -1) if seq % b == 0)
    if best * 4 < want:
        best = next(b for b in range(want, seq + 1) if seq % b == 0)
    return best


def decode_attention(q, k, v, q0: int, capacity: int, r) -> torch.Tensor:
    """Served tokens' queries q (T, H, D) at positions q0 .. q0+T-1 over the
    HiF4 cache's keys and values k, v (n, Hkv, D), in key tiles of the cache
    capacity's :func:`kv_tile`: each tile's softmax weights, normalized by
    the running sum, are held in the stored precision ``r``."""
    T, H, D = q.shape
    rep = H // k.shape[1]
    kk = k.repeat_interleave(rep, dim=1)
    vv = v.repeat_interleave(rep, dim=1)
    sqrt_d = float(torch.tensor(D ** 0.5, dtype=F32))
    qpos = q0 + torch.arange(T, device=q.device)
    m = torch.full((H, T, 1), NEG, device=q.device)
    l = torch.zeros(H, T, 1, device=q.device)
    acc = torch.zeros(H, T, D, device=q.device)
    tile = kv_tile(capacity)
    for b in range(0, capacity, tile):
        if b >= k.shape[0]:
            break                    # tiles past every query's length add 0
        kb, vb = kk[b:b + tile], vv[b:b + tile]
        kpos = torch.arange(b, b + kb.shape[0], device=q.device)
        s = torch.einsum("qhd,khd->hqk", q, kb) / sqrt_d
        s = torch.where(kpos[None, None, :] <= qpos[None, :, None], s, NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l_new = l * corr + torch.sum(e, dim=-1, keepdim=True)
        pv = torch.einsum("hqk,khd->hqd", r(e / l_new), vb)
        acc = acc * (l * corr / l_new) + pv
        m, l = m_new, l_new
    return acc.transpose(0, 1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, r,
                stepwise_from: int) -> torch.Tensor:
    """Depthwise causal conv of x (G, n, C) with w (K, C), bias, then SiLU.
    Positions before ``stepwise_from`` (the prompt) hold every product and
    partial sum in the stored precision ``r``, as the prefill's conv does;
    later ones (the served tokens) sum in float32, as the decode step's."""
    K, n = w.shape[0], x.shape[1]
    wf, bf = w.to(F32), b.to(F32)
    xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    y = r(xp[:, 0:n] * wf[0])
    f = xp[:, 0:n] * wf[0]
    for k in range(1, K):
        y = r(y + r(xp[:, k:k + n] * wf[k]))
        f = f + xp[:, k:k + n] * wf[k]
    pre = torch.cat([r(y + bf)[:, :stepwise_from], (f + bf)[:, stepwise_from:]], 1)
    return r(silu(pre))


def ssd(x, dt, a, bm, cm, d_skip, chunk: int, S: int) -> torch.Tensor:
    """The SSD recurrence h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t + D x_t over G sequences of n steps: x (G, n, H, P), dt
    (G, n, H), a (H,), bm / cm (G, n, N), d_skip (H,). As the configuration
    states it: the prompt's S steps in chunks of ``chunk`` (cut to S), the
    served tokens' steps one at a time; all in float32."""
    G, n, H, P = x.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"a prompt of {S} does not split into chunks of {chunk}")
    out = torch.empty_like(x)
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=x.device))
    s = torch.zeros(G, H, P, bm.shape[-1], dtype=F32, device=x.device)
    for t0 in range(0, S, c):
        t = slice(t0, t0 + c)
        csc = torch.cumsum(dt[:, t] * a, dim=1)                   # (G, l, H)
        diff = csc[:, :, None, :] - csc[:, None, :, :]           # (G, t, j, H)
        lmat = torch.exp(diff.masked_fill(~tri[None, :, :, None], float("-inf")))
        m = (cm[:, t] @ bm[:, t].transpose(1, 2))[..., None] * lmat
        y = torch.einsum("gtjh,gjhp->gthp", m, dt[:, t, :, None] * x[:, t])
        y = y + torch.einsum("gtn,ghpn->gthp", cm[:, t], s) * torch.exp(csc)[..., None]
        out[:, t] = y + d_skip[None, None, :, None] * x[:, t]
        wend = torch.exp(csc[:, -1:, :] - csc) * dt[:, t]          # (G, l, H)
        s = (s * torch.exp(csc[:, -1])[:, :, None, None]
             + torch.einsum("gjh,gjn,gjhp->ghpn", wend, bm[:, t], x[:, t]))
    for i in range(S, n):
        da = torch.exp(dt[:, i] * a)                              # (G, H)
        s = (s * da[:, :, None, None]
             + (dt[:, i, :, None] * x[:, i])[..., None] * bm[:, i, None, None, :])
        out[:, i] = (s @ cm[:, i, None, :, None])[..., 0] + d_skip[None, :, None] * x[:, i]
    return out


def qdq_w(w: torch.Tensor, k: int) -> torch.Tensor:
    """A weight as (K, N), quantized along K in float32."""
    return qdq(w.reshape(k, -1), axis=0)
