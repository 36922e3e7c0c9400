"""Chunked flash attention (prefill) and bf16-cache decode attention, in
plain PyTorch (port of ``repro/models/attention.py``, forward only).

Neither is a kernel in the reference (both are XLA there), so both stay
plain tensor code here, in the reference's op order: f32 scores from bf16
operands, NEG_INF masking, running (max, denominator, accumulator) per
query chunk, probabilities rounded to the value dtype before the PV product.
GQA is computed without repeating KV: q is viewed as (B, S, Hkv, rep, D).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


class AttnChunking(NamedTuple):
    q_chunk: int = 512
    k_chunk: int = 1024


def _chunks(n: int, c: int) -> int:
    c = min(c, n)
    if n % c:
        raise ValueError(f"seq {n} not divisible by chunk {c}")
    return n // c


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    chunking: AttnChunking = AttnChunking()) -> torch.Tensor:
    """Chunked attention. q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H,
    D) in q.dtype. ``causal`` (prefill self-attention): query i sees keys
    0..i; otherwise (the audio encoder, the decoder's cross-attention) every
    query sees all Sk keys, and Sq may differ from Sk.

    Query chunks run in a loop; for each, the KV chunks that hold any
    visible key (all of them unless causal) fold into the online softmax.
    """
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    rep = H // Hkv
    scale = 1.0 / (D ** 0.5)
    nq = _chunks(Sq, chunking.q_chunk)
    nk = _chunks(Sk, chunking.k_chunk)
    cq, ck = Sq // nq, Sk // nk
    dev = q.device

    qc = q.reshape(B, nq, cq, Hkv, rep, D)
    kc = k.reshape(B, nk, ck, Hkv, D)
    vc = v.reshape(B, nk, ck, Hkv, D)
    q_pos = torch.arange(Sq, device=dev).reshape(nq, cq)
    k_pos = torch.arange(Sk, device=dev).reshape(nk, ck)

    outs = []
    for qi in range(nq):
        qblk = qc[:, qi].to(torch.float32)                  # (B, cq, Hkv, rep, D)
        m = torch.full((B, Hkv, rep, cq), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, rep, cq), device=dev)
        acc = torch.zeros((B, Hkv, rep, cq, D), device=dev)
        n_live = min(((qi + 1) * cq - 1) // ck + 1, nk) if causal else nk
        for ki in range(n_live):
            kblk, vblk = kc[:, ki], vc[:, ki]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qblk,
                             kblk.to(torch.float32)) * scale
            if causal:
                mask = q_pos[qi][:, None] >= k_pos[ki][None, :]
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            correction = torch.exp(m - m_new)
            l = l * correction + torch.sum(p, dim=-1)
            acc = acc * correction[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p.to(vblk.dtype).to(torch.float32),
                vblk.to(torch.float32))
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        out = acc / l[..., None]                            # (B,Hkv,rep,cq,D)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, cq, H, D))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """One-token attention against a bf16 KV cache (length-masked softmax).
    q (B, H, D); caches (B, S, Hkv, D); length (B,)."""
    B, S, Hkv, D = k_cache.shape
    H = q.shape[1]
    rep = H // Hkv
    qf = q.reshape(B, Hkv, rep, D).to(torch.float32)
    s = torch.einsum("bgrd,bsgd->bgrs", qf, k_cache.to(torch.float32)) / (D ** 0.5)
    valid = torch.arange(S, device=q.device)[None, :] < length.to(q.device)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(B, H, D).to(q.dtype)
