"""Chunked flash attention (prefill and training), bf16-cache decode
attention and the vectorised-q and packed-KV forms, in plain PyTorch (port
of ``repro/models/attention.py``).

None is a kernel in the reference (all are XLA there), so all stay plain
tensor code here, in the reference's op order: f32 scores from bf16
operands, NEG_INF masking, running (max, denominator, accumulator) per
query chunk, probabilities rounded to the value dtype before the PV product.
GQA is computed without repeating KV: q is viewed as (B, S, Hkv, rep, D).

The backward is the reference's custom VJP as a ``torch.autograd.Function``
(:class:`FlashMHA`): it saves the forward's log-sum-exp and recomputes the
probabilities per (q-chunk, kv-chunk) tile in two passes, dq over q chunks
and dk/dv over kv chunks, skipping the tiles the causal mask empties.
Autograd through the forward's loop instead would keep every tile's
probabilities alive until the backward. :class:`FlashMHAVec` is the
``vec_q`` form (every q chunk advances together, one backward pass over KV
chunks); :func:`flash_mha_vec_packed` and :func:`decode_attention_packed`
read a packed HiF4 cache one dequantized chunk at a time.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


def _flash_forward(q, k, v, causal: bool, q_offset: int,
                   chunking: AttnChunking, want_lse: bool, kv_valid_len=None):
    """Chunked online-softmax forward -> (out (B, Sq, H, D) in q.dtype, lse
    (B, Hkv, rep, Sq) f32 log-sum-exp of the scaled scores, or None unless
    ``want_lse``). ``kv_valid_len`` (B,) masks each row's keys at and past
    its valid length (the reference's ``_flash_fwd_impl``); with it every
    KV chunk is walked, as there."""
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
    q_pos = q_offset + torch.arange(Sq, device=dev).reshape(nq, cq)
    k_pos = torch.arange(Sk, device=dev).reshape(nk, ck)
    if kv_valid_len is not None:
        kv_valid_len = kv_valid_len.to(dev)

    outs, lses = [], []
    for qi in range(nq):
        qblk = qc[:, qi].to(torch.float32)                  # (B, cq, Hkv, rep, D)
        m = torch.full((B, Hkv, rep, cq), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, rep, cq), device=dev)
        acc = torch.zeros((B, Hkv, rep, cq, D), device=dev)
        n_live = (nk if kv_valid_len is not None
                  else _n_live(qi, causal, q_offset, cq, ck, nk))
        for ki in range(n_live):
            kblk, vblk = kc[:, ki], vc[:, ki]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qblk,
                             kblk.to(torch.float32)) * scale
            if kv_valid_len is not None:
                valid = k_pos[ki][None, :] < kv_valid_len[:, None]   # (B, ck)
                s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
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
        if want_lse:
            lses.append(m + torch.log(l))                   # (B,Hkv,rep,cq)
    out = torch.cat(outs, dim=1).to(q.dtype)
    return out, (torch.cat(lses, dim=-1) if want_lse else None)


def _n_live(qi: int, causal: bool, q_offset: int, cq: int, ck: int,
            nk: int) -> int:
    """KV chunks that hold a key visible to query chunk ``qi`` (all of them
    unless causal): the causal early exit."""
    if not causal:
        return nk
    return min((q_offset + (qi + 1) * cq - 1) // ck + 1, nk)


class FlashMHA(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``flash_mha`` custom
    VJP): the forward saves (q, k, v, out, lse); the backward recomputes
    each tile's probabilities from lse. Big operands stay in their dtype
    (bf16) and every product accumulates in f32, as the reference's
    ``preferred_element_type``; p and ds are rounded to q's dtype before
    their products, as there."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, chunking):
        out, lse = _flash_forward(q, k, v, causal, q_offset, chunking, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, chunking)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, chunking = ctx.args
        f32 = torch.float32
        B, Sq, H, D = q.shape
        _, Sk, Hkv, _ = k.shape
        rep = H // Hkv
        scale = 1.0 / (D ** 0.5)
        nq = _chunks(Sq, chunking.q_chunk)
        nk = _chunks(Sk, chunking.k_chunk)
        cq, ck = Sq // nq, Sk // nk
        dev, dt16 = q.device, q.dtype

        qc = q.reshape(B, nq, cq, Hkv, rep, D)
        kc = k.reshape(B, nk, ck, Hkv, D)
        vc = v.reshape(B, nk, ck, Hkv, D)
        doc = dout.reshape(B, nq, cq, Hkv, rep, D)
        lsec = lse.reshape(B, Hkv, rep, nq, cq)
        # delta = rowsum(dout * out): (B, Hkv, rep, nq, cq)
        delta = torch.einsum("bsgrd,bsgrd->bgrs",
                             dout.reshape(B, Sq, Hkv, rep, D).to(f32),
                             out.reshape(B, Sq, Hkv, rep, D).to(f32)
                             ).reshape(B, Hkv, rep, nq, cq)
        q_pos = q_offset + torch.arange(Sq, device=dev).reshape(nq, cq)
        k_pos = torch.arange(Sk, device=dev).reshape(nk, ck)

        def tile(qi, ki):
            """p and ds of one (qi, ki) tile, f32 (B, Hkv, rep, cq, ck)."""
            s = torch.einsum("bqgrd,bkgd->bgrqk", qc[:, qi].to(f32),
                             kc[:, ki].to(f32)) * scale
            if causal:
                mask = q_pos[qi][:, None] >= k_pos[ki][None, :]
                s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lsec[:, :, :, qi, :, None])
            dp = torch.einsum("bqgrd,bkgd->bgrqk", doc[:, qi].to(f32),
                              vc[:, ki].to(f32))
            return p, p * (dp - delta[:, :, :, qi, :, None])

        # pass 1: dq, q chunk by q chunk over its live kv chunks
        dqs = []
        for qi in range(nq):
            dq_blk = torch.zeros((B, cq, Hkv, rep, D), dtype=f32, device=dev)
            for ki in range(_n_live(qi, causal, q_offset, cq, ck, nk)):
                _, ds = tile(qi, ki)
                dq_blk = dq_blk + torch.einsum(
                    "bgrqk,bkgd->bqgrd", ds.to(dt16).to(f32),
                    kc[:, ki].to(f32)) * scale
            dqs.append(dq_blk)
        dq = torch.stack(dqs, dim=1).reshape(B, Sq, H, D)

        # pass 2: dk, dv, kv chunk by kv chunk over the q chunks that see it
        dks, dvs = [], []
        for ki in range(nk):
            first = max((ki * ck - q_offset) // cq, 0) if causal else 0
            dk_blk = torch.zeros((B, ck, Hkv, D), dtype=f32, device=dev)
            dv_blk = torch.zeros((B, ck, Hkv, D), dtype=f32, device=dev)
            for qi in range(first, nq):
                p, ds = tile(qi, ki)
                dv_blk = dv_blk + torch.einsum(
                    "bgrqk,bqgrd->bkgd", p.to(dt16).to(f32), doc[:, qi].to(f32))
                dk_blk = dk_blk + torch.einsum(
                    "bgrqk,bqgrd->bkgd", ds.to(dt16).to(f32),
                    qc[:, qi].to(f32)) * scale
            dks.append(dk_blk)
            dvs.append(dv_blk)
        dk = torch.stack(dks, dim=1).reshape(B, Sk, Hkv, D)
        dv = torch.stack(dvs, dim=1).reshape(B, Sk, Hkv, D)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              q_offset: int, chunking: AttnChunking) -> torch.Tensor:
    """Differentiable flash attention (the training path)."""
    return FlashMHA.apply(q, k, v, causal, q_offset, chunking)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_valid_len: Optional[torch.Tensor] = None,
                    chunking: AttnChunking = AttnChunking()) -> torch.Tensor:
    """Chunked attention. q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H,
    D) in q.dtype. ``causal`` (prefill self-attention): query i (at absolute
    position ``q_offset + i``) sees keys 0..q_offset + i; otherwise (the
    audio encoder, the decoder's cross-attention) every query sees all Sk
    keys, and Sq may differ from Sk.

    Query chunks run in a loop; for each, the KV chunks that hold any
    visible key fold into the online softmax. Where autograd records an
    operand this is :func:`flash_mha` (the same forward, the flash
    backward). ``kv_valid_len`` (B,) masks each row's keys at and past its
    valid prefix; that form is forward-only, as in the reference."""
    if kv_valid_len is not None:
        return _flash_forward(q, k, v, causal, q_offset, chunking, False,
                              kv_valid_len)[0]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_mha(q, k, v, causal, q_offset, chunking)
    return _flash_forward(q, k, v, causal, q_offset, chunking, False)[0]


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


# ---------------------------------------------------------------------------
# Packed-KV decode: an HiF4 4.5-bit cache (repro_torch.core.kvcache)
# ---------------------------------------------------------------------------


def decode_attention_packed(q: torch.Tensor, k_cache: dict, v_cache: dict,
                            length: torch.Tensor, n_kv_heads: int,
                            d_head: int) -> torch.Tensor:
    """One-token attention against an HiF4-packed KV cache (either layout):
    the models-level form beside the engine's fused route
    (:func:`repro_torch.core.engine.attention_decode`, kernel 3 on the card).

    :func:`flash_mha_vec_packed` with Sq = 1 and KV chunks of
    ``select_kv_block(capacity, 1024)``: each chunk is dequantized to bf16
    inside the loop, so the bf16 working set is one (B, chunk, Hkv, Dh)
    chunk, never the whole cache. q (B, H, D); length (B,)."""
    from repro_torch.core import kvcache
    from repro_torch.kernels.fused_attention import select_kv_block

    ck = select_kv_block(kvcache.seq_capacity(k_cache), 1024)
    out = flash_mha_vec_packed(q[:, None], k_cache, v_cache, n_kv_heads,
                               d_head, causal=False, kv_valid_len=length,
                               chunking=AttnChunking(q_chunk=1, k_chunk=ck))
    return out[:, 0]


def flash_mha_vec_packed(q: torch.Tensor, k_cache: dict, v_cache: dict,
                         n_kv_heads: int, d_head: int, *, causal: bool = True,
                         q_offset: int = 0,
                         kv_valid_len: Optional[torch.Tensor] = None,
                         chunking: AttnChunking = AttnChunking()
                         ) -> torch.Tensor:
    """Vectorised-q flash attention straight off a packed KV cache of
    capacity Sk (either layout): the :func:`_flash_fwd_vec` recurrence with
    a loader that slices one KV chunk of the packed leaves and dequantizes
    it, so the bf16 working set is one (B, ck, Hkv, Dh) chunk. q (B, Sq, H,
    D) -> (B, Sq, H, D). Forward only: caches are never differentiated."""
    from repro_torch.core import kvcache

    B, Sq, H, D = q.shape
    if D != d_head:
        raise ValueError(f"q has d_head {D}, expected {d_head}")
    Sk = kvcache.seq_capacity(k_cache)
    ck = Sk // _chunks(Sk, chunking.k_chunk)

    def loader(ki):
        kblk = kvcache.dequantize_kv(
            kvcache.slice_tokens(k_cache, ki * ck, ck), n_kv_heads, D)
        vblk = kvcache.dequantize_kv(
            kvcache.slice_tokens(v_cache, ki * ck, ck), n_kv_heads, D)
        return kblk, vblk

    return _flash_fwd_vec(q, None, None, causal, q_offset, chunking,
                          kv_loader=loader, kv_shape=(Sk, n_kv_heads),
                          kv_valid_len=kv_valid_len)[0]


# ---------------------------------------------------------------------------
# Vectorised-q flash attention ("vec_q"): every q chunk advances together
# ---------------------------------------------------------------------------
#
# The reference makes the q-chunk axis a data axis so that a sharding
# constraint can spread it over the tensor-parallel axis where the head count
# does not divide it. The form has no causal early exit: every (q, k) tile is
# computed, about twice the scores of scan_q for a causal prefill.


def _flash_fwd_vec(q, k, v, causal: bool, q_offset: int,
                   chunking: AttnChunking, *, kv_loader=None, kv_shape=None,
                   kv_valid_len=None):
    """-> (out (B, Sq, H, D) in q.dtype, lse (B, nq, Hkv, rep, cq) f32).

    One online-softmax loop over KV chunks with all nq query chunks in the
    state. ``kv_loader(ki) -> (kblk, vblk)`` says where a chunk comes from:
    None reads the dense (B, Sk, Hkv, D) ``k`` and ``v``; a loader (with
    ``kv_shape = (Sk, Hkv)``) may dequantize a packed cache per chunk."""
    f32 = torch.float32
    B, Sq, H, D = q.shape
    Sk, Hkv = kv_shape if kv_loader is not None else (k.shape[1], k.shape[2])
    rep = H // Hkv
    scale = 1.0 / (D ** 0.5)
    nq = _chunks(Sq, chunking.q_chunk)
    nk = _chunks(Sk, chunking.k_chunk)
    cq, ck = Sq // nq, Sk // nk
    dev = q.device

    qc = q.reshape(B, nq, cq, Hkv, rep, D).to(f32)
    if kv_loader is None:
        kc = k.reshape(B, nk, ck, Hkv, D)
        vc = v.reshape(B, nk, ck, Hkv, D)
        kv_loader = lambda ki: (kc[:, ki], vc[:, ki])  # noqa: E731
    q_pos = q_offset + torch.arange(Sq, device=dev).reshape(nq, cq)
    k_pos = torch.arange(Sk, device=dev).reshape(nk, ck)
    if kv_valid_len is not None:
        kv_valid_len = kv_valid_len.to(dev)

    m = torch.full((B, nq, Hkv, rep, cq), NEG_INF, device=dev)
    l = torch.zeros((B, nq, Hkv, rep, cq), device=dev)
    acc = torch.zeros((B, nq, Hkv, rep, cq, D), device=dev)
    for ki in range(nk):
        kblk, vblk = kv_loader(ki)
        s = torch.einsum("bnqgrd,bkgd->bngrqk", qc, kblk.to(f32)) * scale
        if causal:
            mask = q_pos[:, :, None] >= k_pos[ki][None, None, :]   # (nq, cq, ck)
            s = torch.where(mask[None, :, None, None], s, NEG_INF)
        if kv_valid_len is not None:
            valid = k_pos[ki][None, :] < kv_valid_len[:, None]     # (B, ck)
            s = torch.where(valid[:, None, None, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bngrqk,bkgd->bngrqd", p.to(vblk.dtype).to(f32), vblk.to(f32))
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = acc / l[..., None]                            # (B, nq, Hkv, rep, cq, D)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, Sq, H, D).to(q.dtype)
    return out, m + torch.log(l)


class FlashMHAVec(torch.autograd.Function):
    """Differentiable vectorised-q flash attention (the reference's
    ``flash_mha_vec`` custom VJP). The backward is ``_flash_vec_bwd``'s one
    pass over KV chunks: per chunk, p and ds of every q chunk at once (f32
    tiles (B, nq, Hkv, rep, cq, ck)), rounded to q's dtype before their
    products, dq accumulated in f32, dk and dv a chunk at a time.

    The reference also applies a sharding constraint to the q-chunk axis
    (its ``_VEC_CONSTRAIN`` hook, set by ``attn_full``); on one card there is
    no mesh to constrain, so the port has no counterpart."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, chunking):
        out, lse = _flash_fwd_vec(q, k, v, causal, q_offset, chunking)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, chunking)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, chunking = ctx.args
        f32 = torch.float32
        B, Sq, H, D = q.shape
        _, Sk, Hkv, _ = k.shape
        rep = H // Hkv
        scale = 1.0 / (D ** 0.5)
        nq = _chunks(Sq, chunking.q_chunk)
        nk = _chunks(Sk, chunking.k_chunk)
        cq, ck = Sq // nq, Sk // nk
        dev, dt16 = q.device, q.dtype

        qc = q.reshape(B, nq, cq, Hkv, rep, D).to(f32)
        doc = dout.reshape(B, nq, cq, Hkv, rep, D).to(f32)
        kc = k.reshape(B, nk, ck, Hkv, D)
        vc = v.reshape(B, nk, ck, Hkv, D)
        # delta = rowsum(dout * out): (B, nq, Hkv, rep, cq)
        delta = torch.einsum("bsgrd,bsgrd->bgrs",
                             dout.reshape(B, Sq, Hkv, rep, D).to(f32),
                             out.reshape(B, Sq, Hkv, rep, D).to(f32)
                             ).reshape(B, Hkv, rep, nq, cq).permute(0, 3, 1, 2, 4)
        q_pos = q_offset + torch.arange(Sq, device=dev).reshape(nq, cq)
        k_pos = torch.arange(Sk, device=dev).reshape(nk, ck)

        dq = torch.zeros((B, nq, cq, Hkv, rep, D), dtype=f32, device=dev)
        dks, dvs = [], []
        for ki in range(nk):
            kblk, vblk = kc[:, ki].to(f32), vc[:, ki].to(f32)
            s = torch.einsum("bnqgrd,bkgd->bngrqk", qc, kblk) * scale
            if causal:
                mask = q_pos[:, :, None] >= k_pos[ki][None, None, :]
                s = torch.where(mask[None, :, None, None], s, NEG_INF)
            p = torch.exp(s - lse[..., None])
            dp = torch.einsum("bnqgrd,bkgd->bngrqk", doc, vblk)
            ds = (p * (dp - delta[..., None])).to(dt16).to(f32)
            dq = dq + torch.einsum("bngrqk,bkgd->bnqgrd", ds, kblk) * scale
            dks.append(torch.einsum("bngrqk,bnqgrd->bkgd", ds, qc) * scale)
            dvs.append(torch.einsum("bngrqk,bnqgrd->bkgd",
                                    p.to(dt16).to(f32), doc))
        dk = torch.stack(dks, dim=1).reshape(B, Sk, Hkv, D)
        dv = torch.stack(dvs, dim=1).reshape(B, Sk, Hkv, D)
        return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None)


def flash_mha_vec(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, q_offset: int,
                  chunking: AttnChunking) -> torch.Tensor:
    """Vectorised-q flash attention (``ModelCtx.attn_impl="vec_q"``): q (B,
    Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H, D) in q.dtype. Where
    autograd records an operand it is :class:`FlashMHAVec`, else the
    forward alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashMHAVec.apply(q, k, v, causal, q_offset, chunking)
    return _flash_fwd_vec(q, k, v, causal, q_offset, chunking)[0]
