"""Transformer blocks: GQA attention (QKV bias, qk-norm) + dense MLPs (port
of ``repro/models/transformer.py``, forward only).

Every linear layer runs through :func:`repro_torch.models.common.dense` with
its per-site config (``ctx.site_quant("attn.wq")`` etc.; ``site="xattn"``
for the audio decoder's cross-attention). Norms are RMSNorm, or LayerNorm
with bias for the audio family. Attention modes:
  * full    — flash attention over the whole sequence (causal, or not for
              the audio encoder); with ``return_cache`` it also returns the
              (RoPE'd) KV (prefill)
  * decode  — one token against a KV cache (contiguous, or the paged pool
              through a page table), appending at ``pos``; with ``cross``
              against the read-only encoder cache, projecting only q
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine as qengine
from repro_torch.core import kvcache
from repro_torch.core.spans import span
from repro_torch.models.attention import (AttnChunking, decode_attention,
                                          flash_attention, flash_mha_vec)
from repro_torch.models.common import (ModelCtx, apply_rope, dense, layer_norm,
                                       rms_norm)
from repro_torch.models.params import PSpec


def norm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    if cfg.family == "audio":
        return {"w": PSpec((d,), (None,), init="ones"),
                "b": PSpec((d,), (None,), init="zeros")}
    return {"w": PSpec((d,), (None,), init="ones")}


def norm_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if "b" in p:
        return layer_norm(x, p["w"], p["b"], eps=cfg.norm_eps)
    return rms_norm(x, p["w"], eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attn_specs(cfg: ArchConfig) -> dict:
    a = cfg.attn
    d = cfg.d_model
    specs = {
        "wq": PSpec((d, a.n_heads, a.d_head), ("fsdp", "heads", None)),
        "wk": PSpec((d, a.n_kv_heads, a.d_head), ("fsdp", "kv_heads", None)),
        "wv": PSpec((d, a.n_kv_heads, a.d_head), ("fsdp", "kv_heads", None)),
        "wo": PSpec((a.n_heads, a.d_head, d), ("heads", None, "fsdp")),
    }
    if a.qkv_bias:
        specs["bq"] = PSpec((a.n_heads, a.d_head), ("heads", None), init="zeros")
        specs["bk"] = PSpec((a.n_kv_heads, a.d_head), ("kv_heads", None), init="zeros")
        specs["bv"] = PSpec((a.n_kv_heads, a.d_head), ("kv_heads", None), init="zeros")
    if a.qk_norm:
        specs["q_norm"] = PSpec((a.d_head,), (None,), init="ones")
        specs["k_norm"] = PSpec((a.d_head,), (None,), init="ones")
    return specs


def proj_q(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx,
           site: str = "attn") -> torch.Tensor:
    """x (..., d) -> q (..., H, Dh), bias added, RoPE not yet applied."""
    a = cfg.attn
    q = dense(x, p["wq"].reshape(cfg.d_model, -1),
              quant=ctx.site_quant(f"{site}.wq")
              ).reshape(x.shape[:-1] + (a.n_heads, a.d_head))
    if a.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    return q


def proj_kv(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx,
            site: str = "attn") -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) -> k, v (..., Hkv, Dh), bias added (no norm, no RoPE)."""
    a = cfg.attn
    d = cfg.d_model
    lead = x.shape[:-1] + (a.n_kv_heads, a.d_head)
    k = dense(x, p["wk"].reshape(d, -1), quant=ctx.site_quant(f"{site}.wk")
              ).reshape(lead)
    v = dense(x, p["wv"].reshape(d, -1), quant=ctx.site_quant(f"{site}.wv")
              ).reshape(lead)
    if a.qkv_bias:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return k, v


def _proj_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx,
              site: str = "attn"):
    """x (..., d) -> q (..., H, Dh), k/v (..., Hkv, Dh), RoPE not yet applied.
    ``site`` names the param subtree under ``ctx.scope`` ("attn", or the
    audio decoder's "xattn"), so each projection resolves its own policy
    site."""
    q = proj_q(p, x, cfg, ctx, site)
    k, v = proj_kv(p, x, cfg, ctx, site)
    if cfg.attn.qk_norm:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    return q, k, v


def out_proj(p: dict, o: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx,
             site: str = "attn") -> torch.Tensor:
    a = cfg.attn
    o = o.reshape(o.shape[:-2] + (a.n_heads * a.d_head,))
    return dense(o, p["wo"].reshape(-1, cfg.d_model),
                 quant=ctx.site_quant(f"{site}.wo"))


def attn_full(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx, *,
              causal: bool = True, use_rope: bool = True,
              return_cache: bool = False, site: str = "attn"):
    """Full-sequence self-attention; optionally returns the KV cache
    (prefill)."""
    B, S, _ = x.shape
    q, k, v = _proj_qkv(p, x, cfg, ctx, site)
    if use_rope:
        positions = torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.attn.rope_theta)
        k = apply_rope(k, positions, cfg.attn.rope_theta)
    chunking = AttnChunking(q_chunk=min(ctx.attn_q_chunk, S),
                            k_chunk=min(ctx.attn_k_chunk, S))
    with span("attn.prefill"):
        if ctx.attn_impl == "vec_q":
            o = flash_mha_vec(q, k, v, causal, 0, chunking)
        else:
            o = flash_attention(q, k, v, causal=causal, chunking=chunking)
    y = out_proj(p, o, cfg, ctx, site)
    return y, ({"k": k, "v": v} if return_cache else None)


def _append_kv(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
    """Write new (B, 1, Hkv, Dh) into the bf16 cache (B, S, Hkv, Dh) at the
    per-slot positions ``pos`` (B,) clamped to S - 1 (as the reference's
    dynamic_update_slice clamps), in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, torch.clamp(pos, max=cache.shape[1] - 1)] = new[:, 0].to(cache.dtype)
    return cache


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos, cfg: ArchConfig,
                ctx: ModelCtx, *, use_rope: bool = True, cross: bool = False,
                site: str = "attn", pages=None):
    """One-token attention against, and (unless ``cross``) appending to, a KV
    cache.

    x (B, 1, d); cache {"k","v"} either bf16 (B, S, Hkv, Dh), HiF4-packed
    leaves (:mod:`repro_torch.core.kvcache`) or, with ``pages`` (B,
    max_pages), the per-layer view (NP, F, P) of the paged HiF4 pool;
    ``pos`` the valid-slot count, a scalar (lockstep batch) or (B,) per
    slot. The new token is written into the cache tensors in place (through
    the page table for the pool); the (same) cache dict is returned.

    With ``cross`` the cache is the read-only encoder cache: nothing is
    appended, every slot's length is the cache's capacity, and only q is
    projected (the reference computes k and v too and drops them; XLA
    removes that dead work, so the port does not launch it).
    """
    B = x.shape[0]
    dev = x.device
    posv = kvcache.slot_positions(pos, B, dev)
    packed = kvcache.is_packed_kv(cache["k"])
    if cross:
        q = proj_q(p, x, cfg, ctx, site)                       # (B, 1, H, Dh)
        if cfg.attn.qk_norm:
            q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        if use_rope:
            q = apply_rope(q, posv[:, None], cfg.attn.rope_theta)
        cap = (kvcache.seq_capacity(cache["k"]) if packed
               else cache["k"].shape[1])
        length = torch.full((B,), cap, dtype=torch.int32, device=dev)
    else:
        q, k_new, v_new = _proj_qkv(p, x, cfg, ctx, site)    # (B, 1, H/Hkv, Dh)
        if use_rope:
            q = apply_rope(q, posv[:, None], cfg.attn.rope_theta)
            k_new = apply_rope(k_new, posv[:, None], cfg.attn.rope_theta)
        length = (posv + 1).to(torch.int32)
        if pages is not None and not packed:
            raise ValueError("the page pool is HiF4-only")
        if packed:
            # quantize the one new token of K and V into its own 64-groups
            # + tail and write only those bytes (one kernel launch on the
            # card), through the page table for the pool: (pages[b,
            # pos//P], pos % P), the scheduler giving live slots pages they
            # own alone; attention streams the packed cache
            with span("kv.append"):
                kvcache.append_kv(cache, k_new, v_new, posv, pages)
        else:
            with span("kv.append"):
                _append_kv(cache["k"], k_new, posv)
            with span("kv.append"):
                _append_kv(cache["v"], v_new, posv)
    with span("attn.decode"):
        if packed:
            o = qengine.attention_decode(
                q[:, 0].contiguous(), cache["k"], cache["v"], length,
                cfg.attn.n_kv_heads, cfg.attn.d_head,
                qengine.EngineCtx(quant=ctx.quant), pages=pages,
                block_kv=ctx.attn_kv_block)
        else:
            o = decode_attention(q[:, 0], cache["k"], cache["v"], length)
    y = out_proj(p, o[:, None], cfg, ctx, site)                # (B, 1, d)
    return y, cache


def attn_cache_specs(cfg: ArchConfig, batch: int, seq: int,
                     kv_format: str = "bf16") -> dict:
    """Abstract per-layer KV-cache spec; ``hif4`` yields the packed
    kernel-tile layout (token axis last)."""
    a = cfg.attn
    if kv_format == "hif4":
        g, t = kvcache.split_features(a.n_kv_heads, a.d_head)
        packed = {
            "codes": PSpec((batch, g * 32, seq), ("batch", None, "kv_seq"),
                           dtype=torch.uint8, init="zeros"),
            "meta": PSpec((batch, g, seq), ("batch", None, "kv_seq"),
                          dtype=torch.int32, init="zeros"),
            "tail": PSpec((batch, t, seq), ("batch", None, "kv_seq"),
                          init="zeros"),
        }
        return {"k": dict(packed), "v": dict(packed)}
    return {
        "k": PSpec((batch, seq, a.n_kv_heads, a.d_head),
                   ("batch", "kv_seq", None, None)),
        "v": PSpec((batch, seq, a.n_kv_heads, a.d_head),
                   ("batch", "kv_seq", None, None)),
    }


# ---------------------------------------------------------------------------
# Dense MLP (swiglu | squared_relu | gelu)
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {
            "wg": PSpec((d, f), ("fsdp", "ff")),
            "wu": PSpec((d, f), ("fsdp", "ff")),
            "wo": PSpec((f, d), ("ff", "fsdp")),
        }
    return {"wi": PSpec((d, f), ("fsdp", "ff")), "wo": PSpec((f, d), ("ff", "fsdp"))}


def mlp_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx
              ) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(dense(x, p["wg"], quant=ctx.site_quant("mlp.wg"))
                   .to(torch.float32))
        h = (h * dense(x, p["wu"], quant=ctx.site_quant("mlp.wu"))
             .to(torch.float32)).to(x.dtype)
    else:
        h = dense(x, p["wi"], quant=ctx.site_quant("mlp.wi")).to(torch.float32)
        h = torch.square(F.relu(h)) if cfg.activation == "squared_relu" \
            else F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
        h = h.to(x.dtype)
    return dense(h, p["wo"], quant=ctx.site_quant("mlp.wo"))
