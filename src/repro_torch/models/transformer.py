"""Transformer blocks: GQA attention (QKV bias, qk-norm) + dense MLPs (port
of ``repro/models/transformer.py``, the dense-LM parts).

Every linear layer runs through :func:`repro_torch.models.common.dense` with
its per-site config (``ctx.site_quant("attn.wq")`` etc.). Attention modes:
  * full    — flash attention over the whole sequence; with
              ``return_cache`` it also returns the RoPE'd KV (prefill)
  * decode  — one token against a KV cache (contiguous, or the paged pool
              through a page table), appending at ``pos``
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine as qengine
from repro_torch.core import kvcache
from repro_torch.models.attention import AttnChunking, decode_attention, flash_attention
from repro_torch.models.common import ModelCtx, apply_rope, dense, rms_norm
from repro_torch.models.params import PSpec


def norm_specs(cfg: ArchConfig) -> dict:
    if cfg.family == "audio":
        raise NotImplementedError("LayerNorm (audio family) is not yet ported")
    return {"w": PSpec((cfg.d_model,), (None,), init="ones")}


def norm_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
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


def _proj_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx):
    """x (..., d) -> q (..., H, Dh), k/v (..., Hkv, Dh), RoPE not yet applied."""
    a = cfg.attn
    d = cfg.d_model
    lead = x.shape[:-1]
    q = dense(x, p["wq"].reshape(d, -1), quant=ctx.site_quant("attn.wq")
              ).reshape(lead + (a.n_heads, a.d_head))
    k = dense(x, p["wk"].reshape(d, -1), quant=ctx.site_quant("attn.wk")
              ).reshape(lead + (a.n_kv_heads, a.d_head))
    v = dense(x, p["wv"].reshape(d, -1), quant=ctx.site_quant("attn.wv")
              ).reshape(lead + (a.n_kv_heads, a.d_head))
    if a.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if a.qk_norm:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    return q, k, v


def _out_proj(p: dict, o: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx
              ) -> torch.Tensor:
    a = cfg.attn
    o = o.reshape(o.shape[:-2] + (a.n_heads * a.d_head,))
    return dense(o, p["wo"].reshape(-1, cfg.d_model),
                 quant=ctx.site_quant("attn.wo"))


def attn_full(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx, *,
              return_cache: bool = False):
    """Causal full-sequence attention; optionally returns the KV cache
    (prefill)."""
    B, S, _ = x.shape
    q, k, v = _proj_qkv(p, x, cfg, ctx)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.attn.rope_theta)
    k = apply_rope(k, positions, cfg.attn.rope_theta)
    chunking = AttnChunking(q_chunk=min(ctx.attn_q_chunk, S),
                            k_chunk=min(ctx.attn_k_chunk, S))
    o = flash_attention(q, k, v, chunking=chunking)
    y = _out_proj(p, o, cfg, ctx)
    return y, ({"k": k, "v": v} if return_cache else None)


def _append_kv(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
    """Write new (B, 1, Hkv, Dh) into the bf16 cache (B, S, Hkv, Dh) at the
    per-slot positions ``pos`` (B,) clamped to S - 1 (as the reference's
    dynamic_update_slice clamps), in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, torch.clamp(pos, max=cache.shape[1] - 1)] = new[:, 0].to(cache.dtype)
    return cache


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos, cfg: ArchConfig,
                ctx: ModelCtx, *, pages=None):
    """One-token attention against, and appending to, a KV cache.

    x (B, 1, d); cache {"k","v"} either bf16 (B, S, Hkv, Dh), HiF4-packed
    leaves (:mod:`repro_torch.core.kvcache`) or, with ``pages`` (B,
    max_pages), the per-layer view (NP, F, P) of the paged HiF4 pool;
    ``pos`` the valid-slot count, a scalar (lockstep batch) or (B,) per
    slot. The new token is written into the cache tensors in place (through
    the page table for the pool); the (same) cache dict is returned.
    """
    B = x.shape[0]
    dev = x.device
    posv = kvcache.slot_positions(pos, B, dev)
    q, k_new, v_new = _proj_qkv(p, x, cfg, ctx)              # (B, 1, H/Hkv, Dh)
    q = apply_rope(q, posv[:, None], cfg.attn.rope_theta)
    k_new = apply_rope(k_new, posv[:, None], cfg.attn.rope_theta)
    length = (posv + 1).to(torch.int32)
    if pages is not None:
        # paged HiF4 pool: the one token's bytes land at (pages[b, pos//P],
        # pos % P); the scheduler gives live slots pages they own alone
        if not kvcache.is_packed_kv(cache["k"]):
            raise ValueError("the page pool is HiF4-only")
        kvcache.append_token_paged(cache["k"], k_new, posv, pages)
        kvcache.append_token_paged(cache["v"], v_new, posv, pages)
    elif kvcache.is_packed_kv(cache["k"]):
        # quantize the one new token into its own 64-groups + tail, write
        # only those bytes; attention streams the packed cache
        kvcache.append_token(cache["k"], k_new, posv)
        kvcache.append_token(cache["v"], v_new, posv)
    else:
        _append_kv(cache["k"], k_new, posv)
        _append_kv(cache["v"], v_new, posv)
        o = decode_attention(q[:, 0], cache["k"], cache["v"], length)
    if kvcache.is_packed_kv(cache["k"]):
        o = qengine.attention_decode(
            q[:, 0].contiguous(), cache["k"], cache["v"], length,
            cfg.attn.n_kv_heads, cfg.attn.d_head,
            qengine.EngineCtx(quant=ctx.quant), pages=pages,
            block_kv=ctx.attn_kv_block)
    y = _out_proj(p, o[:, None], cfg, ctx)                     # (B, 1, d)
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
