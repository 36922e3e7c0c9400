"""Language model entry points, every family of the reference: dense and
vlm (LLaVA's backbone on precomputed patch embeddings), moe, ssm (mamba2),
hybrid (zamba2) and audio (whisper's encoder-decoder on precomputed frame
embeddings) (port of ``repro/models/lm.py``).

  abstract_params(cfg)                       -> PSpec tree (no allocation)
  init_params(cfg, seed, device=...)         -> materialized params
  train_loss(params, batch, cfg, ctx)        -> scalar next-token CE loss
  init_cache / init_paged_cache             -> zero decode caches (slot and
                                                paged schedulers)
  prefill(params, batch, cfg, ctx)           -> (last-token logits, decode cache)
  decode_step(params, token, cache, cfg, ctx)-> (logits, cache)
  packed_overlay / realize_packed            -> the packed artifact's tree
                                                (serving-artifact load target)

Params and caches are nested dicts of tensors in the reference's layout:
stacked-layer leaves carry a leading L axis, and the forward walks the layers
in a Python loop over per-layer views (the reference's ``lax.scan``). The
hybrid's Mamba blocks are stacked twice, (n_super, per, ...), behind one
shared attention+MLP block applied before each group of ``per`` (its own
bf16 KV cache per invocation, (n_super, B, S, Hkv, Dh)). The audio family
runs its encoder once in the prefill, projects the encoder output into each
decoder layer's read-only cross K/V, and decodes from BOS with sinusoidal
positions (no RoPE). The decode cache is updated in place; a paged cache
carries its page table (``pages``) beside the pool, and every layer reads
it. Decode caches are ``{"kv", "pos"}`` (transformer), ``{"layers", "pos"}``
(ssm: conv windows and SSD state per layer), ``{"layers", "kv", "pos"}``
(hybrid) and ``{"self", "cross", "pos"}`` (audio).

Training (``mode="train"``, autograd recording): with ``ctx.remat`` each
layer's forward runs under ``torch.utils.checkpoint`` (non-reentrant), the
reference's ``jax.checkpoint`` of its layer scan: the transformer layers
and the audio encoder's whenever ``ctx.remat``, the ssm layers, the
hybrid's groups (shared block and its Mamba layers) and the audio decoder's
layers only in train mode. Remat never engages where nothing is recorded.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import kvcache
from repro_torch.core.policy import STACKED_COLLECTIONS, QuantPlan, QuantPolicy
from repro_torch.core.qlinear import PackedW, QuantConfig
from repro_torch.core.spans import span
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.models.attention import AttnChunking, flash_attention
from repro_torch.models.common import ModelCtx, cross_entropy, dense
from repro_torch.models.params import PSpec, init_from_specs, map_specs, stack_specs

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
# the families whose decode cache is an attention KV cache the page pool,
# the slot scheduler and the HiF4 KV layout serve
KV_FAMILIES = ("dense", "vlm", "moe")
# the families whose attention caches take the packed HiF4 layout: the
# transformer families' "kv", the audio decoder's "self" and "cross"
PACKED_KV_FAMILIES = KV_FAMILIES + ("audio",)
# nominal encoder length backing an audio decode step (the reference's)
ENC_FRAMES_DECODE = 1536


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(...,) int positions -> (..., d) f32 sinusoidal embeddings. The
    division is tensor by tensor: by a Python number CUDA multiplies by its
    reciprocal, which rounds twice."""
    half = d // 2
    dev = positions.device
    ramp = torch.arange(half, dtype=torch.float32, device=dev)
    freqs = torch.exp(-math.log(10000.0) * ramp
                      / torch.tensor(float(half), device=dev))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _tblock_specs(cfg: ArchConfig) -> dict:
    """Transformer block: norm, attention, norm, FFN (the MoE FFN for the
    moe family, else the dense MLP)."""
    specs = {"norm1": tf.norm_specs(cfg), "attn": tf.attn_specs(cfg),
             "norm2": tf.norm_specs(cfg)}
    if cfg.family == "moe":
        specs["moe"] = moe_mod.moe_specs(cfg)
    else:
        specs["mlp"] = tf.mlp_specs(cfg)
    return specs


def _dec_block_specs(cfg: ArchConfig) -> dict:
    """Audio decoder block: self-attention, cross-attention, MLP."""
    return {"norm1": tf.norm_specs(cfg), "attn": tf.attn_specs(cfg),
            "norm_x": tf.norm_specs(cfg), "xattn": tf.attn_specs(cfg),
            "norm2": tf.norm_specs(cfg), "mlp": tf.mlp_specs(cfg)}


def _enc_block_specs(cfg: ArchConfig) -> dict:
    return {"norm1": tf.norm_specs(cfg), "attn": tf.attn_specs(cfg),
            "norm2": tf.norm_specs(cfg), "mlp": tf.mlp_specs(cfg)}


def _hybrid_layout(cfg: ArchConfig) -> tuple[int, int]:
    """(n_super_blocks, mamba_layers_per_super)."""
    per = cfg.hybrid_attn_every
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.n_layers} layers do not split into groups "
                         f"of {per}")
    return cfg.n_layers // per, per


def abstract_params(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    d, v = cfg.d_model, cfg.vocab
    specs: dict = {
        "embed": PSpec((v, d), ("vocab", "fsdp"), std=0.02),
        "final_norm": tf.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = PSpec((d, v), ("fsdp", "vocab"), std=0.02)
    if cfg.family == "ssm":
        specs["blocks"] = stack_specs(mamba2.mamba_specs(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        ns, per = _hybrid_layout(cfg)
        specs["blocks"] = stack_specs(stack_specs(mamba2.mamba_specs(cfg), per),
                                      ns)
        specs["shared"] = {"norm1": tf.norm_specs(cfg), "attn": tf.attn_specs(cfg),
                           "norm2": tf.norm_specs(cfg), "mlp": tf.mlp_specs(cfg)}
    elif cfg.family == "audio":
        specs["enc_blocks"] = stack_specs(_enc_block_specs(cfg), cfg.enc_layers)
        specs["enc_norm"] = tf.norm_specs(cfg)
        specs["blocks"] = stack_specs(_dec_block_specs(cfg), cfg.n_layers)
    else:
        specs["blocks"] = stack_specs(_tblock_specs(cfg), cfg.n_layers)
    return specs


def init_params(cfg: ArchConfig, seed: int = 0, *, device: DeviceLike = None,
                draw_on_device: bool = False) -> dict:
    """Random weights from ``seed`` (see :func:`init_from_specs`)."""
    return init_from_specs(abstract_params(cfg), seed, device=device,
                           draw_on_device=draw_on_device)


def abstract_cache(cfg: ArchConfig, batch: int, seq: int,
                   kv_format: str = "bf16") -> dict:
    """Cache spec for a decode step with capacity ``seq``; the SSM state and
    the hybrid's KV stay bf16 whatever ``kv_format`` asks (the reference's
    fallback). The audio decoder's "cross" cache holds
    ``ENC_FRAMES_DECODE`` encoder frames."""
    _check_family(cfg)
    pos = PSpec((), (), dtype=torch.int32, init="zeros")
    if cfg.family == "ssm":
        return {"layers": stack_specs(mamba2.mamba_cache_specs(cfg, batch),
                                      cfg.n_layers), "pos": pos}
    if cfg.family == "hybrid":
        ns, per = _hybrid_layout(cfg)
        return {"layers": stack_specs(stack_specs(
                    mamba2.mamba_cache_specs(cfg, batch), per), ns),
                "kv": stack_specs(tf.attn_cache_specs(cfg, batch, seq), ns),
                "pos": pos}
    if cfg.family == "audio":
        return {"self": stack_specs(tf.attn_cache_specs(cfg, batch, seq,
                                                        kv_format), cfg.n_layers),
                "cross": stack_specs(tf.attn_cache_specs(
                    cfg, batch, ENC_FRAMES_DECODE, kv_format), cfg.n_layers),
                "pos": pos}
    return {"kv": stack_specs(tf.attn_cache_specs(cfg, batch, seq, kv_format),
                              cfg.n_layers), "pos": pos}


def _check_kv_family(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in KV_FAMILIES:
        raise ValueError(f"{what} serves the transformer families' KV cache "
                         f"{KV_FAMILIES}, got {cfg.family!r}")


def init_cache(cfg: ArchConfig, batch: int, seq: int, kv_format: str = "bf16",
               *, device: DeviceLike = None) -> dict:
    """Zero-filled decode cache of capacity ``seq`` with per-slot positions
    (B,), for the slot scheduler (admission overwrites a slot's whole
    capacity, so the fill never reaches a result)."""
    _check_kv_family(cfg, "init_cache")
    dev = resolve_device(device)
    kv = map_specs(lambda p: torch.zeros(p.shape, dtype=p.dtype, device=dev),
                   abstract_cache(cfg, batch, seq, kv_format)["kv"])
    return {"kv": kv, "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def init_paged_cache(cfg: ArchConfig, batch: int, n_pages: int,
                     page_tokens: int, max_pages_per_slot: int, *,
                     device: DeviceLike = None) -> dict:
    """Zero-initialized PAGED decode cache for the page-pool scheduler:
    ``kv`` the HiF4 page pool shared by all slots (leaves (L, NP, F, P)),
    ``pages`` (B, max_pages_per_slot) int32 the per-slot page table
    (all-zero rows point at the scratch page), ``pos`` (B,) the per-slot
    token counts."""
    _check_kv_family(cfg, "the paged pool")
    dev = resolve_device(device)
    a = cfg.attn
    return {
        "kv": kvcache.init_page_pool(cfg.n_layers, a.n_kv_heads, a.d_head,
                                     n_pages, page_tokens, device=dev),
        "pages": torch.zeros((batch, max_pages_per_slot), dtype=torch.int32,
                             device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def insert_slot_cache(cache: dict, slot_cache: dict, b: int) -> dict:
    """Write a prefilled single-request cache (leaves (L, 1, ...), padded to
    the same capacity) into batch slot ``b`` of a slot-scheduler cache
    (leaves (L, B, ...)), in place; ``pos[b]`` becomes its position."""
    def put(full, one):
        if isinstance(full, dict):
            for key in full:
                put(full[key], one[key])
        else:
            full[:, b] = one[:, 0].to(full.dtype)

    put(cache["kv"], slot_cache["kv"])
    cache["pos"][b] = int(slot_cache["pos"])
    return cache


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                 ctx: ModelCtx) -> torch.Tensor:
    # a gather, not a matmul: the "embed" site never quantizes
    return params["embed"][tokens].to(ctx.compute_dtype)


def lm_logits(params: dict, x: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx
              ) -> torch.Tensor:
    """f32 logits from the (bf16) head, accumulated in f32. The tied head
    contracts a transposed view of the embedding, never an f32 copy of it
    on CUDA."""
    with span("lm.head"):
        x = tf.norm_apply(params["final_norm"], x, cfg)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        y = dense(x, w, quant=ctx.site_quant("lm_head"),
                  accum_dtype=torch.float32)
        return y.to(torch.float32)


# ---------------------------------------------------------------------------
# Transformer forward
# ---------------------------------------------------------------------------


def layer_slice(tree, i: int):
    """Per-layer view of a stacked subtree (tensors and PackedW)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, PackedW):
        return tree.layer(i)
    return tree[i]


def _recorded(params) -> bool:
    """Autograd records this forward: grad mode is on and a parameter
    requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    if isinstance(params, dict):
        return any(_recorded(v) for v in params.values())
    return isinstance(params, torch.Tensor) and params.requires_grad


def _remat(fn, on: bool):
    """``fn`` under non-reentrant activation checkpointing when ``on``."""
    if not on:
        return fn
    return lambda *args, **kw: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, **kw)


def _tblock_apply(p, x, cfg, ctx, *, mode, cache=None, pos=None, pages=None):
    h = tf.norm_apply(p["norm1"], x, cfg)
    if mode == "decode":
        a, new_cache = tf.attn_decode(p["attn"], h, cache, pos, cfg, ctx,
                                      pages=pages)
    else:
        a, new_cache = tf.attn_full(p["attn"], h, cfg, ctx,
                                    return_cache=(mode == "prefill"))
    x = x + a
    h2 = tf.norm_apply(p["norm2"], x, cfg)
    if "moe" in p:
        f = moe_mod.moe_apply(p["moe"], h2, cfg, ctx)
    else:
        f = tf.mlp_apply(p["mlp"], h2, cfg, ctx)
    return x + f, new_cache


def _transformer_forward(params, x, cfg, ctx, *, mode, caches=None, pos=None,
                         pages=None):
    """x (B, S, d). prefill returns the stacked {"k","v"} caches
    (L, B, S, Hkv, Dh); decode updates ``caches`` in place (through the page
    table ``pages``, the same for every layer, when they are a pool)."""
    bctx = ctx.scoped("blocks")
    block = _remat(_tblock_apply,
                   ctx.remat and mode == "train" and _recorded(params))
    kvs = []
    for i in range(cfg.n_layers):
        p_layer = layer_slice(params["blocks"], i)
        cache = layer_slice(caches, i) if mode == "decode" else None
        x, kv = block(p_layer, x, cfg, bctx, mode=mode, cache=cache, pos=pos,
                      pages=pages)
        if mode == "prefill":
            kvs.append(kv)
    if mode == "prefill":
        return x, {key: torch.stack([kv[key] for kv in kvs]) for key in ("k", "v")}
    return x, caches


def _stack_trees(trees: list) -> dict:
    """[{key: tensor}] -> {key: stacked tensor}, nested dicts alike."""
    return {key: (_stack_trees([t[key] for t in trees])
                  if isinstance(trees[0][key], dict)
                  else torch.stack([t[key] for t in trees]))
            for key in trees[0]}


# ---------------------------------------------------------------------------
# SSM-family forward (mamba2)
# ---------------------------------------------------------------------------


def _ssm_forward(params, x, cfg, ctx, *, mode, caches=None):
    """x (B, S, d). prefill returns the stacked per-layer caches
    {"conv_x", "conv_bc", "ssd"}; decode advances ``caches`` in place."""
    bctx = ctx.scoped("blocks")
    full = _remat(mamba2.mamba_full,
                  ctx.remat and mode == "train" and _recorded(params))
    per_layer = []
    for i in range(cfg.n_layers):
        p_layer = layer_slice(params["blocks"], i)
        if mode == "decode":
            out = mamba2.mamba_step(p_layer, x, layer_slice(caches, i), cfg, bctx)
        else:
            out, cache = full(p_layer, x, cfg, bctx,
                              return_cache=(mode == "prefill"))
            per_layer.append(cache)
        x = x + out
    if mode == "prefill":
        return x, _stack_trees(per_layer)
    return x, caches


# ---------------------------------------------------------------------------
# Hybrid-family forward (zamba2: shared attention block + mamba groups)
# ---------------------------------------------------------------------------


def _hybrid_forward(params, x, cfg, ctx, *, mode, caches=None, pos=None):
    """x (B, S, d): for each of the ``ns`` groups, the one shared
    attention+MLP block (its own KV cache per invocation), then the group's
    ``per`` Mamba blocks. prefill returns {"layers": (ns, per, ...) caches,
    "kv": (ns, B, S, Hkv, Dh)}; decode advances ``caches`` in place."""
    shared = params["shared"]
    sctx = ctx.scoped("shared")
    bctx = ctx.scoped("blocks")
    ns, per = _hybrid_layout(cfg)

    def shared_apply(h, kv_cache):
        hn = tf.norm_apply(shared["norm1"], h, cfg)
        if mode == "decode":
            a, new_kv = tf.attn_decode(shared["attn"], hn, kv_cache, pos, cfg,
                                       sctx)
        else:
            a, new_kv = tf.attn_full(shared["attn"], hn, cfg, sctx,
                                     return_cache=(mode == "prefill"))
        h = h + a
        h2 = tf.norm_apply(shared["norm2"], h, cfg)
        return h + tf.mlp_apply(shared["mlp"], h2, cfg, sctx), new_kv

    def group_apply(x, p_super):
        """The train mode's group: the shared block, then ``per`` Mamba
        layers (the unit the reference remats)."""
        x, _ = shared_apply(x, None)
        for j in range(per):
            x = x + mamba2.mamba_full(layer_slice(p_super, j), x, cfg, bctx)[0]
        return x

    group = _remat(group_apply, ctx.remat and _recorded(params))
    kvs, groups = [], []
    for s in range(ns):
        p_super = layer_slice(params["blocks"], s)
        if mode == "train":
            x = group(x, p_super)
            continue
        x, kv = shared_apply(x, layer_slice(caches["kv"], s)
                             if mode == "decode" else None)
        kvs.append(kv)
        mcaches = []
        for j in range(per):
            p_layer = layer_slice(p_super, j)
            if mode == "decode":
                out = mamba2.mamba_step(
                    p_layer, x, layer_slice(layer_slice(caches["layers"], s), j),
                    cfg, bctx)
            else:
                out, mc = mamba2.mamba_full(p_layer, x, cfg, bctx,
                                            return_cache=True)
                mcaches.append(mc)
            x = x + out
        groups.append(mcaches)
    if mode == "prefill":
        return x, {"layers": _stack_trees([_stack_trees(g) for g in groups]),
                   "kv": _stack_trees(kvs)}
    return x, caches


# ---------------------------------------------------------------------------
# Audio encoder-decoder forward (whisper)
# ---------------------------------------------------------------------------


def _encode(params, frames, cfg, ctx):
    """frames (B, S_enc, d): precomputed frame embeddings (the stub
    frontend), plus sinusoidal positions, through the non-causal encoder
    blocks and the encoder's final norm."""
    S, d = frames.shape[1], frames.shape[2]
    x = (frames.to(ctx.compute_dtype)
         + sinusoid(torch.arange(S, device=frames.device), d).to(ctx.compute_dtype))
    ectx = ctx.scoped("enc_blocks")

    def block(p, x):
        h = tf.norm_apply(p["norm1"], x, cfg)
        a, _ = tf.attn_full(p["attn"], h, cfg, ectx, causal=False, use_rope=False)
        x = x + a
        h2 = tf.norm_apply(p["norm2"], x, cfg)
        return x + tf.mlp_apply(p["mlp"], h2, cfg, ectx)

    block = _remat(block, ctx.remat and _recorded(params))
    for i in range(cfg.enc_layers):
        x = block(layer_slice(params["enc_blocks"], i), x)
    return tf.norm_apply(params["enc_norm"], x, cfg)


def _cross_kv(params, enc, cfg, ctx) -> dict:
    """The encoder output projected into each decoder layer's cross K/V:
    {"k", "v"} (L, B, S_enc, Hkv, Dh)."""
    bctx = ctx.scoped("blocks")
    kvs = [tf.proj_kv(layer_slice(params["blocks"], i)["xattn"], enc, cfg, bctx,
                      "xattn") for i in range(cfg.n_layers)]
    return {"k": torch.stack([k for k, _ in kvs]),
            "v": torch.stack([v for _, v in kvs])}


def _dec_block_apply(p, x, cfg, ctx, *, mode, self_cache, cross_kv, pos):
    h = tf.norm_apply(p["norm1"], x, cfg)
    if mode == "decode":
        a, new_self = tf.attn_decode(p["attn"], h, self_cache, pos, cfg, ctx,
                                     use_rope=False)
    else:
        a, new_self = tf.attn_full(p["attn"], h, cfg, ctx, use_rope=False,
                                   return_cache=(mode == "prefill"))
    x = x + a
    hx = tf.norm_apply(p["norm_x"], x, cfg)
    if mode == "decode":
        a, _ = tf.attn_decode(p["xattn"], hx, cross_kv, pos, cfg, ctx,
                              use_rope=False, cross=True, site="xattn")
    else:
        # the whole decoder sequence against the encoder's K/V
        S, Sk = hx.shape[1], cross_kv["k"].shape[1]
        q = tf.proj_q(p["xattn"], hx, cfg, ctx, "xattn")
        o = flash_attention(q, cross_kv["k"], cross_kv["v"], causal=False,
                            chunking=AttnChunking(
                                q_chunk=min(ctx.attn_q_chunk, S),
                                k_chunk=min(ctx.attn_k_chunk, Sk)))
        a = tf.out_proj(p["xattn"], o, cfg, ctx, "xattn")
    x = x + a
    h2 = tf.norm_apply(p["norm2"], x, cfg)
    return x + tf.mlp_apply(p["mlp"], h2, cfg, ctx), new_self


def _audio_forward(params, x, cfg, ctx, *, mode, frames=None, caches=None,
                   pos=None):
    """x (B, S_dec, d) the embedded decoder input. prefill encodes
    ``frames`` and returns {"self": (L, B, S_dec, Hkv, Dh) K/V, "cross":
    (L, B, S_enc, Hkv, Dh) K/V}; decode appends to ``caches["self"]`` in
    place and reads ``caches["cross"]``."""
    bctx = ctx.scoped("blocks")
    if mode == "decode":
        for i in range(cfg.n_layers):
            x, _ = _dec_block_apply(
                layer_slice(params["blocks"], i), x, cfg, bctx, mode=mode,
                self_cache=layer_slice(caches["self"], i),
                cross_kv=layer_slice(caches["cross"], i), pos=pos)
        return x, caches
    cross = _cross_kv(params, _encode(params, frames, cfg, ctx), cfg, ctx)
    block = _remat(_dec_block_apply,
                   ctx.remat and mode == "train" and _recorded(params))
    selfs = []
    for i in range(cfg.n_layers):
        x, kv = block(layer_slice(params["blocks"], i), x, cfg, bctx,
                      mode=mode, self_cache=None,
                      cross_kv=layer_slice(cross, i), pos=None)
        selfs.append(kv)
    if mode == "prefill":
        return x, {"self": _stack_trees(selfs), "cross": cross}
    return x, None


def _backbone(params, x, cfg, ctx, *, mode, caches=None, pos=None, pages=None,
              frames=None):
    """x (B, S, d) through the family's blocks -> (hidden states, caches).
    ``mode``: "train", the cache-free full-sequence forward of
    :func:`train_loss` and the calibration probe (layer remat per the
    module's rule where autograd records it); "prefill", the same forward
    returning the decode cache; "decode", one token against ``caches``."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: expected train, prefill or decode")
    if cfg.family in KV_FAMILIES:
        return _transformer_forward(params, x, cfg, ctx, mode=mode,
                                    caches=caches, pos=pos, pages=pages)
    if pages is not None:
        raise ValueError(f"the paged KV pool is transformer-only, got "
                         f"{cfg.family!r}")
    if cfg.family == "ssm":
        return _ssm_forward(params, x, cfg, ctx, mode=mode, caches=caches)
    if cfg.family == "audio":
        return _audio_forward(params, x, cfg, ctx, mode=mode, frames=frames,
                              caches=caches, pos=pos)
    return _hybrid_forward(params, x, cfg, ctx, mode=mode, caches=caches, pos=pos)


def train_loss(params: dict, batch: dict, cfg: ArchConfig, ctx: ModelCtx
               ) -> torch.Tensor:
    """Next-token CE loss over every position of the batch. ``batch`` is
    {"tokens"} (B, S), {"embeds" (B, S, d), "labels" (B, S)} for the vlm
    family, or {"frames" (B, S_enc, d), "tokens" (B, S)} for the audio
    family (its decoder reads the tokens with sinusoidal positions)."""
    _check_family(cfg)
    if cfg.family == "audio":
        labels = batch["tokens"]
        x = embed_tokens(params, labels, cfg, ctx)
        x = x + sinusoid(torch.arange(x.shape[1], device=x.device),
                         cfg.d_model).to(x.dtype)
        h, _ = _backbone(params, x, cfg, ctx, mode="train",
                         frames=batch["frames"])
    elif cfg.embeds_input:
        labels = batch["labels"]
        h, _ = _backbone(params, batch["embeds"].to(ctx.compute_dtype), cfg,
                         ctx, mode="train")
    else:
        labels = batch["tokens"]
        h, _ = _backbone(params, embed_tokens(params, labels, cfg, ctx), cfg,
                         ctx, mode="train")
    logits = lm_logits(params, h, cfg, ctx)
    return cross_entropy(logits[:, :-1], labels[:, 1:])


def prefill(params: dict, batch: dict, cfg: ArchConfig, ctx: ModelCtx):
    """Process the prompt; return (last-token logits (B, V), decode cache).
    ``batch`` is {"tokens"} (B, S), {"embeds"} (B, S, d) for the vlm
    family (cast to the compute dtype), or {"frames"} (B, S_enc, d) for the
    audio family, whose decoder then consumes BOS (token 0) alone."""
    with span("lm.prefill"):
        _check_family(cfg)
        if cfg.family == "audio":
            frames = batch["frames"]
            bos = torch.zeros((frames.shape[0], 1), dtype=torch.long,
                              device=frames.device)
            x = embed_tokens(params, bos, cfg, ctx)
            x = x + sinusoid(torch.arange(1, device=x.device), cfg.d_model).to(x.dtype)
            h, caches = _backbone(params, x, cfg, ctx, mode="prefill", frames=frames)
        elif cfg.embeds_input:
            x = batch["embeds"].to(ctx.compute_dtype)
            h, caches = _backbone(params, x, cfg, ctx, mode="prefill")
        else:
            x = embed_tokens(params, batch["tokens"], cfg, ctx)
            h, caches = _backbone(params, x, cfg, ctx, mode="prefill")
        logits = lm_logits(params, h[:, -1:], cfg, ctx)[:, 0]
        if cfg.family == "ssm":
            return logits, {"layers": caches, "pos": x.shape[1]}
        if cfg.family == "hybrid":
            return logits, {"layers": caches["layers"], "kv": caches["kv"],
                            "pos": x.shape[1]}
        if cfg.family == "audio":
            return logits, {"self": caches["self"], "cross": caches["cross"],
                            "pos": x.shape[1]}
        return logits, {"kv": caches, "pos": x.shape[1]}


def pad_cache(cache: dict, cfg: ArchConfig, capacity: int) -> dict:
    """Grow the prefill's growing KV cache ("kv", or the audio decoder's
    "self"; never the read-only "cross") along the token axis to
    ``capacity`` (dense leaves (L, B, S, Hkv, Dh) pad axis 2; packed leaves
    their own layout's token axis). Zero padding is inert under the length
    mask. A cache without KV (ssm) is returned as it is."""
    def pad_dense(x):
        s = x.shape[2]
        if s >= capacity:
            return x
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, capacity - s))

    out = dict(cache)
    for key in ("kv", "self"):
        if key in out:
            out[key] = {name: (kvcache.pad_tokens(t, capacity)
                               if kvcache.is_packed_kv(t) else pad_dense(t))
                        for name, t in out[key].items()}
    return out


def quantize_kv_cache(cache: dict, cfg: ArchConfig) -> dict:
    """Convert a prefill KV cache to the HiF4-packed kernel-tile layout
    (one-time; bit-identical to appending the tokens one at a time): the
    transformer families' "kv", the audio decoder's "self" and its
    read-only "cross" (packed once here, only ever read after). Layers are
    packed one at a time to bound the float32 working set. The ssm and
    hybrid families have no packed layout (their KV, if any, stays bf16)."""
    with span("kv.pack"):
        if cfg.family not in PACKED_KV_FAMILIES:
            raise ValueError(f"quantize_kv_cache packs the attention caches of "
                             f"{PACKED_KV_FAMILIES}, got {cfg.family!r}")

        def pack(t):
            per_layer = [kvcache.to_kernel_layout(kvcache.quantize_kv(t[i]))
                         for i in range(t.shape[0])]
            return {key: torch.stack([p[key] for p in per_layer])
                    for key in ("codes", "meta", "tail")}

        out = dict(cache)
        for key in (("self", "cross") if cfg.family == "audio" else ("kv",)):
            out[key] = {"k": pack(cache[key]["k"]), "v": pack(cache[key]["v"])}
        return out


def decode_step(params: dict, token: torch.Tensor, cache: dict,
                cfg: ArchConfig, ctx: ModelCtx):
    """token (B,) -> (logits (B, V), cache advanced by one token, in place).
    A paged cache (``pages`` present) keeps its page table. The audio
    decoder adds the sinusoid at each slot's position."""
    with span("lm.decode_step"):
        pos = cache["pos"]
        x = embed_tokens(params, token[:, None], cfg, ctx)            # (B, 1, d)
        if cfg.family == "audio":
            posv = kvcache.slot_positions(pos, x.shape[0], x.device)
            x = x + sinusoid(posv[:, None], cfg.d_model).to(x.dtype)
            h, new = _backbone(params, x, cfg, ctx, mode="decode", caches=cache,
                               pos=pos)
            new_cache = {"self": new["self"], "cross": new["cross"], "pos": pos + 1}
        elif cfg.family == "ssm":
            h, layers = _backbone(params, x, cfg, ctx, mode="decode",
                                  caches=cache["layers"])
            new_cache = {"layers": layers, "pos": pos + 1}
        elif cfg.family == "hybrid":
            h, new = _backbone(params, x, cfg, ctx, mode="decode", caches=cache,
                               pos=pos)
            new_cache = {"layers": new["layers"], "kv": new["kv"], "pos": pos + 1}
        else:
            pages = cache.get("pages")
            h, kv = _backbone(params, x, cfg, ctx, mode="decode",
                              caches=cache["kv"], pos=pos, pages=pages)
            new_cache = {"kv": kv, "pos": pos + 1}
            if pages is not None:
                new_cache["pages"] = pages
        logits = lm_logits(params, h[:, -1:], cfg, ctx)[:, 0]
        return logits, new_cache


# ---------------------------------------------------------------------------
# Packed-weight serving conversion (HiF4 4.5-bit deployment artifact)
# ---------------------------------------------------------------------------


def quant_plan(cfg: ArchConfig, policy) -> QuantPlan:
    """Resolve a policy (or a global QuantConfig, via the uniform shim)
    against this architecture's param specs."""
    if isinstance(policy, QuantPlan):
        return policy
    if isinstance(policy, QuantConfig):
        policy = QuantPolicy.uniform(policy)
    return policy.resolve(abstract_params(cfg), family=cfg.family)


def _marker_geometry(site, axes: tuple):
    """(k, n, L, out_name, c_name) of a packed STACKED site spec."""
    ca = site.contract_axes
    out_axes = tuple(a for a in range(1, len(site.shape)) if a not in ca)
    k = math.prod(site.shape[a] for a in ca)
    n = math.prod(site.shape[a] for a in out_axes) if out_axes else 1
    out_name = next((axes[a] for a in out_axes if axes[a] is not None), None)
    c_name = next((axes[a] for a in ca if axes[a] is not None), None)
    return k, n, site.shape[0], out_name, c_name


def packed_overlay(specs: dict, plan: QuantPlan) -> dict:
    """Replace the block-weight PSpecs the PLAN marks packed with packed
    codes/meta PSpecs (artifact layout): a marker dict
    ``{"__packed__": True, "codes": PSpec, "meta": PSpec, "shape2d": (K, N),
    "dtype": ..., "axes2d": ...}`` that :func:`realize_packed` turns into a
    :class:`PackedW`. Meta words are int32 here (the port's uint32 bits)."""

    def walk(node, parts):
        if isinstance(node, PSpec):
            site = plan.get(".".join(parts))
            if site is None or not site.packed:
                return node
            k, n, n_layers, out_name, c_name = _marker_geometry(site, node.axes)
            return {
                "__packed__": True,
                "codes": PSpec((n_layers, n, k // 64, 32),
                               ("layers", out_name, c_name, None),
                               dtype=torch.uint8, init="zeros"),
                "meta": PSpec((n_layers, n, k // 64), ("layers", out_name, c_name),
                              dtype=torch.int32, init="zeros"),
                "shape2d": (k, n),
                "dtype": torch.bfloat16,
                "axes2d": (out_name, c_name),
            }
        if isinstance(node, dict):
            return {kk: walk(vv, parts + (kk,)) for kk, vv in node.items()}
        return node

    out = dict(specs)
    for blk in STACKED_COLLECTIONS:
        if blk in out:
            out[blk] = walk(out[blk], (blk,))
    return out


def is_packed_marker(node) -> bool:
    return isinstance(node, dict) and node.get("__packed__") is True


def realize_packed(tree, leaf_fn):
    """Convert packed markers into PackedW nodes (artifact layout) and every
    other PSpec through ``leaf_fn(pspec)`` (e.g. an empty tensor on the
    ``meta`` device as a load target, or a real buffer)."""
    def walk(node):
        if is_packed_marker(node):
            return PackedW(leaf_fn(node["codes"]), leaf_fn(node["meta"]),
                           tuple(node["shape2d"]), node["dtype"],
                           tuple(node["axes2d"]))
        if isinstance(node, PSpec):
            return leaf_fn(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(tree)


def pack_params_for_serving(params: dict, cfg: ArchConfig,
                            plan: Optional[QuantPlan] = None) -> dict:
    """Pack EXACTLY the sites ``plan`` marks packed into stacked PackedW
    leaves (artifact layout); every other leaf passes through."""
    if plan is None:
        plan = quant_plan(cfg, QuantConfig(fmt="hif4", impl="packed"))
    specs = abstract_params(cfg)

    def walk(p_node, s_node, parts):
        if isinstance(s_node, PSpec):
            site = plan.get(".".join(parts))
            if site is None or not site.packed:
                return p_node
            ca = tuple(a - 1 for a in site.contract_axes)
            stacked = [PackedW.from_dense(p_node[i], ca)
                       for i in range(p_node.shape[0])]
            return PackedW(torch.stack([s.codes for s in stacked]),
                           torch.stack([s.meta for s in stacked]),
                           stacked[0].shape2d, p_node.dtype,
                           _marker_geometry(site, s_node.axes)[3:])
        if isinstance(s_node, dict):
            return {k: walk(p_node[k], v, parts + (k,)) for k, v in s_node.items()}
        return p_node

    out = dict(params)
    for blk in STACKED_COLLECTIONS:
        if blk in out:
            out[blk] = walk(params[blk], specs[blk], (blk,))
    return out
