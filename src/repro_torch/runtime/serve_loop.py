"""Batched serving loop: offline weight packing -> prefill -> greedy decode
(port of ``repro/runtime/serve_loop.py``, the lockstep ``serve`` path).

Weights are converted ONCE into the artifact the configured execution path
consumes: sites the policy plan marks packed become 4.5-bit
:class:`~repro_torch.core.qlinear.PackedW` buffers in the K-major kernel
layout; quantized-but-not-packed sites get offline QDQ weights. The
reference's ``lax.scan`` decode is a per-token Python loop here; the decode
cache is updated in place. The slot and paged schedulers come later.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import kvcache
from repro_torch.core.policy import STACKED_COLLECTIONS
from repro_torch.core.qlinear import PackedW, QuantConfig, _qdq_along, \
    quantize_params_offline
from repro_torch.device import DeviceLike, resolve_device, sync
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx


class KVFallbackWarning(UserWarning):
    """``kv_format=hif4`` was narrowed to bf16 for a family whose state has
    no packed layout."""


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    decode_chunk: int = 0                  # tokens between host checks of
    #                                        the eos mask; 0 = whole budget
    eos_id: Optional[int] = None           # stop a request at this token
    kv_format: Optional[str] = None        # 'bf16' | 'hif4'; None = the
    #                                        policy's (ctx.quant.kv)


def resolve_kv_format(cfg: ArchConfig, quant: QuantConfig,
                      serve_cfg: ServeConfig, *, verbose: bool = False) -> str:
    """The KV storage this serve runs: ServeConfig overrides the policy's;
    families without an attention cache fall back to bf16."""
    fmt = serve_cfg.kv_format or quant.kv.kv_format
    if fmt not in kvcache.KV_FORMATS:
        raise ValueError(f"kv_format {fmt!r} not in {kvcache.KV_FORMATS}")
    if fmt == "hif4" and cfg.family not in ("dense", "vlm", "moe", "audio"):
        if verbose:
            warnings.warn(f"kv_format=hif4 has no packed layout for family "
                          f"{cfg.family!r}; serving falls back to bf16 KV",
                          KVFallbackWarning, stacklevel=2)
        return "bf16"
    return fmt


def _to_kernel_layout(tree):
    if isinstance(tree, dict):
        return {k: _to_kernel_layout(v) for k, v in tree.items()}
    return tree.to_kernel_layout() if isinstance(tree, PackedW) else tree


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, PackedW)):
        return tree.to(device)
    return tree


def packed_weight_bytes(params) -> tuple[int, int]:
    """(packed payload bytes, packed value count) over all PackedW leaves."""
    total = values = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, PackedW):
            total += node.nbytes_packed
            values += node.n_values
    return total, values


def prepare_params_for_serving(params: dict, cfg: ArchConfig, quant, *,
                               device: DeviceLike = None) -> dict:
    """One-time offline conversion of block weights into the serving artifact
    on ``device`` (``quant``: a QuantConfig, QuantPolicy or QuantPlan). Sites
    the plan marks packed become PackedW in the K-major kernel layout; other
    quantized sites get offline QDQ weights; everything else stays full
    precision. Idempotent on a packed tree."""
    dev = resolve_device(device)
    params = _to_device(params, dev)
    plan = lm.quant_plan(cfg, quant)
    if not plan.enabled:
        return params
    if packed_weight_bytes(params)[1]:
        return _to_kernel_layout(params)
    out = dict(params)
    if plan.packed_paths:
        out = lm.pack_params_for_serving(out, cfg, plan)
    for key in STACKED_COLLECTIONS:
        if key in out:
            out[key] = quantize_params_offline(out[key], plan.base, plan=plan,
                                               prefix=key)
    site = plan.get("lm_head")
    if (site is not None and "lm_head" in out and site.quantize_offline
            and site.cfg.format() is not None):
        out["lm_head"] = _qdq_along(out["lm_head"], site.cfg.format(),
                                    site.contract_axes)
    if plan.packed_paths:
        return _to_kernel_layout(out)
    return out


def serving_ctx(ctx: ModelCtx) -> ModelCtx:
    """The context decode runs under: weights already quantized offline."""
    qcfg = dataclasses.replace(ctx.quant, offline_weights=True)
    plan = ctx.plan.with_offline_weights() if ctx.plan is not None else None
    return dataclasses.replace(ctx, quant=qcfg, plan=plan)


def kv_cache_bytes(cache: dict) -> tuple[int, int]:
    """(resident KV-cache bytes, token slots B * capacity) of a decode cache,
    bf16 or HiF4-packed."""
    total = slots = 0
    for tensor in (cache["kv"]["k"], cache["kv"]["v"]):
        if kvcache.is_packed_kv(tensor):
            total += kvcache.packed_kv_nbytes(tensor)
            b, s = tensor["meta"].shape[1], kvcache.seq_capacity(tensor)
        else:
            total += tensor.numel() * tensor.element_size()
            b, s = tensor.shape[1], tensor.shape[2]
        slots = b * s
    return total, slots


def build_decode_cache(cfg: ArchConfig, serving_params: dict, batch: dict,
                       sctx: ModelCtx, serve_cfg: ServeConfig, *,
                       verbose: bool = False):
    """Prefill and return (last-token logits, THE decode cache serve runs):
    prefill, pack the prefix once when the serve runs hif4 KV, then pad to
    prompt + max_new_tokens slots."""
    kv_fmt = resolve_kv_format(cfg, sctx.quant, serve_cfg, verbose=verbose)
    logits, cache = lm.prefill(serving_params, batch, cfg, sctx)
    if kv_fmt == "hif4":
        cache = lm.quantize_kv_cache(cache, cfg)
    cap = int(cache["pos"]) + serve_cfg.max_new_tokens
    return logits, lm.pad_cache(cache, cfg, cap)


def serve(cfg: ArchConfig, params: dict, batch: dict, ctx: ModelCtx,
          serve_cfg: ServeConfig = ServeConfig(), *,
          device: DeviceLike = None, stats: Optional[dict] = None
          ) -> torch.Tensor:
    """Greedy-decode ``max_new_tokens`` on ``device``; returns (B, T) int32
    tokens. All requests advance in lockstep. With ``stats`` (a dict), the
    prefill and decode wall times are recorded there (``prefill_s``,
    ``decode_s``, ``decode_steps``), each ending in a device synchronize.
    """
    dev = resolve_device(device)
    sctx = serving_ctx(ctx)
    params = prepare_params_for_serving(params, cfg, ctx.plan or ctx.quant,
                                        device=dev)
    batch = _to_device(batch, dev)
    t0 = time.perf_counter()
    logits, cache = build_decode_cache(cfg, params, batch, sctx, serve_cfg,
                                       verbose=True)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    done = torch.zeros(token.shape, dtype=torch.bool, device=dev)
    if serve_cfg.eos_id is not None:
        done = done | (token == serve_cfg.eos_id)
    if stats is not None:
        sync(dev)
        stats["prefill_s"] = time.perf_counter() - t0
    out = [token[:, None]]

    budget = serve_cfg.max_new_tokens - 1
    chunk = serve_cfg.decode_chunk or budget
    t1 = time.perf_counter()
    emitted = 0
    while emitted < budget:
        for _ in range(min(chunk, budget - emitted)):
            logits, cache = lm.decode_step(params, token, cache, cfg, sctx)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if serve_cfg.eos_id is not None:
                nxt = torch.where(done, serve_cfg.eos_id, nxt)
                done = done | (nxt == serve_cfg.eos_id)
            token = nxt
            out.append(nxt[:, None])
            emitted += 1
        if serve_cfg.eos_id is not None and bool(torch.all(done)):
            break
    if stats is not None:
        sync(dev)
        stats["decode_s"] = time.perf_counter() - t1
        stats["decode_steps"] = emitted
    toks = torch.cat(out, dim=1)
    if toks.shape[1] < serve_cfg.max_new_tokens and serve_cfg.eos_id is not None:
        pad = torch.full((toks.shape[0], serve_cfg.max_new_tokens - toks.shape[1]),
                         serve_cfg.eos_id, dtype=torch.int32, device=dev)
        toks = torch.cat([toks, pad], dim=1)
    return toks
