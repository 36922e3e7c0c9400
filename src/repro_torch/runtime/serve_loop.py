"""Batched serving loop: offline weight packing -> prefill -> greedy decode
(port of ``repro/runtime/serve_loop.py``: ``serve`` and the two schedulers
of ``serve_requests``).

Weights are converted ONCE into the artifact the configured execution path
consumes: sites the policy plan marks packed become 4.5-bit
:class:`~repro_torch.core.qlinear.PackedW` buffers in the K-major kernel
layout; quantized-but-not-packed sites get offline QDQ weights. The
reference's ``lax.scan`` decode chunk is a per-token Python loop here
(:func:`_decode_chunk`); caches and the page pool are updated in place.

:func:`serve_requests` is the continuous-batching scheduler: whole slots of
a contiguous cache, or (``kv_pages > 0``) the paged HiF4 pool with
copy-on-write prefix sharing, LRU eviction and youngest-first preemption.
The guard, the journal and the fault injector of the reference are not yet
ported, nor are serving artifacts.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional, Sequence

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


class PoolExhaustedError(RuntimeError):
    """The KV page pool cannot hold even one resident sequence."""


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    cache_capacity: Optional[int] = None   # default: prompt + max_new
    decode_chunk: int = 0                  # decode steps between host checks
    #                                        (eos, scheduling); 0 = serve:
    #                                        the whole budget, serve_requests:
    #                                        a quarter of it
    eos_id: Optional[int] = None           # stop a request at this token
    kv_format: Optional[str] = None        # 'bf16' | 'hif4'; None = the
    #                                        policy's (ctx.quant.kv)
    kv_pages: int = 0                      # > 0: paged scheduler with this
    #                                        many pool pages (hif4 KV only)
    kv_page_tokens: int = 64               # tokens per pool page
    prefix_sharing: bool = True            # share prompt-prefix pages


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


def kv_format_fallback(cfg: ArchConfig, quant: QuantConfig,
                       serve_cfg: ServeConfig) -> bool:
    """True when the requested KV format was narrowed by family fallback."""
    requested = serve_cfg.kv_format or quant.kv.kv_format
    return resolve_kv_format(cfg, quant, serve_cfg) != requested


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
    ``cache_capacity`` (default prompt + max_new_tokens) slots."""
    kv_fmt = resolve_kv_format(cfg, sctx.quant, serve_cfg, verbose=verbose)
    logits, cache = _prefill(cfg, serving_params, batch, sctx, kv_fmt)
    cap = serve_cfg.cache_capacity or int(cache["pos"]) + serve_cfg.max_new_tokens
    return logits, lm.pad_cache(cache, cfg, cap)


def _prefill(cfg: ArchConfig, serving_params: dict, batch: dict,
             sctx: ModelCtx, kv_fmt: str):
    """Prefill, then pack the prefix once for a hif4 KV serve."""
    logits, cache = lm.prefill(serving_params, batch, cfg, sctx)
    if kv_fmt == "hif4":
        cache = lm.quantize_kv_cache(cache, cfg)
    return logits, cache


def _decode_chunk(params, token, cache, done, n_tokens: int, cfg: ArchConfig,
                  sctx: ModelCtx, eos_id: Optional[int]):
    """Greedy-decode ``n_tokens`` steps (the reference's ``_decode_scan``).

    token (B,) int32 is the last emitted token; done (B,) bool masks
    finished requests (with an eos they keep emitting eos; their cache
    writes are inert, their outputs discarded). Returns (tokens (B,
    n_tokens), token, cache, done); nothing waits for the device."""
    out = []
    for _ in range(n_tokens):
        logits, cache = lm.decode_step(params, token, cache, cfg, sctx)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if eos_id is not None:
            nxt = torch.where(done, eos_id, nxt)
            done = done | (nxt == eos_id)
        token = nxt
        out.append(nxt)
    return torch.stack(out, dim=1), token, cache, done


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
        n = min(chunk, budget - emitted)
        toks, token, cache, done = _decode_chunk(params, token, cache, done, n,
                                                 cfg, sctx, serve_cfg.eos_id)
        out.append(toks)
        emitted += n
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


# ---------------------------------------------------------------------------
# Continuous batching: slot-based admission over a shared decode batch
# ---------------------------------------------------------------------------


def _insert_slot(cache: dict, slot_cache: dict, token: torch.Tensor,
                 slot_token: int, b: int):
    """Write a freshly prefilled request (batch 1, padded to the cache's
    capacity) into batch slot ``b``, in place: KV leaves, ``pos[b]`` and
    ``token[b]``."""
    lm.insert_slot_cache(cache, slot_cache, b)
    token[b] = slot_token
    return cache, token


def _finalize_result(toks: list, budget: int, eos_id: Optional[int]
                     ) -> torch.Tensor:
    """Trim a slot's emitted tokens to the request's (budget,) result: drop
    over-emission past the budget, and past eos replace everything with eos
    padding (a finished request keeps emitting eos inside its chunk)."""
    toks = toks[:budget]
    if eos_id is not None and eos_id in toks:
        stop = toks.index(eos_id) + 1
        toks = toks + [eos_id] * (budget - len(toks))
        toks = toks[:stop] + [eos_id] * (budget - stop)
    return torch.tensor(toks, dtype=torch.int32)


def serve_requests(cfg: ArchConfig, params: dict, requests: Sequence,
                   ctx: ModelCtx, serve_cfg: ServeConfig = ServeConfig(), *,
                   slots: int = 4, stats: Optional[dict] = None,
                   device: DeviceLike = None, injector=None,
                   resume: bool = False) -> list:
    """Continuous-batching scheduler: serve ``requests`` (prompt token
    sequences) through a fixed number of decode ``slots`` on ``device``.

    Each request is prefilled alone at its true length and admitted into a
    free slot with its own cache position; the shared decode batch advances
    in chunks of ``decode_chunk`` steps with per-slot positions and done
    masks, and a slot whose request reached its budget (or eos) takes the
    next queued request. Batch rows never mix and invalid cache columns are
    masked by the per-slot length, so each result equals serving that
    request alone at the same cache capacity.

    With ``serve_cfg.kv_pages > 0`` (hif4 KV only) the whole-slot cache is
    replaced by the paged pool scheduler (:func:`_serve_requests_paged`).

    Returns a list of (max_new_tokens,) int32 CPU tensors in submission
    order. ``stats`` (a dict) receives the scheduler's counters. The
    reference's guard and journal are not yet ported (``ServeConfig`` has
    no such fields); its ``injector`` and ``resume`` arguments raise.
    """
    if injector is not None or resume:
        raise NotImplementedError("the fault injector and journal resume are "
                                  "not yet ported to repro_torch")
    if cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError(f"continuous batching supports KV-cache families, "
                         f"got {cfg.family!r}")
    dev = resolve_device(device)
    sctx = serving_ctx(ctx)
    params = prepare_params_for_serving(params, cfg, ctx.plan or ctx.quant,
                                        device=dev)
    kv_fmt = resolve_kv_format(cfg, ctx.quant, serve_cfg, verbose=True)
    prompts = [[int(t) for t in torch.as_tensor(r).reshape(-1).tolist()]
               for r in requests]
    if serve_cfg.kv_pages:
        if kv_fmt != "hif4":
            raise ValueError("the paged KV pool stores packed HiF4 pages; bf16 "
                             "serving must use the whole-slot scheduler")
        return _serve_requests_paged(cfg, params, prompts, sctx, serve_cfg,
                                     slots=slots, device=dev, stats=stats)

    budget = serve_cfg.max_new_tokens
    eos = serve_cfg.eos_id
    cap = serve_cfg.cache_capacity or max(len(p) for p in prompts) + budget
    B = min(slots, len(prompts))
    chunk = serve_cfg.decode_chunk or max(1, budget // 4)

    cache = lm.init_cache(cfg, B, cap, kv_fmt, device=dev)
    token = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.ones((B,), dtype=torch.bool, device=dev)  # empty slots: done
    queue = list(range(len(prompts)))
    slot_req: list = [None] * B
    slot_toks: list[list] = [[] for _ in range(B)]
    results: list = [None] * len(prompts)
    max_concurrent = 0

    def admit(b: int):
        nonlocal cache, token
        rid = queue.pop(0)
        logits, slot_cache = _prefill(
            cfg, params, {"tokens": _prompt_tensor(prompts[rid], dev)}, sctx, kv_fmt)
        slot_cache = lm.pad_cache(slot_cache, cfg, cap)
        first = int(torch.argmax(logits, dim=-1)[0])
        cache, token = _insert_slot(cache, slot_cache, token, first, b)
        slot_req[b] = rid
        slot_toks[b] = [first]
        done[b] = eos is not None and first == eos

    while queue or any(r is not None for r in slot_req):
        for b in range(B):
            if slot_req[b] is None and queue:
                admit(b)
        max_concurrent = max(max_concurrent, sum(r is not None for r in slot_req))
        active = torch.tensor([r is not None for r in slot_req], device=dev)
        toks, token, cache, done = _decode_chunk(params, token, cache,
                                                 done | ~active, chunk, cfg,
                                                 sctx, eos)
        host_toks = toks.tolist()
        for b in range(B):
            if slot_req[b] is None:
                continue
            slot_toks[b].extend(host_toks[b])
            if len(slot_toks[b]) >= budget or (eos is not None and eos in slot_toks[b]):
                results[slot_req[b]] = _finalize_result(slot_toks[b], budget, eos)
                slot_req[b] = None
    if stats is not None:
        stats.update(scheduler="slots", max_concurrent=max_concurrent,
                     preemptions=0, shared_page_hits=0, evictions=0)
    return results


def _prompt_tensor(toks: list, device) -> torch.Tensor:
    return torch.tensor([toks], dtype=torch.long, device=device)


# ---------------------------------------------------------------------------
# Paged continuous batching: page-pool admission + COW prefix sharing
# ---------------------------------------------------------------------------


def _pool_gather(pool: dict, ids) -> dict:
    """A host COPY of pool pages ``ids`` (K and V, all layers): the
    preemption snapshot. ``index_select`` copies, so the snapshot never
    aliases the pool, on the CPU either."""
    ids = torch.as_tensor(ids, dtype=torch.long)
    return {name: {key: a.cpu() for key, a in kvcache.gather_pages(t, ids).items()}
            for name, t in pool.items()}


def _pool_scatter(pool: dict, pages_k: dict, pages_v: dict, src, dst) -> dict:
    """Write logical pages ``src`` of the (L, n, F, P) blocks into pool
    pages ``dst`` (K and V together), in place."""
    src = torch.as_tensor(src, dtype=torch.long)
    dst = torch.as_tensor(dst, dtype=torch.long)

    def sel(t):
        return {key: a.index_select(1, src.to(a.device)) for key, a in t.items()}

    kvcache.scatter_pages(pool["k"], sel(pages_k), dst)
    kvcache.scatter_pages(pool["v"], sel(pages_v), dst)
    return pool


def _pool_copy(pool: dict, src: int, dst: int) -> dict:
    kvcache.copy_page(pool["k"], src, dst)
    kvcache.copy_page(pool["v"], src, dst)
    return pool


def _page_prefix_equal(pool: dict, pid: int, page_k: dict, page_v: dict,
                       count: int) -> bool:
    """True iff pool page ``pid`` matches the candidate page blocks (L, F, P)
    byte for byte on the first ``count`` token columns: the share-time
    check that makes prefix sharing exact by construction rather than by
    trust in the hash."""
    for pool_t, page in ((pool["k"], page_k), (pool["v"], page_v)):
        for key in ("codes", "meta", "tail"):
            if not torch.equal(pool_t[key][:, pid, ..., :count],
                               page[key][..., :count]):
                return False
    return True


def _serve_requests_paged(cfg: ArchConfig, params: dict, prompts: list,
                          sctx: ModelCtx, serve_cfg: ServeConfig, *,
                          slots: int, device: torch.device,
                          stats: Optional[dict] = None) -> list:
    """Page-pool continuous batching (the :func:`serve_requests` backend for
    ``serve_cfg.kv_pages > 0``).

    The whole-slot cache is replaced by a pool of ``kv_pages`` HiF4 pages of
    ``kv_page_tokens`` tokens; per-slot page tables map logical page
    indices to pool pages, and decode attention walks the table (kernel 4).

    * **admission**: FIFO; the queue head is admitted when its PROMPT pages
      fit (pages it shares with resident requests do not count);
    * **prefix sharing**: prompt pages whose cumulative token key hits the
      full-page hash (or whose tail matches a live partial page) are shared
      by refcount after a byte-for-byte check; a holder that must append
      into a page it does not own copies it first (copy-on-write);
    * **eviction / preemption**: retired requests' full pages park in an LRU
      cache, evicted when the pool runs dry; if nothing is evictable the
      YOUNGEST resident request is preempted: its page bytes are copied to
      the host, its pages freed, and it re-enters the queue front to be
      restored byte for byte later.

    Each result equals solo serving at ``attn_kv_block = P``: pages
    partition the token axis like the contiguous kernel's KV tiles, appends
    land in pages their slot owns alone, and fully masked tiles are exact
    no-ops.
    """
    P = serve_cfg.kv_page_tokens
    budget = serve_cfg.max_new_tokens
    eos = serve_cfg.eos_id
    n_req = len(prompts)
    cap = serve_cfg.cache_capacity or max(len(p) for p in prompts) + budget
    for p_toks in prompts:
        if len(p_toks) + budget > cap:
            raise ValueError(f"prompt {len(p_toks)} + budget {budget} exceeds "
                             f"capacity {cap}")
    maxp = kvcache.pages_for_tokens(cap, P)
    pool = kvcache.PagePool(serve_cfg.kv_pages, P)
    if maxp > pool.usable_pages:
        raise ValueError(f"one max-length sequence needs {maxp} pages but the "
                         f"pool has only {pool.usable_pages} usable "
                         f"(kv_pages={serve_cfg.kv_pages} minus the scratch page)")
    B = min(slots, n_req)
    dev = device
    cache = lm.init_paged_cache(cfg, B, serve_cfg.kv_pages, P, maxp, device=dev)
    token = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.ones((B,), dtype=torch.bool, device=dev)
    chunk = serve_cfg.decode_chunk or max(1, budget // 4)

    queue = list(range(n_req))
    suspended: dict = {}               # rid -> preemption byte snapshot
    slot_req: list = [None] * B
    slot_toks: list[list] = [[] for _ in range(B)]
    slot_written: list[list] = [[] for _ in range(B)]  # tokens whose KV is
    #                                                    resident, in order
    slot_pages: list[list] = [[] for _ in range(B)]    # pool ids, logical
    admit_clock = [0] * B
    results: list = [None] * n_req
    clock = preempt_count = max_concurrent = peak_live = 0

    def set_table_row(b, pids):
        row = torch.zeros((maxp,), dtype=torch.int32)
        row[: len(pids)] = torch.tensor(pids, dtype=torch.int32)
        cache["pages"][b] = row.to(dev)

    def refresh_metadata(b):
        """Index slot ``b``'s OWNED pages for sharing: completed pages by
        their cumulative token key, the live tail page in the partial
        registry. The last table entry is never indexed: over-emission in a
        request's final chunk clamps into it, so its bytes are not trusted."""
        rid = slot_req[b]
        written = slot_written[b]
        for j, pid in enumerate(slot_pages[b]):
            if j == maxp - 1 or pool.owner.get(pid) != rid:
                continue
            seg = written[j * P:(j + 1) * P]
            if len(seg) == P:
                pool.register_full(pid, tuple(written[: (j + 1) * P]))
            elif seg:
                pool.register_partial(pid, tuple(written[: j * P]), seg)

    def release_slot(b):
        for pid in slot_pages[b]:
            pool.release(pid)                  # hashed full pages park LRU
        slot_pages[b] = []
        slot_req[b] = None
        slot_toks[b] = []
        slot_written[b] = []
        set_table_row(b, [])                   # its writes -> scratch page 0

    def preempt(b):
        nonlocal preempt_count
        rid = slot_req[b]
        suspended[rid] = {
            "pages": _pool_gather(cache["kv"], slot_pages[b]),  # BYTES
            "token": int(token[b]),
            "toks": slot_toks[b],
            "written": slot_written[b],
        }
        release_slot(b)
        queue.insert(0, rid)
        preempt_count += 1

    def alloc_page(rid, requester):
        """Allocate, preempting youngest-first when the pool is dry. Returns
        None when the requester itself was the victim."""
        while True:
            pid = pool.alloc(owner=rid)
            if pid is not None:
                return pid
            live = [b for b in range(B) if slot_req[b] is not None]
            if not live:
                raise PoolExhaustedError(
                    f"KV page pool exhausted: {pool.usable_pages} usable pages "
                    "cannot hold even one resident sequence")
            victim = max(live, key=lambda b: admit_clock[b])
            preempt(victim)
            if victim == requester:
                return None

    def try_admit(b, rid):
        nonlocal clock
        snap = suspended.get(rid)
        if snap is not None:
            n = snap["pages"]["k"]["meta"].shape[1]
            if pool.available() < n:
                return False
            pids = [pool.alloc(owner=rid) for _ in range(n)]
            _pool_scatter(cache["kv"], snap["pages"]["k"], snap["pages"]["v"],
                          list(range(n)), pids)
            del suspended[rid]
            token[b] = snap["token"]
            cache["pos"][b] = len(snap["written"])
            done[b] = False
            slot_toks[b] = snap["toks"]
            slot_written[b] = snap["written"]
        else:
            toks = prompts[rid]
            logits, slot_cache = _prefill(cfg, params,
                                          {"tokens": _prompt_tensor(toks, dev)},
                                          sctx, "hif4")
            kp = kvcache.split_pages(slot_cache["kv"]["k"], P)
            vp = kvcache.split_pages(slot_cache["kv"]["v"], P)
            n_pg = kvcache.pages_for_tokens(len(toks), P)
            share: list = [None] * n_pg
            if serve_cfg.prefix_sharing:
                for j in range(n_pg):
                    seg = toks[j * P:(j + 1) * P]
                    if len(seg) == P:
                        cand = pool.lookup_full(tuple(toks[: (j + 1) * P]))
                    else:
                        cand = pool.lookup_partial(tuple(toks[: j * P]), seg)
                    if cand is not None and _page_prefix_equal(
                            cache["kv"], cand,
                            {key: a[:, j] for key, a in kp.items()},
                            {key: a[:, j] for key, a in vp.items()}, len(seg)):
                        share[j] = cand
            n_new = sum(1 for s in share if s is None)
            n_revive = sum(1 for s in share if s is not None and s in pool.cached)
            if pool.available() < n_new + n_revive:
                return False
            # retain every shared page BEFORE allocating: alloc may evict
            # from the LRU cache, and a not-yet-retained candidate must not
            # be its victim
            for s in share:
                if s is not None:
                    pool.retain(s)
                    pool.shared_hits += 1
            pids, own_src, own_dst = [], [], []
            for j in range(n_pg):
                if share[j] is not None:
                    pids.append(share[j])
                else:
                    pid = pool.alloc(owner=rid)
                    own_src.append(j)
                    own_dst.append(pid)
                    pids.append(pid)
            if own_dst:
                _pool_scatter(cache["kv"], kp, vp, own_src, own_dst)
            first = int(torch.argmax(logits, dim=-1)[0])
            token[b] = first
            cache["pos"][b] = len(toks)
            done[b] = eos is not None and first == eos
            slot_toks[b] = [first]
            slot_written[b] = list(toks)
        slot_req[b] = rid
        slot_pages[b] = pids
        set_table_row(b, pids)
        clock += 1
        admit_clock[b] = clock
        refresh_metadata(b)
        return True

    def provision(b):
        """Pre-chunk page work for slot ``b``: copy-on-write the page its
        next append lands in if another holder shares it, then allocate
        pages through the chunk horizon. False if ``b`` got preempted."""
        rid = slot_req[b]
        pos_b = len(slot_written[b])
        cur = pos_b // P
        if cur < len(slot_pages[b]):
            pid = slot_pages[b][cur]
            if pool.owner.get(pid) != rid:
                if pool.ref.get(pid, 0) > 1:
                    new = alloc_page(rid, b)
                    if new is None:
                        return False
                    _pool_copy(cache["kv"], pid, new)
                    pool.release(pid)
                    slot_pages[b][cur] = new
                    cache["pages"][b, cur] = new
                else:
                    pool.owner[pid] = rid      # sole holder adopts in place
        last = min((pos_b + chunk - 1) // P, maxp - 1)
        for j in range(len(slot_pages[b]), last + 1):
            pid = alloc_page(rid, b)
            if pid is None:
                return False
            slot_pages[b].append(pid)
            cache["pages"][b, j] = pid
        return True

    while queue or any(r is not None for r in slot_req):
        # admission: FIFO, page-fit driven; stop at the first request whose
        # prompt pages do not fit (no skip-ahead)
        while queue:
            free_b = next((b for b in range(B) if slot_req[b] is None), None)
            if free_b is None or not try_admit(free_b, queue[0]):
                break
            queue.pop(0)
        if not any(r is not None for r in slot_req):
            raise PoolExhaustedError(
                f"request {queue[0]} cannot be admitted into an empty pool "
                f"({pool.usable_pages} usable pages, {pool.available()} "
                "allocatable)")
        for b in range(B):
            if slot_req[b] is not None:
                provision(b)
        # counted AFTER provisioning: sequences really decoding this chunk
        max_concurrent = max(max_concurrent, sum(r is not None for r in slot_req))
        peak_live = max(peak_live, pool.live_pages())
        active = torch.tensor([r is not None for r in slot_req], device=dev)
        toks, token, cache, done = _decode_chunk(params, token, cache,
                                                 done | ~active, chunk, cfg,
                                                 sctx, eos)
        host_toks = toks.tolist()
        for b in range(B):
            if slot_req[b] is None:
                continue
            new = host_toks[b]
            # this chunk wrote KV for the pending token and every emission
            # but the newest (still pending)
            slot_written[b].extend([slot_toks[b][-1]] + new[:-1])
            slot_toks[b].extend(new)
            refresh_metadata(b)
            if len(slot_toks[b]) >= budget or (eos is not None and eos in slot_toks[b]):
                results[slot_req[b]] = _finalize_result(slot_toks[b], budget, eos)
                release_slot(b)
    audit = pool.audit(holders={f"slot{b}": slot_pages[b] for b in range(B)
                                if slot_pages[b]})
    if stats is not None:
        stats.update(
            scheduler="paged", max_concurrent=max_concurrent,
            preemptions=preempt_count, evictions=pool.evictions,
            shared_page_hits=pool.shared_hits, pages_total=serve_cfg.kv_pages,
            page_tokens=P, peak_live_pages=peak_live,
            pool_bytes=serve_cfg.kv_pages * kvcache.page_nbytes(
                cfg.attn.n_kv_heads, cfg.attn.d_head, P, cfg.n_layers),
            pool_audit=audit)
    return results
