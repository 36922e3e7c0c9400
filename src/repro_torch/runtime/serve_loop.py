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
With ``ServeConfig.guard`` each request is its own fault domain (sentinels,
audits, quarantine with a fallback retry, bounded-retry rejection,
deadlines; :mod:`repro_torch.runtime.guard`); with ``journal_dir`` every
request's lifecycle goes through a write-ahead journal with pool
checkpoints, and ``resume=True`` recovers a crashed serve from it
(:mod:`repro_torch.runtime.journal`). ``injector`` drives the
deterministic faults of :mod:`repro_torch.runtime.faults`.

:func:`save_serving_artifact` / :func:`load_serving_artifact` write and
read the deployment artifact (the reference's on-disk format, verified on
load).
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
from repro_torch.runtime import guard as guard_mod
from repro_torch.runtime.guard import (
    ArtifactLayoutError,
    ArtifactNotFoundError,
    GuardConfig,
    PoolExhaustedError,
)


class KVFallbackWarning(UserWarning):
    """``kv_format=hif4`` was narrowed to bf16 for a family whose state has
    no packed layout."""


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
    guard: Optional[GuardConfig] = None    # health sentinels + fault domains
    #                                        (None = unguarded; failures raise)
    journal_dir: Optional[str] = None      # write-ahead request journal +
    #                                        pool checkpoints live here
    checkpoint_every: int = 0              # pool checkpoint cadence in decode
    #                                        chunks (paged scheduler; 0 = off)


def resolve_kv_format(cfg: ArchConfig, quant: QuantConfig,
                      serve_cfg: ServeConfig, *, verbose: bool = False) -> str:
    """The KV storage this serve runs: ServeConfig overrides the policy's.
    The attention caches pack (the transformer families', and the audio
    decoder's self and read-only cross caches); the SSM-state families fall
    back to bf16."""
    fmt = serve_cfg.kv_format or quant.kv.kv_format
    if fmt not in kvcache.KV_FORMATS:
        raise ValueError(f"kv_format {fmt!r} not in {kvcache.KV_FORMATS}")
    if fmt == "hif4" and cfg.family not in lm.PACKED_KV_FAMILIES:
        if verbose:
            warnings.warn(f"kv_format=hif4 has no packed layout for family "
                          f"{cfg.family!r} (SSM recurrent state) — serving "
                          f"falls back to bf16 KV", KVFallbackWarning,
                          stacklevel=2)
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
                               kernel_layout: bool = True,
                               device: DeviceLike = None) -> dict:
    """One-time offline conversion of block weights into the serving artifact
    on ``device`` (``quant``: a QuantConfig, QuantPolicy or QuantPlan). Sites
    the plan marks packed become PackedW in the K-major kernel layout; other
    quantized sites get offline QDQ weights; everything else stays full
    precision. Idempotent on a packed tree. ``kernel_layout=False`` keeps
    PackedW leaves in the artifact (output-major, on-disk) layout, what
    :func:`save_serving_artifact` writes; serving re-lays it out K-major."""
    dev = resolve_device(device)
    params = _to_device(params, dev)
    plan = lm.quant_plan(cfg, quant)
    if not plan.enabled:
        return params
    if packed_weight_bytes(params)[1]:
        # already packed: honor the layout request (there is no kernel ->
        # artifact inverse, so the artifact layout starts from raw weights)
        return _to_kernel_layout(params) if kernel_layout else params
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
    if plan.packed_paths and kernel_layout:
        return _to_kernel_layout(out)
    return out


def serving_ctx(ctx: ModelCtx) -> ModelCtx:
    """The context decode runs under: weights already quantized offline."""
    qcfg = dataclasses.replace(ctx.quant, offline_weights=True)
    plan = ctx.plan.with_offline_weights() if ctx.plan is not None else None
    return dataclasses.replace(ctx, quant=qcfg, plan=plan)


def save_serving_artifact(directory: str, params: dict, cfg: ArchConfig,
                          policy, *, device: DeviceLike = None) -> str:
    """Write the deployment artifact in the reference's format: the
    policy-converted weights (PackedW leaves in the on-disk artifact
    layout, offline QDQ elsewhere), converted on ``device``, plus the
    policy and an integrity block (per-PackedW-leaf sha256 over codes and
    meta, :func:`repro_torch.runtime.guard.artifact_integrity`) in the
    checkpoint's ``extra.json``. ``params`` are the RAW weights; ``policy``
    a QuantPolicy, QuantPlan or QuantConfig. Returns the step directory."""
    from repro_torch.checkpoint import save_checkpoint

    if packed_weight_bytes(params)[1]:
        raise ArtifactLayoutError(
            f"save_serving_artifact({directory!r}) was handed an "
            "already-packed tree. Expected RAW (unpacked) trained weights: "
            "packed PackedW leaves may be in the K-major kernel layout, "
            "which has no inverse back to the on-disk artifact layout. "
            "To re-export, load the raw training weights and call "
            "save_serving_artifact(directory, raw_params, cfg, policy) — "
            "the policy conversion happens inside.")
    plan = lm.quant_plan(cfg, policy)
    artifact = prepare_params_for_serving(params, cfg, plan, kernel_layout=False,
                                          device=device)
    extra = {"family": cfg.family,
             "quant_policy": plan.policy.to_json_dict(),
             "integrity": guard_mod.artifact_integrity(artifact)}
    return save_checkpoint(directory, 0, artifact, extra)


def load_serving_artifact(directory: str, cfg: ArchConfig, *,
                          device: DeviceLike = None):
    """Restore (serving_params, policy) written by :func:`save_serving_artifact`
    (by either package) onto ``device``. The policy is read first and its
    plan rebuilds the packed/dense tree the arrays load into; the packed
    leaves come back in the artifact layout (serving re-lays them out
    K-major once). An artifact with an integrity block is verified on the
    host before it moves: corruption raises
    :class:`repro_torch.runtime.guard.ArtifactIntegrityError` naming the
    leaf."""
    import json
    import os

    from repro_torch.checkpoint import latest_step, load_checkpoint
    from repro_torch.core.policy import QuantPolicy

    dev = resolve_device(device)
    step = latest_step(directory)
    if step is None:
        raise ArtifactNotFoundError(
            f"no serving artifact under {directory!r}: expected a "
            "step_<NNNNNNNN>/ directory holding manifest.json, the packed "
            "arrays, and extra.json with the serialized quant_policy. "
            "Re-export with repro_torch.runtime.serve_loop."
            "save_serving_artifact(directory, raw_params, cfg, policy).")
    with open(os.path.join(directory, f"step_{step:08d}", "extra.json")) as f:
        extra = json.load(f)
    policy = QuantPolicy.from_json_dict(extra["quant_policy"])
    plan = lm.quant_plan(cfg, policy)
    target = lm.realize_packed(
        lm.packed_overlay(lm.abstract_params(cfg), plan),
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"))
    params, _ = load_checkpoint(directory, step, target, device="cpu")
    integrity = extra.get("integrity")
    if integrity is not None:
        guard_mod.verify_artifact_integrity(params, integrity, directory)
    return _to_device(params, dev), policy


def kv_cache_bytes(cache: dict) -> tuple[int, int]:
    """(resident KV-cache bytes, token slots B * capacity) of a decode cache,
    bf16 or HiF4-packed: every attention cache ("kv", or the audio
    decoder's "self" and "cross") counts its bytes; the slots are the
    growing cache's (the read-only cross cache adds bytes, no slots)."""
    total = slots = 0
    for entry, counts_slots in (("kv", True), ("self", True), ("cross", False)):
        if entry not in cache:
            continue
        for tensor in (cache[entry]["k"], cache[entry]["v"]):
            if kvcache.is_packed_kv(tensor):
                total += kvcache.packed_kv_nbytes(tensor)
                b, s = tensor["meta"].shape[1], kvcache.seq_capacity(tensor)
            else:
                total += tensor.numel() * tensor.element_size()
                b, s = tensor.shape[1], tensor.shape[2]
            if counts_slots:
                slots = b * s
    return total, slots


def build_decode_cache(cfg: ArchConfig, serving_params: dict, batch: dict,
                       sctx: ModelCtx, serve_cfg: ServeConfig, *,
                       verbose: bool = False):
    """Prefill and return (last-token logits, THE decode cache serve runs):
    prefill ``batch`` ({"tokens"}, {"embeds"} or {"frames"}, as the family
    takes), pack the prefix once when the serve runs hif4 KV, then pad its
    growing KV, if it has one (not ssm), to ``cache_capacity`` (default
    prefill position + max_new_tokens; the audio decoder's position after
    the prefill is 1, BOS) slots."""
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


def _decode_steps(params, token, cache, done, n_tokens: int, cfg: ArchConfig,
                  sctx: ModelCtx, eos_id: Optional[int], bad=None):
    out = []
    for _ in range(n_tokens):
        logits, cache = lm.decode_step(params, token, cache, cfg, sctx)
        if bad is not None:
            bad = bad | guard_mod.bad_logits(logits)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if eos_id is not None:
            nxt = torch.where(done, eos_id, nxt)
            done = done | (nxt == eos_id)
        token = nxt
        out.append(nxt)
    return torch.stack(out, dim=1), token, cache, done, bad


def _decode_chunk(params, token, cache, done, n_tokens: int, cfg: ArchConfig,
                  sctx: ModelCtx, eos_id: Optional[int]):
    """Greedy-decode ``n_tokens`` steps (the reference's ``_decode_scan``).

    token (B,) int32 is the last emitted token; done (B,) bool masks
    finished requests (with an eos they keep emitting eos; their cache
    writes are inert, their outputs discarded). Returns (tokens (B,
    n_tokens), token, cache, done); nothing waits for the device."""
    return _decode_steps(params, token, cache, done, n_tokens, cfg, sctx,
                         eos_id)[:4]


def _decode_chunk_guarded(params, token, cache, done, bad, n_tokens: int,
                          cfg: ArchConfig, sctx: ModelCtx,
                          eos_id: Optional[int]):
    """:func:`_decode_chunk` with the health sentinels (the reference's
    ``_decode_scan_guarded``).

    ``bad`` (B,) bool OR-accumulates :func:`guard.bad_logits` every step;
    after the chunk the 0xFF E6M2 counts of the packed KV are reduced per
    slot (contiguous cache) or per pool page (paged pool), zeros for bf16
    KV. Both come back as ONE int32 ``flags`` vector on the device
    (``flags[:B]`` the NaN flags, ``flags[B:]`` the counts), which the
    scheduler pulls with the chunk's tokens in one transfer. The tokens
    are computed by the same ops in the same order as the unguarded chunk,
    so they are bitwise its tokens. Returns (tokens, token, cache, done,
    flags); nothing waits for the device."""
    toks, token, cache, done, bad = _decode_steps(
        params, token, cache, done, n_tokens, cfg, sctx, eos_id, bad)
    kv = cache.get("kv")
    if kv is not None and kvcache.is_packed_kv(kv["k"]):
        meta_nan = guard_mod.slot_meta_nan_counts(kv)
    else:
        meta_nan = torch.zeros(token.shape, dtype=torch.int32, device=token.device)
    return toks, token, cache, done, torch.cat([bad.to(torch.int32), meta_nan])


def serve(cfg: ArchConfig, params: dict, batch: dict, ctx: ModelCtx,
          serve_cfg: ServeConfig = ServeConfig(), *,
          device: DeviceLike = None, stats: Optional[dict] = None
          ) -> torch.Tensor:
    """Greedy-decode ``max_new_tokens`` on ``device``; returns (B, T) int32
    tokens. ``batch`` holds the prefill inputs: {"tokens"} (B, S), or the
    stub frontends' {"embeds"} (vlm) or {"frames"} (audio), (B, S, d). All
    requests advance in lockstep. With ``stats`` (a dict), the
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


def _failed_result(budget: int, eos_id: Optional[int]) -> torch.Tensor:
    """The (budget,) placeholder a rejected/quarantined request returns: eos
    fill when an eos is configured, else -1 (never a valid token)."""
    return torch.full((budget,), eos_id if eos_id is not None else -1,
                      dtype=torch.int32)


def _finalize_partial(toks: list, budget: int, eos_id: Optional[int]
                      ) -> torch.Tensor:
    """A timed-out request's partial tokens, padded to (budget,)."""
    fill = eos_id if eos_id is not None else -1
    toks = list(toks[:budget])
    return torch.tensor(toks + [fill] * (budget - len(toks)), dtype=torch.int32)


def _retry_fallback(cfg: ArchConfig, params: dict, prompt: list, ctx: ModelCtx,
                    serve_cfg: ServeConfig, device: torch.device):
    """Quarantine retry: re-serve ONE request solo on the degradation path,
    qdq impl (dequantize-then-dot on the packed leaves) + bf16 KV, with the
    NaN sentinel carried through prefill and decode.

    Returns ((budget,) int32 tokens, healthy bool). No fused kernel and no
    packed cache runs here, so a fault rooted in packed payloads or kernel
    dispatch cannot recur; a still-unhealthy retry means the fault is
    upstream and the request is quarantined for good. ``params`` are the
    serving params (packed, K-major): preparing them again is a no-op."""
    fb_quant = dataclasses.replace(ctx.quant, impl="qdq", kv=kvcache.KV_BF16)
    fb_ctx = dataclasses.replace(ctx, quant=fb_quant, plan=None)
    fb_serve = dataclasses.replace(serve_cfg, kv_format="bf16", kv_pages=0,
                                   guard=None)
    sctx = serving_ctx(fb_ctx)
    params = prepare_params_for_serving(params, cfg, fb_quant, device=device)
    logits, cache = build_decode_cache(
        cfg, params, {"tokens": _prompt_tensor(prompt, device)}, sctx, fb_serve)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    bad = guard_mod.bad_logits(logits)
    done = torch.zeros(token.shape, dtype=torch.bool, device=device)
    if fb_serve.eos_id is not None:
        done = done | (token == fb_serve.eos_id)
    out = [token[:, None]]
    budget = fb_serve.max_new_tokens - 1
    if budget > 0:
        toks, token, cache, done, flags = _decode_chunk_guarded(
            params, token, cache, done, bad, budget, cfg, sctx, fb_serve.eos_id)
        out.append(toks)
        bad = flags[:1]                    # B=1; the meta part is zeros (bf16)
    pulled = torch.cat([torch.cat(out, dim=1)[0], bad.to(torch.int32)]).tolist()
    return (_finalize_result(pulled[:-1], fb_serve.max_new_tokens,
                             fb_serve.eos_id), not pulled[-1])


def _open_journal(serve_cfg: ServeConfig, requests, *, resume: bool, kind: str,
                  chunk: int, **geometry):
    """(journal, recovery plan) for a serve call; (None, None) without a
    ``journal_dir``. On resume the OLD journal is replayed into the plan
    first; the new journal then stages at ``.tmp``, records its start event
    plus a ``done`` event per already-completed request, and only then
    replaces the old file."""
    if serve_cfg.journal_dir is None:
        if resume:
            raise guard_mod.RecoveryError(
                "resume=True needs serve_cfg.journal_dir pointing at the "
                "crashed serve's journal")
        return None, None
    from repro_torch.runtime import journal as journal_mod

    plan = None
    if resume:
        plan = journal_mod.recover(serve_cfg.journal_dir, requests,
                                   budget=serve_cfg.max_new_tokens,
                                   eos=serve_cfg.eos_id)
    journal = journal_mod.RequestJournal(serve_cfg.journal_dir)
    journal.append(
        "start", v=journal_mod.JOURNAL_VERSION, kind=kind,
        n_requests=len(requests), budget=serve_cfg.max_new_tokens,
        eos=serve_cfg.eos_id, chunk=chunk,
        prompts=[journal_mod.prompt_sha256(r) for r in requests], **geometry)
    if plan is not None:
        for rid in sorted(plan.completed):
            ent = plan.completed[rid]
            journal.append("done", rid=rid, status=ent["status"],
                           detail=ent["detail"], retries=ent["retries"],
                           toks=ent["toks"])
    journal.activate()
    return journal, plan


def _inject_completed(plan, queue, results, reports):
    """Feed a recovery plan's journaled terminal results straight into the
    result/report tables: completed work is never re-served."""
    for rid in sorted(plan.completed):
        ent = plan.completed[rid]
        queue.remove(rid)
        results[rid] = torch.tensor(ent["toks"], dtype=torch.int32)
        reports[rid].update(status=ent["status"], detail=ent["detail"])
        reports[rid]["retries"] = ent["retries"]


def _verify_recovery(plan, results, reports) -> int:
    """Every re-served request that finished cleanly must reproduce its
    journaled token prefix bitwise (a mismatch means recovery restored the
    wrong bytes: :class:`RecoveryError`). Returns the number verified."""
    verified = 0
    for rid in sorted(plan.emitted):
        if rid in plan.completed or reports[rid]["status"] != "ok":
            continue
        exp = plan.expected_prefix(rid)
        if not exp:
            continue
        got = results[rid].tolist()[: len(exp)]
        if got != exp:
            raise guard_mod.RecoveryError(
                f"request {rid}: re-served output {got} contradicts its "
                f"journaled token prefix {exp} — recovered state failed "
                "replay verification")
        verified += 1
    return verified


def _report_counts(reports: dict) -> dict:
    counts = {status: 0 for status in guard_mod.STATUS_NAMES}
    for rep in reports.values():
        counts[rep["status"]] += 1
    return {"quarantined": counts["quarantined"], "retried": counts["retried"],
            "rejected": counts["rejected"], "timeouts": counts["timeout"]}


def _split_pull(pulled: list, batch: int, chunk: int) -> tuple[list, list]:
    """One host transfer of ``cat([tokens (B, chunk) flattened, extra])`` ->
    (per-slot token lists, the extra values)."""
    n = batch * chunk
    return [pulled[b * chunk:(b + 1) * chunk] for b in range(batch)], pulled[n:]


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

    With ``serve_cfg.guard`` each request is its own fault domain: the
    decode chunk carries the NaN/Inf sentinel, packed KV is audited per
    chunk, and a faulty slot is quarantined (evicted, retried once on the
    qdq/bf16 fallback path) while the rest of the batch continues
    bitwise-unaffected; per-request outcomes land in ``stats["reports"]``.
    With ``serve_cfg.journal_dir`` every lifecycle event goes through the
    write-ahead journal, and ``resume=True`` rebuilds a crashed serve from
    it (finished results injected, checkpointed residents restored, the
    rest re-prefilled), verifying the re-served tokens against the
    journaled prefixes (``stats["recovery"]``). ``injector`` is a
    :class:`repro_torch.runtime.faults.FaultInjector`.

    Returns a list of (max_new_tokens,) int32 CPU tensors in submission
    order. ``stats`` (a dict) receives the scheduler's counters.
    """
    if cfg.family not in lm.KV_FAMILIES:
        raise ValueError(f"continuous batching supports KV-cache families, "
                         f"got {cfg.family!r}")
    if cfg.embeds_input:
        raise ValueError(f"continuous batching serves token prompts; "
                         f"{cfg.name!r} ({cfg.family}) takes precomputed "
                         f"embeds (dense/vlm-embeds not supported)")
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
                                     ctx=ctx, slots=slots, device=dev,
                                     stats=stats, injector=injector,
                                     resume=resume)

    guard = serve_cfg.guard
    budget = serve_cfg.max_new_tokens
    eos = serve_cfg.eos_id
    cap = serve_cfg.cache_capacity or max(len(p) for p in prompts) + budget
    B = min(slots, len(prompts))
    chunk = serve_cfg.decode_chunk or max(1, budget // 4)
    journal, plan = _open_journal(serve_cfg, prompts, resume=resume,
                                  kind="slots", chunk=chunk)

    cache = lm.init_cache(cfg, B, cap, kv_fmt, device=dev)
    token = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.ones((B,), dtype=torch.bool, device=dev)  # empty slots: done
    queue = list(range(len(prompts)))
    slot_req: list = [None] * B
    slot_toks: list[list] = [[] for _ in range(B)]
    admit_time = [0.0] * B
    results: list = [None] * len(prompts)
    reports = {rid: guard_mod.new_report() for rid in range(len(prompts))}
    if plan is not None:
        _inject_completed(plan, queue, results, reports)
    max_concurrent = chunk_idx = 0
    guarded = guard is not None and guard.nan_sentinel
    meta_audit = guard is not None and guard.meta_audit and kv_fmt == "hif4"
    if guarded:
        zeros_bad = torch.zeros((B,), dtype=torch.bool, device=dev)

    def jlog_done(rid):
        if journal is not None:
            rep = reports[rid]
            journal.append("done", rid=rid, status=rep["status"],
                           detail=rep["detail"], retries=rep["retries"],
                           toks=results[rid].tolist())

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
        admit_time[b] = time.monotonic()
        done[b] = eos is not None and first == eos
        if journal is not None:
            journal.append("admitted", rid=rid, src="prefill", toks=slot_toks[b])

    def release(b: int):
        slot_req[b] = None
        slot_toks[b] = []
        done[b] = True

    def quarantine(b: int, reason: str):
        """Evict the poisoned slot only; its neighbours' state is untouched
        (batch rows never mix). Its cache region needs no scrub: admission
        overwrites the slot's whole capacity."""
        rid = slot_req[b]
        release(b)
        if guard.retry_fallback:
            res, healthy = _retry_fallback(cfg, params, prompts[rid], ctx,
                                           serve_cfg, dev)
            reports[rid]["retries"] += 1
            if healthy:
                results[rid] = res
                reports[rid].update(status="retried", detail=f"{reason}; "
                                    "re-served solo on the qdq/bf16 fallback path")
                jlog_done(rid)
                return
        results[rid] = _failed_result(budget, eos)
        reports[rid].update(status="quarantined", detail=reason)
        jlog_done(rid)

    while queue or any(r is not None for r in slot_req):
        for b in range(B):
            if slot_req[b] is None and queue:
                admit(b)
                if injector is not None:
                    injector.crash_point("after_admit", chunk_idx=chunk_idx,
                                         rid=slot_req[b], journal=journal)
        max_concurrent = max(max_concurrent, sum(r is not None for r in slot_req))
        if injector is not None:
            cache["kv"] = injector.poison_cache(cache["kv"], slot_req, chunk_idx)
        active = torch.tensor([r is not None for r in slot_req], device=dev)
        badv = metav = None
        if guarded:
            toks, token, cache, done, flags = _decode_chunk_guarded(
                params, token, cache, done | ~active, zeros_bad, chunk, cfg,
                sctx, eos)
            # tokens and flags in ONE transfer
            host_toks, flagsv = _split_pull(
                torch.cat([toks.reshape(-1), flags]).tolist(), B, chunk)
            badv = flagsv[:B]
            if meta_audit:
                metav = flagsv[B:]
        else:
            toks, token, cache, done = _decode_chunk(
                params, token, cache, done | ~active, chunk, cfg, sctx, eos)
            extra = [guard_mod.slot_meta_nan_counts(cache["kv"])] if meta_audit else []
            host_toks, metav = _split_pull(
                torch.cat([toks.reshape(-1)] + extra).tolist(), B, chunk)
            metav = metav if meta_audit else None
        chunk_idx += 1
        if journal is not None:
            journal.append("chunk", idx=chunk_idx - 1, emitted={
                slot_req[b]: host_toks[b] for b in range(B)
                if slot_req[b] is not None})
        for b in range(B):
            if slot_req[b] is None:
                continue
            reason = None
            if badv is not None and badv[b]:
                reason = "nan_logits: non-finite logits in the decode scan"
            if metav is not None and metav[b]:
                reason = (f"meta_nan: {metav[b]} E6M2 NaN sentinel(s) in the "
                          "slot's packed KV")
            if reason is not None:
                quarantine(b, reason)
                continue
            slot_toks[b].extend(host_toks[b])
            if (guard is not None and guard.deadline_s is not None
                    and time.monotonic() - admit_time[b] > guard.deadline_s):
                rid = slot_req[b]
                results[rid] = _finalize_partial(slot_toks[b], budget, eos)
                reports[rid].update(status="timeout",
                                    detail=f"deadline: exceeded {guard.deadline_s}s")
                release(b)
                jlog_done(rid)
                continue
            if len(slot_toks[b]) >= budget or (eos is not None and eos in slot_toks[b]):
                rid = slot_req[b]
                results[rid] = _finalize_result(slot_toks[b], budget, eos)
                slot_req[b] = None
                jlog_done(rid)
        if journal is not None:
            journal.commit()
        if injector is not None:
            injector.crash_point("mid_decode", chunk_idx=chunk_idx - 1,
                                 journal=journal)
    if journal is not None:
        journal.close()
    if plan is not None:
        verified = _verify_recovery(plan, results, reports)
        if stats is not None:
            stats["recovery"] = dict(plan.report(), verified=verified)
    if stats is not None:
        stats.update(scheduler="slots", max_concurrent=max_concurrent,
                     preemptions=0, shared_page_hits=0, evictions=0,
                     reports=reports, **_report_counts(reports))
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


def _pool_scrub(pool: dict, ids) -> dict:
    """Zero the freed pages of a quarantined slot, in place, so stale
    corruption cannot leak into the page's next owner."""
    ids = torch.as_tensor(ids, dtype=torch.long)
    kvcache.scrub_pages(pool["k"], ids)
    kvcache.scrub_pages(pool["v"], ids)
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
                          ctx: ModelCtx, slots: int, device: torch.device,
                          stats: Optional[dict] = None, injector=None,
                          resume: bool = False) -> list:
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

    **Fault domains.** Preemption snapshots always carry a crc32
    fingerprint, verified before re-admission scatters them back; a
    corrupt snapshot is dropped and the request re-queued from its prompt
    (status ``retried``, the result still exact). With ``serve_cfg.guard``
    the chunk carries the NaN sentinel, every chunk audits live pages (0xFF
    meta counts; per-page checksums against the values recorded after the
    previous chunk, skipping pages the scheduler wrote in between), faulty
    slots are quarantined with their freed pages scrubbed, and pool
    starvation becomes a bounded-retry ``rejected`` status. Tokens, flags
    and checksums come to the host in ONE transfer per chunk. With a
    journal, ``checkpoint_every`` chunks also write the residents' pages.
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
    guard = serve_cfg.guard
    chunk = serve_cfg.decode_chunk or max(1, budget // 4)
    guarded = guard is not None and guard.nan_sentinel
    if guarded:
        zeros_bad = torch.zeros((B,), dtype=torch.bool, device=dev)
    if injector is not None:
        injector.steal_pages(pool)
    journal, plan = _open_journal(serve_cfg, prompts, resume=resume, kind="paged",
                                  chunk=chunk, kv_pages=serve_cfg.kv_pages,
                                  page_tokens=P)

    queue = list(range(n_req))
    suspended: dict = {}               # rid -> preemption byte snapshot
    slot_req: list = [None] * B
    slot_toks: list[list] = [[] for _ in range(B)]
    slot_written: list[list] = [[] for _ in range(B)]  # tokens whose KV is
    #                                                    resident, in order
    slot_pages: list[list] = [[] for _ in range(B)]    # pool ids, logical
    admit_clock = [0] * B
    admit_time = [0.0] * B
    results: list = [None] * n_req
    reports = {rid: guard_mod.new_report() for rid in range(n_req)}
    if plan is not None:
        _inject_completed(plan, queue, results, reports)
        for rid, snap in plan.suspended.items():
            # checkpointed residents re-enter through the snapshot path;
            # written follows the invariant written == prompt + toks[:-1]
            suspended[rid] = dict(snap, toks=list(snap["toks"]),
                                  written=prompts[rid] + list(snap["toks"])[:-1])
    admission_attempts: dict = {}      # rid -> failed empty-pool admissions
    clock = preempt_count = max_concurrent = peak_live = snapshot_drops = 0
    chunk_idx = 0
    # checksum audit state: ``recorded`` maps page id -> its checksum after
    # the last chunk; ``dirty`` holds pages the scheduler itself wrote since
    # then (admission scatters, COW copies, horizon allocs, chunk appends),
    # which are re-recorded, not compared
    recorded: dict = {}
    dirty: set = set()

    def jlog_done(rid):
        if journal is not None:
            rep = reports[rid]
            journal.append("done", rid=rid, status=rep["status"],
                           detail=rep["detail"], retries=rep["retries"],
                           toks=results[rid].tolist())

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

    def clear_slot(b):
        slot_pages[b] = []
        slot_req[b] = None
        slot_toks[b] = []
        slot_written[b] = []
        set_table_row(b, [])                   # its writes -> scratch page 0

    def release_slot(b):
        for pid in slot_pages[b]:
            pool.release(pid)                  # hashed full pages park LRU
        clear_slot(b)

    def preempt(b):
        nonlocal preempt_count
        rid = slot_req[b]
        snap = _pool_gather(cache["kv"], slot_pages[b])    # BYTES, on the host
        # fingerprint BEFORE the injector hook: the stamp models the bytes as
        # they left the device; host-side corruption after that is what
        # re-admission must catch
        crc = guard_mod.snapshot_fingerprint(snap)
        if injector is not None:
            snap = injector.poison_snapshot(snap, rid)
        suspended[rid] = {"pages": snap, "crc32": crc, "token": int(token[b]),
                          "toks": slot_toks[b], "written": slot_written[b]}
        release_slot(b)
        queue.insert(0, rid)
        preempt_count += 1
        if journal is not None:
            journal.append("preempted", rid=rid)

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
        nonlocal clock, snapshot_drops
        snap = suspended.get(rid)
        if snap is not None and not guard_mod.verify_snapshot(snap):
            # a truncated/flipped snapshot never reaches the pool: drop it and
            # re-serve from the prompt (greedy decode is deterministic, so the
            # result is still exact)
            del suspended[rid]
            snapshot_drops += 1
            reports[rid]["retries"] += 1
            reports[rid].update(
                status="retried",
                detail="snapshot_integrity: preemption snapshot failed its "
                       "fingerprint at re-admission; re-queued from the prompt")
            snap = None
        if snap is not None:
            n = snap["pages"]["k"]["meta"].shape[1]
            if pool.available() < n:
                return False
            pids = [pool.alloc(owner=rid) for _ in range(n)]
            _pool_scatter(cache["kv"], snap["pages"]["k"], snap["pages"]["v"],
                          list(range(n)), pids)
            dirty.update(pids)
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
                dirty.update(own_dst)
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
        admit_time[b] = time.monotonic()
        refresh_metadata(b)
        if journal is not None:
            # an admitted record RESETS the request's journaled emission to
            # its cumulative tokens (fresh prefill, snapshot, or checkpoint)
            journal.append("admitted", rid=rid,
                           src="snapshot" if snap is not None else "prefill",
                           toks=[int(t) for t in slot_toks[b]])
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
                    dirty.add(new)
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
            dirty.add(pid)
            slot_pages[b].append(pid)
            cache["pages"][b, j] = pid
        return True

    def quarantine(b, reason):
        """Evict the poisoned slot only: drop its pool refs, scrub the pages
        that actually freed (shared pages survive for their other holders,
        whose own audits catch them if THEY are the corrupted bytes), and
        retry the request once on the qdq/bf16 fallback path. Neighbouring
        slots continue bitwise-unaffected."""
        rid = slot_req[b]
        freed = []
        for pid in slot_pages[b]:
            pool.release(pid, keep_cached=False)
            if pid not in pool.ref:
                freed.append(pid)
                recorded.pop(pid, None)
        if freed:
            _pool_scrub(cache["kv"], freed)
            dirty.update(freed)
        clear_slot(b)
        done[b] = True
        if guard.retry_fallback:
            res, healthy = _retry_fallback(cfg, params, prompts[rid], ctx,
                                           serve_cfg, dev)
            reports[rid]["retries"] += 1
            if healthy:
                results[rid] = res
                reports[rid].update(status="retried", detail=f"{reason}; "
                                    "re-served solo on the qdq/bf16 fallback path")
                jlog_done(rid)
                return
        results[rid] = _failed_result(budget, eos)
        reports[rid].update(status="quarantined", detail=reason)
        jlog_done(rid)

    def reject(rid, detail):
        queue.remove(rid)
        suspended.pop(rid, None)
        results[rid] = _failed_result(budget, eos)
        reports[rid].update(status="rejected", detail=detail)
        jlog_done(rid)

    def checkpoint():
        from repro_torch.runtime import journal as journal_mod

        residents = {}
        for b in range(B):
            rid = slot_req[b]
            if rid is not None:
                residents[rid] = {"pages": _pool_gather(cache["kv"], slot_pages[b]),
                                  "token": int(token[b]),
                                  "toks": [int(t) for t in slot_toks[b]]}
        fname, digest = journal_mod.save_pool_checkpoint(
            serve_cfg.journal_dir, chunk_idx, residents)
        if injector is not None:
            # the .npz is on disk but its journal record is not:
            # crash_during_checkpoint leaves an orphan recovery must ignore
            injector.crash_point("during_checkpoint", chunk_idx=chunk_idx - 1,
                                 journal=journal)
        journal.append("checkpoint", chunk=chunk_idx, file=fname, sha256=digest,
                       residents={rid: {"token": ent["token"], "toks": ent["toks"]}
                                  for rid, ent in residents.items()})

    while queue or any(r is not None for r in slot_req):
        # admission: FIFO, page-fit driven; stop at the first request whose
        # prompt pages do not fit (no skip-ahead)
        while queue:
            free_b = next((b for b in range(B) if slot_req[b] is None), None)
            if free_b is None:
                break
            head = queue[0]
            if not try_admit(free_b, head):
                break
            queue.pop(0)
            if injector is not None:
                injector.crash_point("after_admit", chunk_idx=chunk_idx, rid=head,
                                     journal=journal)
        if not any(r is not None for r in slot_req):
            # nothing resident AND the queue head still does not fit: fatal
            # without a guard, else bounded retry + backoff, then rejected
            rid = queue[0]
            msg = (f"request {rid!r} cannot be admitted into an empty pool "
                   f"({pool.usable_pages} usable pages, {pool.available()} "
                   "allocatable)")
            if guard is None:
                raise PoolExhaustedError(msg)
            attempts = admission_attempts.get(rid, 0) + 1
            admission_attempts[rid] = attempts
            if attempts <= guard.max_admission_retries:
                reports[rid]["retries"] += 1
                if guard.admission_backoff_s:
                    time.sleep(guard.admission_backoff_s * 2 ** (attempts - 1))
                continue
            reject(rid, f"pool_exhausted: {msg} after {attempts - 1} retries")
            continue
        for b in range(B):
            if slot_req[b] is not None:
                provision(b)
        # counted AFTER provisioning: sequences really decoding this chunk
        max_concurrent = max(max_concurrent, sum(r is not None for r in slot_req))
        peak_live = max(peak_live, pool.live_pages())
        if injector is not None:
            cache["kv"] = injector.poison_pool(cache["kv"], pool, slot_req,
                                               slot_pages, chunk_idx)
        active = torch.tensor([r is not None for r in slot_req], device=dev)
        extra = []
        if guarded:
            toks, token, cache, done, flags = _decode_chunk_guarded(
                params, token, cache, done | ~active, zeros_bad, chunk, cfg,
                sctx, eos)
            extra.append(flags.to(torch.int64))       # (B,) NaN + (NP,) 0xFF
        else:
            toks, token, cache, done = _decode_chunk(
                params, token, cache, done | ~active, chunk, cfg, sctx, eos)
            if guard is not None and guard.meta_audit:
                extra.append(guard_mod.slot_meta_nan_counts(cache["kv"]).to(
                    torch.int64))
        if guard is not None and guard.page_checksums:
            extra.append(guard_mod.pool_page_sums(cache["kv"]))
        # tokens, flags and page checksums come to the host in ONE transfer
        host_toks, pulled = _split_pull(
            torch.cat([toks.reshape(-1).to(torch.int64)] + extra).tolist()
            if extra else toks.reshape(-1).tolist(), B, chunk)
        n_pool = serve_cfg.kv_pages
        badv = pulled[:B] if guarded else None
        pagemeta = sums = None
        if guarded:
            pagemeta = pulled[B:B + n_pool]
        elif guard is not None and guard.meta_audit:
            pagemeta = pulled[:n_pool]
        if guard is not None and guard.page_checksums:
            sums = pulled[-n_pool:]
        chunk_idx += 1
        # 1) account this chunk's KV writes (and mark their pages dirty)
        chunk_emitted = {}
        for b in range(B):
            if slot_req[b] is None:
                continue
            new = host_toks[b]
            chunk_emitted[slot_req[b]] = new
            # this chunk wrote KV for the pending token and every emission
            # but the newest (still pending)
            n0 = len(slot_written[b])
            slot_written[b].extend([slot_toks[b][-1]] + new[:-1])
            slot_toks[b].extend(new)
            n1 = len(slot_written[b])
            for j in range(n0 // P, (n1 - 1) // P + 1):
                # over-emission past the table clamps into the last entry
                dirty.add(slot_pages[b][min(j, len(slot_pages[b]) - 1)])
        if journal is not None:
            journal.append("chunk", idx=chunk_idx - 1, emitted=chunk_emitted)
        # 2) audit live pages BEFORE retiring anything, so a final-chunk
        #    fault cannot slip out with the request
        faulty = {}
        if guard is not None:
            for b in range(B):
                if slot_req[b] is None:
                    continue
                for pid in slot_pages[b]:
                    if guard.meta_audit and pagemeta is not None and pagemeta[pid]:
                        faulty[b] = (f"meta_nan: page {pid} carries "
                                     f"{pagemeta[pid]} E6M2 NaN sentinel(s)")
                        break
                    if (sums is not None and pid in recorded and pid not in dirty
                            and sums[pid] != recorded[pid]):
                        faulty[b] = (f"page_checksum: settled page {pid} "
                                     "changed outside the scheduler")
                        break
        for b in range(B):
            if (slot_req[b] is not None and b not in faulty and badv is not None
                    and badv[b]):
                faulty[b] = "nan_logits: non-finite logits in the decode scan"
        for b, reason in faulty.items():
            quarantine(b, reason)
        # 3) re-record checksums for the pages still live, then settle
        if sums is not None:
            for b in range(B):
                if slot_req[b] is not None:
                    for pid in slot_pages[b]:
                        recorded[pid] = sums[pid]
        dirty.clear()
        # 4) sharing metadata, deadlines, retirement
        for b in range(B):
            if slot_req[b] is None:
                continue
            refresh_metadata(b)
            rid = slot_req[b]
            if (guard is not None and guard.deadline_s is not None
                    and time.monotonic() - admit_time[b] > guard.deadline_s):
                results[rid] = _finalize_partial(slot_toks[b], budget, eos)
                reports[rid].update(status="timeout",
                                    detail=f"deadline: exceeded {guard.deadline_s}s")
                release_slot(b)
                done[b] = True
                jlog_done(rid)
                continue
            if len(slot_toks[b]) >= budget or (eos is not None and eos in slot_toks[b]):
                results[rid] = _finalize_result(slot_toks[b], budget, eos)
                release_slot(b)
                jlog_done(rid)
        # 5) durability: periodic pool checkpoint, then ONE fsync for the
        #    whole chunk's records
        if journal is not None:
            if (serve_cfg.checkpoint_every > 0
                    and chunk_idx % serve_cfg.checkpoint_every == 0
                    and any(r is not None for r in slot_req)):
                checkpoint()
            journal.commit()
        if injector is not None:
            injector.crash_point("mid_decode", chunk_idx=chunk_idx - 1,
                                 journal=journal)
    if journal is not None:
        journal.close()
    holders = {f"slot{b}": slot_pages[b] for b in range(B) if slot_pages[b]}
    if injector is not None and injector.held_pages:
        holders["__fault_injector__"] = list(injector.held_pages)
    audit = pool.audit(holders=holders)
    if plan is not None:
        verified = _verify_recovery(plan, results, reports)
        if stats is not None:
            stats["recovery"] = dict(plan.report(), verified=verified)
    if stats is not None:
        stats.update(
            scheduler="paged", max_concurrent=max_concurrent,
            preemptions=preempt_count, evictions=pool.evictions,
            shared_page_hits=pool.shared_hits, pages_total=serve_cfg.kv_pages,
            page_tokens=P, peak_live_pages=peak_live,
            pool_bytes=serve_cfg.kv_pages * kvcache.page_nbytes(
                cfg.attn.n_kv_heads, cfg.attn.d_head, P, cfg.n_layers),
            snapshot_drops=snapshot_drops, pool_audit=audit, reports=reports,
            **_report_counts(reports))
    return results
