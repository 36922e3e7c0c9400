"""Serve-cell harness: declared cells with dispatch probes (port of
``repro/runtime/scenario.py``).

A :class:`Scenario` is ONE cell (arch x impl x kv_format x policy x batch x
prompt), declared as data: what to serve, how to serve it, which engine
routes the cell must take (``expect``) and how much latency drift a stored
trajectory tolerates (``rel_tol``). :func:`run_scenarios` serves every cell
through the real serve stack of :mod:`repro_torch.runtime.serve_loop` (the
prefill, the one-time KV pack and the decode chunk, or the page-pool
``serve_requests``) and returns one record per cell carrying:

- decode ms per step, timed interleaved best-of-N across the scan cells
  (each cell alternates with the others inside one timing loop, so a phase
  of machine load hits every cell alike), a tight A/B interleave for each
  gate pair, and prefill ms;
- the exact bytes a decode step must move (:func:`decode_step_bytes`):
  weights at their 4.5-bit payload, the valid KV prefix, SSM state read and
  written;
- the engine dispatch probed for the cell (:func:`probe_dispatch`), checked
  against ``expect`` (:func:`check_expect`);
- for the recovery cell, a crash mid-decode and a resume from the journal
  whose tokens must equal the clean run's bitwise.

Routes keep the port's names: where the reference's end in ``_xla`` (its
off-TPU twin), the port's end in ``_plain`` (the plain PyTorch version a
wrapper runs on a CPU tensor). The expectations are backend-neutral.

Two things differ from the reference, both for full-width cells on the
card: ``Scenario.reduced=False`` builds the published config, its weights
drawn on the device from the seed, and serves it under the ModelCtx's
flash chunks of ``FULL_WIDTH_CHUNK`` (the reference's 8-token chunks are
sized for its reduced cells); every timed window ends in a synchronize.

    from repro_torch.runtime.scenario import Scenario, run_scenarios
    run_scenarios([Scenario("dense", "qwen1.5-0.5b", "packed", "hif4")],
                  repeats=1, device="cpu")
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_arch
from repro_torch.core import engine as qengine
from repro_torch.core import kvcache
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import PackedW
from repro_torch.device import DeviceLike, resolve_device, sync
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.runtime import faults
from repro_torch.runtime import serve_loop
from repro_torch.runtime.serve_loop import (
    ServeConfig,
    build_decode_cache,
    kv_format_fallback,
    packed_weight_bytes,
    resolve_kv_format,
    serve_requests,
)

# flash q and KV chunk of a full-width cell's prefill: divides whisper's
# 1 536 frames; a shorter prompt takes its own length
FULL_WIDTH_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative serve cell."""

    name: str                     # unique cell id
    arch: str                     # registry id
    impl: str                     # qdq | packed | pallas
    kv_format: str                # REQUESTED cache format: bf16 | hif4
    paged: bool = False           # page-pool serve_requests cell
    guarded: bool = False         # guarded decode chunk + per-chunk KV audit
    journaled: bool = False       # write-ahead journal + pool checkpoints
    #                               (journal dir is a per-run tempdir)
    recovery: bool = False        # crash (crash_mid_decode) + resume cell:
    #                               records the recovery report and whether
    #                               the recovered outputs are bitwise equal
    decode_chunk: int = 0         # tokens per decode chunk (0 = budget);
    #                               journal commits are per chunk
    policy: str = "uniform:hif4"  # QuantPolicy preset for weight sites
    batch: int = 2
    prompt_len: int = 16
    new_tokens: int = 8
    rel_tol: float = 3.0          # regression factor vs stored decode_step_ms
    # expected-dispatch assertions, e.g. ("kv:hif4", "kv:no-fallback",
    # "attn:fused_decode_attention", "matmul:fused") -- see check_expect
    expect: Sequence[str] = ()
    reduced: bool = True          # False: the published width and depth,
    #                               weights drawn on the device


# expectation vocabulary -> how the probed dispatch must look. Routes are
# backend-neutral: "attn:fused_decode_attention" means the cell is
# kernel-eligible (the CUDA kernel on the card, its plain version on the
# CPU); "attn:twin" means the chunked-dequantize plain recurrence is the
# ONLY possible execution (qdq impl / layout), on every backend.
_EXPECT_CHECKS = {
    "kv:hif4": lambda d: d["kv_format_resolved"] == "hif4",
    "kv:bf16": lambda d: d["kv_format_resolved"] == "bf16",
    "kv:fallback": lambda d: d["kv_format_fallback"],
    "kv:no-fallback": lambda d: not d["kv_format_fallback"],
    "attn:fused_decode_attention":
        lambda d: d["attn"].get("kernel_eligible") and not d["paged"],
    "attn:fused_paged_decode_attention":
        lambda d: d["attn"].get("kernel_eligible") and d["paged"],
    "attn:twin":
        lambda d: d["attn"]["route"] != "none"
        and d["attn"].get("kernel_eligible") is False,
    "attn:dense": lambda d: d["attn"]["route"] == "dense",
    "attn:none": lambda d: d["attn"]["route"] == "none",
    "matmul:fused": lambda d: d["matmul"]["route"] == "fused",
    "matmul:dequant-dot": lambda d: d["matmul"]["route"] == "dequant-dot",
    "matmul:qdq": lambda d: d["matmul"]["route"] == "qdq",
}

EXPECTATIONS = tuple(sorted(_EXPECT_CHECKS))


def check_expect(expect: Sequence[str], dispatch: dict) -> list:
    """The declared assertions a probed dispatch violates (empty = pass)."""
    failed = []
    for e in expect:
        if e not in _EXPECT_CHECKS:
            failed.append(f"{e} (unknown expectation)")
        elif not _EXPECT_CHECKS[e](dispatch):
            failed.append(e)
    return failed


def prefill_batch(cfg, batch: int, prompt_len: int, seed: int, device) -> dict:
    """The prefill inputs the family's serve takes: ``frames`` (audio) or
    ``embeds`` (vlm), f32 normals (batch, prompt_len, d_model) drawn on
    ``device``; else token ids (batch, prompt_len), drawn on the host."""
    if cfg.family == "audio" or cfg.embeds_input:
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn(batch, prompt_len, cfg.d_model, generator=gen,
                        device=device)
        return {"frames" if cfg.family == "audio" else "embeds": x}
    gen = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                    generator=gen)}


def _leaves(tree):
    """Tensor and PackedW leaves of a nested dict / list tree."""
    if isinstance(tree, (torch.Tensor, PackedW)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _first_packed(params) -> Optional[PackedW]:
    return next((leaf for leaf in _leaves(params)
                 if isinstance(leaf, PackedW)), None)


def probe_dispatch(cfg, quant, serve_cfg: ServeConfig, serving_params, *,
                   paged: bool = False, batch: int = 1, prompt_len: int = 16,
                   device: DeviceLike = None) -> dict:
    """Resolve every dispatch decision this cell will hit on ``device``,
    without serving: ``resolve_kv_format`` for the cache format,
    :func:`repro_torch.core.engine.attention_dispatch_info` on a
    geometry-exact packed probe cache (page-pool shaped for paged cells) and
    :func:`repro_torch.core.engine.packed_dispatch_info` on the first
    ``PackedW`` of the serving params (every block matmul shares the
    eligibility rule, which depends on impl and format, not shape). The
    probe caches are a few tokens on the CPU; only ``device``'s type
    matters."""
    dev = resolve_device(device)
    a = cfg.attn
    resolved = resolve_kv_format(cfg, quant, serve_cfg)
    d = {
        "kv_format_resolved": resolved,
        "kv_format_fallback": kv_format_fallback(cfg, quant, serve_cfg),
        "paged": paged,
    }
    if cfg.family == "ssm" or a is None:
        d["attn"] = {"route": "none"}
    elif resolved != "hif4":
        d["attn"] = {"route": "dense"}
    elif paged:
        pool = kvcache.init_page_pool(cfg.n_layers, a.n_kv_heads, a.d_head,
                                      2, serve_cfg.kv_page_tokens)
        d["attn"] = qengine.attention_dispatch_info(
            quant, pool["k"], n_kv_heads=a.n_kv_heads, d_head=a.d_head,
            device=dev, paged=True)
    else:
        probe = kvcache.to_kernel_layout(kvcache.quantize_kv(
            torch.zeros((1, 8, a.n_kv_heads, a.d_head), dtype=torch.bfloat16)))
        d["attn"] = qengine.attention_dispatch_info(
            quant, probe, n_kv_heads=a.n_kv_heads, d_head=a.d_head, device=dev)
    w = _first_packed(serving_params)
    if w is None:
        # nothing packed (qdq plan / hybrid artifact): fake-quant dense dots
        d["matmul"] = {"route": "qdq", "execution": "qdq dense dot"}
    else:
        info = qengine.packed_dispatch_info(
            quant, w, decode_m=batch, prefill_m=batch * prompt_len, device=dev)
        info["route"] = "fused" if info["fused"] else "dequant-dot"
        d["matmul"] = info
    return d


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _params_nbytes(params) -> int:
    """Resident weight bytes, PackedW-aware (exact 4.5-bit payload)."""
    packed_b, _ = packed_weight_bytes(params)
    dense_b = sum(_nbytes(leaf) for leaf in _leaves(params)
                  if not isinstance(leaf, PackedW))
    return packed_b + dense_b


def decode_step_bytes(cfg, serving_params, cache, valid_len: int) -> dict:
    """The exact bytes one decode step must move, from payload sizes.

    A decode step streams every resident weight byte once (the batch reuses
    them) plus the valid prefix of every attention cache entry: packed
    entries at their 4.5-bit + meta + tail payload
    (``kvcache.packed_kv_nbytes``), dense ones at 2 B/value. The read-only
    cross cache is wholly valid; recurrent ("layers") state is read AND
    written every step. Over the card's memory rate this is the step's
    least time."""
    weight_bytes = _params_nbytes(serving_params)
    kv_bytes = 0
    for entry, frac_valid in (("kv", None), ("self", None), ("cross", 1.0)):
        kv = cache.get(entry)
        if kv is None:
            continue
        for tensor in (kv["k"], kv["v"]):
            if kvcache.is_packed_kv(tensor):
                total = kvcache.packed_kv_nbytes(tensor)
                cap = kvcache.seq_capacity(tensor)
            else:
                total = _nbytes(tensor)
                cap = tensor.shape[2]          # (L, B, S, Hkv, Dh)
            frac = 1.0 if frac_valid else min(valid_len / cap, 1.0)
            kv_bytes += int(total * frac)
    state_bytes = 0
    if "layers" in cache:
        state_bytes = 2 * sum(_nbytes(t) for t in _leaves(cache["layers"]))
    return {
        "weight_bytes": weight_bytes,
        "kv_bytes": kv_bytes,
        "state_bytes": state_bytes,
        "bytes_per_step": weight_bytes + kv_bytes + state_bytes,
    }


def _build_cell(scn: Scenario, device: DeviceLike = None, seed: int = 0):
    """Materialize one cell on ``device``: cfg, ctx, serving params (random
    weights from ``seed``; the harness, as the reference's, draws from 0)."""
    dev = resolve_device(device)
    cfg = get_arch(scn.arch)
    if scn.reduced:
        cfg = cfg.reduced()
    plan = lm.quant_plan(cfg, get_policy(
        scn.policy, impl=scn.impl, kv=kvcache.KVCacheConfig(scn.kv_format)))
    chunk = 8 if scn.reduced else FULL_WIDTH_CHUNK
    ctx = ModelCtx(quant=plan.base, plan=plan, remat=False,
                   attn_q_chunk=chunk, attn_k_chunk=chunk)
    params = lm.init_params(cfg, seed, device=dev,
                            draw_on_device=not scn.reduced)
    sp = serve_loop.prepare_params_for_serving(params, cfg, plan, device=dev)
    return cfg, ctx, sp


def _serve_cfg(scn: Scenario,
               journal_dir: Optional[str] = None) -> ServeConfig:
    sc = ServeConfig(max_new_tokens=scn.new_tokens, kv_format=scn.kv_format,
                     decode_chunk=scn.decode_chunk)
    if scn.paged:
        # pool sized to hold every request at full length, page = 16 tokens
        pages = scn.batch * (-(-(scn.prompt_len + scn.new_tokens) // 16)) + 1
        sc = dataclasses.replace(sc, kv_pages=pages, kv_page_tokens=16,
                                 cache_capacity=-(-(scn.prompt_len
                                                    + scn.new_tokens) // 16) * 16)
    if scn.journaled:
        if journal_dir is None:
            raise ValueError(f"cell {scn.name}: a journaled Scenario needs a "
                             "journal_dir")
        # the overhead cell measures the journal alone (fsync per chunk);
        # pool checkpoints are exercised and timed by the recovery cell
        sc = dataclasses.replace(sc, journal_dir=journal_dir,
                                 checkpoint_every=2 if scn.recovery else 0)
    return sc


def _scan_step(cfg, sctx: ModelCtx, scn: Scenario, dev: torch.device):
    """The decode chunk a scan cell times, with its host pull: tokens (and
    the guard's flags, in the same transfer) come to the host after every
    chunk, as the schedulers pull them, so a guarded cell and its unguarded
    twin differ only by the guard's work."""
    n = scn.new_tokens
    if scn.guarded:
        zeros = torch.zeros((scn.batch,), dtype=torch.bool, device=dev)

        def step(sp, token, cache, done):
            toks, token, cache, done, flags = serve_loop._decode_chunk_guarded(
                sp, token, cache, done, zeros, n, cfg, sctx, None)
            torch.cat([toks.reshape(-1), flags]).tolist()
            return toks, token, cache, done
    else:
        def step(sp, token, cache, done):
            toks, token, cache, done = serve_loop._decode_chunk(
                sp, token, cache, done, n, cfg, sctx, None)
            toks.reshape(-1).tolist()
            return toks, token, cache, done
    return step


def run_scenarios(scenarios: Sequence[Scenario], *, repeats: int = 7,
                  gate_pairs: Sequence[tuple] = (), log=print,
                  device: DeviceLike = None) -> list:
    """Serve each cell on ``device`` (the card unless ``device="cpu"``)
    through the real serve stack; one record per cell.

    Scan cells (everything not paged) are timed INTERLEAVED on their decode
    chunks, feeding each call's returned state back (the serving steady
    state), best-of-``repeats``. Paged cells run the page-pool
    ``serve_requests`` scheduler end to end (admission, prefill, decode),
    ``max(2, repeats // 3)`` rounds, so their latency is a coarser ms per
    token. Each record's ``roofline`` holds exact payload byte counts.

    ``gate_pairs`` lists (baseline, subject) cell-name pairs a ratio gate
    compares. Each pair gets a second, tight A/B interleave after the global
    rotation (3 x ``repeats`` rounds; paged pairs 2 x rounds), recorded on
    the subject's record under ``gate_timing``: strict alternation gives
    both sides the same predecessor.

    Decode past the cache's capacity is what the timing loop does (warm-up
    plus every round decodes ``new_tokens`` more into a cache of capacity
    ``prompt_len + new_tokens``): the writes clamp at the last slot, as the
    reference's do, and the step's cost is that of a full cache.
    """
    dev = resolve_device(device)
    names = [s.name for s in scenarios]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate cell names: {names}")
    records, states, steps, serving, paged_cells = {}, {}, {}, {}, []
    tmp_dirs = []
    try:
        for scn in scenarios:
            t_setup = time.perf_counter()
            cfg, ctx, sp = _build_cell(scn, dev)
            jdir = None
            if scn.journaled:
                # tmpfs where there is one: the journal's software cost, not
                # the sync latency of whatever disk backs $TMPDIR
                shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
                jdir = tempfile.mkdtemp(prefix=f"matrix_{scn.name}_", dir=shm)
                tmp_dirs.append(jdir)
            sc = _serve_cfg(scn, journal_dir=jdir)
            dispatch = probe_dispatch(cfg, ctx.quant, sc, sp, paged=scn.paged,
                                      batch=scn.batch,
                                      prompt_len=scn.prompt_len, device=dev)
            failed = check_expect(scn.expect, dispatch)
            rec = dict(dataclasses.asdict(scn))
            rec["expect"] = list(scn.expect)
            rec.update({
                "family": cfg.family,
                "kv_format_resolved": dispatch["kv_format_resolved"],
                "dispatch": {
                    "kv_format_fallback": dispatch["kv_format_fallback"],
                    "attn": dispatch["attn"],
                    "matmul": dispatch["matmul"],
                },
                "dispatch_ok": not failed,
                "dispatch_failures": failed,
            })
            records[scn.name] = rec
            if scn.paged:
                paged_cells.append((scn, cfg, ctx, sp, sc))
                log(f"[matrix] {scn.name}: paged cell set up "
                    f"({time.perf_counter() - t_setup:.1f}s)")
                continue

            sctx = serve_loop.serving_ctx(ctx)
            batch = prefill_batch(cfg, scn.batch, scn.prompt_len, 1, dev)
            batch = {k: v.to(dev) for k, v in batch.items()}
            step = _scan_step(cfg, sctx, scn, dev)
            logits, cache = build_decode_cache(cfg, sp, batch, sctx, sc)
            rec["roofline"] = decode_step_bytes(
                cfg, sp, cache, scn.prompt_len + scn.new_tokens // 2)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            done = torch.zeros(token.shape, dtype=torch.bool, device=dev)
            toks, token, cache, done = step(sp, token, cache, done)   # warm-up
            sync(dev)
            t_pre = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                lm.prefill(sp, batch, cfg, sctx)
                sync(dev)
                t_pre = min(t_pre, time.perf_counter() - t0)
            rec["prefill_ms"] = round(t_pre * 1e3, 4)
            serving[scn.name], steps[scn.name] = sp, step
            states[scn.name] = (token, cache, done)
            log(f"[matrix] {scn.name}: built + warm "
                f"({time.perf_counter() - t_setup:.1f}s)")

        def timed_step(name) -> float:
            token, cache, done = states[name]
            t0 = time.perf_counter()
            _, token, cache, done = steps[name](serving[name], token, cache,
                                                done)
            sync(dev)
            dt = time.perf_counter() - t0
            states[name] = (token, cache, done)
            return dt / records[name]["new_tokens"]

        # interleaved steady-state decode timing across ALL scan cells
        best = {name: float("inf") for name in states}
        for _ in range(repeats):
            for name in states:
                best[name] = min(best[name], timed_step(name))
        for name, t in best.items():
            records[name]["decode_step_ms"] = round(t * 1e3, 4)
            records[name]["timing"] = "scan-interleaved"

        # tight pairwise A/B interleave per ratio-gate pair
        for base_name, sub_name in gate_pairs:
            if base_name not in states or sub_name not in states:
                continue
            pair_best = {base_name: float("inf"), sub_name: float("inf")}
            for _ in range(3 * repeats):
                for name in (base_name, sub_name):
                    pair_best[name] = min(pair_best[name], timed_step(name))
            records[sub_name].setdefault("gate_timing", {})[base_name] = {
                "baseline_ms": round(pair_best[base_name] * 1e3, 4),
                "subject_ms": round(pair_best[sub_name] * 1e3, 4)}

        pmap = {}
        for scn, cfg, ctx, sp, sc in paged_cells:
            reqs = [torch.randint(0, cfg.vocab, (scn.prompt_len,),
                                  generator=torch.Generator().manual_seed(40 + i))
                    for i in range(scn.batch)]
            pmap[scn.name] = (scn, cfg, ctx, sp, sc, reqs)

        def paged_e2e(name, *, stats=None, injector=None, resume=False):
            scn, cfg, ctx, sp, sc, reqs = pmap[name]
            t0 = time.perf_counter()
            out = serve_requests(cfg, sp, reqs, ctx, sc, slots=scn.batch,
                                 stats=stats, device=dev, injector=injector,
                                 resume=resume)
            sync(dev)
            return out, time.perf_counter() - t0

        rounds = max(2, repeats // 3)
        for name, (scn, cfg, ctx, sp, sc, reqs) in pmap.items():
            rec = records[name]
            t_e2e, out = float("inf"), None
            for _ in range(rounds):
                out, dt = paged_e2e(name)
                t_e2e = min(t_e2e, dt)
            rec["decode_step_ms"] = round(t_e2e / scn.new_tokens * 1e3, 4)
            rec["timing"] = "e2e-paged"
            rec["prefill_ms"] = None
            cache = lm.init_cache(cfg, scn.batch,
                                  scn.prompt_len + scn.new_tokens, "hif4",
                                  device="meta")
            rec["roofline"] = decode_step_bytes(
                cfg, sp, cache, scn.prompt_len + scn.new_tokens // 2)
            log(f"[matrix] {scn.name}: paged e2e {rec['decode_step_ms']} ms/tok")
            if scn.recovery:
                # crash the journaled serve mid-decode, then resume from its
                # journal: the recovered outputs must equal the clean run's
                ref = [r.tolist() for r in out]
                inj = faults.FaultInjector(faults.FaultSpec(
                    "crash_mid_decode", after_chunk=1))
                crashed = False
                try:
                    paged_e2e(name, injector=inj)
                except faults.SimulatedCrash:
                    crashed = True
                stats: dict = {}
                out2, dt2 = paged_e2e(name, stats=stats, resume=True)
                rec["recovery"] = dict(
                    stats.get("recovery", {}), crashed=crashed,
                    bitwise=[r.tolist() for r in out2] == ref,
                    resume_ms=round(dt2 * 1e3, 3))
                log(f"[matrix] {scn.name}: recovery {rec['recovery']}")

        # tight pairwise A/B interleave for paged gate pairs
        for base_name, sub_name in gate_pairs:
            if base_name not in pmap or sub_name not in pmap:
                continue
            pair_best = {base_name: float("inf"), sub_name: float("inf")}
            for _ in range(2 * rounds):
                for name in (base_name, sub_name):
                    _, dt = paged_e2e(name)
                    pair_best[name] = min(pair_best[name],
                                          dt / pmap[name][0].new_tokens)
            records[sub_name].setdefault("gate_timing", {})[base_name] = {
                "baseline_ms": round(pair_best[base_name] * 1e3, 4),
                "subject_ms": round(pair_best[sub_name] * 1e3, 4)}
    finally:
        for d in tmp_dirs:
            shutil.rmtree(d, ignore_errors=True)
    return [records[s.name] for s in scenarios]
