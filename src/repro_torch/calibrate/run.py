"""End-to-end calibration: probe -> frontier search -> emitted policy (port
of ``repro/calibrate/run.py``).

``calibrate()`` is the library entry the CLI
(:mod:`repro_torch.launch.calibrate`) drives. Beyond chaining the three
layers it does the two pieces of bookkeeping that make the output
trustworthy:

* **baseline scoring** — the hand-written presets (``sensitive-fallback``,
  ``paper-iv``) are resolved against the same architecture and priced on
  the SAME probe score table, so "searched beats the fallback preset" is
  an apples-to-apples claim on one calibration set;
* **budget verification** — the emitted policy is round-tripped through
  ``get_policy`` -> ``lm.quant_plan`` and the byte residency recomputed
  from the resolved plan's ``packed_paths`` (exactly what
  ``prepare_params_for_serving`` packs). The search's byte accounting and
  the serving stack's must agree to the byte, or calibrate() raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch.calibrate.emit import emit_policy, emit_report
from repro_torch.calibrate.probe import DENSE_BPV, PACKED_BPV, probe_sites
from repro_torch.calibrate.search import assignment_cost, frontier_search
from repro_torch.configs import get_arch
from repro_torch.core.policy import QuantRule, get_policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm

BASELINE_PRESETS = ("sensitive-fallback", "paper-iv")


def measure_bandwidth(device: DeviceLike = None) -> Optional[float]:
    """Stream bandwidth in bytes/s of ``device``: best of 5 device-to-device
    copies of 128 MiB, timed with CUDA events (each reads and writes the
    bytes once). None on the CPU (no roofline measurement)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    src = torch.zeros(1 << 25, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)                                   # warm-up
    best = float("inf")
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return 2 * src.nbytes / best


def _preset_assignment(cfg, preset: str, budget_paths) -> dict:
    """What a hand-written preset assigns, in the search's vocabulary:
    'hif4' where its resolved plan packs, 'bf16' elsewhere."""
    plan = lm.quant_plan(cfg, get_policy(preset, impl="packed"))
    return {p: ("hif4" if p in plan.packed_paths else "bf16")
            for p in budget_paths}


def _plan_bytes(plan, budget_sites) -> float:
    """Byte residency of the in-budget sites under a resolved plan — the
    serving-side ground truth (``packed_paths`` is exactly the set
    ``prepare_params_for_serving`` packs)."""
    return sum((PACKED_BPV if s.path in plan.packed_paths else DENSE_BPV)
               * s.n_values for s in budget_sites)


def calibrate(arch: str, *, reduced: bool = True, target_bpv=0.7,
              n_batches: int = 2, batch: int = 2, seq_len: int = 64,
              seed: int = 0, kv_format: str = "bf16",
              out: Optional[str] = None, report_out: Optional[str] = None,
              mem_bw: Optional[float] = None, measure_bw: bool = False,
              log=print, params: Optional[dict] = None,
              batches: Optional[Sequence[dict]] = None,
              device: DeviceLike = None) -> dict:
    """Probe ``arch``, search the frontier at ``target_bpv``, emit the
    policy (to ``out`` when given) and return the summary dict.

    ``target_bpv`` is a float budget in bytes/value — or the name of a
    baseline preset (``sensitive-fallback``, ``paper-iv``), meaning "match
    that preset's measured byte residency on this architecture". ``params``
    and ``batches`` are the weights and the calibration set (default: the
    seeded init and ``n_batches`` seeded prefill batches, see
    :func:`~repro_torch.calibrate.probe.probe_sites`); ``device`` where the
    probe runs (default ``cuda``). The summary's ``timings`` holds the
    probe's, HiGPTQ's, the rest of the scoring's and the search's seconds.
    """
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    if mem_bw is None and measure_bw:
        mem_bw = measure_bandwidth(dev)

    timings: dict = {}
    result = probe_sites(cfg, params=params, n_batches=n_batches, batch=batch,
                         seq_len=seq_len, seed=seed, mem_bw=mem_bw, log=log,
                         batches=batches, device=dev, timings=timings)
    t0 = time.perf_counter()
    sites = result.site_scores()
    budget_paths = [s.path for s in sites]
    n_total = sum(s.n_values for s in sites)
    baselines = {}
    for preset in BASELINE_PRESETS:
        a = _preset_assignment(cfg, preset, budget_paths)
        b, e = assignment_cost(sites, a)
        baselines[preset] = {
            "assignment": a, "total_bytes": round(b), "total_error": e,
            "achieved_bpv": round(b / n_total, 6),
        }

    target_spec = target_bpv
    if isinstance(target_bpv, str):
        if target_bpv not in baselines:
            raise ValueError(
                f"target_bpv={target_bpv!r}: expected a float or one of "
                f"{sorted(baselines)}")
        target_bpv = baselines[target_bpv]["total_bytes"] / n_total

    frontier = frontier_search(sites, target_bpv)
    timings["search_s"] = time.perf_counter() - t0
    log(f"[calibrate] search: target {target_bpv:.6g} B/value over "
        f"{len(sites)} sites -> achieved {frontier.achieved_bpv:.4f} "
        f"(feasible={frontier.feasible})")

    provenance = {
        "tool": "repro_torch calibrate",
        "arch": cfg.name,
        "reduced": reduced,
        "target_bpv": round(target_bpv, 6),
        "target_spec": str(target_spec),
        "achieved_bpv": round(frontier.achieved_bpv, 6),
        "feasible": frontier.feasible,
        "calibration": {"n_batches": result.n_batches, "batch": result.batch,
                        "seq_len": result.seq_len, "seed": seed,
                        "n_calib_rows": result.n_calib_rows},
    }
    policy = emit_policy(frontier.assignment,
                         name=f"searched:{cfg.name}@{target_spec}",
                         kv_format=kv_format, provenance=provenance, out=out)

    # budget verification against the serving stack's own byte accounting:
    # round-trip the emitted file through get_policy (or, without a file,
    # the in-memory equivalent of its impl-prepend) and recompute residency
    # from the resolved plan's packed_paths.
    if out is not None:
        served = get_policy(out, impl="packed")
    else:
        served = dataclasses.replace(
            policy, rules=(QuantRule("*", impl="packed"),) + policy.rules)
    plan = lm.quant_plan(cfg, served)
    in_budget = set(budget_paths)
    budget_sites = [s for s in plan.sites if s.path in in_budget]
    measured = _plan_bytes(plan, budget_sites)
    if abs(measured - frontier.total_bytes) > 0.5:
        raise AssertionError(
            f"search byte accounting ({frontier.total_bytes:.0f}) disagrees "
            f"with the resolved plan's packed_paths residency "
            f"({measured:.0f}) — the emitted policy does not serve what the "
            f"search priced")
    budget = target_bpv * n_total
    if frontier.feasible and measured > budget + 1e-6:
        raise AssertionError(
            f"emitted policy misses its own budget: {measured:.0f} B "
            f"resident > {budget:.0f} B allowed at {target_bpv} B/value")
    log(f"[calibrate] verified: {measured:.0f} B resident over "
        f"{n_total} values = {measured / n_total:.4f} B/value "
        f"(budget {target_bpv:.6g}), plan packs {len(plan.packed_paths)} "
        f"sites")

    report = emit_report(result, frontier, target_bpv=target_bpv,
                         baselines=baselines, out=report_out)
    return {
        "arch": cfg.name,
        "family": cfg.family,
        "target_bpv": round(target_bpv, 6),
        "target_spec": str(target_spec),
        "achieved_bpv": round(measured / n_total, 6),
        "feasible": frontier.feasible,
        "total_bytes": round(measured),
        "total_error": frontier.total_error,
        "n_sites": len(sites),
        "n_packed": len(plan.packed_paths & in_budget),
        "assignment": dict(sorted(frontier.assignment.items())),
        "baselines": baselines,
        "policy": policy,
        "policy_path": out,
        "report_path": report_out,
        "report": report,
        "timings": timings,
    }
