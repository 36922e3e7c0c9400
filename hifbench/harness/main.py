"""One run of one cell: set up, measure a window of calls, judge, report.

Set-up builds the kernels (only the first run in a checkout compiles),
draws the weights from the seed on the device and packs them, and serves
one call at the mix's longest prompt with a few decode steps. The window
then serves calls back to back, each one lockstep batch of the mix through
``repro_torch.runtime.serve_loop.serve``, until ``seconds`` have passed
and a cycle of the mix's prompt lengths is whole; it ends with the last
call. With ``trace`` the window's second call is profiled (its prefill
and first decode steps) and the run reports the per-layer metrics;
without, the end-to-end ones. Then the program's state is freed and a
sample of the served requests is judged against the reference.
"""
from __future__ import annotations

import sys
import time

import torch

from hifbench.harness import judge, trace, traffic
from hifbench.harness.program import Program
from hifbench.harness.spec import ROOT, Cell
from hifbench.reference.draw import mix_seed

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACED_CALL = 1
WARM_DECODE_STEPS = 3


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run of the port may not
    load, each compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, traced: bool, *,
        device="cuda", root=ROOT, started: float | None = None,
        control: bool = False, program: Program | None = None) -> dict:
    """One run; ``control`` also judges the control by the cell's limits
    (``control_correct``; not in the benchmark's own runs); ``program``
    reuses a built program (a process that reads many seeds)."""
    started = time.time() if started is None else started
    cell = Cell(name, root)
    mix = cell.mix
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    prog = program or Program(cell.config, dev)
    vocab = prog.numbers["vocab"]
    prog.build_kernels()
    t_built = time.time()
    prog.load(seed)
    t_loaded = time.time()
    warm = torch.randint(0, vocab, (mix["batch"], traffic.longest(mix)),
                         generator=torch.Generator().manual_seed(
                             mix_seed(seed, "warm-up")))
    prog.serve(warm, min(mix["new_tokens"], 1 + WARM_DECODE_STEPS), {})
    if cuda and traced:
        trace.warm_profiler()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - started

    calls, prompts, served, traced_run = [], {}, {}, None
    cycle = len(traffic.lengths(mix))
    w0 = time.perf_counter()
    i = 0
    while True:
        tokens = traffic.prompts(mix, seed, i, vocab)
        stats = {}
        t0 = time.perf_counter()
        if traced and i == TRACED_CALL and cuda:
            with trace.TracedCall(mix["trace_decode_steps"]) as traced_run:
                out = prog.serve(tokens, mix["new_tokens"], stats)
        else:
            out = prog.serve(tokens, mix["new_tokens"], stats)
        t1 = time.perf_counter()
        calls.append({"index": i, "batch": mix["batch"],
                      "prompt_len": tokens.shape[1],
                      "new_tokens": mix["new_tokens"], "wall_s": t1 - t0,
                      "prefill_s": stats["prefill_s"],
                      "decode_s": stats["decode_s"],
                      "decode_steps": stats["decode_steps"],
                      "traced": traced_run is not None and i == TRACED_CALL})
        prompts[i], served[i] = tokens, out
        i += 1
        # the window closes at the end of a whole cycle of the mix's prompt
        # lengths, so every run serves the same set of sizes
        if (t1 - w0 >= seconds and i % cycle == 0
                and (not traced or i > TRACED_CALL)):
            break
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    record = {"model": prog.numbers, "mix": mix, "setup_s": setup_s,
              "window_s": window_s, "calls": calls, "trace": None}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced_run is not None:
        found = trace.analyze(traced_run.events)
        found["decode_steps"] = traced_run.decode_steps
        found["call"] = next(c for c in calls if c["traced"])
        record["trace"] = found
        if "busy_s" in found:
            dev_info["busy_s"] = found["busy_s"]
            dev_info["window_s"] = found["window_s"]
            breakdown = found["breakdown"]
    metrics = {}
    for met in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(met["name"])(record)
        if value is not None:
            metrics[met["name"]] = {"value": value, "unit": met["unit"]}

    table = prog.table
    prog.free()
    del prog
    t_ref = time.perf_counter()
    picks = judge.sample(calls, cell.judge["sample_requests"], seed)
    verdict = judge.verdict(cell.config, table, seed,
                            judge.requests(picks, prompts, served), dev,
                            control=control)
    limits = cell.judge["limits"]
    checks = judge.checks(verdict["program"], limits)
    correct = judge.holds(checks)
    result = {"correct": correct,
              "attempted": sum(c["batch"] for c in calls), "failed": 0,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["detail"] = {
        "seed": seed, "calls": len(calls), "window_s": window_s,
        "build_s": t_built - started, "load_s": t_loaded - t_built,
        "warm_s": setup_s - (t_loaded - started),
        "reference_s": time.perf_counter() - t_ref,
        "served_tokens_judged": verdict["served_tokens"],
        "numbers": verdict["program"], "gaps": verdict["gaps"],
        "call_wall_s": [c["wall_s"] for c in calls]}
    if control:
        control_checks = judge.checks(verdict["control"], limits)
        result["control_correct"] = judge.holds(control_checks)
        result["detail"]["control_checks"] = control_checks
        result["detail"]["control_numbers"] = verdict["control"]
        result["detail"]["control_gaps"] = verdict["control_gaps"]
    result["checks"] = checks
    return result

