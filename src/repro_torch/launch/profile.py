"""Where the decode time goes: time and profile the port's greedy decode step.

    python -m repro_torch.launch.profile --arch qwen1.5-0.5b   # on the card
    python -m repro_torch.launch.profile --kv-pages 65         # paged pool
    python -m repro_torch.launch.profile --arch granite-moe-1b-a400m
    python -m repro_torch.launch.profile --arch mamba2-1.3b    # prompt 512
    python -m repro_torch.launch.profile --kv-format bf16      # bf16 KV cache

Builds the serving artifact (policy paper-iv, impl packed, ``--kv-format``
KV cache, HiF4 by default) from
random weights (``--seed``), prefills ``--batch`` x ``--prompt-len`` tokens
(default 480; 512 for the ssm and hybrid families, whose SSD scan takes a
prompt that is a multiple of its 256-token chunk), profiles a second,
warm prefill of the same prompt with ``torch.profiler``, then times
``--steps`` decode steps with the host clock around work that ends in a device
synchronize, and profiles two more with ``torch.profiler``
(CPU + CUDA activities). Prints the step time, the device-busy share of the
profiled window (the union of the device's activity intervals / wall time,
:func:`device_activity`), the device ops and host kernel launches
(``cudaLaunchKernel`` and its kin, :func:`host_launches`) per step, the
share of those launches and of the host time that the KV append takes
(the program's ``kv.append`` spans), each span's calls, host and device
time and launches per step (:func:`span_table`; ``moe.experts`` for a MoE
arch), the same table for the profiled prefill (``lm.prefill``,
``attn.prefill``, ``kv.pack``, ``ssd.scan``, ...), and the top device
kernels and host operators.
With ``--kv-pages N`` the prefilled cache is cut into pages of 64 tokens
and laid into a pool of N pages (one table row of distinct pages per slot,
page 0 the scratch page), and the
step decodes through the page table (kernel 4) as the paged scheduler's
steps do. For a MoE arch it also times the expert matmuls of one step
(every ``qdq_einsum`` call, its activation quantization included) replayed
alone: events around the eager calls, and a CUDA graph of them (device time
only). Weights are drawn on the card. CUDA only: a time taken on the CPU is
not a device time.
"""
from __future__ import annotations

import argparse
import heapq
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core import engine, kvcache
from repro_torch.core.policy import get_policy
from repro_torch.core.spans import SPANS
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.runtime.serve_loop import (
    ServeConfig, build_decode_cache, prepare_params_for_serving, serving_ctx)


def paged_cache(cfg, cache: dict, batch: int, n_pages: int, P: int, dev) -> dict:
    """The contiguous decode cache (capacity a page multiple) cut into pages
    of ``P`` tokens: slot b's pages are pool pages 1 + b*maxp .. (b+1)*maxp."""
    a = cfg.attn
    cap = kvcache.seq_capacity(cache["kv"]["k"])
    maxp = cap // P
    if n_pages < 1 + batch * maxp:
        raise ValueError(f"--kv-pages {n_pages} < 1 + {batch} slots x {maxp} pages")
    pool = kvcache.init_page_pool(cfg.n_layers, a.n_kv_heads, a.d_head, n_pages, P,
                                  device=dev)
    for name, leaves in cache["kv"].items():
        for key, t in leaves.items():                      # (L, B, F, cap)
            l, b, f, _ = t.shape
            pages = t.reshape(l, b, f, maxp, P).permute(0, 1, 3, 2, 4)
            pool[name][key][:, 1:1 + b * maxp] = pages.reshape(l, b * maxp, f, P)
    table = torch.arange(1, 1 + batch * maxp, dtype=torch.int32,
                         device=dev).reshape(batch, maxp)
    pos = torch.full((batch,), int(cache["pos"]), dtype=torch.int32, device=dev)
    return {"kv": pool, "pages": table, "pos": pos}


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def device_activity(events) -> tuple[float, list]:
    """Device busy ms of profiled ``events`` (``prof.events()``): the union
    of the device's own activity intervals (kernels, copies, sets), so a
    PyTorch operator and the kernels it launched are not counted twice, nor
    overlapping kernels; and (name, count, ms) per device activity name,
    largest first. A ``record_function`` range's device-side twin (a user
    annotation spanning the kernels inside it) is no activity of its own."""
    spans, per = [], {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        count, us = per.get(e.name, (0, 0.0))
        per[e.name] = (count + 1, us + end - start)
    return union_us(spans) / 1e3, sorted(((name, c, us / 1e3) for name, (c, us)
                                  in per.items()), key=lambda x: -x[2])


# the profiler's names of host calls that launch one device op each
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaMemsetAsync", "cudaMemcpyAsync")


def host_launches(events, ranges=()) -> tuple[int, int]:
    """(all, inside) host calls of ``events`` that launch a device op
    (:data:`LAUNCH_CALLS`); ``inside`` counts those that start within one
    of ``ranges`` ((start, end) pairs on the host clock)."""
    n = inside = 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA or \
                e.name not in LAUNCH_CALLS:
            continue
        n += 1
        t = e.time_range.start
        inside += any(a <= t <= b for a, b in ranges)
    return n, inside


def span_table(events) -> dict:
    """{span name: [calls, host us, device us, launches]} of profiled
    ``events``: each host launch call (:data:`LAUNCH_CALLS`), and each
    device op through its launch call's correlation id, counted to the
    innermost of the program's spans (:data:`SPANS`) whose host interval
    holds the launch call; those outside every span under ``(none)``."""
    spans, launches, ops, names = [], {}, [], {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                ops.append((e.id, e.time_range.end - e.time_range.start))
        elif e.name in SPANS:
            spans.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name in LAUNCH_CALLS:
            launches[e.id] = e.time_range.start
    table = {}
    for start, end, name in spans:
        row = table.setdefault(name, [0, [], 0.0, 0])
        row[0] += 1
        row[1].append((start, end))
    # sweep the launch calls in time order, keeping the spans open at each
    spans.sort()
    heap, i = [], 0
    for corr, t in sorted(launches.items(), key=lambda x: x[1]):
        while i < len(spans) and spans[i][0] <= t:
            heapq.heappush(heap, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        names[corr] = heap[0][2] if heap else "(none)"
    for corr, us in ops:
        table.setdefault(names.get(corr, "(none)"), [0, [], 0.0, 0])[2] += us
    for name in names.values():
        table.setdefault(name, [0, [], 0.0, 0])[3] += 1
    return {name: [c, union_us(iv), us, n]
            for name, (c, iv, us, n) in table.items()}


def print_spans(table: dict, per: int) -> None:
    """Print :func:`span_table`'s rows, each divided by ``per``, largest
    device time first."""
    for name, (calls, host_us, dev_us, n) in sorted(table.items(),
                                                    key=lambda x: -x[1][2]):
        print(f"  {name:16s} {calls / per:6.0f} calls  host "
              f"{host_us / per / 1e3:9.3f} ms  device {dev_us / per / 1e3:9.3f} "
              f"ms  {n / per:6.0f} launches")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="default 480; 512 for ssm and hybrid (a multiple of "
                         "the SSD chunk)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="> 0: decode through a page pool of this many pages "
                         f"of {kvcache.DEFAULT_PAGE_TOKENS} tokens")
    ap.add_argument("--kv-format", choices=kvcache.KV_FORMATS, default="hif4",
                    help="the decode KV cache: HiF4-packed (default) or bf16")
    args = ap.parse_args(argv)
    if args.kv_pages and args.kv_format != "hif4":
        ap.error("--kv-pages: the page pool is HiF4-only")
    dev = resolve_device("cuda")
    cfg = get_arch(args.arch)
    if args.prompt_len is None:
        args.prompt_len = 512 if cfg.ssm is not None else 480
    if args.kv_pages and cfg.family not in lm.KV_FAMILIES:
        ap.error(f"--kv-pages: the page pool serves the transformer families' "
                 f"KV cache, not {cfg.family!r}")
    plan = lm.quant_plan(cfg, get_policy("paper-iv", impl="packed",
                                         kv=kvcache.KVCacheConfig(args.kv_format)))
    ctx = ModelCtx(plan=plan)
    sctx = serving_ctx(ctx)
    params = prepare_params_for_serving(
        lm.init_params(cfg, args.seed, device=dev, draw_on_device=True), cfg,
        plan, device=dev)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(args.seed + 1))
    budget = args.steps + 4
    P = kvcache.DEFAULT_PAGE_TOKENS
    cap = -(-(args.prompt_len + budget) // P) * P if args.kv_pages else None
    serve = ServeConfig(max_new_tokens=budget, cache_capacity=cap)
    logits, cache = build_decode_cache(cfg, params, {"tokens": tokens.to(dev)},
                                       sctx, serve)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        build_decode_cache(cfg, params, {"tokens": tokens.to(dev)}, sctx, serve)
        torch.cuda.synchronize()
    prefill_spans = span_table(prof.events())
    if args.kv_pages:
        cache = paged_cache(cfg, cache, args.batch, args.kv_pages, P, dev)

    def step(token, cache):
        logits, cache = lm.decode_step(params, token, cache, cfg, sctx)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    token, cache = step(token, cache)                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        token, cache = step(token, cache)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kv = (f"paged pool {args.kv_pages} x {P} tokens" if args.kv_pages
          else f"contiguous {args.kv_format} KV cache")
    print(f"{torch.cuda.get_device_name(0)}: {cfg.name} batch {args.batch} "
          f"prompt {args.prompt_len}, {kv}: decode {step_ms:.2f} ms/step "
          f"({args.batch * 1e3 / step_ms:.1f} tokens/s)")

    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            token, cache = step(token, cache)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_ms, kernels = device_activity(prof.events())
    events = prof.key_averages()
    n_kernels = sum(c for _, c, _ in kernels)
    print(f"profiled 2 steps: wall {wall_us / 2e3:.2f} ms/step, device busy "
          f"{busy_ms / 2:.2f} ms/step ({100 * busy_ms * 1e3 / wall_us:.1f}% of "
          f"wall; idle {100 - 100 * busy_ms * 1e3 / wall_us:.1f}%), "
          f"{n_kernels / 2:.0f} device ops/step")
    appends = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.name == "kv.append"
               and e.device_type != torch.autograd.DeviceType.CUDA]
    launched, in_append = host_launches(prof.events(), appends)
    append_us = union_us(appends)
    print(f"host launches {launched / 2:.0f}/step; KV append: {len(appends) / 2:.0f} "
          f"calls/step, {in_append / 2:.0f} launches/step "
          f"({100 * in_append / max(launched, 1):.1f}%), host "
          f"{append_us / 2e3:.2f} ms/step ({100 * append_us / wall_us:.1f}% "
          f"of wall)")
    print("spans (per step; device time and launches to the innermost):")
    print_spans(span_table(prof.events()), 2)
    print("spans of the profiled prefill:")
    print_spans(prefill_spans, 1)
    print("top device time (per step):")
    for name, count, ms in kernels[:args.top]:
        print(f"  {ms / 2:9.3f} ms  {count / 2:6.0f}x  {name[:90]}")
    print("top host time (self, per step):")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:args.top]:
        print(f"  {e.self_cpu_time_total / 2e3:9.3f} ms  {e.count / 2:6.0f}x  {e.key[:90]}")
    if cfg.moe is not None:
        expert_einsums(step, token, cache, step_ms, busy_ms / 2)
    return 0


def expert_einsums(step, token, cache, step_ms: float, busy_ms: float) -> None:
    """Record the ``qdq_einsum`` calls of one decode step, then time them
    replayed alone: ``eager`` (events around the calls, host dispatch
    included where the host is slower) and ``device`` (one CUDA graph of
    them, replayed)."""
    calls, einsum = [], engine.qdq_einsum

    def recording(*a, **kw):
        calls.append((a, kw))
        return einsum(*a, **kw)

    engine.qdq_einsum = recording
    try:
        step(token, cache)
    finally:
        engine.qdq_einsum = einsum

    def replay():
        for a, kw in calls:
            einsum(*a, **kw)

    replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        replay()
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / 3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replay()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / 3
    print(f"expert qdq einsums: {len(calls)} calls/step, device {device_ms:.3f} "
          f"ms/step (CUDA graph; {100 * device_ms / busy_ms:.1f}% of the "
          f"step's device busy, {100 * device_ms / step_ms:.1f}% of its "
          f"{step_ms:.2f} ms), eager {eager_ms:.3f} ms/step")


if __name__ == "__main__":
    raise SystemExit(main())
