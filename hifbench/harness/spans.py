"""Device time, launches and idle gaps of one traced call, by the program's
spans.

The program opens named profiler ranges (its spans) inside the functions
they name while a profiler records. For each phase of the traced call (the
harness's ``hifbench.prefill`` and ``hifbench.decode`` ranges, as
:func:`hifbench.harness.trace.analyze` reads them) and each span name,
:func:`attribute` reports:

  calls      the span's ranges that start in the phase
  host_us    the union of their host intervals
  device_us  the device time of the phase's ops launched inside the span
  launches   the phase's launch calls inside the span
  idle_us    the phase's idle gaps whose midpoint falls inside the span

"Inside" is inside the innermost span whose host interval holds the
instant, so a nested span's work counts to it alone. A device op counts
where it was launched: the profiler's correlation id ties it to its host
launch call, whose start decides, however late the device runs the op.
Only the names of :data:`SPANS` are spans here: any other range (the
harness's own, an operator) is ignored. Ops launched, and gaps falling,
outside every span go under ``(none)``. A phase's ops are those that
``analyze`` gives it, so its ``device_us`` over every name is the sum of
its ``kernel_us``, and its ``launches`` its ``launches``.

:data:`SPANS` is a frozen copy of the program's names
(``repro_torch.core.spans.SPANS``), so a span the program adds later moves
no number here until the harness names it.
"""
from __future__ import annotations

import heapq

import torch

from hifbench.harness.trace import DECODE, LAUNCH_CALLS, PREFILL, merged

SPANS = ("lm.prefill", "lm.decode_step", "lm.head", "linear", "attn.prefill",
         "attn.decode", "kv.append", "kv.pack", "ssm.conv", "ssd.scan",
         "ssd.step", "moe.experts")
NONE = "(none)"


def _innermost(spans: list, instants: list) -> list:
    """For each instant, the name of the innermost (latest started) of
    ``spans`` ((start, end, name), properly nested) that holds it, or
    :data:`NONE`."""
    spans = sorted(spans)
    order = sorted(range(len(instants)), key=instants.__getitem__)
    out = [NONE] * len(instants)
    heap, i = [], 0
    for k in order:
        t = instants[k]
        while i < len(spans) and spans[i][0] <= t:
            heapq.heappush(heap, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while heap and heap[0][1] < t:              # ended before t
            heapq.heappop(heap)
        if heap:
            out[k] = heap[0][2]
    return out


def attribute(events) -> dict:
    """{phase: {span name: {calls, host_us, device_us, launches, idle_us}}}
    of a traced call's profiler ``events``."""
    ranges, spans, launch, runtime, dev = {}, [], [], {}, []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.time_range.start, e.time_range.end, e.id))
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.name in (PREFILL, DECODE):
            ranges[e.name] = (start, end)
        elif e.name in SPANS:
            spans.append((start, end, e.name))
        elif e.name.startswith("cu"):               # a CUDA API call
            runtime[e.id] = start
            if e.name in LAUNCH_CALLS:
                launch.append(start)
    out = {}
    for key, name in (("prefill", PREFILL), ("decode", DECODE)):
        if name not in ranges:
            continue
        a, b = ranges[name]
        table = {}

        def row(span):
            return table.setdefault(span, {"calls": 0, "host_us": 0.0,
                                           "device_us": 0.0, "launches": 0,
                                           "idle_us": 0.0})

        mine = [s for s in spans if a <= s[0] <= b]
        intervals = {}
        for s, t, n in mine:
            intervals.setdefault(n, []).append((s, t))
        for n, iv in intervals.items():
            row(n)["calls"] = len(iv)
            row(n)["host_us"] = sum(t - s for s, t in merged(iv))
        ops = [(s, t, c) for s, t, c in dev if a <= s <= b]
        # an op whose launch call is missing counts as launched outside
        # every span, at an instant no span holds
        at = [runtime.get(c, float("-inf")) for _, _, c in ops]
        for (s, t, _), n in zip(ops, _innermost(mine, at)):
            row(n)["device_us"] += t - s
        calls = [t for t in launch if a <= t <= b]
        for n in _innermost(mine, calls):
            row(n)["launches"] += 1
        gaps, reach = [], a
        for s, t in merged([(s, t) for s, t, _ in ops]):
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, t)
        if b > reach:
            gaps.append((reach, b))
        mids = [(s + t) / 2 for s, t in gaps]
        for (s, t), n in zip(gaps, _innermost(mine, mids)):
            row(n)["idle_us"] += t - s
        out[key] = table
    return out
