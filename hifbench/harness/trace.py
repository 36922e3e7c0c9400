"""One call of the window under ``torch.profiler``, and what its trace says.

The call's prefill and its first decode steps run inside ranges the harness
opens around the program's own functions (``hifbench.prefill`` around
``serve_loop.build_decode_cache``, ``hifbench.decode`` from the first
``lm.decode_step`` to a synchronize after the last profiled one); the
profiler stops there, so the rest of the call runs untraced. A device op
belongs to the phase whose range its start falls in (each range ends in a
synchronize, so nothing of it runs later).

``union_us``, the device-activity filter and ``LAUNCH_CALLS`` are frozen
copies of the program's ``launch/profile.py`` arithmetic.
"""
from __future__ import annotations

import heapq

import torch

PREFILL, DECODE = "hifbench.prefill", "hifbench.decode"

# the profiler's names of host calls that launch one device op each
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaMemsetAsync", "cudaMemcpyAsync")


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def merged(spans) -> list:
    out = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


class TracedCall:
    """Patch the program's prefill and decode step for one call, profile its
    prefill and first ``steps`` decode steps, and keep the events."""

    def __init__(self, steps: int):
        self.steps = steps
        self.events = None

    def __enter__(self):
        from repro_torch.models import lm
        from repro_torch.runtime import serve_loop

        self._mods = (lm, serve_loop)
        self._build, self._step = serve_loop.build_decode_cache, lm.decode_step
        self._n, self._range = 0, None
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        serve_loop.build_decode_cache = self._traced_build
        lm.decode_step = self._traced_step
        self.prof.start()
        self._on = True
        return self

    def _traced_build(self, *a, **kw):
        with torch.profiler.record_function(PREFILL):
            out = self._build(*a, **kw)
            torch.cuda.synchronize()
        return out

    def _traced_step(self, *a, **kw):
        if not self._on:
            return self._step(*a, **kw)
        if self._n == 0:
            self._range = torch.profiler.record_function(DECODE)
            self._range.__enter__()
        out = self._step(*a, **kw)
        self._n += 1
        if self._n == self.steps:
            self._stop()
        return out

    def _stop(self):
        torch.cuda.synchronize()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.prof.stop()
        self._on = False

    def __exit__(self, *exc):
        lm, serve_loop = self._mods
        serve_loop.build_decode_cache, lm.decode_step = self._build, self._step
        if self._on:
            self._stop()
        self.events = self.prof.events()
        self.decode_steps = self._n
        return False


def _device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def analyze(events, top: int = 10) -> dict:
    """Per phase (prefill, decode): the range's wall and busy microseconds,
    its host launch calls and its device time by op name; over the whole
    traced window: busy and wall seconds, the device ops that took most
    time and the longest idle gaps by what the host was doing."""
    ranges = {}
    host = []
    dev = []
    for e in events:
        if _device(e):
            dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name in (PREFILL, DECODE):
                ranges[e.name] = (e.time_range.start, e.time_range.end)
            else:
                host.append((e.time_range.start, e.time_range.end, e.name))
    phases = {}
    for key, name in (("prefill", PREFILL), ("decode", DECODE)):
        if name not in ranges:
            continue
        a, b = ranges[name]
        mine = [(s, t, n) for s, t, n in dev if a <= s <= b]
        by_name = {}
        for s, t, n in mine:
            by_name[n] = by_name.get(n, 0.0) + (t - s)
        phases[key] = {
            "wall_us": b - a,
            "busy_us": union_us([(s, t) for s, t, _ in mine]),
            "launches": sum(1 for s, _, n in host
                            if n in LAUNCH_CALLS and a <= s <= b),
            "kernel_us": by_name}
    if not ranges:
        return {"phases": phases}
    w0 = min(a for a, _ in ranges.values())
    w1 = max(b for _, b in ranges.values())
    inside = [(s, t, n) for s, t, n in dev if w0 <= s <= w1]
    ops = {}
    for s, t, n in inside:
        ops[n] = ops.get(n, 0.0) + (t - s) / 1e6
    busy = merged([(s, t) for s, t, _ in inside])
    gaps, reach = [], w0
    for s, t in busy:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, t)
    if w1 > reach:
        gaps.append((reach, w1))
    idle = {}
    host.sort()
    heap, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:           # ended before the gap
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(no host op)"   # the innermost op
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {
        "phases": phases,
        "busy_s": union_us([(s, t) for s, t, _ in inside]) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "breakdown": {
            "device_ops": [[n, s] for n, s in sorted(ops.items(),
                                                      key=lambda x: -x[1])[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(),
                                                     key=lambda x: -x[1])[:top]]},
    }


def warm_profiler() -> None:
    """Start and stop the profiler once on a trivial op: CUPTI's first start
    is slow and belongs to set-up."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.ones(8, device="cuda").sum().item()
    prof.events()
