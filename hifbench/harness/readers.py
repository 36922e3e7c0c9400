"""What the metric readers share: the run's record, cut by phase and call.

A reader gets the run's record: ``model`` (the configuration's numbers),
``mix``, ``setup_s``, ``window_s``, ``calls`` (each call's index, batch,
prompt length, new tokens, host wall seconds and the program's own
``prefill_s``, ``decode_s`` and ``decode_steps``, each ending in a
synchronize; ``traced`` for the profiled one) and ``trace`` (None in an
untraced run; else the phases of the profiled call, from
:func:`hifbench.harness.trace.analyze`). It returns a number, or None where
it finds nothing to read.
"""
from __future__ import annotations

import math


def untraced(record: dict) -> list:
    return [c for c in record["calls"] if not c["traced"]]


def per_request(calls: list, key: str) -> list:
    out = []
    for c in calls:
        out += [c[key]] * c["batch"]
    return out


def percentile(values: list, q: float) -> float:
    """Nearest rank: the smallest value with at least q of them at or below."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def phase(record: dict, name: str):
    t = record["trace"]
    if t is None:
        return None
    return t["phases"].get(name)


def kernel_us(ph: dict, patterns: tuple) -> float:
    return sum(us for name, us in ph["kernel_us"].items()
               if any(p in name for p in patterns))


def idle_pct(record: dict, name: str):
    ph = phase(record, name)
    if ph is None or ph["wall_us"] <= 0:
        return None
    return 100.0 * (1.0 - ph["busy_us"] / ph["wall_us"])
