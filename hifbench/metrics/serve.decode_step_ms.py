"""Milliseconds a decode step, over the untraced calls: their decode
seconds over their decode steps (the program's own clock, to a
synchronize)."""
from hifbench.harness.readers import untraced


def read(record):
    calls = [c for c in untraced(record) if c["decode_steps"]]
    if not calls:
        return None
    return 1e3 * sum(c["decode_s"] for c in calls) / sum(
        c["decode_steps"] for c in calls)
