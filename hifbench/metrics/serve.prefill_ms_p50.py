"""Median over the untraced calls' requests of the prefill milliseconds."""
from hifbench.harness.readers import per_request, percentile, untraced


def read(record):
    values = per_request(untraced(record), "prefill_s")
    return 1e3 * percentile(values, 0.5) if values else None
