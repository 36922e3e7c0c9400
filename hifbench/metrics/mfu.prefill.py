"""The whole prefill's share of the card's peak: over the untraced calls,
the sum of each prefill's least time over their prefill seconds."""
from hifbench import counts
from hifbench.harness.readers import untraced


def read(record):
    m = record["model"]
    calls = untraced(record)
    wall = sum(c["prefill_s"] for c in calls)
    least = sum(counts.least_time_s(counts.prefill(m, c["batch"], c["prompt_len"]))
                for c in calls)
    return 100.0 * least / wall if wall > 0 else None
