"""The whole decode step's share of the card's peak: over the untraced
calls, the sum of each step's least time (the HiF4 linears' operations at
the int8 peak plus the rest at the bf16 peak, or the bytes at 3.35 TB/s:
weights once at their stored size, the KV or SSM state read and written,
whichever is larger) over their decode seconds."""
from hifbench import counts
from hifbench.harness.readers import untraced


def read(record):
    m = record["model"]
    least = wall = 0.0
    for c in untraced(record):
        for j in range(1, c["decode_steps"] + 1):
            least += counts.least_time_s(
                counts.decode_step(m, c["batch"], c["prompt_len"] + j))
        wall += c["decode_s"]
    return 100.0 * least / wall if wall > 0 else None
