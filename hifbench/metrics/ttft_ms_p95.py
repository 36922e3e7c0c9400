"""95th percentile (nearest rank) over every request of the window of its
time to first token, on the harness's own clock. In a call of one new token
that is the call's wall time: from its start to its tokens on the host.
Cells of longer calls have no reading here."""
from hifbench.harness.readers import per_request, percentile


def read(record):
    if any(c["new_tokens"] != 1 for c in record["calls"]):
        return None
    return 1e3 * percentile(per_request(record["calls"], "wall_s"), 0.95)
