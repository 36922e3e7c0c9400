"""Share of the profiled prefill's wall time in which no operation ran on
the device."""
from hifbench.harness.readers import idle_pct


def read(record):
    return idle_pct(record, "prefill")
