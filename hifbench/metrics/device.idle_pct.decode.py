"""Share of the profiled decode steps' wall time in which no operation ran
on the device (1 - the union of its activity intervals / the wall)."""
from hifbench.harness.readers import idle_pct


def read(record):
    return idle_pct(record, "decode")
