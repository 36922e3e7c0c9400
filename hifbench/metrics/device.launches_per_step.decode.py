"""Host calls that launch a device op (the profiler's cudaLaunchKernel and
kin) in the profiled decode steps, a step."""
from hifbench.harness.readers import phase


def read(record):
    ph = phase(record, "decode")
    steps = record["trace"]["decode_steps"] if ph is not None else 0
    return ph["launches"] / steps if steps else None
