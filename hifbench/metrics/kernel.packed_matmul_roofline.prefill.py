"""Kernels 1 and 2 in the profiled prefill: the least time of the HiF4
linears at batch x prompt rows over the device time of the ops that carry
it, by name."""
from hifbench import counts
from hifbench.harness.readers import kernel_us, phase

KERNELS = ("hif4_quantize_kernel", "fused_decode_matmul_kernel",
           "group_matmul_kernel", "group_matmul_sm90_kernel")


def read(record):
    ph = phase(record, "prefill")
    if ph is None:
        return None
    us = kernel_us(ph, KERNELS)
    if us <= 0:
        return None
    call = record["trace"]["call"]
    bound = counts.packed_matmul_bound_s(record["model"],
                                         call["batch"] * call["prompt_len"])
    return 100.0 * bound * 1e6 / us
