"""Kernels 1 and 2 in the profiled decode steps: the least time of the HiF4
linears' work at the batch's rows (each linear's bound: x bf16, weight at
0.5625 B a value, y bf16 against 3.35 TB/s; 2 M K N against 1 979 TOP/s)
over the device time of the ops that carry it, by name."""
from hifbench import counts
from hifbench.harness.readers import kernel_us, phase

KERNELS = ("hif4_quantize_kernel", "fused_decode_matmul_kernel",
           "group_matmul_kernel", "group_matmul_sm90_kernel")


def read(record):
    ph = phase(record, "decode")
    if ph is None:
        return None
    us = kernel_us(ph, KERNELS)
    if us <= 0:
        return None
    steps = record["trace"]["decode_steps"]
    bound = steps * counts.packed_matmul_bound_s(record["model"],
                                                 record["trace"]["call"]["batch"])
    return 100.0 * bound * 1e6 / us
