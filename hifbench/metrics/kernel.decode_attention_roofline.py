"""Kernel 3 in the profiled decode steps: each layer's valid HiF4 KV prefix
read once, q read and out written in bf16, against 3.35 TB/s (or its
operations against 989 TFLOP/s, where larger), over its device time."""
from hifbench import counts
from hifbench.counts import dense
from hifbench.harness.readers import kernel_us, phase

KERNELS = ("fused_decode_attention_kernel",)


def read(record):
    ph = phase(record, "decode")
    if ph is None or record["model"]["family"] != "dense":
        return None
    us = kernel_us(ph, KERNELS)
    if us <= 0:
        return None
    m = record["model"]
    call = record["trace"]["call"]
    bound = 0.0
    for j in range(1, record["trace"]["decode_steps"] + 1):
        work = dense.attention_decode_work(m, call["batch"],
                                            call["prompt_len"] + j)
        bound += m["n_layers"] * counts.bound_s(*work, counts.PEAK_BF16_FLOPS)
    return 100.0 * bound * 1e6 / us
