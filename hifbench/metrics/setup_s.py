"""Set-up seconds: process start (the interpreter's included) to the
window's start: imports, loading (or, in a fresh checkout, building) the
kernels, drawing and packing the weights, the warm-up call."""


def read(record):
    return record["setup_s"]
