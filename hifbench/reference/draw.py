"""Seeded weights, drawn per layer, for the program and the reference alike.

A weight table lists every leaf of the model's parameter tree: its dotted
path, its shape (a stacked leaf's first axis counts the layers), its dtype,
its initializer and its scale. Layer ``l`` of every stacked leaf, and the
unstacked leaves as "layer" -1, come from one ``torch.Generator`` on the
device, seeded from (seed, layer), leaf after leaf in the table's order.
So the reference can draw one layer again, bitwise, without holding the
others, and the program gets the same tensors whole.
"""
from __future__ import annotations

import hashlib
import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SLAB_VALUES = 1 << 28


def mix_seed(*parts) -> int:
    """A 63-bit seed from any parts (the run's seed may exceed 32 bits)."""
    text = ":".join(str(p) for p in parts).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def layer_shape(leaf: dict) -> tuple:
    shape = tuple(leaf["shape"])
    return shape[1:] if leaf["stacked"] else shape


def _one(leaf: dict, gen: torch.Generator, device) -> torch.Tensor:
    shape = layer_shape(leaf)
    dtype = DTYPES[leaf["dtype"]]
    init = leaf["init"]
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "normal":
        # in slabs of leading rows, so that the float32 draw of a large
        # leaf (nemotron's head: 4.7 billion values) never stands whole
        out = torch.empty(shape, dtype=dtype, device=device)
        flat = out.view(shape[0], -1)
        rows = max(1, SLAB_VALUES // max(1, flat.shape[1]))
        for a in range(0, shape[0], rows):
            part = flat[a:a + rows]
            x = torch.randn(part.shape, generator=gen, device=device,
                            dtype=torch.float32)
            part.copy_(x.mul_(leaf["std"]))
        return out
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    lo, hi = math.log(leaf["low"]), math.log(leaf["high"])
    v = torch.exp(lo + u * (hi - lo))                 # log-uniform on [low, high]
    if init == "log_of_log_uniform":                  # mamba2's A = exp(a_log)
        return torch.log(v).to(dtype)
    if init == "softplus_inverse_of_log_uniform":     # mamba2's dt bias
        return (v + torch.log(-torch.expm1(-v))).to(dtype)
    raise ValueError(f"unknown initializer {init!r} of {leaf['path']}")


def draw_layer(table: list, seed: int, layer: int, device) -> dict:
    """{path: tensor} of layer ``layer`` (-1: the unstacked leaves)."""
    gen = torch.Generator(device=device).manual_seed(mix_seed(seed, "layer", layer))
    out = {}
    for leaf in table:
        if leaf["stacked"] == (layer >= 0):
            out[leaf["path"]] = _one(leaf, gen, device)
    return out
