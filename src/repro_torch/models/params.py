"""Abstract parameter specs and seeded initialization (port of
``repro/models/params.py``). There is no sharding in the port, so the
logical axis names are kept only as documentation of each dimension."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class PSpec:
    """One parameter: shape, logical axis names, dtype, initializer."""

    shape: tuple
    axes: tuple                      # logical names (or None), len == ndim
    dtype: Any = torch.bfloat16
    init: str = "normal"             # normal | zeros | ones
    std: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def map_specs(fn, tree):
    """Apply ``fn`` to every PSpec leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return fn(tree) if is_pspec(tree) else tree


def spec_leaves(tree, prefix=()) -> list:
    """[(path tuple, PSpec)] in sorted-key order (the reference's pytree
    flattening order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(spec_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)] if is_pspec(tree) else []


def stack_specs(tree, n: int, axis_name: str = "layers"):
    """Add a leading stacked-layer axis of size ``n`` to every leaf."""
    return map_specs(
        lambda p: dataclasses.replace(p, shape=(n,) + p.shape,
                                      axes=(axis_name,) + p.axes), tree)


def init_from_specs(tree, seed: int = 0, *, device: DeviceLike = None,
                    draw_on_device: bool = False):
    """Materialize parameters: leaf i (sorted-key order) draws a truncated
    normal (+-2 std) from its own ``torch.Generator`` seeded by (seed, i),
    on the CPU, so the weights do not depend on the device they land on.
    ``draw_on_device`` draws with a generator on ``device`` instead: the
    CPU's generator takes minutes for the billions of values of a
    full-width model, the card's a second (other values, from the same
    seeds)."""
    dev = resolve_device(device)
    gdev = dev if draw_on_device else torch.device("cpu")
    leaves = spec_leaves(tree)
    index = {path: i for i, (path, _) in enumerate(leaves)}

    def one(path, p: PSpec):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=p.dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=p.dtype, device=dev)
        gen = torch.Generator(device=gdev).manual_seed(
            seed * 1_000_003 + index[path])
        x = torch.empty(p.shape, dtype=torch.float32, device=gdev)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return x.mul_(p.std).to(dtype=p.dtype, device=dev)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (k,)) for k, v in node.items()}
        return one(prefix, node) if is_pspec(node) else node

    return walk(tree, ())
