"""Carry the JAX package's parameters and decode caches into the port.

The reference's trees are nested dicts whose leaves are arrays, or packed
weights (any object with ``codes``, ``meta``, ``shape2d`` and
``kernel_layout`` attributes, in either layout). This module converts them
with ``np.asarray`` and never imports JAX: a caller holding JAX arrays
passes them as they are (``np.asarray`` reads them) or as numpy arrays.

Conventions of the port: bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16)
become ``torch.bfloat16`` with the same bits; uint32 meta words become int32
tensors with the same bits (:mod:`repro_torch.core.hif4`). :func:`to_numpy`
goes back, for comparisons.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qlinear import PackedW
from repro_torch.device import DeviceLike, resolve_device


def tensor_from_numpy(a, device: DeviceLike = None) -> torch.Tensor:
    """One array -> tensor with identical bits (bf16 and uint32 included)."""
    dev = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32).copy())
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dev)


def to_numpy(t: torch.Tensor, *, uint32: bool = False) -> np.ndarray:
    """Tensor -> numpy on the host; bf16 becomes float32 (exact), and with
    ``uint32=True`` an int32 meta tensor is viewed as its uint32 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    a = t.numpy()
    return a.view(np.uint32) if uint32 else a


def _is_packed(leaf) -> bool:
    return all(hasattr(leaf, a) for a in ("codes", "meta", "shape2d",
                                           "kernel_layout"))


def packed_from_jax(leaf, device: DeviceLike = None) -> PackedW:
    """A reference PackedW (either layout) -> the port's PackedW, same bytes."""
    return PackedW(tensor_from_numpy(leaf.codes, device),
                   tensor_from_numpy(leaf.meta, device),
                   tuple(int(s) for s in leaf.shape2d), torch.bfloat16,
                   tuple(leaf.axes2d), kernel_layout=bool(leaf.kernel_layout))


def params_from_jax(tree, device: DeviceLike = None):
    """Nested dict of arrays / packed weights -> the port's parameter tree."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if _is_packed(tree):
        return packed_from_jax(tree, device)
    return tensor_from_numpy(tree, device)


def opt_state_from_jax(state: dict, device: DeviceLike = None) -> dict:
    """A reference AdamW state {"m": tree, "v": tree, "step": int32 scalar}
    -> the port's (:mod:`repro_torch.optim.adamw`), same bits: f32 moments,
    an int32 0-dim step."""
    if set(state) != {"m", "v", "step"}:
        raise ValueError(f"an AdamW state has m, v and step, got {sorted(state)}")
    step = tensor_from_numpy(np.asarray(state["step"], np.int32), device)
    return {"m": params_from_jax(state["m"], device),
            "v": params_from_jax(state["v"], device), "step": step.reshape(())}


def cache_from_jax(cache: dict, device: DeviceLike = None) -> dict:
    """A reference decode cache -> the port's, same bytes: contiguous
    {"kv": ..., "pos": ...}, paged {"kv": page pool (L, NP, F, P) leaves,
    "pages": (B, max_pages) int32 table, "pos": (B,)}, the SSM and
    hybrid families' {"layers": conv windows and SSD state, "kv"
    (hybrid), "pos"}, or the audio decoder's {"self", "cross", "pos"}. A
    lockstep position becomes a Python int, a per-slot one an int32
    tensor."""
    out = params_from_jax({k: v for k, v in cache.items() if k != "pos"}, device)
    pos = np.asarray(cache["pos"])
    out["pos"] = int(pos) if pos.ndim == 0 else tensor_from_numpy(pos, device)
    return out
