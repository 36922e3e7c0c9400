"""Atomic, hashed checkpoints of a parameter tree (port of
``repro/checkpoint/checkpoint.py``: ``save_checkpoint``, ``latest_step``,
``load_checkpoint`` and the async ``CheckpointManager``).

Layout (one directory per step), byte-compatible with the reference::

    <dir>/step_000120/
        manifest.json    # tree structure, shapes, dtypes, sha256 per array
        arr_00000.npy ... arr_NNNNN.npy
        extra.json       # non-array state

Each array is stored as its raw bytes in a flat uint8 ``.npy``, with the
reference's dtype name in the manifest. Leaves come in the reference's
pytree order: dict keys sorted at every level, tuples and lists in
order (a training checkpoint is ``(params, opt_state)``), a
:class:`PackedW` as ``(codes, meta)``. The port's conventions are translated on the way: an
int32 meta word of a PackedW is stored as ``uint32`` (the same bits), and
bfloat16 is written and read as raw 16-bit words (no ``ml_dtypes``).

Atomicity: written into ``step_XXX.tmp`` then renamed, manifest last, so a
crash mid-write never leaves a directory the loader would accept.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.qlinear import PackedW
from repro_torch.device import DeviceLike, resolve_device


class CheckpointError(RuntimeError):
    """Base of typed checkpoint-load errors."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint array's bytes no longer match the sha256 recorded in its
    manifest: the payload was corrupted after it was written."""


# ---------------------------------------------------------------------------
# Leaves as host bits, in the reference's order and dtype names
# ---------------------------------------------------------------------------


def host_bits(leaf, *, uint32: bool = False) -> tuple[np.ndarray, str]:
    """(contiguous host array of the leaf's bytes, the reference's dtype
    name). bfloat16 comes back as its uint16 bit pattern named
    ``"bfloat16"``; with ``uint32`` an int32 tensor is named ``"uint32"``."""
    if isinstance(leaf, np.ndarray):
        a = np.ascontiguousarray(leaf)
        return a, a.dtype.name
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    if uint32 and a.dtype == np.int32:
        return a.view(np.uint32), "uint32"
    return a, a.dtype.name


def tensor_from_bits(a: np.ndarray, name: str, shape=None,
                     dtype: Optional[torch.dtype] = None,
                     device: DeviceLike = "cpu") -> torch.Tensor:
    """Raw bytes (any numpy dtype) + the reference's dtype name -> a tensor
    with the same bits: ``bfloat16`` as torch.bfloat16, ``uint32`` as
    int32. ``dtype`` (the target leaf's) converts by value otherwise."""
    raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    if name == "bfloat16":
        t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    elif name == "uint32":
        t = torch.from_numpy(raw.view(np.int32).copy())
    else:
        t = torch.from_numpy(raw.view(np.dtype(name)).copy())
    if shape is not None:
        t = t.reshape(tuple(shape))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def tree_leaves(tree, prefix: tuple = ()) -> list:
    """[(key path, leaf, is_meta)] in the reference's pytree order: dict
    keys sorted at every level, tuples and lists in order, a PackedW as its
    codes then its meta."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, node in enumerate(tree):
            out.extend(tree_leaves(node, prefix + (str(i),)))
        return out
    if isinstance(tree, PackedW):
        return [(prefix, tree.codes, False), (prefix, tree.meta, True)]
    return [(prefix, tree, False)]


def tree_flatten(tree) -> list:
    """The leaves alone, in :func:`tree_leaves` order (the inverse of
    :func:`tree_unflatten`)."""
    return [leaf for _, leaf, _ in tree_leaves(tree)]


def tree_unflatten(target, leaves: list):
    """Rebuild ``target``'s structure from leaves in :func:`tree_leaves`
    order (PackedW nodes keep their shape2d, dtype, axes and layout)."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(n) for n in node)
        if isinstance(node, PackedW):
            codes = next(it)
            return node._replace(codes=codes, meta=next(it))
        return next(it)

    out = walk(target)
    if next(it, None) is not None:
        raise ValueError("more leaves than the target tree holds")
    return out


def tree_description(tree) -> str:
    """A readable structure string for the manifest's ``treedef`` field."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_description(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + "".join(f"{tree_description(n)}, " for n in tree) + ")"
    if isinstance(tree, PackedW):
        return (f"PackedW[{tuple(tree.shape2d)}, {tuple(tree.axes2d)}, "
                f"kernel_layout={tree.kernel_layout}](*, *)")
    return "*"


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None, *, verify: bool = True) -> str:
    """Atomically write ``tree`` (tensors, numpy arrays, PackedW) and the
    JSON-able ``extra`` state; returns the step directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = tree_leaves(tree)
    manifest = {"step": step, "treedef": tree_description(tree),
                "n_leaves": len(leaves), "arrays": []}
    for i, (_, leaf, is_meta) in enumerate(leaves):
        arr, name = host_bits(leaf, uint32=is_meta)
        fn = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), np.frombuffer(arr.tobytes(), dtype=np.uint8))
        entry = {"file": fn, "shape": list(arr.shape), "dtype": name}
        if verify:
            with open(os.path.join(tmp, fn), "rb") as f:
                entry["sha256"] = hashlib.sha256(f.read()).hexdigest()
        manifest["arrays"].append(entry)

    with open(os.path.join(tmp, "extra.json"), "w") as f:
        json.dump(extra or {}, f)
    # manifest LAST: its presence marks the payload complete
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    """Largest step with a complete (manifest-bearing) checkpoint."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m or not os.path.exists(os.path.join(directory, name,
                                                    "manifest.json")):
            continue
        s = int(m.group(1))
        best = s if best is None or s > best else best
    return best


def load_checkpoint(directory: str, step: int, target_tree: Any, *,
                    verify: bool = False, device: DeviceLike = None):
    """Restore into the structure of ``target_tree`` (leaves: anything with
    ``shape`` and ``dtype``, e.g. tensors on the ``meta`` device; PackedW
    nodes) on ``device``. With ``verify`` every array is re-hashed against
    its manifest first (:class:`CheckpointCorruptError`). Returns (tree,
    extra)."""
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    targets = tree_leaves(target_tree)
    if manifest["n_leaves"] != len(targets):
        raise CheckpointError(f"checkpoint has {manifest['n_leaves']} leaves, "
                              f"target {len(targets)}")
    out = []
    for entry, (keys, ref, _) in zip(manifest["arrays"], targets):
        fp = os.path.join(path, entry["file"])
        if verify and "sha256" in entry:
            with open(fp, "rb") as f:
                h = hashlib.sha256(f.read()).hexdigest()
            if h != entry["sha256"]:
                raise CheckpointCorruptError(
                    f"checkpoint array {fp} fails its manifest sha256 "
                    f"(expected {entry['sha256'][:12]}..., got {h[:12]}...): "
                    "the payload was corrupted after the atomic write; "
                    "restore an earlier step or re-save the checkpoint")
        if tuple(entry["shape"]) != tuple(ref.shape):
            raise CheckpointError(f"{entry['file']} ({'.'.join(keys)}): shape "
                                  f"{entry['shape']} != target {tuple(ref.shape)}")
        want = ref.dtype if isinstance(ref.dtype, torch.dtype) else None
        if entry["dtype"] == "uint32" and want == torch.int32:
            want = None                          # the port's meta words: bits
        out.append(tensor_from_bits(np.load(fp), entry["dtype"], entry["shape"],
                                    want, dev))
    with open(os.path.join(path, "extra.json")) as f:
        extra = json.load(f)
    return tree_unflatten(target_tree, out), extra


def _host_copy(tree):
    """The tree with every tensor copied to host memory now (a copy even of
    a CPU tensor: the train loop updates its buffers in place)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host_copy(n) for n in tree)
    if isinstance(tree, PackedW):
        return tree._replace(codes=_host_copy(tree.codes),
                             meta=_host_copy(tree.meta))
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


class CheckpointManager:
    """Async saves: the tree is copied to host memory before the save
    thread starts (so the caller may update its buffers), the files are
    written on the thread while training goes on, and the newest ``keep``
    complete steps are kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        """Join the save in flight; re-raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        host_tree = _host_copy(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except Exception as e:  # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(m.group(1))
            for name in os.listdir(self.directory)
            if (m := re.fullmatch(r"step_(\d+)", name))
            and os.path.exists(os.path.join(self.directory, name,
                                            "manifest.json")))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
