"""The per-token HiF4 KV append: K and V of one layer's new token quantized
(Algorithm 1), bit-packed and written into the cache in place, in ONE
launch of the CUDA kernel ``csrc/kv_append.cu``.

It replaces no TPU kernel: the reference runs ``repro/core/kvcache.py``'s
``append_token`` and ``append_token_paged`` under ``jit``, where XLA fuses
them; eager PyTorch dispatches them as about a hundred ops per tensor (the
plain versions :func:`repro_torch.core.kvcache.append_token_plain` and
``append_token_paged_plain``). The kernel writes the plain versions' bytes
bit for bit (its group arithmetic is kernel 1's, its packing the epilogue
``hif4_pack_block`` of ``csrc/hif4_common.cuh``).

    caches  one or two packed tensors (K, then V): the contiguous cache's
            kernel-tile leaves codes (B, G*32, S) uint8, meta (B, G, S)
            int32, tail (B, T, S) bf16, or artifact leaves (B, S, G, 32) /
            (B, S, G) / (B, S, T); with ``pages``, the per-layer pool view
            (NP, G*32, P) / (NP, G, P) / (NP, T, P)
    news    the new tokens (B, 1, Hkv, Dh) bf16 or f32, F = Hkv*Dh = 64*G + T
    pos     (B,) slot positions (int64 on the device; a lockstep int is
            filled there by :func:`repro_torch.core.kvcache.slot_positions`)
    pages   (B, max_pages) int32/int64 page table, or None (contiguous)

Contiguous, slot b writes token column min(pos_b, S - 1) of row b; paged,
column pos_b % P of page pages[b, min(pos_b // P, max_pages - 1)]. Page ids
are read on the device unchecked, as kernel 4 reads them. :func:`kv_append`
takes CUDA tensors only (the dispatch in ``core/kvcache.py`` sends CPU
tensors to the plain versions); a device mix, a dtype or a shape it does
not take raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

GROUP = 64
_LL3 = ctypes.c_longlong * 3


class KvLeaf(ctypes.Structure):
    """``struct KvLeaf`` of csrc/kv_append.cu, field for field."""
    _fields_ = [("x", ctypes.c_void_p), ("x_row", ctypes.c_longlong),
                ("codes", ctypes.c_void_p), ("meta", ctypes.c_void_p),
                ("tail", ctypes.c_void_p), ("codes_st", _LL3),
                ("meta_st", _LL3), ("tail_st", _LL3)]


class KvAppendArgs(ctypes.Structure):
    """``struct KvAppendArgs`` of csrc/kv_append.cu, field for field."""
    _fields_ = [("leaf", KvLeaf * 2), ("pos", ctypes.c_void_p),
                ("pos_st", ctypes.c_longlong), ("pages", ctypes.c_void_p),
                ("pages_row", ctypes.c_longlong), ("pages_64", ctypes.c_int),
                ("max_pages", ctypes.c_int), ("page_tokens", ctypes.c_int),
                ("capacity", ctypes.c_int), ("batch", ctypes.c_int),
                ("groups", ctypes.c_int), ("tail", ctypes.c_int),
                ("n_leaves", ctypes.c_int), ("x_f32", ctypes.c_int)]


def leaf_views(pk: dict) -> dict:
    """A packed tensor's leaves as (row, feature, token) views of the same
    storage: kernel-tile and pool leaves as they are, artifact leaves
    (B, S, G, 32) / (B, S, G) / (B, S, T) with their token axis moved last
    (the code bytes' (G, 32) axes must merge without a copy, or this
    raises)."""
    codes, meta, tail = pk["codes"], pk["meta"], pk["tail"]
    if codes.ndim == meta.ndim:                       # kernel tile / pool
        if codes.ndim != 3:
            raise ValueError(f"kv_append: cache leaves must be 3-D per layer, "
                             f"got codes {tuple(codes.shape)}")
        return {"codes": codes, "meta": meta, "tail": tail}
    if codes.ndim != 4 or meta.ndim != 3 or tail.ndim != 3:
        raise ValueError(f"kv_append: artifact leaves must be (B, S, G, 32), "
                         f"(B, S, G), (B, S, T); got {tuple(codes.shape)}, "
                         f"{tuple(meta.shape)}, {tuple(tail.shape)}")
    b, s, g, w = codes.shape
    try:
        flat = codes.view(b, s, g * w)
    except RuntimeError as e:
        raise ValueError("kv_append: the artifact codes' (G, 32) axes do not "
                         "merge in place") from e
    return {"codes": flat.transpose(1, 2), "meta": meta.transpose(1, 2),
            "tail": tail.transpose(1, 2)}


def _check_leaf(views: dict, rows: int, g: int, t: int) -> None:
    want = {"codes": (torch.uint8, g * 32), "meta": (torch.int32, g),
            "tail": (torch.bfloat16, t)}
    tokens = views["meta"].shape[2]
    for key, a in views.items():
        dtype, feats = want[key]
        if a.dtype != dtype:
            raise TypeError(f"kv_append: cache leaf {key} must be {dtype}, got "
                            f"{a.dtype}")
        if tuple(a.shape) != (rows, feats, tokens):
            raise ValueError(f"kv_append: cache leaf {key} is "
                             f"{tuple(a.shape)} as (row, feature, token); "
                             f"want ({rows}, {feats}, {tokens})")


def _fill_leaf(leaf: KvLeaf, new: torch.Tensor, views: dict) -> None:
    leaf.x = new.data_ptr()
    leaf.x_row = new.stride(0)
    for key in ("codes", "meta", "tail"):
        a = views[key]
        setattr(leaf, key, a.data_ptr())
        setattr(leaf, f"{key}_st", _LL3(*a.stride()))


def kv_append(caches: list, news: list, pos: torch.Tensor,
              pages: Optional[torch.Tensor] = None) -> None:
    """Quantize each of ``news`` and write it into the matching packed tensor
    of ``caches``, all in one launch of the CUDA kernel (see the module
    docstring for the shapes). Raises on a dtype or a shape the kernel does
    not take, then on tensors that are not all on one CUDA device."""
    if not 1 <= len(caches) == len(news) <= 2:
        raise ValueError("kv_append takes one or two (cache, new) pairs")
    new0 = news[0]
    if new0.ndim != 4 or new0.shape[1] != 1:
        raise ValueError(f"kv_append: new tokens must be (B, 1, Hkv, Dh), got "
                         f"{tuple(new0.shape)}")
    b, _, hkv, dh = new0.shape
    g, t = divmod(hkv * dh, GROUP)
    for new in news:
        if new.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"kv_append: new tokens must be bf16 or f32, got "
                            f"{new.dtype}")
        if tuple(new.shape) != tuple(new0.shape) or new.dtype != new0.dtype:
            raise ValueError("kv_append: K and V must share shape and dtype")
        if new.stride(3) != 1 or (hkv > 1 and new.stride(2) != dh):
            raise ValueError("kv_append: each token's (Hkv, Dh) features must "
                             "be dense")
    if pos.dtype != torch.int64 or tuple(pos.shape) != (b,):
        raise ValueError(f"kv_append: pos must be ({b},) int64, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    if pages is not None and (pages.dtype not in (torch.int32, torch.int64)
                              or pages.ndim != 2 or pages.shape[0] != b
                              or pages.stride(1) != 1):
        raise ValueError(f"kv_append: pages must be ({b}, max_pages) "
                         f"int32/int64, rows dense; got {tuple(pages.shape)} "
                         f"{pages.dtype}")
    views = [leaf_views(pk) for pk in caches]
    rows = views[0]["meta"].shape[0] if pages is not None else b
    for v in views:
        _check_leaf(v, rows, g, t)
    tokens = views[0]["meta"].shape[2]
    if any(v["meta"].shape[2] != tokens for v in views):
        raise ValueError("kv_append: K and V caches differ in token slots")
    dev = new0.device
    tensors = [*news, pos, *(a for v in views for a in v.values())]
    if pages is not None:
        tensors.append(pages)
    if dev.type != "cuda" or any(a.device != dev for a in tensors):
        raise ValueError(f"kv_append launches the CUDA kernel: every tensor "
                         f"must be on one CUDA device, got "
                         f"{sorted({str(a.device) for a in tensors})} (the "
                         f"plain versions serve CPU tensors)")
    args = KvAppendArgs()
    if pages is not None:
        args.pages = pages.data_ptr()
        args.pages_row = pages.stride(0)
        args.pages_64 = int(pages.dtype == torch.int64)
        args.max_pages = pages.shape[1]
        args.page_tokens = tokens
    for i, (new, v) in enumerate(zip(news, views)):
        _fill_leaf(args.leaf[i], new, v)
    args.pos = pos.data_ptr()
    args.pos_st = pos.stride(0)
    args.capacity = tokens
    args.batch, args.groups, args.tail = b, g, t
    args.n_leaves = len(news)
    args.x_f32 = int(new0.dtype == torch.float32)
    fn = build.function("kv_append", "kv_append",
                        [ctypes.POINTER(KvAppendArgs), ctypes.c_void_p])
    rc = fn(ctypes.byref(args), build.stream_ptr(dev))
    build.check("kv_append", "kv_append", rc,
                (b, hkv, dh, len(news), pages is not None))
