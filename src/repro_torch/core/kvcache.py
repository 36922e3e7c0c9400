"""HiF4-packed KV cache, contiguous part (port of ``repro/core/kvcache.py``).

With token features F = n_kv_heads * d_head flattened per token,
G = F // 64 whole HiF4 groups and T = F % 64 tail features, two layouts carry
the same bits (docs/FORMATS.md):

* artifact (token-major, what :func:`quantize_kv` writes)::

      codes (..., S, G, 32) uint8    meta (..., S, G) int32    tail (..., S, T) bf16

* kernel-tile (feature-major, the resident serving layout the fused
  decode-attention kernel streams, :func:`to_kernel_layout`)::

      codes (..., G*32, S) uint8     meta (..., G, S) int32    tail (..., T, S) bf16

Meta words are int32 tensors holding the uint32 bits (see
:mod:`repro_torch.core.hif4`). Grouping is per token, so appending one token
re-quantizes nothing and bulk packing equals token-at-a-time appends.

Unlike the reference's pure functions, :func:`append_token` writes the new
token's bytes into the cache tensors IN PLACE (and returns the same dict):
the decode loop then never copies the cache. The page pool comes with the
paged kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Union

import torch
import torch.nn.functional as F

from repro_torch.core import hif4

KV_FORMATS = ("bf16", "hif4")


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """How the decode KV cache is stored: 'bf16' (dense, 2 B/value) or
    'hif4' (packed, 4.5 bits/value + bf16 tail)."""

    kv_format: str = "bf16"

    def __post_init__(self):
        if self.kv_format not in KV_FORMATS:
            raise ValueError(f"kv_format {self.kv_format!r} not in {KV_FORMATS}")

    @property
    def packed(self) -> bool:
        return self.kv_format == "hif4"


KV_BF16 = KVCacheConfig("bf16")
KV_HIF4 = KVCacheConfig("hif4")


def split_features(n_kv_heads: int, d_head: int) -> tuple[int, int]:
    """(whole 64-groups, bf16 tail features) per token."""
    return divmod(n_kv_heads * d_head, hif4.GROUP_SIZE)


def kv_bytes_per_token(n_kv_heads: int, d_head: int,
                       kv_format: str = "bf16") -> int:
    """Resident cache bytes per token PER LAYER (K and V together)."""
    f = n_kv_heads * d_head
    if kv_format == "hif4":
        g, t = divmod(f, hif4.GROUP_SIZE)
        per_tensor = g * (32 + 4) + t * 2      # codes + meta, bf16 tail
    else:
        per_tensor = f * 2
    return 2 * per_tensor                      # K + V


def is_packed_kv(cache) -> bool:
    """True for the packed per-tensor dict {"codes","meta","tail"}."""
    return isinstance(cache, dict) and "codes" in cache


def is_kernel_layout(pk: dict) -> bool:
    """Kernel-tile codes and meta have the same rank; artifact codes carry
    one trailing 32-byte axis more."""
    return pk["codes"].ndim == pk["meta"].ndim


def to_kernel_layout(pk: dict) -> dict:
    """Artifact leaves -> kernel-tile leaves (a pure bit move, idempotent).
    The results are contiguous."""
    if is_kernel_layout(pk):
        return pk
    codes = pk["codes"]
    lead, s, g = codes.shape[:-3], codes.shape[-3], codes.shape[-2]
    return {
        "codes": codes.reshape(lead + (s, g * 32)).transpose(-1, -2).contiguous(),
        "meta": pk["meta"].transpose(-1, -2).contiguous(),
        "tail": pk["tail"].transpose(-1, -2).contiguous(),
    }


def seq_capacity(pk: dict) -> int:
    """Token capacity S of a packed tensor, in either layout."""
    if is_kernel_layout(pk):
        return pk["meta"].shape[-1]
    return pk["meta"].shape[-2]


def _token_axes(pk: dict) -> dict:
    if is_kernel_layout(pk):
        return {key: a.ndim - 1 for key, a in pk.items()}
    return {"codes": pk["codes"].ndim - 3, "meta": pk["meta"].ndim - 2,
            "tail": pk["tail"].ndim - 2}


def slice_tokens(pk: dict, start: int, count: int) -> dict:
    """Take ``count`` token slots beginning at ``start`` (same layout)."""
    axes = _token_axes(pk)
    return {key: pk[key].narrow(axes[key], start, count)
            for key in ("codes", "meta", "tail")}


def pad_tokens(pk: dict, capacity: int) -> dict:
    """Zero-pad the token axis to ``capacity`` slots (either layout); zero
    padding is inert under the length mask."""
    axes = _token_axes(pk)

    def pad(a, axis):
        if a.shape[axis] >= capacity:
            return a
        widths = [0, 0] * (a.ndim - 1 - axis) + [0, capacity - a.shape[axis]]
        return F.pad(a, widths)

    return {key: pad(pk[key], axes[key]) for key in ("codes", "meta", "tail")}


# ---------------------------------------------------------------------------
# Quantize / dequantize (leading dims arbitrary)
# ---------------------------------------------------------------------------


def quantize_kv(kv: torch.Tensor) -> dict:
    """(..., Hkv, Dh) K or V values -> packed artifact leaves
    {codes, meta, tail}; the F % 64 remainder stays bf16 in ``tail``."""
    lead = kv.shape[:-2]
    f = kv.shape[-2] * kv.shape[-1]
    g, _ = divmod(f, hif4.GROUP_SIZE)
    flat = kv.reshape(lead + (f,))
    body = flat[..., : g * hif4.GROUP_SIZE].reshape(lead + (g, hif4.GROUP_SIZE))
    packed = hif4.quantize_packed(body.to(torch.bfloat16))
    return {
        "codes": packed.codes,
        "meta": packed.meta,
        "tail": flat[..., g * hif4.GROUP_SIZE:].to(torch.bfloat16),
    }


def dequantize_kv(pk: dict, n_kv_heads: int, d_head: int) -> torch.Tensor:
    """Packed leaves (either layout) -> (..., S, Hkv, Dh) bf16 values, through
    the shared K-major decode (:func:`repro_torch.core.hif4.dequantize_km`)."""
    pk = to_kernel_layout(pk)
    codes, meta, tail = pk["codes"], pk["meta"], pk["tail"]
    lead = codes.shape[:-2]
    s = codes.shape[-1]
    body = hif4.dequantize_km(codes, meta)                    # (..., G*64, S)
    flat = torch.cat([body, tail.to(torch.bfloat16)], dim=-2)  # (..., F, S)
    return flat.transpose(-1, -2).reshape(lead + (s, n_kv_heads, d_head))


# ---------------------------------------------------------------------------
# Append-one-token (the decode hot path)
# ---------------------------------------------------------------------------


def slot_positions(pos: Union[int, torch.Tensor], batch: int,
                   device) -> torch.Tensor:
    """A lockstep int or per-slot (B,) ``pos`` -> (B,) int64 on ``device``.
    An int is filled on the device, not copied from the host, so the decode
    loop never waits for the device."""
    if torch.is_tensor(pos):
        return pos.to(device=device, dtype=torch.long).expand(batch)
    return torch.full((batch,), int(pos), dtype=torch.long, device=device)


def append_token(pcache: dict, kv_new: torch.Tensor,
                 pos: Union[int, torch.Tensor]) -> dict:
    """Quantize kv_new (B, 1, Hkv, Dh) and write it at sequence slot ``pos``,
    in place, in the cache's own layout.

    ``pos`` is a scalar (whole batch in lockstep) or (B,) per-slot offsets.
    Cache leaves are (B, S, ...) artifact or (B, ..., S) kernel-tile; only
    the G + tail bytes of the one token are written.
    """
    b = kv_new.shape[0]
    new = quantize_kv(kv_new)
    dev = pcache["meta"].device
    posv = slot_positions(pos, b, dev)
    rows = torch.arange(b, device=dev)
    kernel = is_kernel_layout(pcache)
    if kernel:
        new = to_kernel_layout(new)             # (B, F/2, 1) / (B, G, 1) / ..
    for key in ("codes", "meta", "tail"):
        full, one = pcache[key], new[key].to(pcache[key].dtype)
        if kernel:
            full[rows, ..., posv] = one[..., 0]
        else:
            full[rows, posv] = one[:, 0]
    return pcache


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------


def packed_kv_nbytes(pk: dict) -> int:
    """Resident bytes of one packed K or V tensor (codes + meta + tail)."""
    return (math.prod(pk["codes"].shape) + 4 * math.prod(pk["meta"].shape)
            + 2 * math.prod(pk["tail"].shape))
