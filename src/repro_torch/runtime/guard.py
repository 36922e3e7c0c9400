"""Request-level fault domains for the serve stack (port of
``repro/runtime/guard.py``).

The HiF4 0xFF E6M2 NaN sentinel exists so that corrupted 4-bit payloads
surface loudly instead of decoding into silently wrong values. This module
is the serving side of that contract: cheap health sentinels computed
beside the decode chunk, per-chunk integrity audits over packed KV pages,
integrity fingerprints for host preemption snapshots and serving
artifacts, and the status vocabulary the schedulers use to contain a fault
to the one request it hit.

Detection, by fault class:

* **NaN/Inf activations**: the guarded decode chunk carries a per-slot
  ``bad`` flag, OR-ing a ``~isfinite(logits)`` reduction every step
  (:func:`bad_logits`); tokens are bitwise the unguarded chunk's.
* **0xFF meta corruption**: :func:`repro_torch.core.hif4.meta_nan_mask`
  counted per slot (contiguous cache) or per page (paged pool).
* **Bit flips in packed pages**: per-page modular checksums
  (:func:`repro_torch.core.kvcache.page_checksums`) recomputed once per
  chunk and compared against the values recorded after the previous one,
  skipping pages the scheduler wrote in between.
* **Snapshot truncation / flips**: :func:`snapshot_fingerprint` (crc32
  over bytes and shapes), stamped when a preempted slot's pages reach the
  host and verified before they are scattered back.
* **Artifact corruption**: per-leaf sha256 over PackedW codes/meta plus
  the format invariants (:func:`artifact_integrity`), written into the
  serving artifact's ``extra.json`` and re-verified on load.

Statuses (every request gets exactly one, in ``stats["reports"]``): ``ok``,
``retried`` (re-served exactly after a fault), ``quarantined`` (the one
fallback retry also failed, or retries are off: an eos/-1 fill),
``rejected`` (never admitted within the bounded retries), ``timeout``
(deadline exceeded: partial result, padded).

The device-side sentinels are plain PyTorch reductions that stay on the
device: the schedulers concatenate them with the chunk's tokens and bring
everything to the host in one transfer. Fingerprints and digests use the
reference's byte layout and dtype names (meta words as ``uint32``,
``bfloat16`` tails), so a value computed by one package equals the other's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import host_bits
from repro_torch.core import hif4, kvcache
from repro_torch.core.qlinear import PackedW

STATUS_NAMES = frozenset({"ok", "retried", "quarantined", "rejected", "timeout"})

FAULT_REASONS = (
    "nan_logits",          # decode-chunk sentinel fired
    "meta_nan",            # 0xFF E6M2 count went nonzero
    "page_checksum",       # a settled page's checksum changed
    "snapshot_integrity",  # preemption snapshot failed its fingerprint
    "pool_exhausted",      # admission/growth starved of pages
    "deadline",            # wall-clock deadline exceeded
)


# ---------------------------------------------------------------------------
# Typed serving exceptions
# ---------------------------------------------------------------------------


class ServeError(RuntimeError):
    """Base of all typed serving errors (a RuntimeError, so existing
    ``except RuntimeError`` handling keeps working)."""


class PoolExhaustedError(ServeError):
    """The paged KV pool cannot supply the pages a request needs and no
    guard is installed to turn the failure into a ``rejected`` status."""


class SnapshotIntegrityError(ServeError):
    """A preempted slot's host page snapshot failed its fingerprint."""


class JournalError(ServeError):
    """The write-ahead request journal is missing or corrupt beyond the
    torn-tail case its framing recovers from."""


class RecoveryError(ServeError):
    """Crash recovery could not be performed safely: the resume request list
    or serve config does not match the journaled serve, or a recovered
    request's output contradicts its journaled token prefix."""


class ArtifactError(ServeError):
    """Base for serving-artifact load/save problems."""


class ArtifactNotFoundError(ArtifactError):
    """No serving artifact at the given path."""


class ArtifactLayoutError(ArtifactError):
    """The tree handed to ``save_serving_artifact`` is not raw weights."""


class ArtifactIntegrityError(ArtifactError):
    """A loaded artifact's packed payload fails its recorded checksums or the
    HiF4 format invariants."""


# ---------------------------------------------------------------------------
# Guard configuration + per-request reports
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Health-sentinel configuration.

    nan_sentinel: carry the per-slot NaN/Inf logits flag through the decode
        chunk. meta_audit: count 0xFF E6M2 sentinels over packed KV per
        chunk. page_checksums: per-page checksum audit over the paged pool
        per chunk. retry_fallback: re-serve a quarantined request once,
        solo, on the qdq impl + bf16 KV path. deadline_s: per-request
        wall-clock budget (None = unlimited). max_admission_retries /
        admission_backoff_s: bounded retry with exponential backoff before
        a starved request is ``rejected``.
    """

    nan_sentinel: bool = True
    meta_audit: bool = True
    page_checksums: bool = True
    retry_fallback: bool = True
    deadline_s: Optional[float] = None
    max_admission_retries: int = 2
    admission_backoff_s: float = 0.0


def new_report() -> dict:
    return {"status": "ok", "detail": None, "retries": 0}


# ---------------------------------------------------------------------------
# Decode-chunk + cache sentinels (device side; nothing waits for the device)
# ---------------------------------------------------------------------------


def bad_logits(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) bool: True where any entry is NaN/Inf."""
    return ~torch.isfinite(logits.to(torch.float32)).all(dim=-1)


def slot_meta_nan_counts(kv: dict) -> torch.Tensor:
    """Packed {"k","v"} kernel-layout leaves with meta (L, X, G, S) -> (X,)
    int32 counts of 0xFF E6M2 sentinels: per slot for the contiguous cache
    (X = B), per page for the paged pool (X = NP)."""
    total = 0
    for t in (kv["k"], kv["v"]):
        total = total + hif4.meta_nan_mask(t["meta"]).sum(dim=(0, 2, 3),
                                                          dtype=torch.int32)
    return total


def pool_page_sums(kv: dict) -> torch.Tensor:
    """Paged pool {"k","v"} -> (NP,) int64 per-page checksums in [0, 2^32),
    K+V combined (the reference's uint32 sum)."""
    return (kvcache.page_checksums(kv["k"]) + kvcache.page_checksums(kv["v"])
            ) & kvcache.U32_MASK


def pool_page_stats(kv: dict) -> dict:
    """Paged pool {"k","v"} -> {"sums": (NP,) checksums, "meta_nan": (NP,)
    int32 0xFF counts}, both K+V combined."""
    nan = (kvcache.page_meta_nan_counts(kv["k"])
           + kvcache.page_meta_nan_counts(kv["v"]))
    return {"sums": pool_page_sums(kv), "meta_nan": nan}


# ---------------------------------------------------------------------------
# Preemption-snapshot fingerprints (host side)
# ---------------------------------------------------------------------------


def _snapshot_leaf(a, key: str) -> tuple[np.ndarray, str]:
    """A snapshot leaf's host bytes and the reference's dtype name (int32
    meta words are ``uint32``)."""
    return host_bits(a, uint32=(key == "meta"))


def snapshot_fingerprint(pages: dict) -> int:
    """crc32 over a host page snapshot's bytes AND shapes ({"k","v"} of
    {"codes","meta","tail"} blocks, tensors or numpy arrays): truncation
    changes the shape term even if the surviving bytes collide. Equal to
    the reference's fingerprint of the same bytes."""
    h = 0
    for tname in ("k", "v"):
        for key in ("codes", "meta", "tail"):
            a, name = _snapshot_leaf(pages[tname][key], key)
            h = zlib.crc32(repr((tname, key, tuple(a.shape), name)).encode(), h)
            h = zlib.crc32(np.ascontiguousarray(a).view(np.uint8).tobytes(), h)
    return h


def verify_snapshot(snap: dict) -> bool:
    """True iff a preemption snapshot still matches the fingerprint stamped
    when it was taken."""
    try:
        return snapshot_fingerprint(snap["pages"]) == snap["crc32"]
    except Exception:
        return False           # missing leaves / mangled structure


# ---------------------------------------------------------------------------
# Serving-artifact integrity (per-leaf checksums + format invariants)
# ---------------------------------------------------------------------------

INTEGRITY_VERSION = 1


def keystr(path: tuple) -> str:
    """The reference's leaf name for a dict key path: ``['blocks']['attn']``."""
    return "".join(f"[{k!r}]" for k in path)


def _packed_leaves(tree, path: tuple = ()) -> list:
    """(leaf name, PackedW) pairs in the reference's pytree order."""
    if isinstance(tree, PackedW):
        return [(keystr(path), tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_packed_leaves(tree[k], path + (k,)))
        return out
    return []


def _sha256(t, *, uint32: bool = False) -> str:
    return hashlib.sha256(host_bits(t, uint32=uint32)[0].tobytes()).hexdigest()


def packed_invariants(name: str, leaf: PackedW) -> list:
    """HiF4 format invariants of one packed weight; [] when healthy: the
    E6M2 byte is never the 0xFF sentinel, K is whole 64-groups, and codes
    and meta agree on the group geometry."""
    errs = []
    k, _ = leaf.shape2d
    meta, codes = leaf.meta, leaf.codes
    if k % hif4.GROUP_SIZE:
        errs.append(f"{name}: K={k} is not a multiple of 64 (group size)")
    nan = int(hif4.meta_nan_mask(meta).sum())
    if nan:
        errs.append(
            f"{name}: {nan} meta word(s) carry the E6M2 NaN sentinel 0xFF "
            "— Algorithm 1 never emits it; the payload is corrupt")
    mshape = tuple(meta.shape)
    if leaf.kernel_layout:
        want_codes = mshape[:-2] + (mshape[-2] * 32, mshape[-1])
    else:
        want_codes = mshape + (32,)
    if tuple(codes.shape) != want_codes:
        errs.append(f"{name}: codes shape {tuple(codes.shape)} does not match "
                    f"meta geometry (expected {want_codes})")
    return errs


def artifact_integrity(tree) -> dict:
    """Integrity record of a serving artifact: per-PackedW-leaf sha256 over
    the codes and meta payloads (stored by ``save_serving_artifact``)."""
    leaves = {name: {"codes_sha256": _sha256(leaf.codes),
                     "meta_sha256": _sha256(leaf.meta, uint32=True)}
              for name, leaf in _packed_leaves(tree)}
    return {"version": INTEGRITY_VERSION, "leaves": leaves}


def verify_artifact_integrity(tree, integrity: dict, directory: str):
    """Raise :class:`ArtifactIntegrityError` if any packed leaf fails its
    recorded checksums or the HiF4 format invariants."""
    recorded = integrity.get("leaves", {})
    errs = []
    for name, leaf in _packed_leaves(tree):
        errs.extend(packed_invariants(name, leaf))
        ent = recorded.get(name)
        if ent is None:
            errs.append(f"{name}: no integrity record in extra.json")
            continue
        for field, payload, u32 in (("codes_sha256", leaf.codes, False),
                                    ("meta_sha256", leaf.meta, True)):
            if _sha256(payload, uint32=u32) != ent[field]:
                errs.append(f"{name}: {field} mismatch (payload corrupt)")
    if errs:
        raise ArtifactIntegrityError(
            f"serving artifact at {directory!r} failed integrity "
            f"verification:\n  - " + "\n  - ".join(errs)
            + "\n  re-export it with repro_torch.runtime.serve_loop."
            "save_serving_artifact from the raw training weights.")
