"""Deterministic, seedable fault injection for the serve stack (port of
``repro/runtime/faults.py``).

Every guard in :mod:`repro_torch.runtime.guard` must be shown to FIRE, not
just exist; this module is the attacker side of that proof. The schedulers
in ``serve_loop`` expose the injection points (all no-ops without an
injector): page-pool corruption before a decode chunk, contiguous-cache
corruption before a chunk, preemption-snapshot corruption after the
fingerprint is stamped, page theft at serve start, and the crash points of
the journaled schedulers.

Fault classes (``FaultSpec.kind``):

* ``code_flip``: one random bit of one packed-codes byte in a settled page
  owned by the target request; values perturb silently, so ONLY the
  per-page checksum audit can catch it.
* ``meta_flip``: one random bit of one packed meta word in such a page.
* ``page_corruption``: ``bits`` random bit flips across the page's codes
  plus one meta word forced to the 0xFF sentinel.
* ``nan_activation``: a NaN written into the target slot's bf16 V cache.
* ``pool_starvation``: the injector holds pool pages from serve start so
  the target can never be admitted.
* ``snapshot_truncation``: a preempted slot's host snapshot loses its last
  page column (``bits == 0``) or takes one bit flip, after its
  fingerprint was stamped.

Crash classes (``crash_after_admit``, ``crash_mid_decode``,
``crash_during_checkpoint``, ``journal_truncation``) raise
:class:`SimulatedCrash` out of ``serve_requests`` like a SIGKILL, leaving
exactly the journal prefix a real crash at that point leaves.

All randomness comes from ``numpy.random.default_rng(spec.seed)``, drawn in
the reference's order on the same pool geometry: the same spec flips the
same page, index and bit in both packages. The port's caches and pool are
mutated in place (and returned).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

FAULT_CLASSES = (
    "code_flip",
    "meta_flip",
    "page_corruption",
    "nan_activation",
    "pool_starvation",
    "snapshot_truncation",
    "crash_after_admit",
    "crash_mid_decode",
    "crash_during_checkpoint",
    "journal_truncation",
)

CRASH_CLASSES = FAULT_CLASSES[-4:]

_INJECTOR_OWNER = "__fault_injector__"
# 0xFF << 24 as the int32 the port's meta words hold
_META_NAN_WORD = (0xFF << 24) - (1 << 32)


class SimulatedCrash(RuntimeError):
    """The injected process kill: deliberately NOT a ServeError, so no
    scheduler guard catches it. The journal's durable prefix is all
    recovery gets."""


@dataclasses.dataclass
class FaultSpec:
    """One injected fault. ``target_request`` is the victim's request id;
    ``after_chunk`` delays injection until that many decode chunks have run;
    ``bits`` sets the flip count for ``page_corruption`` and selects
    truncation (``0``) vs bit flip for ``snapshot_truncation``;
    ``hold_pages`` is how many pages ``pool_starvation`` steals (0 = all)."""

    kind: str
    seed: int = 0
    target_request: int = 0
    after_chunk: int = 0
    bits: int = 16
    hold_pages: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_CLASSES:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of "
                             f"{FAULT_CLASSES}")


def parse_fault(text: str) -> FaultSpec:
    """``kind[:key=value,...]`` (the ``--inject-fault`` launcher syntax),
    e.g. ``meta_flip:seed=3,target_request=1,after_chunk=2``."""
    kind, _, rest = text.partition(":")
    kwargs = {}
    if rest:
        for part in rest.split(","):
            key, _, val = part.partition("=")
            kwargs[key.strip()] = int(val)
    return FaultSpec(kind=kind.strip(), **kwargs)


def _flip_bit(arr: torch.Tensor, idx: tuple, bit: int) -> None:
    """XOR one bit of ``arr[idx]`` in place; bit 31 of an int32 word is its
    sign bit."""
    one = 1 << bit
    if arr.dtype == torch.int32 and one >= 1 << 31:
        one -= 1 << 32
    arr[idx] = arr[idx] ^ one


class FaultInjector:
    """Injects exactly ONE fault per serve call, at a deterministic spot.

    ``events`` logs every injection as ``(kind, detail_dict)``; ``fired``
    is True afterwards.
    """

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        self.fired = False
        self.events: list = []
        self.held_pages: list = []

    # -- serve-start hook ---------------------------------------------------

    def steal_pages(self, pool) -> None:
        """pool_starvation: hold pages so admission starves."""
        if self.spec.kind != "pool_starvation":
            return
        want = self.spec.hold_pages or pool.usable_pages
        while len(self.held_pages) < want:
            pid = pool.alloc(owner=_INJECTOR_OWNER)
            if pid is None:
                break
            self.held_pages.append(pid)
        self.fired = True
        self.events.append(("pool_starvation", {"held": tuple(self.held_pages)}))

    # -- paged-scheduler hook (before a decode chunk) -----------------------

    def _target_page(self, pool, slot_req, slot_pages):
        for b, rid in enumerate(slot_req):
            if rid != self.spec.target_request or not slot_pages[b]:
                continue
            owned = [p for p in slot_pages[b] if pool.owner.get(p) == rid]
            return (owned or slot_pages[b])[0]
        return None

    def poison_pool(self, kv: dict, pool, slot_req, slot_pages,
                    chunk_idx: int) -> dict:
        """Corrupt one settled page of the target request on the device."""
        if (self.fired or chunk_idx < self.spec.after_chunk
                or self.spec.kind not in ("code_flip", "meta_flip",
                                          "page_corruption")):
            return kv
        pid = self._target_page(pool, slot_req, slot_pages)
        if pid is None:
            return kv            # victim not resident yet: try next chunk
        k = kv["k"]
        rows, cols = k["codes"].shape[2], k["codes"].shape[3]
        if self.spec.kind == "code_flip":
            idx = (0, pid, int(self.rng.integers(rows)), 0)
            bit = int(self.rng.integers(8))
            _flip_bit(k["codes"], idx, bit)
            detail = {"page": pid, "leaf": "codes", "idx": idx, "bit": bit}
        elif self.spec.kind == "meta_flip":
            idx = (0, pid, int(self.rng.integers(k["meta"].shape[2])), 0)
            bit = int(self.rng.integers(32))
            _flip_bit(k["meta"], idx, bit)
            detail = {"page": pid, "leaf": "meta", "idx": idx, "bit": bit}
        else:                    # page_corruption
            flips = []
            for _ in range(max(1, self.spec.bits)):
                idx = (0, pid, int(self.rng.integers(rows)),
                       int(self.rng.integers(cols)))
                bit = int(self.rng.integers(8))
                _flip_bit(k["codes"], idx, bit)
                flips.append((idx, bit))
            # and one meta word forced to the 0xFF NaN sentinel
            midx = (0, pid, int(self.rng.integers(k["meta"].shape[2])), 0)
            k["meta"][midx] = k["meta"][midx] | _META_NAN_WORD
            detail = {"page": pid, "flips": flips, "meta_nan_at": midx}
        self.fired = True
        self.events.append((self.spec.kind, detail))
        return kv

    # -- slot-scheduler hook (before a decode chunk) ------------------------

    def poison_cache(self, kv: dict, slot_req, chunk_idx: int) -> dict:
        """nan_activation: NaN into the target slot's bf16 V cache (token 0,
        always a valid, attended position)."""
        if (self.fired or chunk_idx < self.spec.after_chunk
                or self.spec.kind != "nan_activation"):
            return kv
        for b, rid in enumerate(slot_req):
            if rid != self.spec.target_request:
                continue
            v = kv["v"]
            if isinstance(v, dict):
                raise ValueError(
                    "nan_activation targets the bf16 KV cache; use "
                    "code_flip/meta_flip/page_corruption for packed KV")
            idx = (0, b) + (0,) * (v.ndim - 2)
            v[idx] = float("nan")
            self.fired = True
            self.events.append(("nan_activation", {"slot": b, "idx": idx}))
            return kv
        return kv

    # -- crash-point hook (journaled schedulers) ----------------------------

    def crash_point(self, point: str, *, chunk_idx: int = 0, rid=None,
                    journal=None) -> None:
        """Kill the process at a named crash point by raising
        :class:`SimulatedCrash`. The journal is committed first (these
        faults model the crash after the durable write the point is named
        for); ``journal_truncation`` also tears ``spec.bits`` bytes off the
        journal's end."""
        if self.fired or self.spec.kind not in CRASH_CLASSES:
            return
        kind = self.spec.kind
        if kind == "crash_after_admit":
            if point != "after_admit" or rid != self.spec.target_request:
                return
        elif kind in ("crash_mid_decode", "journal_truncation"):
            if point != "mid_decode" or chunk_idx < self.spec.after_chunk:
                return
        elif point != "during_checkpoint":         # crash_during_checkpoint
            return
        if journal is not None:
            journal.commit()
            if kind == "journal_truncation":
                journal.truncate_tail(self.spec.bits)
        self.fired = True
        self.events.append((kind, {"point": point, "chunk": chunk_idx,
                                   "rid": rid}))
        raise SimulatedCrash(
            f"simulated process kill at crash point {point!r} "
            f"(fault {kind}, chunk {chunk_idx}); resume from the journal")

    # -- preemption hook (after the fingerprint is stamped) -----------------

    def poison_snapshot(self, pages: dict, rid) -> dict:
        """Corrupt a host page snapshot: truncate the last page column
        (``bits == 0``) or flip one bit in the codes payload."""
        if (self.fired or self.spec.kind != "snapshot_truncation"
                or rid != self.spec.target_request):
            return pages
        out = {t: dict(leaves) for t, leaves in pages.items()}
        if self.spec.bits == 0:
            for t in ("k", "v"):
                out[t] = {key: a[:, :-1] for key, a in out[t].items()}
            detail = {"mode": "truncated_last_page"}
        else:
            codes = out["k"]["codes"].clone()
            flat = codes.reshape(-1)
            pos = int(self.rng.integers(flat.numel()))
            bit = int(self.rng.integers(8))
            flat[pos] ^= 1 << bit
            out["k"]["codes"] = codes
            detail = {"mode": "bit_flip", "pos": pos, "bit": bit}
        self.fired = True
        self.events.append(("snapshot_truncation", {"rid": rid, **detail}))
        return out
