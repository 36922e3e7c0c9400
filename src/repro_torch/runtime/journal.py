"""Crash-safe serving: write-ahead request journal + pool checkpoints (port of
``repro/runtime/journal.py``; the byte layouts are the reference's,
docs/FORMATS.md §Write-ahead journal, so a journal written by one package
resumes in the other).

A crash must not lose finished work, and what it does lose must be
recomputable EXACTLY. Packed HiF4 page bytes are per-token deterministic and
greedy decode is deterministic, so a request re-served from its prompt
reproduces its tokens bit for bit: the journal only makes the bookkeeping
durable (admissions, each chunk's tokens, terminal statuses), plus periodic
page-pool checkpoints so residents resume from their last durable position.

* :class:`RequestJournal`: append-only, crc32-framed records
  (``serve.journal``), buffered in memory and written + fsynced once per
  decode chunk; a fresh journal stages at ``serve.journal.tmp`` and
  replaces the live file only once its start record is durable.
* :func:`save_pool_checkpoint` / :func:`load_pool_checkpoint`: the resident
  slots' page bytes as an ``.npz`` beside the journal (meta as uint32, the
  bf16 tails as uint16 bits), sha256-fingerprinted; the journal's
  ``checkpoint`` record is the commit point.
* :func:`recover`: replays a journal (torn tails dropped by the framing)
  into a :class:`RecoveryPlan`: terminal requests get their journaled
  results, checkpointed residents become crc-stamped byte snapshots the
  paged scheduler restores, the rest re-enter the queue from their prompts.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import host_bits, tensor_from_bits
from repro_torch.runtime.guard import (JournalError, RecoveryError,
                                       snapshot_fingerprint)

JOURNAL_VERSION = 1
JOURNAL_NAME = "serve.journal"
MAGIC = b"HJ01"
_HEADER = len(MAGIC) + 8            # magic | u32 payload len | u32 crc32

EVENT_KINDS = frozenset(
    {"start", "admitted", "chunk", "preempted", "done", "checkpoint"})


# ---------------------------------------------------------------------------
# Record framing (encode / decode)
# ---------------------------------------------------------------------------


def encode_record(event: dict) -> bytes:
    """One framed record: ``HJ01 | u32 len | u32 crc32(payload) | payload``,
    the payload UTF-8 JSON with sorted keys and no spaces. Little-endian
    lengths; crc over the payload bytes only. Values must be plain Python
    ints, strings, lists and dicts."""
    if event.get("ev") not in EVENT_KINDS:
        raise ValueError(f"unknown journal event {event!r}")
    payload = json.dumps(event, sort_keys=True,
                         separators=(",", ":")).encode("utf-8")
    head = (MAGIC + len(payload).to_bytes(4, "little")
            + zlib.crc32(payload).to_bytes(4, "little"))
    return head + payload


def decode_records(data: bytes) -> tuple[list, int]:
    """(events, dropped_bytes): every fully-framed, crc-clean record from the
    front of ``data``; parsing stops at the FIRST bad frame (wrong magic,
    short header or payload, crc mismatch, invalid JSON or event) and
    everything from there on counts as dropped."""
    events, off = [], 0
    n = len(data)
    while off + _HEADER <= n:
        if data[off:off + 4] != MAGIC:
            break
        size = int.from_bytes(data[off + 4:off + 8], "little")
        crc = int.from_bytes(data[off + 8:off + 12], "little")
        payload = data[off + _HEADER:off + _HEADER + size]
        if len(payload) < size or zlib.crc32(payload) != crc:
            break
        try:
            event = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            break
        if not isinstance(event, dict) or event.get("ev") not in EVENT_KINDS:
            break
        events.append(event)
        off += _HEADER + size
    return events, n - off


def prompt_sha256(prompt) -> str:
    """Identity of one request's prompt tokens (sha256 of their ``<i4``
    bytes): journaled at start and re-checked at resume."""
    toks = torch.as_tensor(prompt).reshape(-1).to(torch.int32).cpu().numpy()
    return hashlib.sha256(toks.astype("<i4").tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# Write-ahead journal (writer)
# ---------------------------------------------------------------------------


class RequestJournal:
    """Append-only request-lifecycle journal, fsync-batched per chunk.

    Writes stage at ``<dir>/serve.journal.tmp``; :meth:`activate` renames it
    atomically over ``serve.journal`` (the fd stays valid across the
    rename). ``append`` only buffers; ``commit`` does one write + flush +
    fsync.
    """

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.path = os.path.join(directory, JOURNAL_NAME)
        self._tmp_path = self.path + ".tmp"
        self._fh = open(self._tmp_path, "wb")
        self._buffer: list[bytes] = []
        self.records_written = 0

    def append(self, ev: str, **fields) -> None:
        self._buffer.append(encode_record({"ev": ev, **fields}))

    def commit(self) -> None:
        """Flush buffered records durably (a no-op with nothing buffered)."""
        if not self._buffer:
            return
        self._fh.write(b"".join(self._buffer))
        self.records_written += len(self._buffer)
        self._buffer.clear()
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def activate(self) -> None:
        """Commit, then atomically replace the live journal with the staged
        one; until then a crash leaves the previous journal untouched."""
        self.commit()
        os.replace(self._tmp_path, self.path)

    def truncate_tail(self, nbytes: int) -> None:
        """Chop ``nbytes`` off the end of the journal file (the
        ``journal_truncation`` fault's torn final write)."""
        self.commit()
        size = self._fh.tell()
        self._fh.truncate(max(0, size - max(1, nbytes)))
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh.closed:
            return
        self.commit()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_journal(directory: str) -> tuple[list, int]:
    """(events, dropped_bytes) of ``<dir>/serve.journal``. Raises
    :class:`JournalError` when there is no journal or its first record is
    not a valid ``start``."""
    path = os.path.join(directory, JOURNAL_NAME)
    if not os.path.exists(path):
        raise JournalError(
            f"no journal at {path!r}: nothing to resume (a journaled serve "
            "writes it on its first committed chunk)")
    with open(path, "rb") as f:
        data = f.read()
    events, dropped = decode_records(data)
    if (not events or events[0]["ev"] != "start"
            or events[0].get("v") != JOURNAL_VERSION):
        raise JournalError(
            f"journal at {path!r} has no valid version-{JOURNAL_VERSION} "
            "start record — corrupt beyond the torn-tail case the framing "
            "recovers from")
    return events, dropped


# ---------------------------------------------------------------------------
# Pool checkpoints (resident page bytes, sha256-fingerprinted)
# ---------------------------------------------------------------------------

_SNAP_LEAVES = tuple((t, key) for t in ("k", "v")
                     for key in ("codes", "meta", "tail"))


def _store(a, key: str) -> np.ndarray:
    """A snapshot leaf as the reference stores it: meta as uint32, the bf16
    tail as its uint16 bits."""
    arr, _ = host_bits(a, uint32=(key == "meta"))
    return arr


def _restore(a: np.ndarray, key: str) -> torch.Tensor:
    name = {"meta": "uint32", "tail": "bfloat16"}.get(key, a.dtype.name)
    return tensor_from_bits(a, name, a.shape)


def save_pool_checkpoint(directory: str, chunk_idx: int,
                         residents: dict) -> tuple[str, str]:
    """Write ``ckpt_<chunk>.npz`` holding every resident request's page
    blocks (``residents``: rid -> ``{"pages": {"k"/"v": {"codes", "meta",
    "tail"}}, "token", "toks"}``). Returns (filename, sha256 of the file
    bytes), which the journal's ``checkpoint`` record carries."""
    arrays = {}
    for rid, snap in residents.items():
        for t, key in _SNAP_LEAVES:
            arrays[f"r{rid}_{t}_{key}"] = _store(snap["pages"][t][key], key)
    fname = f"ckpt_{chunk_idx:08d}.npz"
    path = os.path.join(directory, fname)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return fname, digest


def load_pool_checkpoint(directory: str, record: dict) -> Optional[dict]:
    """Rebuild rid -> page-block dicts (host tensors, the port's dtypes) from
    a journal ``checkpoint`` record. None (checkpoint unusable; callers
    re-prefill) when the file is missing or its sha256 does not match."""
    path = os.path.join(directory, record["file"])
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != record["sha256"]:
        return None
    with np.load(path) as z:
        out = {}
        for rid_s in record["residents"]:
            rid = int(rid_s)
            try:
                out[rid] = {t: {key: _restore(z[f"r{rid}_{t}_{key}"], key)
                                for key in ("codes", "meta", "tail")}
                            for t in ("k", "v")}
            except KeyError:
                return None
    return out


# ---------------------------------------------------------------------------
# Replay -> recovery plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecoveryPlan:
    """Everything a resumed serve needs, rebuilt from checkpoint + tail.

    ``completed``: rid -> {"toks", "status", "detail", "retries"} for
    requests with a journaled terminal event. ``suspended``: rid ->
    preemption-style snapshot (``pages``/``crc32``/``token``/``toks``).
    ``emitted``: rid -> the journaled token prefix every re-served request
    is verified against. ``recovery_ms`` is the plan-build time."""

    meta: dict
    completed: dict = dataclasses.field(default_factory=dict)
    suspended: dict = dataclasses.field(default_factory=dict)
    emitted: dict = dataclasses.field(default_factory=dict)
    replayed: int = 0
    re_prefilled: int = 0
    dropped_records: int = 0
    recovery_ms: float = 0.0

    def report(self) -> dict:
        return {"completed": len(self.completed), "replayed": self.replayed,
                "re_prefilled": self.re_prefilled,
                "dropped_bytes": self.dropped_records,
                "recovery_ms": round(self.recovery_ms, 3)}

    def expected_prefix(self, rid: int) -> list:
        """The journaled greedy tokens a re-served request MUST reproduce
        (clamped at the budget and the first eos)."""
        toks = list(self.emitted.get(rid, ()))[: self.meta["budget"]]
        eos = self.meta.get("eos")
        if eos is not None and eos in toks:
            toks = toks[: toks.index(eos) + 1]
        return toks


def replay(events: list) -> tuple[dict, dict, set, Optional[dict]]:
    """Fold a journal's events into (emitted, terminal, in_flight,
    last_checkpoint): an ``admitted`` record resets a request's emission to
    its cumulative tokens; ``chunk`` records extend it."""
    emitted: dict = {}
    terminal: dict = {}
    admitted: set = set()
    last_ckpt = None
    for ev in events[1:]:
        kind = ev["ev"]
        if kind == "admitted":
            admitted.add(ev["rid"])
            emitted[ev["rid"]] = list(ev["toks"])
        elif kind == "chunk":
            for rid_s, toks in ev["emitted"].items():
                emitted.setdefault(int(rid_s), []).extend(toks)
        elif kind == "done":
            terminal[ev["rid"]] = ev
        elif kind == "checkpoint":
            last_ckpt = ev
    in_flight = {rid for rid in admitted if rid not in terminal}
    return emitted, terminal, in_flight, last_ckpt


def recover(directory: str, requests, *, budget: int,
            eos: Optional[int]) -> RecoveryPlan:
    """Build the :class:`RecoveryPlan` a resumed serve starts from: check the
    journal against the resume-time ``requests`` (count and per-prompt
    sha256) and config (:class:`RecoveryError` on mismatch), load and
    verify the last committed checkpoint, and restore each covered resident
    as a crc-stamped byte snapshot."""
    t0 = time.perf_counter()
    events, dropped = read_journal(directory)
    meta = events[0]
    if meta["n_requests"] != len(requests):
        raise RecoveryError(
            f"journal at {directory!r} covers {meta['n_requests']} "
            f"requests but resume was handed {len(requests)}")
    shas = [prompt_sha256(r) for r in requests]
    if meta["prompts"] != shas:
        bad = [i for i, (a, b) in enumerate(zip(meta["prompts"], shas)) if a != b]
        raise RecoveryError(
            f"resume prompts differ from the journaled serve at request "
            f"id(s) {bad}: a journal only replays onto the request list "
            "that wrote it")
    if budget != meta["budget"] or eos != meta.get("eos"):
        raise RecoveryError(
            f"resume serve config (budget={budget}, eos={eos}) differs "
            f"from the journaled serve (budget={meta['budget']}, "
            f"eos={meta.get('eos')}); recovered decode would not be "
            "bitwise comparable")

    emitted, terminal, in_flight, ckpt = replay(events)
    plan = RecoveryPlan(meta=meta, emitted=emitted, dropped_records=dropped)
    for rid, ev in terminal.items():
        plan.completed[rid] = {"toks": list(ev["toks"]), "status": ev["status"],
                               "detail": ev.get("detail"),
                               "retries": ev.get("retries", 0)}
    pages_by_rid = {}
    if ckpt is not None:
        pages_by_rid = load_pool_checkpoint(directory, ckpt) or {}
    for rid in sorted(in_flight):
        res = ckpt["residents"].get(str(rid)) if ckpt is not None else None
        pages = pages_by_rid.get(rid)
        if res is not None and pages is not None:
            plan.suspended[rid] = {"pages": pages, "token": res["token"],
                                   "toks": list(res["toks"]), "written": None,
                                   "crc32": snapshot_fingerprint(pages)}
            plan.replayed += 1
        else:
            plan.re_prefilled += 1
    plan.recovery_ms = (time.perf_counter() - t0) * 1e3
    return plan


def journal_residency(directory: str) -> dict:
    """Bytes on disk under a journal dir: journal file size, checkpoint
    count and bytes."""
    out = {"journal_bytes": 0, "checkpoints": 0, "checkpoint_bytes": 0}
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if name == JOURNAL_NAME:
            out["journal_bytes"] = os.path.getsize(path)
        elif name.startswith("ckpt_") and name.endswith(".npz"):
            out["checkpoints"] += 1
            out["checkpoint_bytes"] += os.path.getsize(path)
    return out
