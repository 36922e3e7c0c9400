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

Unlike the reference's pure functions, :func:`append_token`,
:func:`append_token_paged`, :func:`append_kv`, :func:`scatter_pages` and
:func:`copy_page` write into the cache or pool tensors IN PLACE (and return
the same dict): the decode loop and the scheduler then never copy the cache
or the pool. The appends take the CUDA kernel
(:func:`repro_torch.kernels.kv_append.kv_append`, K and V of a layer in one
launch) on CUDA tensors and their plain versions
(:func:`append_token_plain`, :func:`append_token_paged_plain`) on CPU
tensors.

The paged pool (docs/FORMATS.md "Paged KV-cache pool") keeps the
kernel-tile layout with a leading page axis, leaves (L, NP, F, P), page 0
the reserved scratch page; :class:`PagePool` is its host-side bookkeeping.
The guard's pool helpers (:func:`scrub_pages`, :func:`page_checksums`,
:func:`page_meta_nan_counts`) reduce it per page on the device.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import hif4
from repro_torch.kernels.kv_append import kv_append

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


def _append(caches: list, news: list, pos, pages=None) -> None:
    """The dispatch of the appends: CPU tensors take the plain versions (one
    tensor at a time), anything else the CUDA kernel, all ``news`` in one
    launch (which raises on a device mix, a dtype or a shape it does not
    take)."""
    on_cpu = all(t.device.type == "cpu" for t in news) and all(
        a.device.type == "cpu" for pk in caches for a in pk.values())
    if on_cpu:
        kv_append_plain(caches, news, pos, pages)
        return
    dev = news[0].device
    posv = slot_positions(pos, news[0].shape[0], dev)
    kv_append(caches, news, posv, pages)


def kv_append_plain(caches: list, news: list, pos, pages=None) -> None:
    """The plain versions of :func:`repro_torch.kernels.kv_append.kv_append`
    (the same arguments; ``pos`` may be an int): each new token through
    :func:`append_token_plain`, or :func:`append_token_paged_plain` with
    ``pages``."""
    for pk, new in zip(caches, news):
        if pages is None:
            append_token_plain(pk, new, pos)
        else:
            append_token_paged_plain(pk, new, pos, pages)


def append_kv(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor, pos,
              pages: Optional[torch.Tensor] = None) -> dict:
    """A decode step's append of one layer: k_new and v_new (B, 1, Hkv, Dh)
    into the packed cache {"k", "v"} (contiguous, or with ``pages`` the
    per-layer pool view), in place, ONE kernel launch on the card.
    Positions as :func:`append_token` / :func:`append_token_paged`."""
    _append([cache["k"], cache["v"]], [k_new, v_new], pos, pages)
    return cache


def append_token(pcache: dict, kv_new: torch.Tensor,
                 pos: Union[int, torch.Tensor]) -> dict:
    """Quantize kv_new (B, 1, Hkv, Dh) and write it at sequence slot ``pos``,
    in place, in the cache's own layout (the kernel on CUDA tensors, the
    plain version on CPU tensors).

    ``pos`` is a scalar (whole batch in lockstep) or (B,) per-slot offsets,
    clamped to S - 1. Cache leaves are (B, S, ...) artifact or (B, ..., S)
    kernel-tile; only the G + tail bytes of the one token are written.
    """
    _append([pcache], [kv_new], pos)
    return pcache


def append_token_plain(pcache: dict, kv_new: torch.Tensor,
                       pos: Union[int, torch.Tensor]) -> dict:
    """The plain version of :func:`append_token` (the reference's
    ``append_token`` op by op)."""
    b = kv_new.shape[0]
    new = quantize_kv(kv_new)
    dev = pcache["meta"].device
    # positions past the capacity clamp to its last slot, as the reference's
    # dynamic_update_slice does (retired slots and over-emission in a
    # scheduler's last chunk write there; their tokens are discarded)
    posv = torch.clamp(slot_positions(pos, b, dev), max=seq_capacity(pcache) - 1)
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
# Paged pool: device-side helpers
# ---------------------------------------------------------------------------

DEFAULT_PAGE_TOKENS = 64


def pages_for_tokens(n_tokens: int, page_tokens: int) -> int:
    """Pages needed to hold ``n_tokens`` token columns."""
    return -(-n_tokens // page_tokens)


def page_nbytes(n_kv_heads: int, d_head: int, page_tokens: int,
                n_layers: int) -> int:
    """Resident bytes of ONE pool page (K + V, all layers)."""
    return n_layers * page_tokens * kv_bytes_per_token(n_kv_heads, d_head, "hif4")


def init_page_pool(n_layers: int, n_kv_heads: int, d_head: int, n_pages: int,
                   page_tokens: int, *, device=None) -> dict:
    """Zero-initialized page pool {"k","v"} of packed kernel-tile leaves with
    a leading page axis: codes (L, NP, G*32, P) uint8, meta (L, NP, G, P)
    int32 (uint32 bits), tail (L, NP, T, P) bf16. Page 0 is the scratch page
    (:class:`PagePool` never hands it out); zero pages decode to zeros."""
    g, t = split_features(n_kv_heads, d_head)
    shape = (n_layers, n_pages)

    def leaves():
        return {
            "codes": torch.zeros(shape + (g * 32, page_tokens), dtype=torch.uint8,
                                 device=device),
            "meta": torch.zeros(shape + (g, page_tokens), dtype=torch.int32,
                                device=device),
            "tail": torch.zeros(shape + (t, page_tokens), dtype=torch.bfloat16,
                                device=device),
        }

    return {"k": leaves(), "v": leaves()}


def pool_page_tokens(pool_t: dict) -> int:
    """Tokens per page P of pool leaves (any leading axes, tokens last)."""
    return pool_t["meta"].shape[-1]


def pool_n_pages(pool_t: dict) -> int:
    """Total pages in a (L, NP, ..., P) pool tensor."""
    return pool_t["meta"].shape[1]


def split_pages(pk: dict, page_tokens: int) -> dict:
    """A single-sequence packed cache (L, 1, F, S) -> pages (L, n, F, P),
    the token axis zero-padded to a page multiple (inert under the length
    mask). Page j holds exactly token columns [j*P, (j+1)*P)."""
    pk = to_kernel_layout(pk)

    def cut(a):
        l, b, f, s = a.shape
        if b != 1:
            raise ValueError("split_pages takes a single-sequence (B=1) cache")
        n = pages_for_tokens(s, page_tokens)
        a = F.pad(a[:, 0], (0, n * page_tokens - s))
        return a.reshape(l, f, n, page_tokens).movedim(2, 1)

    return {key: cut(pk[key]) for key in ("codes", "meta", "tail")}


def gather_pages(pool_t: dict, page_ids: torch.Tensor) -> dict:
    """Pool leaves (L, NP, F, P) -> a COPY of the selected pages (L, n, F, P)."""
    ids = page_ids.to(device=pool_t["meta"].device, dtype=torch.long)
    return {key: a.index_select(1, ids) for key, a in pool_t.items()}


def scatter_pages(pool_t: dict, pages: dict, page_ids: torch.Tensor) -> dict:
    """Write page blocks (L, n, F, P) into the pool at ``page_ids``, in place."""
    ids = page_ids.to(device=pool_t["meta"].device, dtype=torch.long)
    for key in ("codes", "meta", "tail"):
        full = pool_t[key]
        full.index_copy_(1, ids, pages[key].to(device=full.device, dtype=full.dtype))
    return pool_t


def copy_page(pool_t: dict, src: int, dst: int) -> dict:
    """Duplicate one page's bytes, all layers, in place (the copy-on-write
    primitive)."""
    for a in pool_t.values():
        a[:, dst] = a[:, src]
    return pool_t


def append_token_paged(pool_t: dict, kv_new: torch.Tensor, pos: torch.Tensor,
                       pages: torch.Tensor) -> dict:
    """Quantize kv_new (B, 1, Hkv, Dh) and write one token column through
    the page table, in place: the kernel on CUDA tensors (page ids read on
    the device, unchecked), the plain version
    (:func:`append_token_paged_plain`) on CPU tensors."""
    _append([pool_t], [kv_new], pos, pages)
    return pool_t


def append_token_paged_plain(pool_t: dict, kv_new: torch.Tensor,
                             pos: torch.Tensor, pages: torch.Tensor) -> dict:
    """The plain version of :func:`append_token_paged`: quantize kv_new
    (B, 1, Hkv, Dh) and write one token column through the page table, in
    place.

    ``pool_t`` is the PER-LAYER pool view (NP, F, P); ``pages`` (B,
    max_pages) maps each slot's logical page index to a pool page id;
    ``pos`` (B,) is the slot's token count. The write lands at
    (pages[b, pos_b // P], :, pos_b % P). Logical indices beyond the table
    clamp to its last entry. A retired slot's table row is all zeros, so its
    (masked, never read) writes land in the scratch page 0, where several
    may collide; the scheduler gives every ACTIVE slot a page it owns
    alone before each chunk, so live writes never collide.
    """
    p = pool_page_tokens(pool_t)
    maxp = pages.shape[1]
    new = to_kernel_layout(quantize_kv(kv_new))          # (B, F, 1) leaves
    dev = pool_t["meta"].device
    pos = pos.to(device=dev, dtype=torch.long)
    idx = torch.clamp(pos // p, max=maxp - 1)
    pids = torch.gather(pages.to(device=dev, dtype=torch.long), 1, idx[:, None])[:, 0]
    offs = pos % p
    for key in ("codes", "meta", "tail"):
        full = pool_t[key]
        full[pids, :, offs] = new[key][..., 0].to(full.dtype)
    return pool_t


def scrub_pages(pool_t: dict, page_ids: torch.Tensor) -> dict:
    """Zero every byte of the selected pages (all layers), in place.

    Quarantine support: a poisoned slot's freed pages are scrubbed so stale
    corruption (e.g. a 0xFF NaN sentinel) cannot leak into the next
    sequence the allocator hands the page to. Zero pages decode to zeros,
    like freshly initialized ones.
    """
    ids = page_ids.to(device=pool_t["meta"].device, dtype=torch.long)
    for a in pool_t.values():
        a.index_fill_(1, ids, 0)
    return pool_t


# Odd multipliers decorrelate the three leaf sums. Any SINGLE bit flip in one
# leaf element changes that leaf's modular sum by +-2^j (j < 32), and an odd
# multiple of +-2^j is never 0 mod 2^32, so one flipped bit anywhere in a
# page provably changes the page checksum.
_CKSUM_META_MULT = 0x9E3779B1
_CKSUM_TAIL_MULT = 0x85EBCA77
U32_MASK = 0xFFFFFFFF


def _mul_u32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit ``m``,
    without passing 2^63: m splits into 16-bit halves."""
    hi, lo = m >> 16, m & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & U32_MASK


def page_checksums(pool_t: dict) -> torch.Tensor:
    """(n_pages,) content checksum of each pool page: the reference's uint32
    modular sum over codes + meta + tail, as int64 values in [0, 2^32).

    Reduced on the device, so an audit moves n_pages words to the host
    instead of the pool's bytes. Any single bit flip in a page
    changes its checksum (see the multiplier note above).
    """
    dims = (0, 2, 3)
    sums = pool_t["codes"].sum(dim=dims, dtype=torch.int64) & U32_MASK
    # an int32 word and its uint32 bits are equal mod 2^32
    meta = pool_t["meta"].sum(dim=dims, dtype=torch.int64) & U32_MASK
    sums = (sums + _mul_u32(meta, _CKSUM_META_MULT)) & U32_MASK
    if pool_t["tail"].shape[2]:
        bits = pool_t["tail"].view(torch.int16).to(torch.int32) & 0xFFFF
        tail = bits.sum(dim=dims, dtype=torch.int64) & U32_MASK
        sums = (sums + _mul_u32(tail, _CKSUM_TAIL_MULT)) & U32_MASK
    return sums


def page_meta_nan_counts(pool_t: dict) -> torch.Tensor:
    """(n_pages,) int32 count of E6M2 NaN-sentinel meta words per page.
    Algorithm 1 never emits the 0xFF scale code, so any nonzero count marks
    a corrupted page, the hot partial page included."""
    return hif4.meta_nan_mask(pool_t["meta"]).sum(dim=(0, 2, 3), dtype=torch.int32)


# ---------------------------------------------------------------------------
# Paged pool: host-side allocator / sharing metadata
# ---------------------------------------------------------------------------


class PagePool:
    """Host-side bookkeeping for the fixed-size device page pool.

    Tracks, per pool page id:

    * a free list and per-page refcounts (``alloc`` / ``retain`` /
      ``release``);
    * ``owner``: the one holder allowed to append IN PLACE (any other
      holder of a page with refcount > 1 copies it first);
    * the FULL-page token-hash index (``register_full`` / ``lookup_full``):
      key = the cumulative token tuple through the end of the page, so equal
      keys imply equal page bytes (per-token grouping);
    * the partial-tail registry (``register_partial`` / ``lookup_partial``):
      live, still-appendable tail pages keyed by their cumulative prefix and
      current contents, shareable by a prompt whose tail is a prefix of them
      (copy-on-write at its first divergent append);
    * the LRU cache of retired hashed pages (``cached``): a released full
      page parks here instead of freeing, is revived by a later prefix hit,
      and is evicted least-recently-used when ``alloc`` runs dry.

    Page id 0 is the scratch page retired decode slots write into; it is
    never handed out.
    """

    def __init__(self, n_pages: int, page_tokens: int):
        if n_pages < 2:
            raise ValueError("pool needs the scratch page + 1 usable page")
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        self.free: list[int] = list(range(n_pages - 1, 0, -1))
        self.ref: dict[int, int] = {}
        self.owner: dict[int, object] = {}
        self.full_hash: dict[tuple, int] = {}
        self.key_of: dict[int, tuple] = {}
        self.partials: dict[int, dict] = {}      # pid -> {"key", "toks"}
        self.cached: "OrderedDict[int, None]" = OrderedDict()
        self.evictions = 0
        self.shared_hits = 0

    # -- capacity -----------------------------------------------------------

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1                  # minus the scratch page

    def available(self) -> int:
        """Pages an alloc() could return right now (free + evictable)."""
        return len(self.free) + len(self.cached)

    def live_pages(self) -> int:
        return len(self.ref)

    # -- alloc / refcount ---------------------------------------------------

    def alloc(self, owner=None) -> Optional[int]:
        """Take a page: free list first, else evict the LRU cached page."""
        if self.free:
            pid = self.free.pop()
        elif self.cached:
            pid, _ = self.cached.popitem(last=False)
            key = self.key_of.pop(pid, None)
            if key is not None:
                self.full_hash.pop(key, None)
            self.evictions += 1
        else:
            return None
        self.ref[pid] = 1
        self.partials.pop(pid, None)
        if owner is not None:
            self.owner[pid] = owner
        return pid

    def retain(self, pid: int):
        """Add a holder; revives a page parked in the LRU cache."""
        if pid in self.cached:
            del self.cached[pid]
            self.ref[pid] = 1
        else:
            self.ref[pid] += 1

    def release(self, pid: int, keep_cached: bool = True):
        """Drop a holder. A hashed full page with no holders parks in the
        LRU cache (still shareable, evictable) unless ``keep_cached`` is
        False (the guard's quarantine: its hash goes too); anything else
        frees."""
        self.ref[pid] -= 1
        if self.ref[pid] > 0:
            return
        del self.ref[pid]
        self.owner.pop(pid, None)
        self.partials.pop(pid, None)
        if keep_cached and pid in self.key_of:
            self.cached[pid] = None
        else:
            key = self.key_of.pop(pid, None)
            if key is not None:
                self.full_hash.pop(key, None)
            self.free.append(pid)

    # -- sharing indexes ----------------------------------------------------

    def register_full(self, pid: int, key: tuple):
        """Index an immutable full page by its cumulative token key (first
        writer wins; duplicates stay unshared)."""
        self.partials.pop(pid, None)
        if key in self.full_hash or pid in self.key_of:
            return
        self.full_hash[key] = pid
        self.key_of[pid] = key

    def lookup_full(self, key: tuple) -> Optional[int]:
        return self.full_hash.get(key)

    def register_partial(self, pid: int, prefix_key: tuple, toks: list):
        """(Re)index a live tail page: ``prefix_key`` is the cumulative
        token tuple before the page, ``toks`` its current contents."""
        if pid not in self.key_of:
            self.partials[pid] = {"key": prefix_key, "toks": list(toks)}

    def lookup_partial(self, prefix_key: tuple, seg: list) -> Optional[int]:
        """A live page whose prefix matches and whose contents start with
        ``seg`` (the new prompt's tail), shareable with COW on append."""
        for pid, ent in self.partials.items():
            if (ent["key"] == prefix_key and len(seg) <= len(ent["toks"])
                    and ent["toks"][: len(seg)] == list(seg)):
                return pid
        return None

    # -- invariants ---------------------------------------------------------

    def audit(self, holders: Optional[dict] = None) -> dict:
        """Check every cross-structure invariant and raise AssertionError
        naming ALL violations; return occupancy counters on success.

        The free list, the refcounted live set and the LRU cache partition
        pages 1..n_pages-1 exactly; refcounts are positive; owners and
        partial entries exist only on live pages; cached pages are
        hash-indexed; the full-page hash is a bijection onto live-or-cached
        pages, disjoint from the partial registry. ``holders`` (holder ->
        page ids it retains) must then count exactly the refcounts.
        """
        errs = []
        free, live, cached = set(self.free), set(self.ref), set(self.cached)
        if len(free) != len(self.free):
            errs.append(f"free list has duplicates: {sorted(self.free)}")
        for name, a, b in (("free/live", free, live),
                           ("free/cached", free, cached),
                           ("live/cached", live, cached)):
            both = a & b
            if both:
                errs.append(f"pages tracked twice ({name}): {sorted(both)}")
        expected = set(range(1, self.n_pages))
        tracked = free | live | cached
        leaked = expected - tracked
        if leaked:
            errs.append(f"leaked pages (in no structure): {sorted(leaked)}")
        bogus = tracked - expected
        if bogus:
            errs.append(f"out-of-range or scratch page ids tracked: "
                        f"{sorted(bogus)}")
        for pid, n in self.ref.items():
            if n <= 0:
                errs.append(f"page {pid}: non-positive refcount {n}")
        for pid in self.owner:
            if pid not in self.ref:
                errs.append(f"page {pid}: owned but not live")
        for pid in self.partials:
            if pid not in self.ref:
                errs.append(f"page {pid}: in the partial registry but not live")
            if pid in self.key_of:
                errs.append(f"page {pid}: both partial and full-hashed")
        for pid in cached:
            if pid not in self.key_of:
                errs.append(f"page {pid}: cached without a full-page hash "
                            "(unshareable — should have freed)")
        if len(self.full_hash) != len(self.key_of):
            errs.append(f"full_hash ({len(self.full_hash)}) and key_of "
                        f"({len(self.key_of)}) disagree on size")
        for pid, key in self.key_of.items():
            if self.full_hash.get(key) != pid:
                errs.append(f"page {pid}: key_of/full_hash mismatch")
            if pid not in self.ref and pid not in self.cached:
                errs.append(f"page {pid}: hash-indexed but neither live nor cached")
        if holders is not None:
            counts: dict[int, int] = {}
            for ids in holders.values():
                for pid in ids:
                    counts[pid] = counts.get(pid, 0) + 1
            if counts != dict(self.ref):
                errs.append(f"refcounts {dict(sorted(self.ref.items()))} != "
                            f"holder counts {dict(sorted(counts.items()))}")
        assert not errs, "PagePool.audit failed:\n  - " + "\n  - ".join(errs)
        return {"free": len(free), "live": len(live), "cached": len(cached),
                "hashed": len(self.key_of), "partials": len(self.partials)}


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------


def packed_kv_nbytes(pk: dict) -> int:
    """Resident bytes of one packed K or V tensor (codes + meta + tail)."""
    return (math.prod(pk["codes"].shape) + 4 * math.prod(pk["meta"].shape)
            + 2 * math.prod(pk["tail"].shape))
