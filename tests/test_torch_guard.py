"""The guard layer of the PyTorch port (``repro_torch.runtime.guard`` and the
guard's pool helpers in ``repro_torch.core.kvcache``) vs the JAX reference.

* Bitwise the reference's on the same inputs: ``bad_logits``,
  ``slot_meta_nan_counts``, ``page_checksums`` (pages whose sums wrap at
  2^32, land just below it or on 0, and bf16 tails), ``page_meta_nan_counts``,
  ``pool_page_stats``, ``snapshot_fingerprint`` and ``artifact_integrity``.
* Any single flipped bit of a page changes that page's checksum and no
  other's; snapshots detect flips, truncation and mangled structure;
  ``packed_invariants`` flags the 0xFF sentinel.
* Within the port: a guarded serve's tokens are bitwise the unguarded
  serve's on the slot scheduler (HiF4 and bf16 KV) and the paged one, and
  the guard adds no host transfer: a guarded run converts device values to
  host values exactly as often as the unguarded run (one pull per chunk).
"""
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hif4 as JH
from repro.core import kvcache as JK
from repro.core.qlinear import PackedW as JPackedW
from repro.runtime import guard as JG
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import hif4, kvcache
from repro_torch.core.qlinear import PackedW, QuantConfig
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.runtime import guard
from repro_torch.runtime import serve_loop
from repro_torch.runtime.serve_loop import (ServeConfig, prepare_params_for_serving,
                                            serve_requests)

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

CFG = get_arch("qwen1.5-0.5b").reduced()


# ---------------------------------------------------------------------------
# Typed exceptions
# ---------------------------------------------------------------------------


def test_exception_hierarchy_matches_reference():
    names = ("ServeError", "PoolExhaustedError", "SnapshotIntegrityError",
             "JournalError", "RecoveryError", "ArtifactError",
             "ArtifactNotFoundError", "ArtifactLayoutError",
             "ArtifactIntegrityError")
    for name in names:
        jbase = [b.__name__ for b in getattr(JG, name).__mro__]
        tbase = [b.__name__ for b in getattr(guard, name).__mro__]
        assert tbase == jbase, name
    assert issubclass(guard.ServeError, RuntimeError)
    assert serve_loop.PoolExhaustedError is guard.PoolExhaustedError
    assert guard.STATUS_NAMES == JG.STATUS_NAMES
    assert guard.FAULT_REASONS == JG.FAULT_REASONS
    assert dataclasses.asdict(guard.GuardConfig()) == dataclasses.asdict(
        JG.GuardConfig())
    assert guard.new_report() == JG.new_report()


# ---------------------------------------------------------------------------
# Device-side sentinels, bitwise the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bad_logits_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    x[1, 3], x[2, 0], x[4, 39] = np.nan, np.inf, -np.inf
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(JG.bad_logits(jx))
    np.testing.assert_array_equal(guard.bad_logits(tx).numpy(), want)
    assert want.tolist() == [False, True, True, False, True]


def test_slot_meta_nan_counts_match_reference():
    """A contiguous packed cache (L, B, G, S) with 0xFF words planted in two
    slots: per-slot counts equal the reference's."""
    rng = np.random.default_rng(1)
    kv = {}
    for name in ("k", "v"):
        x = torch.from_numpy(rng.standard_normal((2, 3, 24, 2, 64)).astype(
            np.float32) * 0.3).to(torch.bfloat16)
        kv[name] = kvcache.to_kernel_layout(kvcache.quantize_kv(x))
    kv["k"]["meta"][0, 1, 0, 3] = kv["k"]["meta"][0, 1, 0, 3] | ((0xFF << 24) - (1 << 32))
    kv["v"]["meta"][1, 2, 1, 5] = (0xFF << 24) - (1 << 32)
    kv["v"]["meta"][0, 2, 0, 0] = (0xFF << 24) - (1 << 32)
    jkv = {n: {key: jnp.asarray(interop.to_numpy(a, uint32=key == "meta"))
               for key, a in t.items() if key != "tail"} for n, t in kv.items()}
    want = np.asarray(JG.slot_meta_nan_counts(jkv))
    got = guard.slot_meta_nan_counts(kv)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [0, 1, 2]


M_META, M_TAIL = 0x9E3779B1, 0x85EBCA77


def _pool_bits(L=2, NP=8, hkv=1, d=80, P=8, seed=2):
    """Pool leaves as raw bits (codes uint8, meta uint32, tail uint16) with
    pages built to probe the uint32 arithmetic: page 1 one meta word
    0xFFFFFFFF, page 2 every meta word 0xFFFFFFFE (its sum passes 2^32 many
    times), page 3 codes and tail all ones, page 4 a total of exactly
    2^32 - 1, page 5 a total that wraps to 0, pages 6-7 random."""
    g, t = kvcache.split_features(hkv, d)
    rng = np.random.default_rng(seed)
    codes = np.zeros((L, NP, g * 32, P), np.uint8)
    meta = np.zeros((L, NP, g, P), np.uint32)
    tail = np.zeros((L, NP, t, P), np.uint16)
    meta[0, 1, 0, 0] = 0xFFFFFFFF
    meta[:, 2] = 0xFFFFFFFE
    codes[:, 3] = 0xFF
    tail[:, 3] = 0xFFFF
    inv = pow(M_META, -1, 1 << 32)
    for page, total in ((4, 0xFFFFFFFF), (5, 0)):
        codes[:, page] = rng.integers(0, 256, codes[:, page].shape, dtype=np.uint8)
        c = int(codes[:, page].astype(np.int64).sum())
        meta[0, page, 0, 1] = ((total - c) * inv) % (1 << 32)
    for page in (6, 7):
        codes[:, page] = rng.integers(0, 256, codes[:, page].shape, dtype=np.uint8)
        meta[:, page] = rng.integers(0, 1 << 32, meta[:, page].shape, dtype=np.uint32)
        tail[:, page] = rng.integers(0, 1 << 16, tail[:, page].shape, dtype=np.uint16)
    return codes, meta, tail


def _both(codes, meta, tail):
    jpool = {"codes": jnp.asarray(codes), "meta": jnp.asarray(meta),
             "tail": jnp.asarray(tail.view(jnp.bfloat16))}
    tpool = {"codes": torch.from_numpy(codes.copy()),
             "meta": torch.from_numpy(meta.view(np.int32).copy()),
             "tail": torch.from_numpy(tail.view(np.int16).copy()).view(torch.bfloat16)}
    return jpool, tpool


@pytest.mark.parametrize("d", [80, 64])          # with and without a bf16 tail
def test_page_checksums_bitwise_near_2_32(d):
    codes, meta, tail = _pool_bits(d=d)
    jpool, tpool = _both(codes, meta, tail)
    want = np.asarray(JK.page_checksums(jpool))
    assert want.dtype == np.uint32
    got = kvcache.page_checksums(tpool)
    assert got.dtype == torch.int64 and bool((got >= 0).all() and (got < 2**32).all())
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if d == 64:
        assert want[4] == 0xFFFFFFFF and want[5] == 0


def test_pool_page_stats_and_meta_nan_counts_match_reference():
    codes, meta, tail = _pool_bits()
    meta[1, 6, 0, 2] = np.uint32(0xFF << 24)
    meta[0, 3, 0, 0] = np.uint32(0xFF123456)
    jk, tk = _both(codes, meta, tail)
    jv, tv = _both(*_pool_bits(seed=9))
    want = JG.pool_page_stats({"k": jk, "v": jv})
    got = guard.pool_page_stats({"k": tk, "v": tv})
    np.testing.assert_array_equal(got["sums"].numpy(),
                                  np.asarray(want["sums"]).astype(np.int64))
    np.testing.assert_array_equal(got["meta_nan"].numpy(), np.asarray(want["meta_nan"]))
    np.testing.assert_array_equal(kvcache.page_meta_nan_counts(tk).numpy(),
                                  np.asarray(JK.page_meta_nan_counts(jk)))
    assert got["meta_nan"].tolist()[3] >= 1 and got["meta_nan"].tolist()[6] >= 1
    np.testing.assert_array_equal(
        guard.slot_meta_nan_counts({"k": tk, "v": tv}).numpy(),
        np.asarray(JG.slot_meta_nan_counts({"k": jk, "v": jv})))


@pytest.mark.parametrize("leaf,bit", [("codes", 0), ("codes", 7), ("meta", 0),
                                      ("meta", 31), ("tail", 0), ("tail", 15)])
def test_page_checksum_catches_any_single_bit(leaf, bit):
    """One flipped bit anywhere in a page changes that page's checksum and
    no other's, in both packages."""
    codes, meta, tail = _pool_bits()
    arrays = {"codes": codes, "meta": meta, "tail": tail}
    _, before = _both(codes, meta, tail)
    before = kvcache.page_checksums(before).numpy()
    a = arrays[leaf]
    a[1, 6, 0, 4] ^= a.dtype.type(1 << bit)
    jpool, tpool = _both(codes, meta, tail)
    after = kvcache.page_checksums(tpool).numpy()
    np.testing.assert_array_equal(after, np.asarray(JK.page_checksums(jpool)))
    assert after[6] != before[6]
    mask = np.arange(len(after)) != 6
    np.testing.assert_array_equal(after[mask], before[mask])


def test_scrub_pages_zeroes_only_the_given_pages():
    codes, meta, tail = _pool_bits()
    jpool, tpool = _both(codes, meta, tail)
    kvcache.scrub_pages(tpool, torch.tensor([2, 6]))
    want = JK.scrub_pages(jpool, jnp.asarray([2, 6]))
    for key in ("codes", "meta", "tail"):
        w = np.asarray(want[key])
        got = interop.to_numpy(tpool[key], uint32=key == "meta")
        np.testing.assert_array_equal(got, w.astype(got.dtype))
    assert int(kvcache.page_checksums(tpool)[6]) == 0


# ---------------------------------------------------------------------------
# Preemption-snapshot fingerprints
# ---------------------------------------------------------------------------


def _snapshot(seed=0, t=16):
    """A host snapshot in both packages' forms: the reference's numpy leaves
    (uint32 meta, bfloat16 tail) and the port's tensors (int32 meta, bf16)."""
    rng = np.random.default_rng(seed)
    jpages, tpages = {}, {}
    for name in ("k", "v"):
        codes = rng.integers(0, 256, (2, 3, 64, 8), dtype=np.uint8)
        meta = rng.integers(0, 1 << 32, (2, 3, 2, 8), dtype=np.uint32)
        tail = rng.integers(0, 1 << 16, (2, 3, t, 8), dtype=np.uint16)
        jpages[name] = {"codes": codes, "meta": meta,
                        "tail": tail.view(jnp.bfloat16)}
        tpages[name] = {"codes": torch.from_numpy(codes.copy()),
                        "meta": torch.from_numpy(meta.view(np.int32).copy()),
                        "tail": torch.from_numpy(tail.view(np.int16).copy()
                                                 ).view(torch.bfloat16)}
    return jpages, tpages


@pytest.mark.parametrize("t", [16, 0])
def test_snapshot_fingerprint_equals_reference(t):
    jpages, tpages = _snapshot(t=t)
    crc = guard.snapshot_fingerprint(tpages)
    assert crc == JG.snapshot_fingerprint(jpages)
    # numpy leaves in the reference's dtypes fingerprint the same
    assert guard.snapshot_fingerprint(jpages) == crc


def test_snapshot_fingerprint_detects_flip_and_truncation():
    _, pages = _snapshot()
    crc = guard.snapshot_fingerprint(pages)
    assert guard.verify_snapshot({"pages": pages, "crc32": crc})
    _, flipped = _snapshot()
    flipped["k"]["codes"][0, 1, 3, 2] ^= 1
    assert not guard.verify_snapshot({"pages": flipped, "crc32": crc})
    _, full = _snapshot()
    truncated = {n: {key: a[:, :-1] for key, a in leaves.items()}
                 for n, leaves in full.items()}
    assert not guard.verify_snapshot({"pages": truncated, "crc32": crc})
    assert not guard.verify_snapshot({"pages": {"k": {}}, "crc32": crc})


# ---------------------------------------------------------------------------
# Artifact integrity
# ---------------------------------------------------------------------------


def _packed(seed, k=128, n=8):
    w = torch.randn(k, n, generator=torch.Generator().manual_seed(seed)) * 0.3
    return PackedW.from_dense(w.to(torch.bfloat16))


def _to_jax(p: PackedW):
    return JPackedW(jnp.asarray(p.codes.numpy()),
                    jnp.asarray(interop.to_numpy(p.meta, uint32=True)),
                    p.shape2d, jnp.bfloat16, p.axes2d, p.kernel_layout)


def test_artifact_integrity_matches_reference_and_catches_corruption():
    tree = {"b": _packed(1), "a": {"x": _packed(0)}, "c": torch.zeros(3)}
    jtree = {"b": _to_jax(tree["b"]), "a": {"x": _to_jax(tree["a"]["x"])},
             "c": jnp.zeros(3)}
    rec = guard.artifact_integrity(tree)
    assert rec == JG.artifact_integrity(jtree)
    assert list(rec["leaves"]) == ["['a']['x']", "['b']"]
    guard.verify_artifact_integrity(tree, rec, "mem")            # clean
    bad = dict(tree, b=dataclasses.replace(tree["b"],
                                           codes=tree["b"].codes.contiguous().clone()))
    bad["b"].codes.view(-1)[7] ^= 1 << 3
    with pytest.raises(guard.ArtifactIntegrityError, match=r"\['b'\]: codes_sha256"):
        guard.verify_artifact_integrity(bad, rec, "mem")
    with pytest.raises(guard.ArtifactIntegrityError, match="no integrity"):
        guard.verify_artifact_integrity(tree, {"version": 1, "leaves": {}}, "mem")


def test_packed_invariants_catch_meta_nan_like_reference():
    leaf = _packed(2)
    assert guard.packed_invariants("w", leaf) == []
    poisoned = dataclasses.replace(leaf, meta=leaf.meta.contiguous().clone())
    poisoned.meta.view(-1)[0] |= (hif4.META_NAN << 24) - (1 << 32)
    errs = guard.packed_invariants("w", poisoned)
    assert errs == JG.packed_invariants("w", _to_jax(poisoned))
    assert errs and "NaN sentinel" in errs[0]
    km = poisoned.to_kernel_layout()
    assert guard.packed_invariants("w", km) == JG.packed_invariants("w", _to_jax(km))
    assert JH.META_NAN == hif4.META_NAN


# ---------------------------------------------------------------------------
# Guarded serving within the port
# ---------------------------------------------------------------------------


def _scaled(tree, f):
    if isinstance(tree, dict):
        return {k: _scaled(v, f) for k, v in tree.items()}
    return tree * f if tree.dtype == torch.bfloat16 else tree


@pytest.fixture(scope="module")
def params():
    raw = lm.init_params(CFG, 0, device="cpu")
    raw = dict(raw, blocks=_scaled(raw["blocks"], 5), embed=raw["embed"] * 5)
    return prepare_params_for_serving(raw, CFG, QuantConfig(fmt="hif4", impl="packed"),
                                      device="cpu")


def _ctx(kv):
    return ModelCtx(quant=QuantConfig(fmt="hif4", impl="packed",
                                      kv=kvcache.KVCacheConfig(kv)),
                    attn_q_chunk=2, attn_k_chunk=2)


def _prompts():
    g = torch.Generator().manual_seed(7)
    prefix = torch.randint(0, CFG.vocab, (12,), generator=g)
    return [torch.cat([prefix, torch.randint(0, CFG.vocab, (n,), generator=g)])
            for n in (4, 6, 8, 2)]


_HOST_READS = ("tolist", "item", "__bool__", "__int__", "__float__", "__index__",
               "cpu", "numpy")


@contextlib.contextmanager
def _count_host_reads(counts):
    """Count every conversion of a tensor to host values (each is a device
    synchronize on the card)."""
    saved = {name: getattr(torch.Tensor, name) for name in _HOST_READS}

    def wrap(name, fn):
        def counted(self, *a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(self, *a, **k)
        return counted

    for name, fn in saved.items():
        setattr(torch.Tensor, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


@pytest.mark.parametrize("sched", ["slots-hif4", "slots-bf16", "paged"])
def test_guarded_tokens_bitwise_and_no_extra_host_reads(params, sched):
    kv = "bf16" if sched == "slots-bf16" else "hif4"
    sc = ServeConfig(max_new_tokens=6, decode_chunk=2, cache_capacity=32,
                     kv_format=kv, kv_pages=12 if sched == "paged" else 0,
                     kv_page_tokens=8)
    runs = {}
    for name, guard_cfg in (("plain", None), ("guarded", guard.GuardConfig())):
        counts: dict = {}
        stats: dict = {}
        with _count_host_reads(counts):
            res = serve_requests(CFG, params, _prompts(), _ctx(kv),
                                 dataclasses.replace(sc, guard=guard_cfg),
                                 slots=3, stats=stats, device="cpu")
        runs[name] = (res, counts, stats)
    (plain, c_plain, _), (guarded, c_guarded, stats) = runs["plain"], runs["guarded"]
    for i, (a, b) in enumerate(zip(plain, guarded)):
        assert torch.equal(a, b), i
    assert len(set(plain[0].tolist())) > 1
    assert all(r["status"] == "ok" for r in stats["reports"].values())
    assert stats["quarantined"] == stats["retried"] == stats["rejected"] == 0
    # the guard's flags and checksums ride the chunk's one pull
    assert c_guarded == c_plain, (c_guarded, c_plain)
