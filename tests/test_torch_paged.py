"""The paged HiF4 KV pool of the PyTorch port vs the JAX reference.

* The pool primitives (``split_pages``, ``gather_pages``, ``scatter_pages``,
  ``copy_page``, ``append_token_paged``, ``init_page_pool``, ``page_nbytes``)
  give the reference's bytes, bitwise (meta compared as uint32 bits). The
  port writes in place; the reference returns new arrays.
* ``PagePool`` driven by one seeded sequence of alloc / retain / release /
  register / lookup operations in both packages: identical state after
  every operation (free list, refcounts, owners, LRU order, hash indexes,
  partial registry, evictions, shared hits, ``audit()``).
* ``fused_paged_decode_attention_plain`` against the reference's XLA twin
  at the contiguous plain version's stated multi-tile tolerance
  (rtol=2^-7, atol=1e-3: the f32 sums run in another order), and bitwise
  against the port's own contiguous plain version at ``block_kv = P`` on
  the same bytes laid out contiguously (shared pages, trailing scratch
  entries, a partial last page).
* The engine's paged route and dispatch info, and ``interop`` carrying a
  reference page pool and page table across.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import kvcache as JK
from repro.core.qlinear import QuantConfig as JQC
from repro.kernels import fused_attention as JA
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import kvcache as TK
from repro_torch.core.qlinear import QuantConfig
from repro_torch.kernels import fused_attention as TA

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

L, HKV, D = 2, 2, 32          # F = 64: one HiF4 group per token


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), "cpu")


def _to_t(tree):
    return {k: _to_t(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


def _assert_leaves_equal(jtree, ttree):
    for key in ("codes", "meta", "tail"):
        want = np.asarray(jtree[key])
        got = interop.to_numpy(ttree[key], uint32=want.dtype == np.uint32)
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=key)


def _bf16(rng, *shape):
    return jnp.asarray((rng.standard_normal(shape) * 0.5).astype(np.float32)
                       ).astype(jnp.bfloat16)


_pack = jax.jit(lambda kv: JK.to_kernel_layout(JK.quantize_kv(kv)))


def _random_pool(seed, n_pages, P, hkv=HKV, d=D):
    """A reference pool whose pages hold real quantized tokens (packed under
    jit: these bytes are inputs to both packages, not a comparison)."""
    rng = np.random.default_rng(seed)
    pool = {}
    for name in ("k", "v"):
        kv = _bf16(rng, L * n_pages * P, hkv, d)
        pk = _pack(kv)                                    # (F, tokens) leaves
        pool[name] = {key: jnp.moveaxis(
            a.reshape(a.shape[0], L, n_pages, P), 0, 2) for key, a in pk.items()}
    return pool


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hkv, d, P, layers", [(16, 64, 64, 24), (2, 32, 16, 2),
                                                (3, 24, 8, 2)])
def test_page_geometry_matches_reference(hkv, d, P, layers):
    assert TK.page_nbytes(hkv, d, P, layers) == JK.page_nbytes(hkv, d, P, layers)
    for n in (0, 1, P - 1, P, P + 1, 5 * P):
        assert TK.pages_for_tokens(n, P) == JK.pages_for_tokens(n, P)
    jp = JK.init_page_pool(layers, hkv, d, 5, P)
    tp = TK.init_page_pool(layers, hkv, d, 5, P, device="cpu")
    for name in ("k", "v"):
        for key in ("codes", "meta", "tail"):
            assert tuple(tp[name][key].shape) == jp[name][key].shape
            assert not tp[name][key].any()
        assert tp[name]["codes"].dtype == torch.uint8
        assert tp[name]["meta"].dtype == torch.int32      # uint32 bits
        assert tp[name]["tail"].dtype == torch.bfloat16
        assert TK.pool_page_tokens(tp[name]) == JK.pool_page_tokens(jp[name]) == P
        assert TK.pool_n_pages(tp[name]) == JK.pool_n_pages(jp[name]) == 5


# ---------------------------------------------------------------------------
# pool primitives, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S, P", [(37, 8), (32, 16), (5, 8)])
def test_split_pages_bitwise(S, P):
    rng = np.random.default_rng(S)
    pk = _pack(_bf16(rng, L, 1, S, 3, 24))                # F 72: a tail of 8
    want = JK.split_pages(pk, P)
    got = TK.split_pages(_to_t(pk), P)
    _assert_leaves_equal(want, got)


def test_gather_scatter_copy_bitwise():
    P, n_pages = 8, 7
    jpool = _random_pool(1, n_pages, P)["k"]
    tpool = _to_t(jpool)
    ids = jnp.asarray([5, 2, 2, 6], jnp.int32)
    _assert_leaves_equal(JK.gather_pages(jpool, ids),
                         TK.gather_pages(tpool, _t(ids)))
    # the gather is a copy: writing the pool afterwards leaves it unchanged
    g = TK.gather_pages(tpool, _t(ids))
    before = g["codes"].clone()
    tpool["codes"][:, 5] ^= 0xFF
    assert torch.equal(g["codes"], before)
    tpool = _to_t(jpool)
    src = _random_pool(2, 3, P)["k"]
    dst = jnp.asarray([4, 1, 6], jnp.int32)
    want = JK.scatter_pages(jpool, src, dst)
    got = TK.scatter_pages(tpool, _to_t(src), _t(dst))
    assert got is tpool                                   # in place
    _assert_leaves_equal(want, got)
    _assert_leaves_equal(JK.copy_page(want, 4, 3), TK.copy_page(got, 4, 3))


@pytest.mark.parametrize("P", [4, 8])
def test_append_token_paged_bitwise(P):
    """Live slots write through their tables; slot 2 runs past its table
    (clamped into the last entry); slot 3 is retired (all-zero row) and
    writes into scratch page 0."""
    n_pages, maxp = 9, 3
    rng = np.random.default_rng(P)
    jpool = _random_pool(3, n_pages, P)["v"]
    layer = {key: a[1] for key, a in jpool.items()}       # per-layer view
    pages = jnp.asarray([[1, 4, 7], [2, 5, 8], [3, 6, 0], [0, 0, 0]], jnp.int32)
    pos = jnp.asarray([0, P + 3, 3 * P + 1, 2], jnp.int32)
    kv_new = _bf16(rng, 4, 1, HKV, D)
    want = JK.append_token_paged(layer, kv_new, pos, pages)
    tl = _to_t(layer)
    got = TK.append_token_paged(tl, _t(kv_new), _t(pos), _t(pages))
    assert got is tl
    _assert_leaves_equal(want, got)
    np.testing.assert_array_equal(np.asarray(want["codes"][0]),
                                  got["codes"][0].numpy())   # scratch written


# ---------------------------------------------------------------------------
# PagePool: one op sequence, both packages, identical state
# ---------------------------------------------------------------------------


def _pool_state(pool):
    return (list(pool.free), dict(pool.ref), dict(pool.owner),
            list(pool.cached), dict(pool.full_hash), dict(pool.key_of),
            {pid: (e["key"], list(e["toks"])) for pid, e in pool.partials.items()},
            pool.evictions, pool.shared_hits, pool.available(),
            pool.live_pages(), pool.usable_pages)


def test_page_pool_op_sequence_matches_reference():
    rng = np.random.default_rng(4)
    jp, tp = JK.PagePool(10, 4), TK.PagePool(10, 4)
    keys = [tuple(int(t) for t in rng.integers(0, 3, n)) for n in (4, 8, 12) * 4]
    n_ops = {"alloc": 0, "retain": 0, "release": 0, "register_full": 0,
             "register_partial": 0, "lookup_full": 0, "lookup_partial": 0}
    most_cached = 0
    for step in range(400):
        live = sorted(tp.ref)
        op = rng.choice(list(n_ops))
        if op in ("retain", "release", "register_full", "register_partial") \
                and not live:
            op = "alloc"
        if op == "retain" and rng.random() < 0.2 and tp.cached:
            pid = int(rng.choice(list(tp.cached)))          # revive
        else:
            pid = int(rng.choice(live)) if live else None
        if op == "alloc":
            owner = int(rng.integers(0, 4))
            out = (jp.alloc(owner=owner), tp.alloc(owner=owner))
        elif op == "retain":
            out = (jp.retain(pid), tp.retain(pid))
        elif op == "release":
            out = (jp.release(pid), tp.release(pid))
        elif op == "register_full":
            key = keys[int(rng.integers(0, len(keys)))]
            out = (jp.register_full(pid, key), tp.register_full(pid, key))
        elif op == "register_partial":
            key = keys[int(rng.integers(0, len(keys)))]
            toks = [int(t) for t in rng.integers(0, 3, int(rng.integers(1, 4)))]
            out = (jp.register_partial(pid, key, toks),
                   tp.register_partial(pid, key, toks))
        elif op == "lookup_full":
            key = keys[int(rng.integers(0, len(keys)))]
            out = (jp.lookup_full(key), tp.lookup_full(key))
        else:
            key = keys[int(rng.integers(0, len(keys)))]
            seg = [int(t) for t in rng.integers(0, 3, int(rng.integers(0, 3)))]
            out = (jp.lookup_partial(key, seg), tp.lookup_partial(key, seg))
        n_ops[op] += 1
        assert out[0] == out[1], (step, op)
        assert _pool_state(jp) == _pool_state(tp), (step, op)
        assert jp.audit() == tp.audit()
        most_cached = max(most_cached, len(tp.cached))
    assert all(n > 10 for n in n_ops.values()), n_ops
    assert tp.evictions > 0 and most_cached > 1 and tp.shared_hits == 0


def test_page_pool_audit_names_violations_like_reference():
    jp, tp = JK.PagePool(6, 4), TK.PagePool(6, 4)
    for pool in (jp, tp):
        a = pool.alloc(owner="r")
        pool.free.append(a)                               # double-tracked
        pool.ref.pop(pool.alloc())                        # leaked
    msgs = []
    for pool in (jp, tp):
        with pytest.raises(AssertionError) as exc:
            pool.audit(holders={"r": [1]})
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError):
        TK.PagePool(1, 4)


# ---------------------------------------------------------------------------
# paged attention, plain version
# ---------------------------------------------------------------------------


def _paged_case(seed, P, hkv, d, rep=1):
    """Slots 0 and 1 share their first two pages; slot 2 has a partial last
    page and trailing scratch entries; slot 3 is one token long."""
    n_pages, maxp = 12, 4
    pool = _random_pool(seed, n_pages, P, hkv, d)
    layer = {name: {key: a[0] for key, a in t.items()} for name, t in pool.items()}
    pages = np.array([[3, 7, 1, 9], [3, 7, 4, 10], [2, 11, 0, 0], [5, 0, 0, 0]],
                     np.int32)
    length = np.array([4 * P, 3 * P + 1, P + P // 2, 1], np.int32)
    rng = np.random.default_rng(seed + 100)
    q = _bf16(rng, 4, hkv * rep, d)
    return q, layer, pages, length


def _contiguous(layer_t, pages):
    """The same bytes laid out as a contiguous (B, F, max_pages*P) cache."""
    out = {}
    for key, a in layer_t.items():
        g = a[torch.from_numpy(pages).long()]             # (B, maxp, F, P)
        b, maxp, f, p = g.shape
        out[key] = g.permute(0, 2, 1, 3).reshape(b, f, maxp * p).contiguous()
    return out


@pytest.mark.parametrize("P, hkv, d, rep", [(16, 2, 32, 1), (64, 2, 64, 2),
                                            (8, 4, 32, 1)])
def test_paged_plain_vs_reference_and_contiguous(P, hkv, d, rep):
    q, layer, pages, length = _paged_case(5, P, hkv, d, rep)
    oj = np.asarray(jax.jit(JA.fused_paged_decode_attention_xla,
                            static_argnums=(5, 6))(
        q, layer["k"], layer["v"], jnp.asarray(pages), jnp.asarray(length),
        hkv, d).astype(jnp.float32))
    tk, tv = _to_t(layer["k"]), _to_t(layer["v"])
    ot = TA.fused_paged_decode_attention(_t(q), tk, tv, torch.from_numpy(pages),
                                         torch.from_numpy(length),
                                         n_kv_heads=hkv, d_head=d)
    np.testing.assert_allclose(ot.float().numpy(), oj, rtol=2 ** -7, atol=1e-3)
    oc = TA.fused_decode_attention_plain(_t(q), _contiguous(tk, pages),
                                         _contiguous(tv, pages),
                                         torch.from_numpy(length), hkv, d,
                                         block_kv=P)
    assert torch.equal(ot.view(torch.int16), oc.view(torch.int16))
    # trailing scratch entries are exact no-ops: cut them off, same bits
    cut = TA.fused_paged_decode_attention(_t(q)[2:4], tk, tv,
                                          torch.from_numpy(pages[2:4, :2].copy()),
                                          torch.from_numpy(length[2:4]),
                                          n_kv_heads=hkv, d_head=d)
    assert torch.equal(ot[2:4].view(torch.int16), cut.view(torch.int16))


def test_paged_plain_nan_meta_reaches_only_its_holders():
    q, layer, pages, length = _paged_case(6, 16, 2, 32)
    tk, tv = _to_t(layer["k"]), _to_t(layer["v"])
    tk["meta"][7, 0, 2] |= -(1 << 24)                    # page 7: slots 0, 1
    out = TA.fused_paged_decode_attention(_t(q), tk, tv, torch.from_numpy(pages),
                                          torch.from_numpy(length), n_kv_heads=2,
                                          d_head=32)
    nan = out.isnan().flatten(1).any(1).tolist()
    assert nan == [True, True, False, False]


def test_paged_wrapper_rejects_bad_operands():
    q, layer, pages, length = _paged_case(7, 8, 2, 32)
    tk, tv = _to_t(layer["k"]), _to_t(layer["v"])
    with pytest.raises(ValueError):
        TA.fused_paged_decode_attention(_t(q), tk, tv, torch.from_numpy(pages[:2]),
                                        torch.from_numpy(length), n_kv_heads=2,
                                        d_head=32)
    with pytest.raises(ValueError):
        TA.fused_paged_decode_attention(_t(q).to("meta"), tk, tv,
                                        torch.from_numpy(pages),
                                        torch.from_numpy(length), n_kv_heads=2,
                                        d_head=32)


# ---------------------------------------------------------------------------
# engine, dispatch, interop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["packed", "qdq"])
def test_engine_paged_route(impl):
    q, layer, pages, length = _paged_case(8, 8, 2, 32)
    tk, tv = _to_t(layer["k"]), _to_t(layer["v"])
    args = (_t(q), tk, tv, torch.from_numpy(length), 2, 32)
    out = TE.attention_decode(*args, TE.EngineCtx(QuantConfig(fmt="hif4", impl=impl)),
                              pages=torch.from_numpy(pages))
    want = TA.fused_paged_decode_attention_plain(
        _t(q), tk, tv, torch.from_numpy(pages), torch.from_numpy(length), 2, 32)
    assert torch.equal(out, want)
    for device, interpret in (("cuda", False), ("cpu", True)):
        ij = JE.attention_dispatch_info(JQC(fmt="hif4", impl=impl), layer["k"],
                                        n_kv_heads=2, d_head=32,
                                        interpret=interpret, paged=True)
        it = TE.attention_dispatch_info(QuantConfig(fmt="hif4", impl=impl), tk,
                                        n_kv_heads=2, d_head=32, device=device,
                                        paged=True)
        for key in ("fused", "block_kv", "kernel_eligible"):
            assert it[key] == ij[key], key
        assert it["route"].startswith("fused_paged_decode_attention")


def test_interop_carries_a_paged_cache():
    pool = _random_pool(9, 6, 8)
    jcache = {"kv": pool, "pages": jnp.asarray([[1, 2], [3, 0]], jnp.int32),
              "pos": jnp.asarray([9, 4], jnp.int32)}
    tcache = interop.cache_from_jax(jcache, "cpu")
    for name in ("k", "v"):
        _assert_leaves_equal(pool[name], tcache["kv"][name])
    assert tcache["pages"].dtype == torch.int32
    assert tcache["pages"].tolist() == [[1, 2], [3, 0]]
    assert tcache["pos"].tolist() == [9, 4]
