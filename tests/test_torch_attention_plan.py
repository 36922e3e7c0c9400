"""The launch plan of the decode-attention kernels (3 and 4) and the op
order of their CTA body, on the CPU.

* ``attention_plan``: one CTA per (slot, head block), no cluster, so no
  tile is ever split across CTAs; every tile in one wave when it fits in
  227 KB of shared memory, else the widest wave of a two-stage ring; the
  shared bytes at the main shapes; refusals.
* ``tile_layout``: the per-tile reduction layout is a function of the tile
  width alone, whatever the tile count, batch, GQA or head width.
* ``quad_path``: only head widths whose D/16 slices an xor tree can add.
* The body's phased order, emulated here with the plain version's own
  per-tile ops: every tile's scores, then the tile maxima and the prefix
  max, e and the tile sums, the l chain and p, every tile's p.V, and the
  accumulator folded in tile order; every tile walked, those past the
  length too. It is BITWISE the ``_tile_step`` recurrence over every tile
  (m, l and acc in f32) on ragged lengths, trailing scratch entries, NaN V
  metadata in masked tokens and in tiles wholly past the length, a slot of
  length 0, rows with no score above -1e30, GQA (rep 2) and D = 32; and
  within rtol=2^-7, atol=1e-3 of the JAX reference's XLA twin, NaN where
  it has NaN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as JK
from repro.kernels import fused_attention as JA
from repro_torch import interop
from repro_torch.core import kvcache as TK
from repro_torch.kernels import fused_attention as TA

torch.set_num_threads(1)

NAN_SCALE = -(1 << 24)      # OR into a meta word: E6M2 code 0xFF


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), "cpu")


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch, hkv, rep, d, ck, n_tiles", [
    (8, 16, 1, 64, 256, 2), (8, 16, 1, 64, 64, 8), (1, 16, 1, 64, 64, 8),
    (6, 4, 2, 32, 32, 5), (3, 8, 4, 128, 256, 16), (2, 2, 1, 64, 16, 300)])
def test_plan_one_cta_per_head_block_and_fits(batch, hkv, rep, d, ck, n_tiles):
    plan = TA.attention_plan(batch, hkv, rep, d, ck, n_tiles)
    hb = TA.heads_per_block(d)
    assert plan.grid == (hkv // hb, batch)        # no cluster: a tile is one CTA's
    assert plan.threads == TA.ATTN_THREADS
    assert 1 <= plan.wave <= n_tiles and plan.smem_bytes <= 232_448
    if plan.stages == 1:
        assert plan.wave == n_tiles
    else:                                         # the widest ring that fits
        assert plan.stages == 2 and plan.wave < n_tiles
        assert TA._smem_bytes(hb * rep, d, hb * d, ck, n_tiles, 1) > 232_448
        assert TA._smem_bytes(hb * rep, d, hb * d, ck, plan.wave + 1, 2) > 232_448


def test_plan_at_the_main_shapes():
    """The serve phase's kernel 3 (2 tiles of 256) and the paged phase's
    kernel 4 (8 pages of 64) each stage every tile at once (< 84 KB), on
    the quad path."""
    k3 = TA.attention_plan(8, 16, 1, 64, 256, 2)
    k4 = TA.attention_plan(8, 16, 1, 64, 64, 8)
    assert (k3.wave, k3.stages, k3.pitch, k3.parts, k3.smem_bytes) == (
        2, 1, 260, 8, 77_536)
    assert (k4.wave, k4.stages, k4.pitch, k4.parts, k4.smem_bytes) == (
        8, 1, 68, 2, 81_008)
    assert TA.attention_plan(8, 16, 1, 64, 256, 16).stages == 2   # a 4096 cache


@pytest.mark.parametrize("ck", [1, 16, 33, 64, 100, 256])
@pytest.mark.parametrize("d", [32, 64, 128, 24, 80, 192])
def test_tile_layout_is_a_function_of_the_tile_width_alone(ck, d):
    """Not of the tile count, the batch, GQA or the kernel: kernel 4's tiles
    of P and kernel 3's at block_kv = P reduce alike."""
    pitch, parts, part_tokens, chains, slices, chunks = TA.tile_layout(ck, d)
    assert pitch % 4 == 0 and pitch >= ck + 4 and parts * part_tokens >= ck
    if ck % 8 == 0:
        assert (pitch // 4) % 2 == 1          # 32 code rows in 32 banks
    assert (chains, slices) == ((4, d // 16) if d in (32, 64, 128) else (1, 1))
    assert chunks == (ck // 32 if ck % 32 == 0 else 1)
    hb = TA.heads_per_block(d)
    plans = [TA.attention_plan(b, hkv * hb, rep, d, ck, n)
             for b, hkv, rep, n in [(1, 1, 1, 1), (8, 2, 1, 8), (3, 4, 2, 33)]]
    assert {(p.pitch, p.parts) for p in plans} == {(pitch, parts)}


def test_quad_path_takes_power_of_two_slice_counts_only():
    """The quad path adds a head's D/16 slices by an xor tree over aligned
    groups of lanes, right only for a power of two dividing 32; zamba2's
    D = 80, D = 96 and nemotron-4's D = 192 take the scalar path."""
    quads = {d: TA.quad_path(d) for d in (16, 32, 40, 48, 64, 80, 96, 128,
                                          192, 256, 512, 1024)}
    assert [d for d, ok in quads.items() if ok] == [16, 32, 64, 128, 256, 512]


@pytest.mark.parametrize("batch, hkv, rep, d, ck, n_tiles", [
    (0, 16, 1, 64, 64, 8), (8, 16, 1, 64, 64, 0), (8, 3, 1, 32, 64, 8),
    (8, 1, 600, 64, 64, 8), (1, 64, 1, 2048, 8192, 2), (1, 64, 1, 3, 64, 2)])
def test_plan_refuses_what_no_launch_takes(batch, hkv, rep, d, ck, n_tiles):
    with pytest.raises(ValueError):
        TA.attention_plan(batch, hkv, rep, d, ck, n_tiles)


# ---------------------------------------------------------------------------
# the phased op order, bitwise the recurrence
# ---------------------------------------------------------------------------


def _pool(rng, n_pages, P, hkv, d):
    kv = (rng.standard_normal((n_pages * P, hkv, d)) * 0.5).astype(np.float32)
    pk = TK.to_kernel_layout(TK.quantize_kv(_t(kv).to(torch.bfloat16)))
    return {key: a.reshape(a.shape[0], n_pages, P).transpose(0, 1).contiguous()
            for key, a in pk.items()}


def _paged_case(seed, P, hkv, rep, d):
    """Six slots over a 16-page pool: a full table; a shared prefix with a
    partial last page; a partial page then trailing scratch entries; one
    token; length 0; a page used only past the length. NaN V scales in the
    scratch page 0 (group 0) and in page 15 past slot 5's length (the last
    group); a NaN K scale in the scratch page."""
    rng = np.random.default_rng(seed)
    n_pages = 16
    kp, vp = _pool(rng, n_pages, P, hkv, d), _pool(rng, n_pages, P, hkv, d)
    pages = np.array([[1, 2, 3, 4], [1, 2, 5, 6], [7, 8, 0, 0], [9, 0, 0, 0],
                      [10, 11, 12, 0], [13, 14, 15, 0]], np.int32)
    length = np.array([4 * P, 3 * P + 1, P + P // 2, 1, 0, 2 * P], np.int32)
    groups = hkv * d // 64
    vp["meta"][0, 0, 3] |= NAN_SCALE
    vp["meta"][15, groups - 1, P - 1] |= NAN_SCALE
    kp["meta"][0, 0, 2] |= NAN_SCALE
    q = (rng.standard_normal((6, hkv * rep, d)) * 0.5).astype(np.float32)
    return _t(q).to(torch.bfloat16), kp, vp, torch.from_numpy(pages), \
        torch.from_numpy(length)


def _paged_tiles(kp, vp, pages, hkv, d):
    """(K tile, V tile) per table column, gathered as the plain version
    gathers them."""
    out = []
    for ki in range(pages.shape[1]):
        pids = pages[:, ki].long()
        gk = {key: a.index_select(0, pids) for key, a in kp.items()}
        gv = {key: a.index_select(0, pids) for key, a in vp.items()}
        out.append((TK.dequantize_kv(gk, hkv, d), TK.dequantize_kv(gv, hkv, d)))
    return out


def _contiguous_tiles(kc, vc, ck, hkv, d):
    S = TK.seq_capacity(kc)
    out = []
    for ki in range(S // ck):
        sk, sv = TK.slice_tokens(kc, ki * ck, ck), TK.slice_tokens(vc, ki * ck, ck)
        out.append((TK.dequantize_kv(sk, hkv, d), TK.dequantize_kv(sv, hkv, d)))
    return out


def _recurrence(q, tiles, length, hkv, d):
    """The plain version's loop: every tile through ``_tile_step``."""
    B, H, D = q.shape
    rep = H // hkv
    ck = tiles[0][0].shape[1]
    qf = q.reshape(B, hkv, rep, D).to(torch.float32)
    state = TA._init_state(B, hkv, rep, D, q.device)
    pos = torch.arange(ck)
    for ki, (kblk, vblk) in enumerate(tiles):
        valid = (ki * ck + pos)[None, :] < length[:, None]
        state = TA._tile_step(state, qf, kblk, vblk, valid, TA._sqrt_d(d))
    return state


def _phased(q, tiles, length, hkv, d):
    """The kernels' order, with the plain version's per-tile ops on the same
    shapes: all scores; tile maxima and the prefix max; e and the tile sums;
    the l chain, p and fac; all p.V; acc folded in tile order. Every tile is
    walked, those wholly past the length too."""
    B, H, D = q.shape
    rep, n, ck = H // hkv, len(tiles), tiles[0][0].shape[1]
    qf = q.reshape(B, hkv, rep, D).to(torch.float32)
    sqrt_d = TA._sqrt_d(d)
    m, l, acc = TA._init_state(B, hkv, rep, D, q.device)
    pos = torch.arange(ck)
    s = []
    for ki, (kblk, _) in enumerate(tiles):                       # all scores
        valid = (ki * ck + pos)[None, :] < length[:, None]
        sk = torch.einsum("bgrd,bkgd->bgrk", qf, kblk.to(torch.float32)) / sqrt_d
        s.append(torch.where(valid[:, None, None, :], sk, TA.NEG_INF))
    mx = [torch.amax(sk, dim=-1, keepdim=True) for sk in s]      # tile maxima
    ms = []
    for ki in range(n):                                          # prefix max
        m_new = torch.maximum(m, mx[ki])
        ms.append((m, m_new))
        m = m_new
    e = [torch.exp(s[ki] - ms[ki][1]) for ki in range(n)]
    sums = [torch.sum(ek, dim=-1, keepdim=True) for ek in e]
    ps, facs = [], []
    for ki in range(n):                                          # l chain, p
        corr = torch.exp(ms[ki][0] - ms[ki][1])
        l_new = l * corr + sums[ki]
        ps.append((e[ki] / l_new).to(torch.bfloat16))
        facs.append(l * corr / l_new)
        l = l_new
    pvs = [torch.einsum("bgrk,bkgd->bgrd", ps[ki].to(torch.float32),
                        tiles[ki][1].to(torch.float32)) for ki in range(n)]
    for ki in range(n):                                          # ordered sum
        acc = acc * facs[ki] + pvs[ki]
    return m, l, acc


def _assert_bitwise(got, want):
    for name, a, b in zip(("m", "l", "acc"), got, want):
        assert torch.equal(a.isnan(), b.isnan()), name
        ok = ~a.isnan()
        assert torch.equal(a[ok].view(torch.int32), b[ok].view(torch.int32)), name


@pytest.mark.parametrize("P, hkv, rep, d", [(16, 2, 1, 64), (16, 2, 2, 64),
                                            (8, 4, 2, 32), (32, 2, 1, 128)])
def test_phased_order_is_bitwise_the_recurrence_paged(P, hkv, rep, d):
    q, kp, vp, pages, length = _paged_case(20 + d + rep, P, hkv, rep, d)
    tiles = _paged_tiles(kp, vp, pages, hkv, d)
    want = _recurrence(q, tiles, length, hkv, d)
    got = _phased(q, tiles, length, hkv, d)
    _assert_bitwise(got, want)
    nan_slots = got[2].isnan().flatten(1).any(1).tolist()
    # scratch page 0 holds a NaN V scale: slots 2, 3 (trailing entries) and
    # 4 (length 0) hold it; slot 5 holds page 15 past its length
    assert nan_slots == [False, False, True, True, True, True]
    plain = TA.fused_paged_decode_attention(q, kp, vp, pages, length,
                                            n_kv_heads=hkv, d_head=d)
    out = got[2].reshape(plain.shape).to(torch.bfloat16)
    assert torch.equal(plain.isnan(), out.isnan())
    ok = ~out.isnan()
    assert torch.equal(plain[ok].view(torch.int16), out[ok].view(torch.int16))


@pytest.mark.parametrize("hkv, rep, d, S, ck", [(2, 1, 64, 128, 32), (4, 2, 32, 96, 16)])
def test_phased_order_is_bitwise_the_recurrence_contiguous(hkv, rep, d, S, ck):
    """Capacity past the length (a solo serve's cache), NaN V in a masked
    token of a partly valid tile and in a tile wholly past the length, and
    a slot of length 0."""
    rng = np.random.default_rng(30 + d)
    B = 5
    kv = lambda: TK.to_kernel_layout(TK.quantize_kv(_t(
        (rng.standard_normal((B, S, hkv, d)) * 0.5).astype(np.float32)).to(torch.bfloat16)))
    kc, vc = kv(), kv()
    length = torch.tensor([S, ck + 3, 1, 0, 2 * ck], dtype=torch.int32)
    vc["meta"][1, 0, ck + 5] |= NAN_SCALE        # masked token, partly valid tile
    vc["meta"][2, 0, S - 1] |= NAN_SCALE         # a tile wholly past the length
    kc["meta"][4, 0, 3 * ck] |= NAN_SCALE        # K there: masked, no effect
    q = _t((rng.standard_normal((B, hkv * rep, d)) * 0.5).astype(np.float32)
           ).to(torch.bfloat16)
    tiles = _contiguous_tiles(kc, vc, ck, hkv, d)
    got = _phased(q, tiles, length, hkv, d)
    _assert_bitwise(got, _recurrence(q, tiles, length, hkv, d))
    assert got[2].isnan().flatten(1).any(1).tolist() == [False, True, True,
                                                         False, False]


def test_phased_order_walks_on_where_no_score_passes_minus_1e30():
    """Scores all at or below -1e30 leave the running max at -1e30, where a
    masked token weighs exp(0) = 1 in the reference: the body, walking every
    tile, keeps its bits."""
    rng = np.random.default_rng(40)
    B, S, hkv, d, ck = 2, 64, 2, 64, 16
    k = np.zeros((B, S, hkv, d), np.float32)
    k[..., 0] = 1.0
    kc = TK.to_kernel_layout(TK.quantize_kv(_t(k).to(torch.bfloat16)))
    vc = TK.to_kernel_layout(TK.quantize_kv(_t(
        (rng.standard_normal((B, S, hkv, d)) * 0.5).astype(np.float32)).to(torch.bfloat16)))
    q = np.zeros((B, hkv, d), np.float32)
    q[0, :, 0] = -3e38                          # slot 0: scores -inf
    q[1, :, 0] = 1.0                            # slot 1: ordinary
    q = _t(q).to(torch.bfloat16)
    length = torch.tensor([20, 20], dtype=torch.int32)
    tiles = _contiguous_tiles(kc, vc, ck, hkv, d)
    got = _phased(q, tiles, length, hkv, d)
    _assert_bitwise(got, _recurrence(q, tiles, length, hkv, d))
    assert bool((got[0][0] == TA.NEG_INF).all())


def test_phased_order_within_tolerance_of_the_jax_reference():
    """The slice as a whole: the phased order on the ragged table against
    the reference's paged XLA twin, NaN where it has NaN."""
    P, hkv, rep, d = 16, 2, 2, 64
    q, kp, vp, pages, length = _paged_case(50, P, hkv, rep, d)
    tiles = _paged_tiles(kp, vp, pages, hkv, d)
    got = _phased(q, tiles, length, hkv, d)[2].reshape(q.shape).to(torch.bfloat16)
    def to_jax(pool):
        return {key: jnp.asarray(interop.to_numpy(a, uint32=key == "meta"))
                for key, a in pool.items()}

    oj = np.asarray(jax.jit(JA.fused_paged_decode_attention_xla,
                            static_argnums=(5, 6))(
        jnp.asarray(interop.to_numpy(q)).astype(jnp.bfloat16), to_jax(kp),
        to_jax(vp), jnp.asarray(pages.numpy()), jnp.asarray(length.numpy()),
        hkv, d).astype(jnp.float32))
    ot = got.float().numpy()
    assert np.array_equal(np.isnan(ot), np.isnan(oj))
    ok = ~np.isnan(oj)
    np.testing.assert_allclose(ot[ok], oj[ok], rtol=2 ** -7, atol=1e-3)
    assert JK.page_nbytes(hkv, d, P, 1) == TK.page_nbytes(hkv, d, P, 1)
