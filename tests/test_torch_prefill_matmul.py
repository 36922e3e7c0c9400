"""Kernel 2's prefill form and kernel 5 above 32 rows, on the CPU: the parts
of the tensor-core body (``csrc/group_matmul_sm90.cuh``) that Python can
reach. The body itself runs only on the card (``tests/test_torch_cuda.py``).

* ``prefill_plan``: 128 x 128 output tiles, a ring of 6 one-group stages
  with 4 in flight, the shared bytes of both loaders within 227 KB, a grid
  that covers every (M, N) the tests and the main path use; refusals.
* A mirror of the B tile, emulated in numpy thread by thread: kernel 2's
  producers stage 32 code rows and the meta words of a 128-column tile,
  then expand them (prmt table lookups per quad of codes, the column order
  rotated per thread, the 64-byte swizzle); read back through the wgmma
  descriptor's address map the tile is ``hif4.absorbed_int_km``, bitwise,
  on random packed weights and on every code and meta bit pattern (NaN
  scales and a ragged N edge included). Kernel 5's copies and the A tile
  land where the descriptor reads them, and the consumers' fragments cover
  the output tile once.
* The promotion's int -> float is exact for every |dot| <= 64 * 28 * 28.
* ``out_dtype``: the plain path's bf16 is bitwise ``.to()`` of its f32; the
  engine's bits are unchanged.
* The plain prefill form against the JAX reference's XLA twin and its
  interpret-mode Pallas kernel at M > 32: within 1e-6 of the summed group
  magnitudes (only the f32 order of the sum over groups may differ; the
  int32 group partials are bitwise, ``tests/test_torch_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qlinear import PackedW as JPackedW
from repro.kernels import fused_matmul as JM
from repro_torch import interop
from repro_torch.core import engine, hif4
from repro_torch.core.qlinear import PackedW, QuantConfig
from repro_torch.kernels import bfp_matmul as TB
from repro_torch.kernels import fused_matmul as TM
from repro_torch.kernels import hif4_quant as TQ

torch.set_num_threads(1)

TILE_M, TILE_N = TB.PREFILL_TILE_M, TB.PREFILL_TILE_N
# every (M, K, N) the cuda tests and chip_smoke.py give the prefill body
PREFILL_SHAPES = [(3840, 1024, 1024), (3840, 1024, 2816), (3840, 2816, 1024),
                  (33, 1024, 1024), (33, 320, 1000), (300, 320, 1000),
                  (37, 320, 1000), (129, 192, 136), (300, 2816, 1024),
                  (40, 1024, 2816), (300, 1024, 2816), (300, 256, 200),
                  (40, 256, 64)]


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), "cpu")


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loader, stage, smem", [("packed", 22528, 136320),
                                                 ("int8", 17408, 105600)])
def test_plan_stages_and_shared_bytes(loader, stage, smem):
    """A stage holds one group: A and B tiles of 64 B a row, 4 B of scale
    per row and column, and kernel 2's 32 code rows + meta words; rounded
    to 1024 B, six of them, 1024 B of base alignment and the mbarriers."""
    plan = TB.prefill_plan(3840, 1024, 2816, loader)
    assert (plan.tile_m, plan.tile_n) == (128, 128)
    assert (plan.stages, plan.lookahead) == (6, 4)
    assert plan.lookahead <= plan.stages - 2      # no wait on a stage in use
    raw = {"packed": 32 * TILE_N + 4 * TILE_N, "int8": 0}[loader]
    assert plan.stage_bytes == -(-((128 + 128) * (64 + 4) + raw) // 1024) * 1024
    assert plan.stage_bytes == stage and plan.smem_bytes == smem
    assert plan.smem_bytes <= TB.SMEM_PER_CTA_MAX == 227 * 1024
    # the launcher's kPlanFields ints, in its order
    assert tuple(plan.c_plan()) == (128, 128, 6, 4, stage, smem)


@pytest.mark.parametrize("m, k, n", PREFILL_SHAPES)
def test_plan_grid_covers_every_output_once(m, k, n):
    for loader in ("packed", "int8"):
        plan = TB.prefill_plan(m, k, n, loader)
        # the launcher's grid: (ceil(N / tile_n), ceil(M / tile_m))
        gn, gm = -(-n // plan.tile_n), -(-m // plan.tile_m)
        assert (gn - 1) * TILE_N < n <= gn * TILE_N
        assert (gm - 1) * TILE_M < m <= gm * TILE_M
        assert plan.smem_bytes <= TB.SMEM_PER_CTA_MAX


def test_plan_refusals_and_tiles_report():
    for m, k, n in [(32, 1024, 1024), (64, 1000, 64), (64, 0, 64), (64, 64, 0)]:
        with pytest.raises(ValueError):
            TB.prefill_plan(m, k, n)
    assert TB.cuda_tiles(33) == TB.cuda_tiles(3840) == (128, 128, 6)
    assert TB.cuda_tiles(8) == (16, 32, 4) and TB.cuda_tiles(32) == (32, 32, 4)


# ---------------------------------------------------------------------------
# a mirror of the tiles: the producers' copies and expansion, the
# descriptor's reads
# ---------------------------------------------------------------------------


def sw64(row, chunk):
    """csrc/group_matmul_sm90.cuh::sw64: the byte of (row, 16-byte chunk)."""
    return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4)


def descriptor_read(row, k):
    """The byte a wgmma operand descriptor (K-major, 64-byte swizzle, 8-row
    groups 512 B apart) reads for (row, k) of a tile at a 1024-aligned
    base; the second k32 step's start address is 32 bytes on, which is the
    same map at k + 32: address bits [4, 6) xor bits [7, 9)."""
    addr = row * 64 + k
    return addr ^ (((addr >> 7) & 3) << 4)


def prmt(a, b, c):
    """PTX prmt.b32 (default mode) on uint32 arrays: byte i of the result is
    byte (c >> 4i) & 7 of {b, a}, or its sign bit replicated where bit 3 of
    that selector nibble is set."""
    src = a.astype(np.uint64) | (b.astype(np.uint64) << np.uint64(32))
    out = np.zeros(np.broadcast(a, b, c).shape, np.uint64)
    c = c.astype(np.uint64)
    for i in range(4):
        sel = (c >> np.uint64(4 * i)) & np.uint64(0xF)
        byte = (src >> (np.uint64(8) * (sel & np.uint64(7)))) & np.uint64(0xFF)
        rep = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        byte = np.where(sel & np.uint64(8), rep, byte)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def byte_perm(a, b, c):
    """CUDA __byte_perm: bits [2:0] of each selector nibble only."""
    return prmt(a, b, c & np.uint32(0x7777))


def absorbed_quad(codes, s):
    """fused_matmul.cu::absorbed_quad on uint32 arrays."""
    p = prmt(np.uint32(0x03020100), np.uint32(0x07060504), codes)
    n = prmt(np.uint32(0x03020100), np.uint32(0x07060504), codes ^ np.uint32(0x8888))
    s = s.astype(np.uint64)
    out = ((p.astype(np.uint64) << s) + np.uint64(0x80808080)
           - (n.astype(np.uint64) << s)) & np.uint64(0xFFFFFFFF)
    return (out ^ np.uint64(0x80808080)).astype(np.uint32)


def stage_packed(codes_km, meta_km, n0, g):
    """PackedB::issue: the raw stage of group g, columns n0.., zero past N:
    32 code rows of 128 bytes, then 128 meta words."""
    half, n = codes_km.shape
    cols = np.arange(n0, n0 + TILE_N)
    ok = cols < n
    rows = codes_km[g * 32:(g + 1) * 32][:, np.minimum(cols, n - 1)]
    codes = np.where(ok[None, :], rows, 0).astype(np.uint8)
    meta = np.where(ok, meta_km[g][np.minimum(cols, n - 1)], 0).astype(np.uint32)
    return codes, meta


def expand_packed(codes, meta):
    """PackedB::expand by the 128 producer threads: thread t takes columns
    4q..4q+3 (q = t % 32) over code rows 8rb..8rb+7 (rb = t / 32), in the
    order rotated by q / 2, and writes each column's 16 bytes to its
    swizzled chunk rb. Returns the B tile's 8 KB and how often each byte
    was written."""
    tile = np.zeros(TILE_N * 64, np.uint8)
    written = np.zeros(TILE_N * 64, np.int64)
    words = codes.reshape(32, TILE_N // 4, 4).copy().view("<u4")[..., 0]
    t = np.arange(128)
    q, rb = t & 31, t >> 5
    w = [words[8 * rb + r, q] for r in range(8)]
    for i in range(4):
        x = ((i + (q >> 1)) & 3).astype(np.uint32)
        c = 4 * q + x
        sel = x | ((x + 4) << 4)
        w0 = byte_perm(byte_perm(w[0], w[1], sel), byte_perm(w[2], w[3], sel),
                       np.uint32(0x5410))
        w1 = byte_perm(byte_perm(w[4], w[5], sel), byte_perm(w[6], w[7], sel),
                       np.uint32(0x5410))
        m = meta[c]
        e16 = m >> (4 * rb).astype(np.uint32)
        e8 = m >> (16 + 2 * rb).astype(np.uint32)
        quads = [absorbed_quad(w0, (e16 & 1) + (e8 & 1)),
                 absorbed_quad(w0 >> 16, ((e16 >> 1) & 1) + (e8 & 1)),
                 absorbed_quad(w1, ((e16 >> 2) & 1) + ((e8 >> 1) & 1)),
                 absorbed_quad(w1 >> 16, ((e16 >> 3) & 1) + ((e8 >> 1) & 1))]
        chunk = np.stack(quads, axis=-1).astype("<u4").view(np.uint8)  # (128, 16)
        dst = sw64(c, rb)[:, None] + np.arange(16)[None, :]
        tile[dst] = chunk
        written[dst] += 1
    return tile, written


def _read_tile(tile):
    """(128, 64) int8 as the descriptor reads the tile: (row, k)."""
    rows, ks = np.meshgrid(np.arange(TILE_N), np.arange(64), indexing="ij")
    return tile[descriptor_read(rows, ks)].view(np.int8)


def test_writer_and_descriptor_agree_on_every_byte():
    rows, ks = np.meshgrid(np.arange(TILE_N), np.arange(64), indexing="ij")
    write = sw64(rows, ks >> 4) + (ks & 15)
    assert np.array_equal(write, descriptor_read(rows, ks))
    assert np.array_equal(np.sort(write.ravel()), np.arange(TILE_N * 64))


def _check_expansion(codes_km, meta_km):
    """Every column tile and group of a packed weight, through the mirror,
    against hif4.absorbed_int_km (ints bitwise; columns past N zero)."""
    want_i, _ = hif4.absorbed_int_km(torch.from_numpy(codes_km.view(np.uint8)),
                                      torch.from_numpy(meta_km.view(np.int32)))
    want_i = want_i.numpy()
    half, n = codes_km.shape
    for g in range(half // 32):
        for n0 in range(0, n, TILE_N):
            codes, meta = stage_packed(codes_km, meta_km, n0, g)
            tile, written = expand_packed(codes, meta)
            assert (written == 1).all()               # each byte once
            got = _read_tile(tile)                    # (column, k)
            cols = min(TILE_N, n - n0)
            assert np.array_equal(got[:cols], want_i[g * 64:(g + 1) * 64,
                                                     n0:n0 + cols].T)
            assert not got[cols:].any()


@pytest.mark.parametrize("k, n", [(128, 256), (320, 1000), (64, 130)])
def test_expansion_mirror_is_absorbed_int_on_every_bit_pattern(k, n):
    """Random code bytes (all 16 codes, -0 included) and random meta words
    (every shift pattern; E6M2 0xFF among them)."""
    rng = np.random.default_rng(k + n)
    codes = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    meta = rng.integers(0, 2 ** 32, (k // 64, n), dtype=np.uint64).astype(np.uint32)
    meta[0, 3] |= np.uint32(0xFF << 24)
    _check_expansion(codes, meta)


def test_expansion_mirror_on_a_packed_weight():
    g = torch.Generator().manual_seed(30)
    w = (torch.randn(256, 300, generator=g) * 0.02).to(torch.bfloat16)
    pw = PackedW.from_dense(w).to_kernel_layout()
    _check_expansion(pw.codes.numpy(), pw.meta.numpy().view(np.uint32))


def test_meta_scale_matches_expand_meta():
    """The tile's b scales: csrc's meta_scale (2^(E-50) * (1 + M/4), NaN for
    0xFF) against hif4.expand_meta_km, over every E6M2 code."""
    codes = np.arange(256, dtype=np.uint32)
    meta = (codes << 24).astype(np.uint32)
    e, mant = (codes >> 2).astype(np.int64), codes & 3
    mirror = (np.ldexp(1.0, e - 50) * (1 + mant / 4)).astype(np.float32)
    mirror[codes == 0xFF] = np.nan
    _, scale = hif4.expand_meta_km(torch.from_numpy(meta.view(np.int32))[None])
    np.testing.assert_array_equal(scale.numpy()[0], mirror)


@pytest.mark.parametrize("tile", ["A", "B"])
def test_int8_copies_and_a_tile_land_where_the_descriptor_reads(tile):
    """Int8B::issue (the B tile's 128 columns) and stage_a (the A tile's 128
    rows): piece i = t + 128 j of 128 threads is row (or column) i / 4,
    chunk i % 4 of a K-contiguous 64-byte row; the wgmma of m64 tile u
    reads rows 64u.. from a start 64u x 64 bytes on (a multiple of 512)."""
    rows = {"A": TILE_M, "B": TILE_N}[tile]
    rng = np.random.default_rng(31)
    want = rng.integers(-28, 29, (rows, 64), dtype=np.int8)
    smem = np.zeros(rows * 64, np.uint8)
    for t in range(128):
        for j in range(rows * 4 // 128):
            i = t + 128 * j
            r, ch = i >> 2, i & 3
            smem[sw64(r, ch):sw64(r, ch) + 16] = want[r, 16 * ch:16 * ch + 16].view(np.uint8)
    for u in range(rows // 64):
        start = u * 64 * 64
        assert start % 512 == 0
        part = smem[start:start + 64 * 64]
        r, k = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        assert np.array_equal(part[descriptor_read(r, k)].view(np.int8),
                              want[64 * u:64 * u + 64])


def test_consumer_fragments_cover_the_output_tile_once():
    """Consumer warpgroup wg (of 2), warp w, lane l holds d[4j + {0..3}] at
    rows r0, r0 + 8 (r0 = 64 wg + 16 w + l / 4) and columns 8j + 2 (l % 4)
    + {0, 1}; its wgmma reads A rows 64 wg.. from a start 64 wg x 64 bytes
    on, a multiple of 512, so the swizzle phase is the tile's."""
    seen = np.zeros((TILE_M, TILE_N), np.int64)
    for tid in range(256):
        wg, lane = tid >> 7, tid & 31
        assert (wg * 64 * 64) % 512 == 0
        r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2)
        for j in range(TILE_N // 8):
            c = 8 * j + 2 * (lane & 3)
            for r in (r0, r0 + 8):
                seen[r, c:c + 2] += 1
    assert (seen == 1).all()


def test_every_group_dot_converts_exactly():
    """The promotion converts each int32 dot with __int2float_rn, exact for
    |dot| < 2^24; a group's |dot| is at most 64 * 28 * 28. The bits of
    1.5 * 2^23 + dot less 1.5 * 2^23, the other exact spelling (timed
    against it on the card), agree on every such dot."""
    v = np.arange(-(64 * 28 * 28), 64 * 28 * 28 + 1, dtype=np.int64)
    assert np.array_equal(v.astype(np.float32).astype(np.int64), v)
    bits = (v + 0x4B400000).astype(np.uint32)
    np.testing.assert_array_equal(bits.view(np.float32) - np.float32(12582912.0),
                                  v.astype(np.float32))


# ---------------------------------------------------------------------------
# out_dtype, and the plain prefill form against the reference
# ---------------------------------------------------------------------------


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)) * np.exp2(rng.uniform(-8, 8, (m, k // 64))
                                              ).repeat(64, axis=1)
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.02).astype(np.float32))
    pw = PackedW.from_dense(w.to(torch.bfloat16)).to_kernel_layout()
    return x, pw


@pytest.mark.parametrize("m, k, n", [(40, 256, 96), (33, 320, 100), (8, 128, 64)])
def test_out_dtype_is_the_cast_of_the_f32_result(m, k, n):
    x, pw = _operands(32, m, k, n)
    ai, asc = TQ.hif4_quantize(x)
    y32 = TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta)
    y16 = TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta, torch.bfloat16)
    assert y32.dtype == torch.float32 and y16.dtype == torch.bfloat16
    assert torch.equal(y16.view(torch.int16), y32.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(y16.view(torch.int16), TM.fused_packed_matmul_plain(
        ai, asc, pw.codes, pw.meta, torch.bfloat16).view(torch.int16))
    with pytest.raises(TypeError):
        TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta, torch.float16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_engine_prefill_linear_bits_unchanged(dtype):
    """The engine now asks the kernel for x's dtype: the same bits as the
    f32 result cast afterwards."""
    x, pw = _operands(33, 48, 256, 80)
    x = x.to(dtype).reshape(2, 24, 256)
    y = engine.matmul(x, pw, engine.EngineCtx(QuantConfig(fmt="hif4",
                                                          impl="packed")))
    ai, asc = TQ.hif4_quantize(x.reshape(48, 256))
    ref = TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta).to(dtype)
    assert y.dtype == dtype
    assert torch.equal(y.reshape(48, 80), ref)


def _jax_operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)) * np.exp2(rng.uniform(-10, 10, (m, k // 64))
                                              ).repeat(64, axis=1)
    x = jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
    w = jnp.asarray((rng.standard_normal((k, n)) * 0.02).astype(np.float32))
    pw = jax.jit(lambda a: JPackedW.from_dense(a).to_kernel_layout())(w)
    return x, pw


def _assert_close(yt, yj, ai, asc, codes, meta):
    b_ints, b_sc = hif4.absorbed_int_km(codes, meta)
    abs_sum = TB.bfp_matmul_quantized_plain(ai.abs(), asc.abs(), b_ints.abs(),
                                            b_sc.abs()).numpy()
    assert (np.abs(yt - yj) <= 1e-6 * abs_sum).all()


@pytest.mark.parametrize("m, k, n", [(40, 256, 96), (33, 320, 72), (130, 128, 136)])
def test_plain_prefill_form_vs_reference_xla_twin(m, k, n):
    x, pw = _jax_operands(34 + m, m, k, n)
    ai, asc = JM.absorbed_activation(x)               # op by op
    yj = np.asarray(jax.jit(JM.fused_packed_matmul_xla)(ai, asc, pw.codes, pw.meta))
    ta, ts, tc, tm = _t(ai), _t(asc), _t(pw.codes), _t(pw.meta)
    yt = TM.fused_packed_matmul(ta, ts, tc, tm).numpy()
    _assert_close(yt, yj, ta, ts, tc, tm)


def test_plain_prefill_form_vs_interpret_kernel():
    x, pw = _jax_operands(35, 40, 128, 64)
    ai, asc = JM.absorbed_activation(x)
    yj = np.asarray(JM.fused_packed_matmul(ai, asc, pw.codes, pw.meta,
                                           interpret=True))
    ta, ts, tc, tm = _t(ai), _t(asc), _t(pw.codes), _t(pw.meta)
    yt = TM.fused_packed_matmul_plain(ta, ts, tc, tm).numpy()
    _assert_close(yt, yj, ta, ts, tc, tm)
