"""Kernel 5's decode regime and its decode form (the LM head's route), on
the CPU: the parts of ``csrc/group_matmul_decode.cuh`` that Python can
reach. The body itself runs only on the card (``tests/test_torch_cuda.py``).

* ``kernels.ops.matmul`` at M <= 32 takes the decode form
  (``bfp_decode_matmul``: kernel 1 on x, then kernel 5 with the weight's
  Algorithm 1 in its loader); its plain route equals the JAX
  ``repro.kernels.ops.matmul(interpret=True)`` within rtol=1e-6, atol=1e-6
  (the tolerance of ``test_ops_matmul_and_prequantized_match_reference``:
  the reference sums its groups in another f32 order) and is bitwise the
  port's composition kernel 1 twice, then kernel 5.
* ``decode_matmul_plan``: row slots, ring stages, warps, CTAs per SM, grid
  and shared bytes, mirrored from the C++ constants; refusals.
* A mirror of the body in numpy: the lane map (lane l holds ints 32 l ..
  32 l + 31 of a chunk of 1024), Algorithm 1's layout (kernel 1's 8 lanes
  per group, 4 passes a chunk) through the staging row to that map, the
  lane pair's fold (whole group dots, half the rows each), the term tile
  (free of bank conflicts at 8 rows), and the whole walk (persistent warps
  over whole columns, the group-order sum per row) bitwise kernel 5's plain
  version, at ragged N, K/64 = 5 and K over two chunks.
* The engine's dense pallas route: kernel 1 + the decode form at M <= 32,
  kernel 1 twice + kernel 5 above; the dispatch report and the launcher's
  line.
"""
import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro_torch import interop
from repro_torch.core import engine
from repro_torch.core.qlinear import QuantConfig
from repro_torch.kernels import bfp_matmul as TB
from repro_torch.kernels import build
from repro_torch.kernels import hif4_quant as TQ
from repro_torch.kernels import ops as TO
from repro_torch.launch import serve as launcher

torch.set_num_threads(1)

OPS_SHAPES = [(64, 96), (320, 1000), (1024, 256)]          # (K, N)


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), "cpu")


def _rand(seed, shape, scale):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bits(t):
    return t.view(torch.int32)


# ---------------------------------------------------------------------------
# the plain route against the reference and the port's composition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k, n", OPS_SHAPES)
@pytest.mark.parametrize("m", [1, 8, 32])
def test_ops_matmul_decode_route_matches_reference(m, k, n):
    x, w = _rand(m + k, (m, k), 0.5), _rand(n + 1, (k, n), 0.05)
    yj = JO.matmul(jnp.asarray(x), jnp.asarray(w), interpret=True)
    yt = TO.matmul(_t(x), _t(w))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6, atol=1e-6)
    ai, asc = TQ.hif4_quantize(_t(x))
    wi, wsc = TQ.hif4_quantize(_t(w).T.contiguous())
    assert torch.equal(_bits(yt), _bits(TB.bfp_matmul_quantized(ai, asc, wi.T,
                                                                wsc.T)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_form_plain_on_a_transposed_view_is_the_composition(dtype):
    """The tied head's operand: embed.T, a transposed view of (N, K)."""
    embed = _t(_rand(3, (200, 320), 0.02)).to(dtype)
    ai, asc = TQ.hif4_quantize(_t(_rand(4, (8, 320), 1.0)).to(dtype))
    y = TB.bfp_decode_matmul(ai, asc, embed.T)
    wi, wsc = TQ.hif4_quantize(embed)
    assert y.dtype == torch.float32 and y.shape == (8, 200)
    assert torch.equal(_bits(y), _bits(TB.bfp_matmul_quantized_plain(
        ai, asc, wi.T, wsc.T)))
    # a row-major (K, N) weight gives the same bits
    assert torch.equal(_bits(y), _bits(TB.bfp_decode_matmul(
        ai, asc, embed.T.contiguous())))


def test_decode_form_nan_weight_reaches_only_its_column():
    embed = _t(_rand(5, (40, 256), 0.02))
    embed[17, 70] = float("nan")                      # group 1 of column 17
    embed[23, 5] = float("inf")                       # clamps, stays finite
    ai, asc = TQ.hif4_quantize(_t(_rand(6, (8, 256), 1.0)))
    y = TB.bfp_decode_matmul(ai, asc, embed.T)
    want = torch.zeros_like(y, dtype=torch.bool)
    want[:, 17] = True
    assert torch.equal(y.isnan(), want)
    assert bool(y[:, 23].isfinite().all())


def test_decode_form_wrapper_refusals():
    ai, asc = TQ.hif4_quantize(_t(_rand(7, (8, 128), 1.0)))
    w = _t(_rand(8, (128, 16), 0.05))
    with pytest.raises(TypeError):
        TB.bfp_decode_matmul(ai, asc, w.to(torch.float16))
    with pytest.raises(TypeError):
        TB.bfp_decode_matmul(ai.to(torch.int32), asc, w)
    with pytest.raises(ValueError):
        TB.bfp_decode_matmul(ai[:, :64], asc, w)
    with pytest.raises(ValueError):
        TB.bfp_decode_matmul(ai, asc, w[:64])
    with pytest.raises(ValueError):
        TB.bfp_decode_matmul(*(t.to("meta") for t in (ai, asc, w)))
    build.reset_launches()
    TB.bfp_decode_matmul(ai, asc, w)                  # CPU: plain version
    assert sum(build.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loader, stage, stages, staging, most", [
    ("int8", 1024 + 64, 5, 0, 2), ("bf16", 2048, 3, 1024 + 64, 2),
    ("f32", 4096, 3, 1024 + 64, 2)])
@pytest.mark.parametrize("m, rows", [(1, 8), (8, 8), (9, 16), (17, 24),
                                     (32, 32)])
def test_decode_plan_fields(loader, stage, stages, staging, most, m, rows):
    """M rounded up to 8 row slots; per warp a ring of chunks of 1024
    elements (int8 with 16 scales, bf16, f32), a staging row (ints and 16
    scales: the quantizing loaders) and a term tile of 20 floats per row
    slot; 8 warps per CTA; the loader's CTAs per SM or as many as 228 KB
    hold; the launcher's order."""
    plan = TB.decode_matmul_plan(m, 1024, 151936, loader)
    assert (plan.rows, plan.stages, plan.warps) == (rows, stages, 8)
    assert plan.smem_bytes == 8 * (stages * stage + staging + rows * 20 * 4)
    assert plan.smem_bytes % 16 == 0 and stage % 16 == 0
    assert plan.ctas_per_sm == min(most, 233472 // (plan.smem_bytes + 1024))
    assert 1 <= plan.ctas_per_sm and plan.ctas_per_sm * (
        plan.smem_bytes + 1024) <= 228 * 1024
    # the weight in flight per SM: every warp's ring but the chunk in use
    weight = stage - 64 * (loader == "int8")
    assert plan.ctas_per_sm * 8 * (stages - 1) * weight >= 64 * 1024
    assert plan.grid == plan.ctas_per_sm * TB.H100_SMS   # fills the card
    assert tuple(plan.c_plan()) == (rows, stages, 8, plan.ctas_per_sm,
                                    plan.grid, plan.smem_bytes)


@pytest.mark.parametrize("m, n", [(8, 96), (8, 1000), (32, 1000), (1, 1),
                                  (8, 151936), (32, 151936), (17, 4223)])
def test_decode_plan_grid_walks_every_column_once(m, n):
    for loader in ("int8", "bf16", "f32"):
        plan = TB.decode_matmul_plan(m, 320, n, loader)
        warps = plan.grid * plan.warps
        full = plan.ctas_per_sm * TB.H100_SMS
        assert plan.grid == min(-(-n // plan.warps), full)
        assert (plan.grid - 1) * plan.warps < n or plan.grid == full
        walked = np.concatenate([np.arange(w, n, warps) for w in range(warps)])
        assert np.array_equal(np.sort(walked), np.arange(n))
        per_warp = [len(range(w, n, warps)) for w in range(warps)]
        assert max(per_warp) - min(per_warp) <= 1


def test_decode_plan_refusals():
    for m, k, n in [(33, 1024, 1024), (0, 1024, 8), (8, 1000, 64), (8, 0, 64),
                    (8, 64, 0)]:
        with pytest.raises(ValueError):
            TB.decode_matmul_plan(m, k, n)


# ---------------------------------------------------------------------------
# a mirror of the body: the lane maps, Algorithm 1's layout, the walk
# ---------------------------------------------------------------------------

CHUNK, TERM_STRIDE = 1024, 20


def lane_ints(col_ints, chunk, lane):
    """The body's lane map: lane l of a chunk holds ints 32 l .. 32 l + 31
    (zero past K); they are half of group 16 chunk + l / 2."""
    k0 = chunk * CHUNK + 32 * lane
    out = np.zeros(32, np.int8)
    if k0 < col_ints.shape[0]:
        out[:] = col_ints[k0:k0 + 32]
    return out


def half_at(lane, h):
    """Int8B::half_at: byte offset of lane l's 16-byte half h in a stage."""
    return 32 * lane + 16 * (h ^ ((lane >> 2) & 1))


def test_int8_stage_copies_land_where_each_lane_reads_them():
    """Int8B: lane l copies pieces l and l + 32 (16 bytes each, 512
    contiguous bytes per warp instruction) to half_at(i / 2, i % 2); lane l
    then reads its ints 32 l .. 32 l + 31 from half_at(l, 0) and
    half_at(l, 1), 8 lanes a wavefront on distinct groups of 4 banks."""
    col = np.arange(1024, dtype=np.int64).astype(np.uint16)   # K index tags
    stage = np.zeros(1024, np.uint16)
    for lane in range(32):
        for j in range(2):
            i = lane + 32 * j
            at = half_at(i >> 1, i & 1)
            stage[at:at + 16] = col[16 * i:16 * i + 16]
    for lane in range(32):
        got = np.concatenate([stage[half_at(lane, 0):half_at(lane, 0) + 16],
                              stage[half_at(lane, 1):half_at(lane, 1) + 16]])
        assert np.array_equal(got, col[32 * lane:32 * lane + 32])
    for h in range(2):
        for quarter in range(4):
            groups = {(half_at(lane, h) // 16) % 8
                      for lane in range(8 * quarter, 8 * quarter + 8)}
            assert len(groups) == 8


def quantize_chunk(col, chunk):
    """QuantB's layout: pass p gives lane 8 slot + blk the 8 values at 256 p
    + 8 lane of the chunk (kernel 1's: group 4p + slot, block blk), whose
    ints land in the staging row at the same offset and whose group's scale
    lands at 4p + slot; lane l then reads ints 32 l .. and scale l / 2."""
    K = col.shape[0]
    staging = np.zeros(CHUNK, np.int8)
    scales = np.zeros(16, np.float32)
    for p in range(4):
        for lane in range(32):
            k = chunk * CHUNK + 256 * p + 8 * lane
            vals = col[k:k + 8] if k < K else torch.zeros(8, dtype=col.dtype)
            # the lane's group, quantized by kernel 1 (8 lanes together)
            g0 = (k // 64) * 64
            grp = col[g0:g0 + 64] if k < K else torch.zeros(64, dtype=col.dtype)
            ints, sc = TQ.absorbed_activation(grp.reshape(1, 64))
            assert torch.equal(grp[8 * (lane & 7):8 * (lane & 7) + 8], vals)
            staging[256 * p + 8 * lane:256 * p + 8 * lane + 8] = \
                ints[0, 8 * (lane & 7):8 * (lane & 7) + 8].numpy()
            if lane & 7 == 0:
                scales[4 * p + (lane >> 3)] = sc[0, 0].item()
    return [(staging[32 * lane:32 * lane + 32], scales[lane // 2])
            for lane in range(32)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [320, 1024, 2048 + 192])
def test_quantize_chunk_gives_each_lane_kernel_1s_ints(dtype, k):
    col = torch.from_numpy(_rand(k, (k,), 0.3)).to(dtype)
    col[5] = 40.0                                     # a group with E1 shifts
    want_i, want_s = TQ.absorbed_activation(col.reshape(1, k))
    want_i = want_i[0].numpy()
    for chunk in range(-(-k // CHUNK)):
        got = quantize_chunk(col, chunk)
        for lane in range(32):
            ints, scale = got[lane]
            g = chunk * 16 + lane // 2
            if chunk * CHUNK + 32 * lane < k:
                assert np.array_equal(ints, lane_ints(want_i, chunk, lane))
                assert np.float32(scale).view(np.int32) == \
                    want_s[0, g].numpy().view(np.int32)


def test_pass4_scale_lanes_cover_every_group_once_and_feed_its_lanes():
    """hif4_quantize_pass4: lane L works out the scale of group (pass L / 8,
    slot L / 2 % 4) from the max shuffled from lane 8 * slot (which holds
    that group's max in its pass-p register); lane 8 * slot + blk of pass p
    takes its group's E6M2 and reciprocal from lane 8 p + 2 slot."""
    computed = {}
    for L in range(32):
        p, s = L // 8, (L // 2) % 4
        src = 8 * ((L >> 1) & 3)
        assert src // 8 == s                          # a lane of that group
        computed.setdefault((p, s), []).append(L)
    assert sorted(computed) == [(p, s) for p in range(4) for s in range(4)]
    assert all(len(lanes) == 2 for lanes in computed.values())
    for p in range(4):
        for lane in range(32):
            own = 8 * p + 2 * (lane >> 3)
            assert own in computed[(p, lane >> 3)]


def fold(dots):
    """The lane pair's shuffle level: dots (32 lanes, R) of half-group
    partials -> (32, R/2): the even lane keeps rows 0 .. R/2-1, the odd one
    rows R/2 .. R-1, each adding the partner's copy."""
    lanes = np.arange(32)
    h = dots.shape[1] // 2
    odd = (lanes & 1)[:, None] == 1
    send = np.where(odd, dots[:, :h], dots[:, h:])
    keep = np.where(odd, dots[:, h:], dots[:, :h])
    return keep + send[lanes ^ 1]


@pytest.mark.parametrize("rows", [8, 16, 24, 32])
def test_fold_leaves_each_lane_whole_group_dots(rows):
    part = np.random.default_rng(rows).integers(-25088, 25089, (32, rows))
    got = fold(part)
    for lane in range(32):
        pair = part[lane & ~1] + part[lane | 1]       # the group's dots
        h = rows // 2
        assert np.array_equal(got[lane], pair[(lane & 1) * h:(lane & 1) * h + h])


def test_term_tile_is_free_of_bank_conflicts_at_8_rows():
    """Every term store of the 8-slot fold (even lanes rows i, odd lanes
    rows 4 + i, at group l / 2) hits 32 distinct banks; lane r's 16-byte
    reads of its row, 8 lanes a wavefront, hit distinct groups of 4 banks."""
    for i in range(4):
        banks = {((((lane & 1) * 4 + i) * TERM_STRIDE) + lane // 2) % 32
                 for lane in range(32)}
        assert len(banks) == 32
    for j in range(4):
        groups = {((r * TERM_STRIDE * 4 + 16 * j) // 16) % 8 for r in range(8)}
        assert len(groups) == 8


def decode_body(ai, asc, b_nk, bsc_nk, plan):
    """The decode body's order of operations in numpy: every warp of the
    persistent grid walks its columns, chunk by chunk; lane l dots its 32
    ints with each row's (8 __dp4a), the pair fold gives whole group dots,
    the lane writes (float(dot) * a_scale) * b_scale into the term tile,
    and lane r adds row r's terms of the chunk in group order to its
    running sum, stored after the column's last chunk."""
    M, K = ai.shape
    N, G = bsc_nk.shape
    f = np.float32
    chunks = -(-K // CHUNK)
    warps = plan.grid * plan.warps
    R, H = plan.rows, plan.rows // 2
    out = np.full((M, N), np.nan, np.float32)
    written = np.zeros((M, N), np.int64)
    a = ai.numpy()
    for w in range(min(warps, N)):
        for n in range(w, N, warps):
            acc = np.zeros(32, np.float32)
            for c in range(chunks):
                part = np.zeros((32, R), np.int64)
                for lane in range(32):
                    wl = lane_ints(b_nk[n], c, lane).astype(np.int64)
                    for r in range(M):
                        part[lane, r] = lane_ints(a[r], c, lane).astype(
                            np.int64) @ wl
                dots = fold(part)
                terms = np.zeros((R, TERM_STRIDE), np.float32)
                for lane in range(32):
                    g = c * 16 + lane // 2
                    for i in range(H):
                        row = (lane & 1) * H + i
                        live = row < M and g < G
                        as_ = f(asc[row, g]) if live else f(0)
                        bs = f(bsc_nk[n, g]) if g < G else f(0)
                        terms[row, lane // 2] = f(f(f(dots[lane, i]) * as_) * bs)
                for r in range(M):
                    for j in range(min(16, G - 16 * c)):
                        acc[r] = f(acc[r] + terms[r, j])
            out[:, n] = acc[:M]
            written[:, n] += 1
    assert (written == 1).all()
    return torch.from_numpy(out)


@pytest.mark.parametrize("m, k, n", [(1, 320, 21), (8, 320, 40), (17, 128, 9),
                                     (32, 128, 5), (8, 2048 + 192, 3)])
def test_body_mirror_is_bitwise_the_plain_version(m, k, n):
    ai, asc = TQ.hif4_quantize(_t(_rand(m, (m, k), 1.0)))
    wi, wsc = TQ.hif4_quantize(_t(_rand(n, (n, k), 0.02)))
    plan = TB.decode_matmul_plan(m, k, n, "int8")
    got = decode_body(ai, asc.numpy(), wi.numpy(), wsc.numpy(), plan)
    want = TB.bfp_matmul_quantized_plain(ai, asc, wi.T, wsc.T)
    assert torch.equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# the engine's dense pallas route, the dispatch report, the launcher
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded(monkeypatch):
    """Record which kernel wrappers kernels.ops calls, with the rows."""
    calls = []
    for name in ("hif4_quantize", "bfp_decode_matmul", "bfp_matmul_quantized"):
        real = getattr(TO, name)

        def spy(*args, _real=real, _name=name):
            calls.append((_name, args[0].shape[0]))
            return _real(*args)

        monkeypatch.setattr(TO, name, spy)
    yield calls


@pytest.mark.parametrize("rows, want", [
    (8, [("hif4_quantize", 8), ("bfp_decode_matmul", 8)]),
    (32, [("hif4_quantize", 32), ("bfp_decode_matmul", 32)]),
    (40, [("hif4_quantize", 40), ("hif4_quantize", 96),
          ("bfp_matmul_quantized", 40)])])
def test_engine_dense_pallas_route_by_rows(rows, want, monkeypatch):
    embed = _t(_rand(11, (96, 256), 0.02)).to(torch.bfloat16)
    x = _t(_rand(12, (2, rows // 2, 256), 1.0)).to(torch.bfloat16)
    ectx = engine.EngineCtx(QuantConfig(fmt="hif4", impl="pallas"))
    with recorded(monkeypatch) as calls:
        y = engine.matmul(x, embed.T, ectx)
    assert calls == want
    ai, asc = TQ.hif4_quantize(x.reshape(rows, 256))
    wi, wsc = TQ.hif4_quantize(embed)
    ref = TB.bfp_matmul_quantized_plain(ai, asc, wi.T, wsc.T).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y.reshape(rows, 96).view(torch.int16), ref.view(torch.int16))


def test_dense_dispatch_info_names_the_route():
    q = QuantConfig(fmt="hif4", impl="pallas")
    info = engine.dense_dispatch_info(q, 1024, 151936, m=8, device="cuda")
    assert info["pallas"] and "bfp_decode_matmul" in info["route"]
    plan = TB.decode_matmul_plan(8, 1024, 151936, "bf16")
    assert info["plan"] == (plan.rows, plan.stages, plan.ctas_per_sm,
                            plan.grid)
    info = engine.dense_dispatch_info(q, 1024, 151936, m=40, device="cuda")
    assert "hif4_quantize on x and on w.T" in info["route"]
    assert "bfp_matmul_quantized" in info["route"]
    assert info["plan"] == TB.cuda_tiles(40)
    cpu = engine.dense_dispatch_info(q, 1024, 151936, m=8, device="cpu")
    assert cpu["pallas"] and cpu["route"] is None
    for off in (QuantConfig(fmt="hif4", impl="packed"),
                QuantConfig(fmt="nvfp4", impl="pallas"),
                QuantConfig(fmt="hif4", impl="pallas", weights_only=True)):
        assert not engine.dense_dispatch_info(off, 1024, 64, m=8,
                                              device="cuda")["pallas"]


def test_launcher_prints_the_head_route(tmp_path):
    pol = tmp_path / "head.json"
    pol.write_text(json.dumps({
        "name": "hif4-with-head", "kv_format": "hif4",
        "rules": [{"pattern": "*", "fmt": "hif4"},
                  {"pattern": "embed", "fmt": "none"},
                  {"pattern": "*.router", "fmt": "none"}]}))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launcher.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                            "cpu", "--batch", "2", "--prompt-len", "8",
                            "--new-tokens", "2", "--impl", "pallas",
                            "--kv-format", "hif4", "--policy", str(pol)])
    text = out.getvalue()
    assert rc == 0
    lines = text.splitlines()
    head = [i for i, ln in enumerate(lines) if ln.startswith("dense matmul (lm_head):")]
    packed = [i for i, ln in enumerate(lines) if ln.startswith("packed matmul:")]
    assert len(head) == 1 and packed == [head[0] - 1]
    assert "plain PyTorch fixed-point contraction (CPU)" in lines[head[0]]
