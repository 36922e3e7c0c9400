"""The five CUDA kernels of the port against their plain PyTorch versions,
on a CUDA card. Every test here carries the ``cuda`` marker and skips
without a card (the kernels have no interpret mode); the file imports no
JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: hif4_quantize bitwise; fused_packed_matmul BITWISE equal to its
plain version (kernel 5's on the expanded weight, then the cast), in f32
and bf16 out, at the decode regime, at qwen1.5-0.5b's three prefill shapes
(M = 3840: the tensor-core body), at M = 33 and 300 and at ragged (M, K,
N) with N % 16 != 0 and K/64 = 5; a NaN meta word reaches only its column
in either body; bfp_matmul_quantized bitwise to its plain version (same
group order, no contracted multiply-add) and to fused_packed_matmul on the
absorbed expansion of a packed weight (one CTA body per regime, at M = 8,
33, 300 and 3840); a NaN scale reaches exactly its row or column in
either body; fused_decode_attention
rtol=2^-7, atol=1e-3 (f32 sum orders and ``expf`` differ from the plain
version); an E6M2 0xFF meta word yields NaN in its slot only, as in the
plain version. fused_paged_decode_attention within the same tolerance of
its plain version, BITWISE equal to fused_decode_attention at
``block_kv = P`` on the same bytes laid out contiguously (one CTA body, two
tile loaders), and NaN metadata in a page reaches exactly the slots whose
tables hold that page. The decode form of kernel 2 with kernel 1 as its
prologue (fused_decode_matmul) BITWISE equal to its plain version (the pair
hif4_quantize -> fused_packed_matmul, then the cast) at qwen1.5-0.5b's three
decode shapes, M in {1, 8, 16, 32}, bf16 and f32 in and out, and to kernel 5
on the absorbed expansion of the weight; a NaN meta word reaches only its
column; one launch per decode linear of the engine. Kernel 5 at most 32
rows (its decode body, csrc/group_matmul_decode.cuh) BITWISE its plain
version and kernel 2 on the absorbed expansion at M = 1, 8, 17, 32; its
decode form (bfp_decode_matmul: the weight's Algorithm 1 in the loader)
BITWISE its plain version and kernel 1 on w.T then kernel 5 at M 1, 8, 17,
32, K 320 and 1024, the LM head's (8, 1024, 151 936), bf16 and f32
weights on a transposed view that is not copied; a NaN or Inf in one
weight group reaches exactly what the plain version's reaches; the
launcher refuses a plan unlike its own; the engine's dense pallas route
launches kernel 1 + the decode form up to 32 rows, kernel 1 twice +
kernel 5 above. Calibration, which launches no kernel, on the card against
the CPU on the same weights and batches: HiGPTQ at least 99% equal values,
the reduced qwen1.5-0.5b calibration's assignment and bytes equal and its
per-site errors within rtol 2e-2. Training, which launches no kernel
either (impl qdq): the flash backward against autograd of the naive
attention (f32, atol 3e-5), the engine's f32-out product differentiable on
the card, one train step of the smoke arch card vs CPU (the loss within
1e-4, every gradient within 5e-2 by relative norm), and kill and resume
repeating the uninterrupted run's losses bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import engine, kvcache
from repro_torch.core.qlinear import PackedW
from repro_torch.kernels import bfp_matmul as TB
from repro_torch.kernels import build
from repro_torch.kernels import fused_attention as TA
from repro_torch.kernels import fused_matmul as TM
from repro_torch.kernels import hif4_quant as TQ

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


DT = {"bf16": torch.bfloat16, "f32": torch.float32}


def _packed(k, n, device, seed=18):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn(k, n, generator=g) * 0.02).to(torch.bfloat16).to(device)
    return PackedW.from_dense(w).to_kernel_layout()


def _act(seed, m, k, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)) * np.exp2(rng.uniform(-10, 10, (m, k // 64))
                                              ).repeat(64, axis=1)
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).to(device)


@pytest.mark.parametrize("m, k", [(8, 1024), (64, 2816)])
def test_quantize_bitwise(cuda, m, k):
    x = _act(11, m, k, cuda)
    build.reset_launches()
    ki, ks = TQ.hif4_quantize(x)
    pi, ps = TQ.absorbed_activation(x)
    assert build.LAUNCHES["hif4_quantize"] == 1
    assert torch.equal(ki, pi) and torch.equal(ks.view(torch.int32),
                                               ps.view(torch.int32))


MATMUL_SHAPES = [(8, 1024, 2816), (300, 2816, 1024),      # (M, K, N)
                 (3840, 1024, 1024), (3840, 1024, 2816), (3840, 2816, 1024),
                 (33, 1024, 1024), (33, 320, 1000), (300, 320, 1000),
                 (37, 320, 1000), (129, 192, 136)]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("m, k, n", MATMUL_SHAPES)
def test_matmul_vs_plain(cuda, m, k, n, out):
    """Bitwise: the decode regime, the prefill shapes, the first M of the
    tensor-core body, ragged M / N tails with N % 16 != 0 and K/64 = 5 (not a
    multiple of anything the ring holds), and N % 16 == 0 with a partial
    column tile."""
    g = torch.Generator().manual_seed(12)
    w = (torch.randn(k, n, generator=g) * 0.02).to(torch.bfloat16).to(cuda)
    pw = PackedW.from_dense(w).to_kernel_layout()
    ai, asc = TQ.absorbed_activation(_act(12, m, k, cuda))
    build.reset_launches()
    y = TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta, DT[out])
    assert build.LAUNCHES["fused_packed_matmul"] == 1
    ref = TM.fused_packed_matmul_plain(ai, asc, pw.codes, pw.meta, DT[out])
    assert y.dtype == DT[out]
    assert torch.equal(_bits(y), _bits(ref))


@pytest.mark.parametrize("m", [8, 33, 300])
def test_matmul_nan_meta_reaches_only_its_column(cuda, m):
    """An E6M2 0xFF meta word in the ragged last column tile (N = 1000),
    in either body."""
    pw = _packed(1024, 1000, cuda)
    meta = pw.meta.clone()
    meta[5, 997] |= -(1 << 24)
    ai, asc = TQ.hif4_quantize(_act(24, m, 1024, cuda))
    y = TM.fused_packed_matmul(ai, asc, pw.codes, meta)
    want = torch.zeros_like(y, dtype=torch.bool)
    want[:, 997] = True
    assert torch.equal(y.isnan(), want)


def test_prefill_form_refuses_misaligned_operands(cuda):
    pw = _packed(256, 64, cuda)
    ai, asc = TQ.hif4_quantize(_act(25, 40, 256, cuda))
    buf = torch.empty(40 * 256 + 4, dtype=torch.int8, device=cuda)
    shifted = buf[4:].view(40, 256)
    shifted.copy_(ai)
    build.reset_launches()
    with pytest.raises(ValueError):                   # 4-byte aligned only
        TM.fused_packed_matmul(shifted, asc, pw.codes, pw.meta)
    with pytest.raises(TypeError):
        TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta, torch.float16)
    assert build.LAUNCHES["fused_packed_matmul"] == 0
    y = TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta)
    assert torch.equal(_bits(y), _bits(TM.fused_packed_matmul_plain(
        ai, asc, pw.codes, pw.meta)))
    assert build.SHAPE_LAUNCHES == {("fused_packed_matmul", (40, 256, 64)): 1}


@pytest.mark.parametrize("field", ["tile_m", "tile_n", "stages", "lookahead",
                                   "stage_bytes", "smem_bytes"])
def test_prefill_launcher_refuses_a_plan_unlike_its_own(cuda, field, monkeypatch):
    """Every field of the host plan is checked by the C launcher, so the
    Python mirror cannot drift from the kernel's constants unseen."""
    pw = _packed(256, 64, cuda)
    ai, asc = TQ.hif4_quantize(_act(25, 40, 256, cuda))
    bi, bsc = engine.packed_to_absorbed(pw)
    real = TB.prefill_plan

    def off(*args, **kwargs):
        plan = real(*args, **kwargs)
        return dataclasses.replace(plan, **{field: getattr(plan, field) + 1})

    for mod in (TB, TM):
        monkeypatch.setattr(mod, "prefill_plan", off)
    build.reset_launches()
    with pytest.raises(RuntimeError):
        TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta)
    with pytest.raises(RuntimeError):
        TB.bfp_matmul_quantized(ai, asc, bi, bsc)
    assert sum(build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("hkv, rep, d, s", [(16, 1, 64, 512), (4, 2, 32, 160),
                                           (8, 2, 128, 256), (4, 2, 32, 33),
                                           (16, 1, 64, 4096), (16, 1, 64, 492),
                                           (8, 1, 40, 100), (8, 1, 80, 100),
                                           (4, 2, 96, 160), (2, 6, 192, 130)])
def test_attention_vs_plain(cuda, hkv, rep, d, s):
    g = torch.Generator().manual_seed(13)
    b = 6
    mk = lambda *shape: (torch.randn(*shape, generator=g) * 0.5).to(torch.bfloat16).to(cuda)
    q = mk(b, hkv * rep, d)
    pk = kvcache.to_kernel_layout(kvcache.quantize_kv(mk(b, s, hkv, d)))
    pv = kvcache.to_kernel_layout(kvcache.quantize_kv(mk(b, s, hkv, d)))
    length = torch.tensor([1, 63, 64, 65, s, s - 1], dtype=torch.int32, device=cuda)
    out = TA.fused_decode_attention(q, pk, pv, length, n_kv_heads=hkv, d_head=d)
    ref = TA.fused_decode_attention_plain(q, pk, pv, length, hkv, d)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
    pk["meta"][2, 0, 3] |= -(1 << 24)                 # E6M2 code 0xFF
    out = TA.fused_decode_attention(q, pk, pv, length, n_kv_heads=hkv, d_head=d)
    ref = TA.fused_decode_attention_plain(q, pk, pv, length, hkv, d)
    assert torch.equal(out.isnan(), ref.isnan()) and bool(out[2].isnan().any())
    assert not bool(out[[0, 1, 3, 4, 5]].isnan().any())


def _paged_case(device, P, hkv=16, d=64, n_pages=24, seed=14):
    """Per-layer pool leaves with real quantized tokens; slots 0 and 1 share
    their first two pages, slot 2 ends in a partial page followed by
    trailing scratch entries, slot 3 holds one token."""
    g = torch.Generator().manual_seed(seed)
    mk = lambda *shape: (torch.randn(*shape, generator=g) * 0.5).to(torch.bfloat16)

    def pool():
        pk = kvcache.to_kernel_layout(kvcache.quantize_kv(mk(n_pages * P, hkv, d)))
        return {k: a.reshape(a.shape[0], n_pages, P).transpose(0, 1).contiguous()
                .to(device) for k, a in pk.items()}

    pages = torch.tensor([[3, 7, 1, 9], [3, 7, 4, 10], [2, 11, 0, 0],
                          [5, 0, 0, 0]], dtype=torch.int32, device=device)
    length = torch.tensor([4 * P, 3 * P + 1, P + P // 2, 1], dtype=torch.int32,
                          device=device)
    return mk(4, hkv, d).to(device), pool(), pool(), pages, length


def _contiguous(pool, pages):
    out = {}
    for key, a in pool.items():
        gth = a[pages.long()]                               # (B, maxp, F, P)
        b, maxp, f, p = gth.shape
        out[key] = gth.permute(0, 2, 1, 3).reshape(b, f, maxp * p).contiguous()
    return out


@pytest.mark.parametrize("P", [16, 64])
def test_paged_attention_vs_plain_and_contiguous(cuda, P):
    q, kp, vp, pages, length = _paged_case(cuda, P)
    build.reset_launches()
    out = TA.fused_paged_decode_attention(q, kp, vp, pages, length,
                                          n_kv_heads=16, d_head=64)
    assert build.LAUNCHES["fused_paged_decode_attention"] == 1
    ref = TA.fused_paged_decode_attention_plain(q, kp, vp, pages, length, 16, 64)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
    cont = TA.fused_decode_attention(q, _contiguous(kp, pages),
                                     _contiguous(vp, pages), length,
                                     n_kv_heads=16, d_head=64, block_kv=P)
    assert torch.equal(out.view(torch.int16), cont.view(torch.int16))
    # trailing scratch entries are exact no-ops: cut them off, same bits
    cut = TA.fused_paged_decode_attention(q[2:4], kp, vp,
                                          pages[2:4, :2].contiguous(),
                                          length[2:4], n_kv_heads=16, d_head=64)
    assert torch.equal(out[2:4].view(torch.int16), cut.view(torch.int16))


def test_paged_attention_nan_meta_reaches_only_its_holders(cuda):
    q, kp, vp, pages, length = _paged_case(cuda, 16)
    kp["meta"][7, 0, 2] |= -(1 << 24)                  # page 7: slots 0 and 1
    out = TA.fused_paged_decode_attention(q, kp, vp, pages, length,
                                          n_kv_heads=16, d_head=64)
    ref = TA.fused_paged_decode_attention_plain(q, kp, vp, pages, length, 16, 64)
    assert torch.equal(out.isnan(), ref.isnan())
    assert out.isnan().flatten(1).any(1).tolist() == [True, True, False, False]


def _table_case(device, max_pages, P=16, hkv=16, d=64, seed=16):
    """Four slots over a pool of 1 + 4 * max_pages pages: a full table, one
    ending in a partial page and a trailing scratch entry, a 1-token slot
    (all but its first entry scratch) and a slot of length 0."""
    g = torch.Generator().manual_seed(seed)
    mk = lambda *shape: (torch.randn(*shape, generator=g) * 0.5).to(torch.bfloat16)
    n_pages = 1 + 4 * max_pages

    def pool():
        pk = kvcache.to_kernel_layout(kvcache.quantize_kv(mk(n_pages * P, hkv, d)))
        return {k: a.reshape(a.shape[0], n_pages, P).transpose(0, 1).contiguous()
                .to(device) for k, a in pk.items()}

    ids = torch.arange(1, n_pages, dtype=torch.int32).reshape(4, max_pages)
    if max_pages > 1:
        ids[1, -1] = 0
    ids[2, 1:] = 0
    length = torch.tensor([max_pages * P, max(1, (max_pages - 1) * P - 3), 1, 0],
                          dtype=torch.int32)
    return (mk(4, hkv, d).to(device), pool(), pool(), ids.to(device),
            length.to(device))


@pytest.mark.parametrize("max_pages, P", [(1, 16), (2, 16), (3, 16), (8, 16),
                                          (33, 16), (3, 18)])
def test_paged_bitwise_contiguous_at_every_tile_count(cuda, max_pages, P):
    """Kernel 4 is kernel 3 at block_kv = P bit for bit whatever the tile
    count (and at a page size that is not a multiple of 4), with trailing
    scratch entries and a length-0 slot, and within the tolerance of its
    plain version."""
    q, kp, vp, pages, length = _table_case(cuda, max_pages, P=P)
    out = TA.fused_paged_decode_attention(q, kp, vp, pages, length,
                                          n_kv_heads=16, d_head=64)
    cont = TA.fused_decode_attention(q, _contiguous(kp, pages),
                                     _contiguous(vp, pages), length,
                                     n_kv_heads=16, d_head=64, block_kv=P)
    assert torch.equal(out.view(torch.int16), cont.view(torch.int16))
    ref = TA.fused_paged_decode_attention_plain(q, kp, vp, pages, length, 16, 64)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("hkv, rep, d", [(4, 1, 80), (2, 2, 96), (2, 6, 192)])
def test_paged_bitwise_contiguous_at_scalar_path_head_widths(cuda, hkv, rep, d):
    """Head widths whose D/16 is not a power of two (zamba2's 80, 96,
    nemotron-4's 192) take the scalar path: kernel 4 is still kernel 3 at
    block_kv = P bit for bit, and within the tolerance of its plain
    version."""
    q, kp, vp, pages, length = _table_case(cuda, 3, hkv=hkv, d=d)
    q = q.repeat_interleave(rep, dim=1).contiguous()
    out = TA.fused_paged_decode_attention(q, kp, vp, pages, length,
                                          n_kv_heads=hkv, d_head=d)
    cont = TA.fused_decode_attention(q, _contiguous(kp, pages),
                                     _contiguous(vp, pages), length,
                                     n_kv_heads=hkv, d_head=d, block_kv=16)
    assert torch.equal(out.view(torch.int16), cont.view(torch.int16))
    ref = TA.fused_paged_decode_attention_plain(q, kp, vp, pages, length, hkv, d)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)


def test_attention_refuses_an_odd_head_width(cuda):
    """An odd d_head is kernel-compatible by the reference's rule, but the
    kernels take heads of whole code bytes: on the card the wrapper raises
    (no quiet switch to the plain version)."""
    g = torch.Generator().manual_seed(17)
    kv = (torch.randn(2, 64, 64, 3, generator=g) * 0.5).to(torch.bfloat16)
    cache = {k: a.to(cuda) for k, a in
             kvcache.to_kernel_layout(kvcache.quantize_kv(kv)).items()}
    q = (torch.randn(2, 64, 3, generator=g) * 0.5).to(torch.bfloat16).to(cuda)
    length = torch.tensor([5, 64], dtype=torch.int32, device=cuda)
    assert TA.kernel_compatible(cache, 64, 3)
    with pytest.raises(ValueError, match="even d_head"):
        TA.fused_decode_attention(q, cache, cache, length, n_kv_heads=64, d_head=3)


def test_trailing_scratch_entries_keep_the_nan_rule(cuda):
    """A NaN V scale in the scratch page reaches exactly the slots whose
    tables hold it, as in the plain version (p = 0 there, 0 * NaN); a NaN K
    scale there is masked and reaches none."""
    q, kp, vp, pages, length = _table_case(cuda, 3)
    vp["meta"][0, 0, 5] |= -(1 << 24)               # group 0 = head 0's features
    kp["meta"][0, 1, 7] |= -(1 << 24)
    out = TA.fused_paged_decode_attention(q, kp, vp, pages, length,
                                          n_kv_heads=16, d_head=64)
    ref = TA.fused_paged_decode_attention_plain(q, kp, vp, pages, length, 16, 64)
    assert torch.equal(out.isnan(), ref.isnan())
    assert out.isnan().flatten(1).any(1).tolist() == [False, True, True, False]
    assert bool(out[1, 0].isnan().all()) and not bool(out[1, 1:].isnan().any())


def test_length_zero_slot_is_bitwise_plain(cuda):
    """A slot of length 0 (its masked tokens weigh exp(0) = 1 in the
    reference): p is a power of two or its products are exact, so its bits
    are the plain version's."""
    for max_pages in (1, 3, 8):
        q, kp, vp, pages, length = _table_case(cuda, max_pages)
        out = TA.fused_paged_decode_attention(q, kp, vp, pages, length,
                                              n_kv_heads=16, d_head=64)
        ref = TA.fused_paged_decode_attention_plain(q, kp, vp, pages, length,
                                                    16, 64)
        assert torch.equal(out[3].view(torch.int16), ref[3].view(torch.int16))


def test_paged_attention_refuses_empty_work(cuda):
    """An empty page table or batch raises instead of counting a launch
    that did not happen."""
    q, kp, vp, pages, length = _paged_case(cuda, 16)
    build.reset_launches()
    with pytest.raises(ValueError):
        TA.fused_paged_decode_attention(q, kp, vp, pages[:, :0].contiguous(),
                                        length, n_kv_heads=16, d_head=64)
    with pytest.raises(ValueError):
        TA.fused_paged_decode_attention(q[:0], kp, vp, pages[:0], length[:0],
                                        n_kv_heads=16, d_head=64)
    assert build.LAUNCHES["fused_paged_decode_attention"] == 0


# ---------------------------------------------------------------------------
# kernel 5: bfp_matmul_quantized
# ---------------------------------------------------------------------------


def _int8_operands(m, k, n, device, seed=15):
    """Absorbed operands as the engine makes them: a (M, K) row-major, b the
    transposed views of hif4_quantize(w.T), K-contiguous per column."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16).to(device)
    w = (torch.randn(n, k, generator=g) * 0.02).to(torch.bfloat16).to(device)
    ai, asc = TQ.hif4_quantize(x)
    wi, wsc = TQ.hif4_quantize(w)
    return ai, asc, wi.T, wsc.T


@pytest.mark.parametrize("m, k, n", [(8, 1024, 151936), (3840, 1024, 2816),
                                     (37, 320, 1000), (33, 1024, 1024),
                                     (300, 2816, 1024)])
def test_bfp_matmul_bitwise_vs_plain(cuda, m, k, n):
    """The LM head's decode shape, the prefill shape, a ragged one (M and N
    tails, K/64 = 5 groups: not a multiple of the groups per step), and the
    tensor-core body's first M and a K of 44 groups."""
    ai, asc, bi, bsc = _int8_operands(m, k, n, cuda)
    build.reset_launches()
    y = TB.bfp_matmul_quantized(ai, asc, bi, bsc)
    assert build.LAUNCHES["bfp_matmul_quantized"] == 1
    ref = TB.bfp_matmul_quantized_plain(ai, asc, bi, bsc)
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("m", [8, 33, 300, 3840])
def test_bfp_matmul_bitwise_vs_fused_matmul(cuda, m):
    g = torch.Generator().manual_seed(16)
    w = (torch.randn(1024, 2816, generator=g) * 0.02).to(torch.bfloat16).to(cuda)
    pw = PackedW.from_dense(w).to_kernel_layout()
    ai, asc = TQ.hif4_quantize(_act(16, m, 1024, cuda))
    y5 = TB.bfp_matmul_quantized(ai, asc, *engine.packed_to_absorbed(pw))
    y2 = TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta)
    assert torch.equal(y5.view(torch.int32), y2.view(torch.int32))


@pytest.mark.parametrize("m", [8, 300])
def test_bfp_matmul_nan_scale_reaches_its_row_and_column_only(cuda, m):
    ai, asc, bi, bsc = _int8_operands(m, 256, 200, cuda)
    asc[3, 2] = float("nan")
    bsc[1, 130] = float("nan")                        # group 1 of column 130
    y = TB.bfp_matmul_quantized(ai, asc, bi, bsc)
    want = torch.zeros_like(y, dtype=torch.bool)
    want[3, :] = True
    want[:, 130] = True
    assert torch.equal(y.isnan(), want)
    assert torch.equal(y.isnan(), TB.bfp_matmul_quantized_plain(
        ai, asc, bi, bsc).isnan())


def test_bfp_matmul_launches_on_a_transposed_view_without_a_copy(cuda, monkeypatch):
    ai, asc, bi, bsc = _int8_operands(8, 256, 96, cuda)
    seen = []
    function = build.function

    def spy(lib, name, argtypes):
        fn = function(lib, name, argtypes)
        return lambda *args: (seen.append(args), fn(*args))[1]

    monkeypatch.setattr(build, "function", spy)
    TB.bfp_matmul_quantized(ai, asc, bi, bsc)        # transposed views
    assert seen[-1][2] == bi.data_ptr() and seen[-1][3] == bsc.data_ptr()
    row_major = bi.contiguous()                      # a direct caller's (K, N)
    y = TB.bfp_matmul_quantized(ai, asc, row_major, bsc)
    assert seen[-1][2] not in (bi.data_ptr(), row_major.data_ptr())   # copied
    assert torch.equal(y, TB.bfp_matmul_quantized(ai, asc, bi, bsc))


def test_bfp_matmul_refuses_empty_work(cuda):
    ai, asc, bi, bsc = _int8_operands(8, 256, 96, cuda)
    build.reset_launches()
    with pytest.raises(ValueError):
        TB.bfp_matmul_quantized(ai[:0], asc[:0], bi, bsc)
    with pytest.raises(ValueError):
        TB.bfp_matmul_quantized(ai, asc, bi[:, :0], bsc[:, :0])
    assert build.LAUNCHES["bfp_matmul_quantized"] == 0


# ---------------------------------------------------------------------------
# the decode form of kernel 2, kernel 1 as its prologue: fused_decode_matmul
# ---------------------------------------------------------------------------

DECODE_SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024)]      # (K, N)


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 8, 16, 32])
@pytest.mark.parametrize("k, n", DECODE_SHAPES)
def test_decode_form_bitwise_vs_plain(cuda, k, n, m, dtype, out):
    pw = _packed(k, n, cuda)
    x = _act(19 + m, m, k, cuda).to(DT[dtype])
    build.reset_launches()
    y = TM.fused_decode_matmul(x, pw.codes, pw.meta, DT[out])
    assert build.LAUNCHES["fused_decode_matmul"] == 1
    assert build.LAUNCHES["fused_packed_matmul"] == 1
    assert build.LAUNCHES["hif4_quantize"] == 0
    ref = TM.fused_decode_matmul_plain(x, pw.codes, pw.meta, DT[out])
    assert y.dtype == DT[out]
    assert torch.equal(_bits(y), _bits(ref))


@pytest.mark.parametrize("k, n", DECODE_SHAPES + [(320, 1000), (1024, 1040)])
def test_decode_form_bitwise_vs_bfp_matmul(cuda, k, n):
    """Kernel 5 on packed_to_absorbed(pw), fed kernel 1's ints: the same
    bits as the decode form's f32 output (and ragged N: K/64 = 5 with
    N % 16 != 0, and N % 16 == 0 with a partial last column tile)."""
    pw = _packed(k, n, cuda)
    x = _act(20, 8, k, cuda)
    y = TM.fused_decode_matmul(x, pw.codes, pw.meta, torch.float32)
    ai, asc = TQ.hif4_quantize(x)
    y5 = TB.bfp_matmul_quantized(ai, asc, *engine.packed_to_absorbed(pw))
    assert torch.equal(y.view(torch.int32), y5.view(torch.int32))


def test_decode_form_nan_meta_reaches_only_its_column(cuda):
    pw = _packed(1024, 1000, cuda)
    meta = pw.meta.clone()
    meta[5, 997] |= -(1 << 24)                        # E6M2 code 0xFF
    x = _act(21, 8, 1024, cuda)
    y = TM.fused_decode_matmul(x, pw.codes, meta)
    want = torch.zeros_like(y, dtype=torch.bool)
    want[:, 997] = True
    assert torch.equal(y.isnan(), want)
    assert torch.equal(y.isnan(), TM.fused_decode_matmul_plain(
        x, pw.codes, meta).isnan())


def test_decode_form_refuses_bad_operands(cuda):
    pw = _packed(256, 64, cuda)
    x = _act(22, 8, 256, cuda)
    build.reset_launches()
    with pytest.raises(ValueError):                   # empty work
        TM.fused_decode_matmul(x[:0], pw.codes, pw.meta)
    with pytest.raises(ValueError):                   # non-contiguous
        TM.fused_decode_matmul(x.T.contiguous().T, pw.codes, pw.meta)
    buf = torch.empty(8 * 256 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                   # 2-byte aligned only
        TM.fused_decode_matmul(buf[1:].view(8, 256), pw.codes, pw.meta)
    with pytest.raises(ValueError):                   # more than 32 rows
        TM.fused_decode_matmul(_act(22, 33, 256, cuda), pw.codes, pw.meta)
    assert build.LAUNCHES["fused_decode_matmul"] == 0
    assert build.LAUNCHES["fused_packed_matmul"] == 0


@pytest.mark.parametrize("rows", [8, 40])
def test_engine_decode_linear_is_one_launch(cuda, rows):
    """A packed linear with at most 32 rows is one launch of the decode form;
    with more it is kernel 1 then kernel 2's prefill form. Either way the
    bits of the plain pair, cast."""
    from repro_torch.core.qlinear import QuantConfig

    pw = _packed(1024, 2816, cuda)
    x = _act(23, rows, 1024, cuda).reshape(2, rows // 2, 1024)
    build.reset_launches()
    y = engine.matmul(x, pw, engine.EngineCtx(QuantConfig(fmt="hif4",
                                                          impl="packed")))
    decode = rows <= TB.DECODE_M_MAX
    assert build.LAUNCHES["fused_packed_matmul"] == 1
    assert build.LAUNCHES["fused_decode_matmul"] == int(decode)
    assert build.LAUNCHES["hif4_quantize"] == int(not decode)
    ref = TM.fused_decode_matmul_plain(x.reshape(rows, 1024), pw.codes, pw.meta)
    assert torch.equal(_bits(y.reshape(rows, 2816)), _bits(ref))


# ---------------------------------------------------------------------------
# kernel 5's decode body, and its decode form: bfp_decode_matmul
# ---------------------------------------------------------------------------

HEAD_CASES = ([(m, k, 1000) for m in (1, 8, 17, 32) for k in (320, 1024)]
              + [(8, 1024, 151936)])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("m, k, n", HEAD_CASES)
def test_head_decode_form_bitwise_vs_plain(cuda, m, k, n, dtype, monkeypatch):
    g = torch.Generator().manual_seed(m + k)
    embed = (torch.randn(n, k, generator=g) * 0.02).to(DT[dtype]).to(cuda)
    ai, asc = TQ.hif4_quantize(_act(24 + m, m, k, cuda))
    seen = []
    function = build.function

    def spy(lib, name, argtypes):
        fn = function(lib, name, argtypes)
        return lambda *args: (seen.append(args), fn(*args))[1]

    monkeypatch.setattr(build, "function", spy)
    build.reset_launches()
    y = TB.bfp_decode_matmul(ai, asc, embed.T)
    assert seen[-1][2] == embed.data_ptr()            # the view, not a copy
    assert build.LAUNCHES["bfp_decode_matmul"] == 1
    assert build.LAUNCHES["bfp_matmul_quantized"] == 1
    assert build.LAUNCHES["hif4_quantize"] == 0
    assert build.SHAPE_LAUNCHES == {("bfp_decode_matmul", (m, k, n)): 1}
    ref = TB.bfp_decode_matmul_plain(ai, asc, embed.T)
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))
    wi, wsc = TQ.hif4_quantize(embed)
    y5 = TB.bfp_matmul_quantized(ai, asc, wi.T, wsc.T)
    assert torch.equal(y.view(torch.int32), y5.view(torch.int32))


@pytest.mark.parametrize("bad", ["nan", "inf"])
def test_head_decode_form_bad_weight_reaches_what_the_plain_version_does(cuda, bad):
    g = torch.Generator().manual_seed(26)
    embed = (torch.randn(1000, 1024, generator=g) * 0.02).to(torch.bfloat16).to(cuda)
    embed[997, 70] = float(bad)                       # group 1 of column 997
    ai, asc = TQ.hif4_quantize(_act(27, 8, 1024, cuda))
    y = TB.bfp_decode_matmul(ai, asc, embed.T)
    ref = TB.bfp_decode_matmul_plain(ai, asc, embed.T)
    want = torch.zeros_like(y, dtype=torch.bool)
    if bad == "nan":
        want[:, 997] = True
    assert torch.equal(y.isnan(), want) and torch.equal(ref.isnan(), want)
    keep = ~want
    assert torch.equal(y[keep].view(torch.int32), ref[keep].view(torch.int32))


@pytest.mark.parametrize("m", [1, 8, 17, 32])
def test_bfp_matmul_decode_body_bitwise_vs_plain_and_fused_matmul(cuda, m):
    pw = _packed(1024, 2816, cuda, seed=28)
    ai, asc = TQ.hif4_quantize(_act(28 + m, m, 1024, cuda))
    bi, bsc = engine.packed_to_absorbed(pw)
    build.reset_launches()
    y5 = TB.bfp_matmul_quantized(ai, asc, bi, bsc)
    assert build.LAUNCHES["bfp_matmul_quantized"] == 1
    assert build.LAUNCHES["bfp_decode_matmul"] == 0
    y2 = TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta)
    ref = TB.bfp_matmul_quantized_plain(ai, asc, bi, bsc)
    assert torch.equal(y5.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(y5.view(torch.int32), y2.view(torch.int32))


@pytest.mark.parametrize("field", ["rows", "stages", "warps", "ctas_per_sm",
                                   "grid", "smem_bytes"])
def test_decode_launcher_refuses_a_plan_unlike_its_own(cuda, field, monkeypatch):
    g = torch.Generator().manual_seed(29)
    embed = (torch.randn(96, 256, generator=g) * 0.02).to(torch.bfloat16).to(cuda)
    ai, asc = TQ.hif4_quantize(_act(29, 8, 256, cuda))
    wi, wsc = TQ.hif4_quantize(embed)
    real = TB.decode_matmul_plan

    def off(*args, **kwargs):
        plan = real(*args, **kwargs)
        return dataclasses.replace(plan, **{field: getattr(plan, field) + 1})

    monkeypatch.setattr(TB, "decode_matmul_plan", off)
    build.reset_launches()
    with pytest.raises(RuntimeError):
        TB.bfp_matmul_quantized(ai, asc, wi.T, wsc.T)
    with pytest.raises(RuntimeError):
        TB.bfp_decode_matmul(ai, asc, embed.T)
    assert sum(build.LAUNCHES.values()) == 0


def test_head_decode_form_refuses_what_it_does_not_take(cuda):
    g = torch.Generator().manual_seed(30)
    embed = (torch.randn(96, 256, generator=g) * 0.02).to(torch.bfloat16).to(cuda)
    build.reset_launches()
    ai, asc = TQ.hif4_quantize(_act(30, 33, 256, cuda))
    with pytest.raises(ValueError):                   # more than 32 rows
        TB.bfp_decode_matmul(ai, asc, embed.T)
    with pytest.raises(ValueError):                   # empty work
        TB.bfp_decode_matmul(ai[:0], asc[:0], embed.T)
    buf = torch.empty(96 * 256 + 8, dtype=torch.bfloat16, device=cuda)
    shifted = buf[8:].view(96, 256)                   # 16 bytes on: aligned
    shifted.copy_(embed)
    y = TB.bfp_decode_matmul(ai[:8], asc[:8], shifted.T)
    shifted = buf[1:96 * 256 + 1].view(96, 256)       # 2 bytes on
    with pytest.raises(ValueError):
        TB.bfp_decode_matmul(ai[:8], asc[:8], shifted.T)
    assert build.LAUNCHES["bfp_decode_matmul"] == 1
    assert torch.equal(y.view(torch.int32), TB.bfp_decode_matmul_plain(
        ai[:8], asc[:8], embed.T).view(torch.int32))


@pytest.mark.parametrize("rows", [8, 32, 40])
def test_engine_dense_pallas_route_launches(cuda, rows):
    """The LM head's route: at most 32 rows kernel 1 on x, then the decode
    form; above, kernel 1 on x and on w.T, then kernel 5; the bits of the
    plain composition, cast to x's dtype."""
    from repro_torch.core.qlinear import QuantConfig

    g = torch.Generator().manual_seed(31)
    embed = (torch.randn(2000, 1024, generator=g) * 0.02).to(torch.bfloat16).to(cuda)
    x = _act(31, rows, 1024, cuda).reshape(2, rows // 2, 1024)
    build.reset_launches()
    y = engine.matmul(x, embed.T, engine.EngineCtx(QuantConfig(fmt="hif4",
                                                               impl="pallas")))
    decode = rows <= TB.DECODE_M_MAX
    assert build.LAUNCHES["hif4_quantize"] == (1 if decode else 2)
    assert build.LAUNCHES["bfp_decode_matmul"] == int(decode)
    assert build.LAUNCHES["bfp_matmul_quantized"] == 1
    ai, asc = TQ.absorbed_activation(x.reshape(rows, 1024))
    ref = TB.bfp_decode_matmul_plain(ai, asc, embed.T).to(torch.bfloat16)
    assert torch.equal(_bits(y.reshape(rows, 2000)), _bits(ref))


def test_higptq_on_the_card_equals_the_cpu(cuda):
    from repro_torch.core.higptq import higptq_quantize

    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((256, 64)) * 0.05).astype(np.float32))
    base = rng.standard_normal((512, 64)).astype(np.float32)
    x = torch.from_numpy(base @ rng.standard_normal((64, 256)).astype(np.float32))
    cpu = higptq_quantize(w, x)
    card = higptq_quantize(w.to(cuda), x.to(cuda)).cpu()
    assert float((card == cpu).float().mean()) >= 0.99


def test_calibrate_on_the_card_equals_the_cpu(cuda):
    from repro_torch.calibrate import calibrate
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import prefill_batch
    from repro_torch.models import lm

    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    batches = [prefill_batch(cfg, 2, 64, i, "cpu") for i in range(2)]
    runs = {}
    for dev in ("cpu", cuda):
        runs[str(dev)] = calibrate(
            "qwen1.5-0.5b", target_bpv="sensitive-fallback", device=dev,
            params=_to(params, dev),
            batches=batches, log=lambda *_: None)
    cpu, card = runs["cpu"], runs[str(cuda)]
    assert card["assignment"] == cpu["assignment"]
    assert card["total_bytes"] == cpu["total_bytes"]
    for a, b in zip(cpu["report"]["sites"], card["report"]["sites"]):
        if a["errors"] is not None:
            for fmt, e in a["errors"].items():
                np.testing.assert_allclose(b["errors"][fmt], e, rtol=2e-2)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# training (no kernel: impl qdq)
# ---------------------------------------------------------------------------


def test_flash_backward_matches_naive_attention_on_the_card(cuda):
    from repro_torch.models.attention import AttnChunking, flash_mha

    g = torch.Generator(device=cuda).manual_seed(0)
    for causal in (True, False):
        qkv = [torch.randn((2, 96, 4, 16), generator=g, device=cuda)
               .requires_grad_(True) for _ in range(3)]

        def grads(fn):
            return torch.autograd.grad(torch.sum(torch.sin(fn(*qkv))), qkv)

        def naive(q, k, v):
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
            if causal:
                mask = torch.ones(96, 96, dtype=torch.bool, device=cuda).tril()
                s = torch.where(mask, s, -1e30)
            return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)

        got = grads(lambda q, k, v: flash_mha(q, k, v, causal, 0,
                                              AttnChunking(32, 48)))
        for a, b in zip(got, grads(naive)):
            torch.testing.assert_close(a, b, atol=3e-5, rtol=0)


def test_f32_out_product_is_differentiable_on_the_card(cuda):
    """The head's bf16 x bf16 -> f32 product: ``torch.mm(out_dtype=)``
    outside autograd, the upcast product where autograd records it; both
    f32-close, and the recorded one has gradients."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(8, 256, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(256, 512, generator=g, device=cuda).to(torch.bfloat16)
    plain = engine.dot(x, w, torch.float32)
    wr = w.clone().requires_grad_(True)
    recorded = engine.dot(x, wr, torch.float32)
    torch.testing.assert_close(recorded.detach(), plain, atol=1e-4, rtol=1e-5)
    (dw,) = torch.autograd.grad(recorded.sum(), wr)
    assert dw.dtype == torch.bfloat16 and bool(torch.isfinite(dw).all())


def _smoke_step(device):
    from repro_torch.configs import get_arch
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import _grads
    from repro_torch.models import lm
    from repro_torch.models.common import ModelCtx
    from repro_torch.checkpoint.checkpoint import tree_flatten

    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = lm.init_params(cfg, 0, device=device)
    leaves = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = SyntheticLMDataset(cfg.vocab, 32, 4, seed=0).batch_at(0)
    ctx = ModelCtx(quant=QuantConfig(fmt="hif4"), attn_q_chunk=32,
                   attn_k_chunk=32)
    loss = lm.train_loss(params, {"tokens": batch["tokens"].to(device)}, cfg,
                         ctx)
    return float(loss.detach()), [g.float().cpu() for g in _grads(loss, leaves)]


def test_train_step_card_vs_cpu(cuda):
    build.reset_launches()
    loss_c, grads_c = _smoke_step(cuda)
    assert not any(build.LAUNCHES.values()), build.LAUNCHES
    loss_h, grads_h = _smoke_step(torch.device("cpu"))
    assert abs(loss_c - loss_h) <= 1e-4 * abs(loss_h)
    for a, b in zip(grads_c, grads_h):
        rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        assert rel <= 5e-2, rel


def test_kill_and_resume_on_the_card(cuda, tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.models.common import ModelCtx
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainLoopConfig, train

    cfg = get_arch("qwen1.5-0.5b").reduced()
    ctx = ModelCtx(quant=QuantConfig(fmt="hif4"), attn_q_chunk=32,
                   attn_k_chunk=32)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)

    def run(steps, directory=None):
        loop = TrainLoopConfig(steps=steps, global_batch=4, seq_len=32,
                               checkpoint_every=4, checkpoint_dir=directory)
        return train(cfg, ctx, loop, opt, device=cuda)[2]["loss"]

    full = run(10)
    run(6, str(tmp_path))
    assert run(10, str(tmp_path)) == full[-4:]
