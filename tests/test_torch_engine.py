"""The port's execution engine: the fallback table of the reference
(``repro/core/engine.py``) and its dispatch reports, on CPU tensors.

Each route is checked against the composition it must run (bitwise: the
same functions on the same inputs), and the dispatch reports against the
reference's (the reference's TPU answers correspond to the port's CUDA
answers, its off-TPU answers to the port's CPU answers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import kvcache as JK
from repro.core.qlinear import PackedW as JPackedW
from repro.core.qlinear import QuantConfig as JQC
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import kvcache as TK
from repro_torch.core import hif4
from repro_torch.core.qlinear import PackedW, QuantConfig, quantize_activation
from repro_torch.kernels.fused_attention import fused_decode_attention_plain
from repro_torch.kernels.fused_matmul import fused_packed_matmul_plain
from repro_torch.kernels.hif4_quant import absorbed_activation

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

PACKED = QuantConfig(fmt="hif4", impl="packed", offline_weights=True)


def _setup(m=6, k=256, n=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, m // 2, k, generator=g).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g) * 0.02).to(torch.bfloat16)
    return x, w, PackedW.from_dense(w).to_kernel_layout()


def test_fused_route_is_quantize_then_fused_matmul():
    x, _, pw = _setup()
    y = TE.matmul(x, pw, TE.EngineCtx(PACKED))
    ai, asc = absorbed_activation(x.reshape(-1, 256))
    ref = fused_packed_matmul_plain(ai, asc, pw.codes, pw.meta)
    assert torch.equal(y, ref.reshape(2, 3, 96).to(torch.bfloat16))


def _dequant_then_dot(x, pw, cfg):
    xq = quantize_activation(x, cfg)
    return TE.dot(xq, pw.dequantize(), x.dtype)


@pytest.mark.parametrize("cfg", [
    QuantConfig(fmt="hif4", impl="qdq", offline_weights=True),
    QuantConfig(fmt="hif4", impl="packed", weights_only=True),
    QuantConfig(fmt="none", impl="packed")])
def test_packed_weight_fallbacks_dequantize_then_dot(cfg):
    x, _, pw = _setup()
    y = TE.matmul(x, pw, TE.EngineCtx(cfg))
    assert torch.equal(y, _dequant_then_dot(x, pw, cfg))


def test_plain_intermediate_cap_takes_the_dequantize_fallback(monkeypatch):
    x, _, pw = _setup()
    monkeypatch.setattr(TE, "_PLAIN_FUSED_PART_BYTES_MAX", 16)
    y = TE.matmul(x, pw, TE.EngineCtx(PACKED))
    assert torch.equal(y, _dequant_then_dot(x, pw, PACKED))


def test_dense_weight_routes():
    x, w, _ = _setup()
    cfg = QuantConfig(fmt="hif4", impl="packed")
    y = TE.matmul(x, w, TE.EngineCtx(cfg))          # dense under packed -> qdq
    ref = TE.dot(hif4.qdq(x), hif4.qdq(w, axis=0), torch.bfloat16)
    assert torch.equal(y, ref)
    # dense under pallas: the §III.B fixed-point flow, bit-exact to the f32
    # dot of the quantized operands up to the bf16 output cast (the
    # reference's tests/test_engine.py::test_pallas_dense_equals_exact_fixed_point)
    y = TE.matmul(x, w, TE.EngineCtx(QuantConfig(fmt="hif4", impl="pallas")))
    exact = hif4.qdq(x.float(), axis=-1) @ hif4.qdq(w.float(), axis=0)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, exact.to(torch.bfloat16))
    y32 = TE.matmul(x, w, TE.EngineCtx(), accum_dtype=torch.float32)
    assert y32.dtype == torch.bfloat16               # cast back to x.dtype
    assert torch.equal(y32, (x.float() @ w.float()).to(torch.bfloat16))


@pytest.mark.parametrize("cfg", [
    QuantConfig(fmt="nvfp4", impl="pallas"),
    QuantConfig(fmt="mxfp4", impl="pallas"),
    QuantConfig(fmt="hif4", impl="pallas", weights_only=True)])
def test_pallas_fallbacks_to_qdq(cfg):
    """Non-HiF4 formats and weights_only cannot run the integer kernels:
    the pallas impl runs them as qdq (the reference's
    tests/test_engine.py::test_pallas_fallbacks_to_qdq)."""
    import dataclasses

    x, w, _ = _setup()
    got = TE.matmul(x, w, TE.EngineCtx(cfg))
    want = TE.matmul(x, w, TE.EngineCtx(dataclasses.replace(cfg, impl="qdq")))
    assert torch.equal(got, want)


def test_qdq_matmul_close_to_reference():
    """The qdq route against the reference's on the same numpy inputs (the
    operands quantize bitwise; the bf16 dot may round differently)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 32)) * 0.05).astype(np.float32)
    yj = np.asarray(JE.matmul(jnp.asarray(x), jnp.asarray(w),
                              JE.EngineCtx(quant=JQC(fmt="hif4", impl="qdq"))))
    yt = TE.matmul(torch.from_numpy(x), torch.from_numpy(w),
                   TE.EngineCtx(QuantConfig(fmt="hif4", impl="qdq"))).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["packed", "qdq"])
def test_packed_dispatch_info_matches_reference(impl):
    w = np.random.default_rng(2).standard_normal((256, 64)).astype(np.float32)
    pj = JPackedW.from_dense(jnp.asarray(w)).to_kernel_layout()
    pt = interop.packed_from_jax(pj, "cpu")
    jq, tq = JQC(fmt="hif4", impl=impl), QuantConfig(fmt="hif4", impl=impl)
    for device, interpret in (("cuda", False), ("cpu", True)):
        ij = JE.packed_dispatch_info(jq, pj, decode_m=8, prefill_m=256,
                                     interpret=interpret)
        it = TE.packed_dispatch_info(tq, pt, decode_m=8, prefill_m=256,
                                     device=device)
        assert it["fused"] == ij["fused"]
        assert it["decode_blocks"] == ij["decode_blocks"]
        assert it["prefill_blocks"] == ij["prefill_blocks"]
        if device == "cuda" and it["fused"]:
            # the decode form's plan (M, column tile, CTAs splitting K): 2
            # column tiles of 32, K = 256 split over its 4 groups
            assert it["decode_kernel"].startswith("fused_decode_matmul")
            assert it["decode_tiles"] == (8, 32, 4)
            # the prefill form's plan (BM, BN, ring stages of one group)
            assert it["prefill_kernel"].startswith("fused_packed_matmul")
            assert it["prefill_tiles"] == (128, 128, 6)


@pytest.mark.parametrize("impl, hkv, dh", [("packed", 4, 32), ("qdq", 4, 32),
                                           ("packed", 3, 24), ("packed", 64, 3)])
def test_attention_dispatch_info_matches_reference(impl, hkv, dh):
    kv = jnp.zeros((1, 96, hkv, dh), jnp.bfloat16)
    cj = JK.to_kernel_layout(JK.quantize_kv(kv))
    ct = {k: interop.tensor_from_numpy(np.asarray(v), "cpu") for k, v in cj.items()}
    for device, interpret in (("cuda", False), ("cpu", True)):
        ij = JE.attention_dispatch_info(JQC(fmt="hif4", impl=impl), cj,
                                        n_kv_heads=hkv, d_head=dh,
                                        interpret=interpret)
        it = TE.attention_dispatch_info(QuantConfig(fmt="hif4", impl=impl), ct,
                                        n_kv_heads=hkv, d_head=dh, device=device)
        for key in ("fused", "block_kv", "kernel_eligible"):
            assert it[key] == ij[key], key


@pytest.mark.parametrize("impl", ["packed", "qdq"])
def test_attention_decode_routes(impl):
    g = torch.Generator().manual_seed(3)
    kv = torch.randn(2, 64, 4, 32, generator=g).to(torch.bfloat16)
    q = torch.randn(2, 4, 32, generator=g).to(torch.bfloat16)
    cache = TK.to_kernel_layout(TK.quantize_kv(kv))
    length = torch.tensor([5, 64], dtype=torch.int32)
    out = TE.attention_decode(q, cache, cache, length, 4, 32,
                              TE.EngineCtx(QuantConfig(fmt="hif4", impl=impl)))
    assert torch.equal(out, fused_decode_attention_plain(q, cache, cache,
                                                         length, 4, 32))
