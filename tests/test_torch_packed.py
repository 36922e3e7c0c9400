"""Packed weights, the packed KV cache and the policy plan of the PyTorch port
vs the JAX reference.

Bit-level artifacts are compared exactly (tolerance: none): a JAX-packed
``PackedW`` carried across by ``repro_torch.interop`` keeps its bytes in both
layouts, the port's own ``from_dense`` reproduces them, and the packed KV
cache's bulk quantization, re-layout, padding and per-token appends (scalar
and per-slot positions) produce the reference's bytes. Policy resolution
must give the reference's site table.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import kvcache as JK
from repro.core import policy as JP
from repro.core.qlinear import PackedW as JPackedW
from repro.models import lm as JL
from repro_torch import interop
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import kvcache as TK
from repro_torch.core import policy as TP
from repro_torch.core.qlinear import PackedW as TPackedW
from repro_torch.models import lm as TL
from repro_torch.models.common import ModelCtx as TCtx
from repro_torch.runtime import serve_loop as TS

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), "cpu")


def _same(a_jax, t_torch):
    a = np.asarray(a_jax)
    b = interop.to_numpy(t_torch, uint32=a.dtype == np.uint32)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    np.testing.assert_array_equal(a, b)


WEIGHTS = [  # (shape, contract axes) of the qwen block weights (smoke widths)
    ((128, 4, 32), (0,)),        # attn wq
    ((4, 32, 128), (0, 1)),      # attn wo
    ((128, 256), (0,)),          # mlp wg
    ((256, 128), (0,)),          # mlp wo
]


@pytest.mark.parametrize("shape, ca", WEIGHTS)
def test_packedw_bytes_both_layouts(shape, ca):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    pj = jax.jit(lambda a: JPackedW.from_dense(a, ca))(wj)
    carried = interop.packed_from_jax(pj, "cpu")
    own = TPackedW.from_dense(_t(wj), ca)
    for p in (carried, own):
        _same(pj.codes, p.codes)
        _same(pj.meta, p.meta)
        assert p.shape2d == pj.shape2d
        assert p.nbytes_packed / p.n_values == 0.5625
    kj = jax.jit(lambda p: p.to_kernel_layout())(pj)
    for p in (carried.to_kernel_layout(), own.to_kernel_layout(),
              interop.packed_from_jax(kj, "cpu")):
        assert p.kernel_layout
        _same(kj.codes, p.codes)
        _same(kj.meta, p.meta)
        _same(jax.jit(lambda p: p.dequantize())(kj), p.dequantize())
    _same(jax.jit(lambda p: p.dequantize())(pj), own.dequantize())


def test_packedw_reshape_guards():
    p = TPackedW.from_dense(torch.randn(128, 64).to(torch.bfloat16))
    assert p.reshape(128, -1) is p and p.reshape(-1, 64) is p
    with pytest.raises(ValueError):
        p.reshape(64, -1)
    with pytest.raises(ValueError):
        p.to_kernel_layout().layer(0).kernel_operands()


def _kv(seed, shape=(2, 6, 4, 32), tail_heads=None):
    rng = np.random.default_rng(seed)
    if tail_heads is not None:
        shape = shape[:2] + (tail_heads, 24)
    return jnp.asarray((rng.standard_normal(shape) * 0.5).astype(np.float32)
                       ).astype(jnp.bfloat16)


@pytest.mark.parametrize("tail_heads", [None, 3])
def test_quantize_kv_layouts_pad_bitwise(tail_heads):
    """Artifact leaves, kernel-tile re-layout, padding and dequantization
    (a 3 x 24 head geometry leaves a bf16 staging tail)."""
    kv = _kv(1, tail_heads=tail_heads)
    hkv, dh = kv.shape[-2:]
    pj, pt = JK.quantize_kv(kv), TK.quantize_kv(_t(kv))
    for key in ("codes", "meta", "tail"):
        _same(pj[key], pt[key])
    kj, kt = JK.to_kernel_layout(pj), TK.to_kernel_layout(pt)
    for key in ("codes", "meta", "tail"):
        _same(kj[key], kt[key])
    assert TK.is_kernel_layout(kt) and not TK.is_kernel_layout(pt)
    for pk_j, pk_t in ((pj, pt), (kj, kt)):
        padj, padt = JK.pad_tokens(pk_j, 11), TK.pad_tokens(pk_t, 11)
        assert TK.seq_capacity(padt) == 11
        for key in ("codes", "meta", "tail"):
            _same(padj[key], padt[key])
        _same(JK.dequantize_kv(padj, hkv, dh), TK.dequantize_kv(padt, hkv, dh))
        sj = JK.slice_tokens(padj, 3, 4)
        st = TK.slice_tokens(padt, 3, 4)
        for key in ("codes", "meta", "tail"):
            _same(sj[key], st[key])
        assert TK.packed_kv_nbytes(padt) == JK.packed_kv_nbytes(padj)
    assert TK.kv_bytes_per_token(hkv, dh, "hif4") == JK.kv_bytes_per_token(hkv, dh, "hif4")
    assert TK.split_features(hkv, dh) == JK.split_features(hkv, dh)


@pytest.mark.parametrize("kernel_layout", [True, False])
@pytest.mark.parametrize("per_slot", [False, True])
def test_append_token_bitwise_and_bulk_equals_appends(kernel_layout, per_slot):
    """Token-at-a-time appends reproduce the reference's bytes, and end up
    equal to packing the whole sequence at once."""
    kv = _kv(2)                                   # (B=2, S=6, 4, 32)
    b, s = kv.shape[:2]
    zeros = jnp.zeros_like(kv)
    cj = JK.quantize_kv(zeros)
    ct = TK.quantize_kv(_t(zeros))
    if kernel_layout:
        cj, ct = JK.to_kernel_layout(cj), TK.to_kernel_layout(ct)
    for i in range(s):
        pos = jnp.full((b,), i, jnp.int32) if per_slot else jnp.int32(i)
        cj = JK.append_token(cj, kv[:, i:i + 1], pos)
        ct = TK.append_token(ct, _t(kv[:, i:i + 1]),
                             torch.full((b,), i) if per_slot else i)
        for key in ("codes", "meta", "tail"):
            _same(cj[key], ct[key])
    bulk = TK.quantize_kv(_t(kv))
    if kernel_layout:
        bulk = TK.to_kernel_layout(bulk)
    for key in ("codes", "meta", "tail"):
        assert torch.equal(bulk[key], ct[key]), key


def test_append_token_staggered_slots():
    """Per-slot positions that differ between slots (continuous batching)."""
    kv = _kv(3)
    cj = JK.to_kernel_layout(JK.quantize_kv(jnp.zeros_like(kv)))
    ct = TK.to_kernel_layout(TK.quantize_kv(_t(jnp.zeros_like(kv))))
    pos = np.array([4, 1], np.int32)
    cj = JK.append_token(cj, kv[:, :1], jnp.asarray(pos))
    ct = TK.append_token(ct, _t(kv[:, :1]), torch.from_numpy(pos))
    for key in ("codes", "meta", "tail"):
        _same(cj[key], ct[key])


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _spec_shapes(tree):
    """{path: (shape, itemsize)} of a nested dict of PSpec leaves (JAX's or
    the port's)."""
    size = lambda dt: dt.itemsize if isinstance(dt, torch.dtype) else np.dtype(dt).itemsize
    return {path: (tuple(s.shape), size(s.dtype)) for path, s in _leaves(tree)}


@pytest.mark.parametrize("kv_format", ["bf16", "hif4"])
def test_abstract_cache_matches_reference_and_serving_cache(kv_format):
    """The decode-cache spec has the reference's leaves, and the cache that
    serving builds after prefill (packed, padded to capacity) is exactly
    that allocation."""
    jcfg, tcfg = jget_arch("qwen1.5-0.5b").reduced(), tget_arch("qwen1.5-0.5b").reduced()
    batch, prompt, cap = 2, 8, 12
    tspec = TL.abstract_cache(tcfg, batch, cap, kv_format)
    assert _spec_shapes(tspec) == _spec_shapes(JL.abstract_cache(jcfg, batch, cap,
                                                                 kv_format))
    plan = TL.quant_plan(tcfg, TP.get_policy("paper-iv", impl="packed",
                                             kv=TK.KV_HIF4))
    params = TS.prepare_params_for_serving(TL.init_params(tcfg, 0, device="cpu"),
                                           tcfg, plan, device="cpu")
    tokens = torch.randint(0, tcfg.vocab, (batch, prompt),
                           generator=torch.Generator().manual_seed(0))
    _, cache = TS.build_decode_cache(
        tcfg, params, {"tokens": tokens}, TS.serving_ctx(TCtx(plan=plan)),
        TS.ServeConfig(max_new_tokens=cap - prompt, kv_format=kv_format))
    built = {path: (tuple(t.shape), t.element_size())
             for path, t in _leaves(cache["kv"], ("kv",))}
    want = {path: v for path, v in _spec_shapes(tspec).items() if path[0] == "kv"}
    assert built == want


@pytest.mark.parametrize("spec", ["paper-iv", "sensitive-fallback",
                                  "uniform:hif4", "uniform:none"])
@pytest.mark.parametrize("impl", ["packed", "qdq"])
def test_policy_plan_matches_reference(spec, impl):
    jcfg, tcfg = jget_arch("qwen1.5-0.5b").reduced(), tget_arch("qwen1.5-0.5b").reduced()
    pj = JL.quant_plan(jcfg, JP.get_policy(spec, impl=impl, kv=JK.KV_HIF4))
    pt = TL.quant_plan(tcfg, TP.get_policy(spec, impl=impl, kv=TK.KV_HIF4))
    rows = lambda plan: [(s.path, s.cfg.fmt, s.cfg.impl, s.packed,
                          s.quantize_offline, tuple(s.contract_axes),
                          tuple(s.shape)) for s in plan.sites]
    assert rows(pj) == rows(pt)
    assert pj.base.fmt == pt.base.fmt and pj.base.impl == pt.base.impl
    assert pt.kv.kv_format == "hif4"
    assert TP.known_policy_spec(spec)


def test_policy_json_round_trip_and_strictness(tmp_path):
    """A policy file written by the reference loads unchanged; typos raise."""
    pol = JP.get_policy("sensitive-fallback", impl="packed", kv=JK.KV_HIF4)
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(pol.to_json_dict()))
    loaded = TP.get_policy(str(path), impl="packed")
    assert loaded.to_json_dict()["rules"][1:] == pol.to_json_dict()["rules"]
    assert loaded.kv.kv_format == "hif4"
    with pytest.raises(ValueError):
        TP.QuantPolicy.from_json_dict({"rulse": []})
    # nvfp4-baseline resolves as the reference's preset does
    tb = TP.get_policy("nvfp4-baseline", impl="pallas", kv=TK.KV_HIF4)
    jb = JP.get_policy("nvfp4-baseline", impl="pallas", kv=JK.KV_HIF4)
    assert tb.to_json_dict() == jb.to_json_dict()
    assert TP.known_policy_spec("nvfp4-baseline")
