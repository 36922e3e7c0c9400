"""The NVFP4 / NVFP4+PTS / MXFP4 baseline formats, the format registry, the
error metrics and the fixed-point dot of the PyTorch port vs the JAX
reference, on the same numpy inputs.

* Bitwise: the E2M1, E4M3 and E8M0 helpers on an edge grid (every grid
  value and midpoint, the E4M3 normal/subnormal border, 448, E8M0 across
  its range); ``quantize_groups`` and ``to_absorbed_int``; every format's
  ``qdq`` and ``qdq_pts`` at sigma = 0.01 * 2^x for x in {0, 8, 17, 19} (the
  last two are where direct-cast NVFP4 saturates its E4M3 scale); offline
  weight PTQ of a model's blocks; ``hif4_dot_fixed_point``; the registry's
  metadata and the ``nvfp4-baseline`` plan, site by site.
* Float-close (rtol 1e-5): the metrics, whose float32 means may sum in
  another order.
* The reference runs jitted on float32 inputs (bitwise equal to its eager
  run there, and much quicker to compile) and eagerly on bfloat16 inputs,
  where XLA's excess precision would skip bf16 roundings under jit.
* The one documented difference: XLA's CPU backend flushes float32
  subnormals, PyTorch keeps them, so the E8M0 scale for an amax below
  2^-124 (scale 2^-127, a subnormal) differs (ROADMAP §3); the port follows
  IEEE, as the card does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import formats as JF
from repro.core import hif4 as JH
from repro.core import kvcache as JK
from repro.core import metrics as JM
from repro.core import mxfp4 as JMX
from repro.core import nvfp4 as JNV
from repro.core import policy as JP
from repro.core import rounding as JR
from repro.core.qlinear import QuantConfig as JQC
from repro.core.qlinear import hif4_dot_fixed_point as j_dot
from repro.core.qlinear import quantize_params_offline as j_offline
from repro.models import lm as JL
from repro_torch import interop
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import formats as TF
from repro_torch.core import kvcache as TK
from repro_torch.core import metrics as TM
from repro_torch.core import mxfp4 as TMX
from repro_torch.core import nvfp4 as TNV
from repro_torch.core import policy as TP
from repro_torch.core import rounding as TR
from repro_torch.core.qlinear import QuantConfig as TQC
from repro_torch.core.qlinear import hif4_dot_fixed_point as t_dot
from repro_torch.core.qlinear import quantize_params_offline as t_offline
from repro_torch.models import lm as TL

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

FORMATS = ("hif4", "nvfp4", "nvfp4_pts", "mxfp4")


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), "cpu")


def _same(a_jax, t_torch):
    """Bitwise: the same float32 / integer bits (bf16 compared as float32)."""
    a = np.asarray(a_jax)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    b = interop.to_numpy(t_torch)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b)


def _signed(v):
    v = np.asarray(v, np.float32)
    return np.concatenate([v, -v])


def _midpoints(grid):
    g = np.asarray(grid, np.float64)
    return ((g[1:] + g[:-1]) / 2).astype(np.float32)


# ---------------------------------------------------------------------------
# element and scale codecs
# ---------------------------------------------------------------------------

E2M1_EDGE = _signed(np.concatenate([
    JR.E2M1_VALUES, _midpoints(JR.E2M1_VALUES),
    [0.24, 0.26, 0.74, 0.76, 5.0, 6.5, 7.0, 100.0, 2.0 ** -20, 2.0 ** -30,
     1e-3, 3.9999, 4.0001]]))


def test_e2m1_quantize_and_codec_bitwise():
    q = TR.quantize_e2m1(_t(E2M1_EDGE))
    _same(JR.quantize_e2m1(jnp.asarray(E2M1_EDGE)), q)
    grid = jnp.asarray(_signed(JR.E2M1_VALUES))
    _same(JR.encode_e2m1(grid), TR.encode_e2m1(_t(grid)))
    _same(JR.e2m1_to_int(grid), TR.e2m1_to_int(_t(grid)))
    codes = np.arange(16, dtype=np.uint8)
    _same(JR.decode_e2m1(jnp.asarray(codes)), TR.decode_e2m1(_t(codes)))


# E4M3: the subnormal grid k * 2^-9, the normal/subnormal border 2^-6 and
# its neighbours, midpoints in both regions, 448 and above
_E4M3_SUB = np.arange(0, 8) * 2.0 ** -9
_E4M3_NORMAL = 2.0 ** -6 * (1 + np.arange(8) / 8)
E4M3_EDGE = _signed(np.concatenate([
    _E4M3_SUB, _midpoints(_E4M3_SUB), _E4M3_NORMAL, _midpoints(_E4M3_NORMAL),
    [2.0 ** -6 - 2.0 ** -10, 2.0 ** -6 - 2.0 ** -11, 2.0 ** -10, 1.5 * 2.0 ** -10,
     416.0, 432.0, 440.0, 448.0, 456.0, 464.0, 480.0, 500.0, 1e4, 3e38,
     1.0, 1.0625, 1.1875, 240.0, 248.0]]))


@pytest.mark.parametrize("saturate", [True, False])
def test_e4m3_round_bitwise(saturate):
    x = E4M3_EDGE if saturate else E4M3_EDGE[np.abs(E4M3_EDGE) < 1e4]
    _same(JR.round_e4m3(jnp.asarray(x), saturate=saturate),
          TR.round_e4m3(_t(x), saturate=saturate))


# E8M0: amax across the scale's normal range, grid values of E2M1 x 2^e and
# their neighbours; 0 maps to 1
E8M0_EDGE = np.concatenate([
    [0.0, 2.0 ** -124, 1.5 * 2.0 ** -124, 2.0 ** -123, 1.0, 3.0, 4.0, 5.99,
     6.0, 7.0, 8.0, 2.0 ** 100, 3e38, 2.0 ** 127, 2.0 ** -100 * 6.0],
    2.0 ** np.arange(-120, 128, 7)]).astype(np.float32)


def test_e8m0_scale_bitwise():
    _same(JR.e8m0_scale_from_amax(jnp.asarray(E8M0_EDGE)),
          TR.e8m0_scale_from_amax(_t(E8M0_EDGE)))


def test_e8m0_subnormal_scale_is_kept_where_xla_flushes():
    """amax below 2^-124: the scale 2^(floor(log2 amax) - 2), clamped at
    2^-127, is a float32 subnormal. The port keeps it (IEEE, as PyTorch on
    the CPU and on the card computes); XLA's CPU backend flushes it to zero,
    and reads a subnormal amax (2^-127) as zero (scale 1). A group at such
    an amax then dequantizes to itself in the port and to zero in the
    reference."""
    amax = np.array([1.5 * 2.0 ** -125, 2.0 ** -126, 2.0 ** -127], np.float32)
    port = TR.e8m0_scale_from_amax(_t(amax)).numpy()
    ref = np.asarray(JR.e8m0_scale_from_amax(jnp.asarray(amax)))
    np.testing.assert_array_equal(port, np.array([2.0 ** -127] * 3, np.float32))
    np.testing.assert_array_equal(ref, np.array([0.0, 0.0, 1.0], np.float32))
    group = np.full((1, 32), 2.0 ** -126, np.float32)
    np.testing.assert_array_equal(TMX.qdq(_t(group)).numpy(), group)
    np.testing.assert_array_equal(np.asarray(JMX.qdq(jnp.asarray(group))), 0 * group)


# ---------------------------------------------------------------------------
# group quantization and qdq
# ---------------------------------------------------------------------------


def _gauss(seed, shape, sigma, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * sigma).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_nvfp4_groups_and_absorbed_int_bitwise(dtype):
    x = _gauss(0, (64, 16), 0.02, dtype) * jnp.asarray(
        np.exp2(np.random.default_rng(1).uniform(-12, 12, (64, 1)))).astype(
            jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    gj, gt = JNV.quantize_groups(x), TNV.quantize_groups(_t(x))
    _same(gj.scale, gt.scale)
    _same(gj.e2m1, gt.e2m1)
    _same(JNV.dequantize_groups(gj), TNV.dequantize_groups(gt))
    for a, b in zip(JNV.to_absorbed_int(gj), TNV.to_absorbed_int(gt)):
        _same(a, b)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_mxfp4_groups_bitwise(dtype):
    x = _gauss(2, (64, 32), 1.0, dtype) * jnp.asarray(
        np.exp2(np.random.default_rng(3).uniform(-60, 60, (64, 1)))).astype(
            jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    gj, gt = JMX.quantize_groups(x), TMX.quantize_groups(_t(x))
    _same(gj.scale, gt.scale)
    _same(gj.e2m1, gt.e2m1)
    _same(JMX.dequantize_groups(gj), TMX.dequantize_groups(gt))


@pytest.mark.parametrize("x_exp", [0, 8, 17, 19])
@pytest.mark.parametrize("fmt", ["nvfp4", "nvfp4_pts", "mxfp4"])
def test_qdq_bitwise_across_scales(fmt, x_exp):
    """sigma = 0.01 * 2^x: at x = 17 and 19 direct-cast NVFP4's group scale
    (amax / 6) passes E4M3's 448 and saturates; PTS rescales first. (HiF4's
    qdq is held bitwise in tests/test_torch_hif4.py.)"""
    x = _gauss(4 + x_exp, (48, 256), 0.01 * 2.0 ** x_exp)
    jf, tf = JF.get_format(fmt), TF.get_format(fmt)
    for axis in (-1, 0):
        _same(jax.jit(jf.qdq, static_argnums=1)(x, axis), tf.qdq(_t(x), axis=axis))
    xb = x.astype(jnp.bfloat16)                      # the serving dtype
    _same(jf.qdq(xb, axis=-1), tf.qdq(_t(xb), axis=-1))


def test_nvfp4_direct_cast_saturates_where_pts_does_not():
    x = _gauss(9, (16, 256), 0.01 * 2.0 ** 19)
    err = {f: TM.qdq_error(_t(x), f, "rel_mse") for f in ("nvfp4", "nvfp4_pts")}
    assert err["nvfp4"] > 10 * err["nvfp4_pts"], err


def test_registry_metadata_matches_reference():
    assert TF.available_formats() == JF.available_formats()
    for name in JF.available_formats():
        j, t = JF.get_format(name), TF.get_format(name)
        for field in ("name", "group_size", "bits_per_value", "max_pos",
                      "min_pos", "local_dynamic_range_binades", "needs_pts"):
            assert getattr(t, field) == getattr(j, field), (name, field)
    for none in (None, "none", "bf16"):
        assert TF.get_format(none) is None
    with pytest.raises(ValueError):
        TF.get_format("fp3")


@pytest.mark.parametrize("fmt", ["nvfp4", "nvfp4_pts", "mxfp4"])
def test_offline_weight_ptq_bitwise(fmt):
    """quantize_params_offline through a resolved plan: every block weight
    of the smoke model QDQ'd along its contraction axes as the reference
    does (per-tensor scale over the stacked layers for PTS)."""
    jcfg, tcfg = jget_arch("qwen1.5-0.5b").reduced(), tget_arch("qwen1.5-0.5b").reduced()
    rng = np.random.default_rng(5)
    blocks = {}
    for path, spec in _block_specs(TL.abstract_params(tcfg)["blocks"]):
        blocks[path] = (rng.standard_normal(spec.shape) * 0.02).astype(np.float32)
    jtree, ttree = _nest(blocks, jnp.asarray), _nest(blocks, _t)
    jplan = JL.quant_plan(jcfg, JQC(fmt=fmt, impl="qdq"))
    tplan = TL.quant_plan(tcfg, TQC(fmt=fmt, impl="qdq"))
    jout = jax.jit(lambda tree: j_offline(tree, jplan.base, plan=jplan,
                                          prefix="blocks"))(jtree)
    tout = t_offline(ttree, tplan.base, plan=tplan, prefix="blocks")
    n_quantized = 0
    for path in blocks:
        j, t = _get(jout, path), _get(tout, path)
        _same(j, t)
        n_quantized += not np.array_equal(np.asarray(j), blocks[path])
    assert n_quantized == 7


def _block_specs(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _block_specs(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(flat, conv):
    out: dict = {}
    for path, a in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = conv(a)
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("n", [64, 256])
def test_hif4_dot_fixed_point_bitwise(n):
    rng = np.random.default_rng(n)
    a = (rng.standard_normal(n) * np.exp2(rng.uniform(-8, 8, n))).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    got = t_dot(_t(a), _t(b))
    _same(jax.jit(j_dot)(jnp.asarray(a), jnp.asarray(b)), got)
    # the integer flow equals the dot of the dequantized operands
    exact = float(np.dot(np.asarray(JH.qdq(jnp.asarray(a)), np.float64),
                         np.asarray(JH.qdq(jnp.asarray(b)), np.float64)))
    assert abs(float(got) - exact) <= 1e-6 * max(1.0, abs(exact))


@pytest.mark.parametrize("impl", ["packed", "pallas"])
def test_nvfp4_baseline_plan_site_by_site(impl):
    jcfg, tcfg = jget_arch("qwen1.5-0.5b").reduced(), tget_arch("qwen1.5-0.5b").reduced()
    pj = JL.quant_plan(jcfg, JP.get_policy("nvfp4-baseline", impl=impl, kv=JK.KV_HIF4))
    pt = TL.quant_plan(tcfg, TP.get_policy("nvfp4-baseline", impl=impl, kv=TK.KV_HIF4))
    rows = lambda plan: [(s.path, s.cfg.fmt, s.cfg.impl, s.cfg.weights_only,
                          s.packed, s.quantize_offline, tuple(s.contract_axes),
                          tuple(s.shape), s.n_values) for s in plan.sites]
    assert rows(pt) == rows(pj)
    assert not pt.packed_paths                       # NVFP4 has no container
    assert (pt.base.fmt, pt.base.impl) == ("nvfp4_pts", impl)
    assert TP.known_policy_spec("nvfp4-baseline")


# ---------------------------------------------------------------------------
# metrics (float-close: float32 means may sum in another order)
# ---------------------------------------------------------------------------


def test_metrics_close_to_reference():
    """The port's metrics of its own qdq against the reference's metrics of
    the reference's qdq (``qdq_error`` spelled out with the jitted qdq)."""
    x = _gauss(6, (48, 256), 0.01 * 2.0 ** 8)
    xt = _t(x)
    want = {}
    for fmt in FORMATS + ("none",):
        xq = x if fmt == "none" else jax.jit(JF.get_format(fmt).qdq)(x)
        for metric, fn in JM.METRICS.items():
            want[fmt, metric] = float(fn(x, xq))
            np.testing.assert_allclose(TM.qdq_error(xt, fmt, metric=metric),
                                       want[fmt, metric], rtol=1e-5, atol=1e-12,
                                       err_msg=f"{fmt} {metric}")
    table = TM.format_error_table(xt)
    assert list(table) == list(TM.QDQ_FORMATS) == list(JM.QDQ_FORMATS)
    np.testing.assert_allclose([table[f] for f in table],
                               [want[f, "mse"] for f in table], rtol=1e-5)
    w = _gauss(7, (256, 64), 0.02)
    wq = JF.get_format("mxfp4").qdq(w, axis=0)
    xs = _gauss(8, (32, 256), 1.0)
    np.testing.assert_allclose(TM.rel_output_error(_t(w), _t(wq), _t(xs)),
                               JM.rel_output_error(w, wq, xs), rtol=1e-5)
    p = np.array([1, 2, 3, 4, 5]); r = np.array([1, 2, 0, 4, 0])
    assert TM.agreement(_t(p), _t(r)) == JM.agreement(jnp.asarray(p), jnp.asarray(r))
    assert TM.agreement(_t(p), _t(r)) == pytest.approx(0.6)
    assert TM.agreement(_t(p), None) == 1.0
