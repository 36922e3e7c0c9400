"""HiF4 format core of the PyTorch port vs the JAX reference, bitwise.

The same inputs, made with numpy from a seed, go through ``repro.core``
(JAX, on the CPU) and ``repro_torch.core`` (PyTorch, on the CPU). Every
bit-level quantity must agree exactly: Algorithm 1's components on f32 and
bf16 inputs, the packed codes and meta words, unpacking and dequantization,
the absorbed-shift integers and the K-major tile helpers, including the
E6M2 0xFF code decoding to NaN on every path. Tolerance: none (bitwise).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hif4 as J
from repro.core import rounding as JR
from repro.core.qlinear import PackedW as JPackedW
from repro_torch import interop
from repro_torch.core import hif4 as T
from repro_torch.core import rounding as TR

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)


def _bits(a) -> np.ndarray:
    """Bit pattern of a JAX array or torch tensor (floats as uint32/uint16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    else:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _meta_bits(t: torch.Tensor) -> np.ndarray:
    return interop.to_numpy(t, uint32=True)


def _inputs(seed: int, n: int = 48) -> np.ndarray:
    """Groups over a wide exponent range plus the edge rows: zeros, signed
    zeros, subnormals, the 4.0 / 2.0 micro-exponent thresholds, values at
    the top of the bf16 range, ties of the S1P2 grid."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 64)).astype(np.float32)
    x *= np.exp2(rng.uniform(-40, 40, (n, 1))).astype(np.float32)
    x[0] = 0.0
    x[1] = -0.0
    x[2, :8] = [1e-40, -1e-39, 3e-45, -0.0, 4.0, 2.0, -2.0, 7.0]
    x[3] = np.float32(2.0 ** -126) * np.arange(64)
    x[4] = 3.0e38 * np.where(np.arange(64) % 2, 1, -1)
    x[5] = 7.0 * np.exp2(np.arange(-32, 32)).astype(np.float32)
    x[6] = np.tile([4.0, 0.5, 2.0, 0.125], 16)
    x[7] = np.tile([0.125, 0.375, -0.125, 1.0], 16)
    return x


def _pair(x: np.ndarray, dtype: str):
    xj = jnp.asarray(x)
    if dtype == "bf16":
        xj = xj.astype(jnp.bfloat16)
    return xj, interop.tensor_from_numpy(np.asarray(xj), "cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_groups_bitwise(dtype, seed):
    xj, xt = _pair(_inputs(seed), dtype)
    gj, gt = J.quantize_groups(xj), T.quantize_groups(xt)
    for field in ("e6m2", "e1_8", "e1_16", "s1p2"):
        a, b = getattr(gj, field), getattr(gt, field)
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=field)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_unpack_dequantize_bitwise(dtype):
    xj, xt = _pair(_inputs(3), dtype)
    pj, pt = J.quantize_packed(xj), T.quantize_packed(xt)
    np.testing.assert_array_equal(np.asarray(pj.codes), pt.codes.numpy())
    np.testing.assert_array_equal(np.asarray(pj.meta), _meta_bits(pt.meta))
    uj, ut = J.unpack_groups(pj), T.unpack_groups(pt)
    for field in ("e6m2", "e1_8", "e1_16", "s1p2"):
        np.testing.assert_array_equal(_bits(getattr(uj, field)),
                                      _bits(getattr(ut, field)), err_msg=field)
    np.testing.assert_array_equal(_bits(J.dequantize_groups(J.unpack_groups(pj))),
                                  _bits(T.dequantize_packed(pt)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_absorbed_int_bitwise(dtype):
    xj, xt = _pair(_inputs(4), dtype)
    ij, sj = J.to_absorbed_int(J.quantize_groups(xj))
    it, st = T.to_absorbed_int(T.quantize_groups(xt))
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_array_equal(_bits(sj), _bits(st))
    assert int(np.abs(it.numpy()).max()) <= 28


def _kmajor_pair(seed: int, k: int = 256, n: int = 48, nan_at=None):
    """K-major (codes, meta) of one packed weight, in JAX and in torch."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * np.exp2(rng.uniform(-8, 8, (1, n)))
         ).astype(np.float32)
    pw = JPackedW.from_dense(jnp.asarray(w)).to_kernel_layout()
    codes, meta = np.asarray(pw.codes), np.asarray(pw.meta).copy()
    if nan_at is not None:
        meta[nan_at] = (meta[nan_at] & 0x00FFFFFF) | 0xFF000000
    return ((jnp.asarray(codes), jnp.asarray(meta)),
            (interop.tensor_from_numpy(codes, "cpu"),
             interop.tensor_from_numpy(meta, "cpu")))


@pytest.mark.parametrize("nan_at", [None, (1, 5), (3, 0)])
def test_kmajor_helpers_bitwise(nan_at):
    (cj, mj), (ct, mt) = _kmajor_pair(5, nan_at=nan_at)
    np.testing.assert_array_equal(np.asarray(J.expand_codes_km(cj)),
                                  T.expand_codes_km(ct).numpy())
    shj, scj = J.expand_meta_km(mj)
    sht, sct = T.expand_meta_km(mt)
    np.testing.assert_array_equal(np.asarray(shj), sht.numpy())
    np.testing.assert_array_equal(np.isnan(np.asarray(scj)), sct.isnan().numpy())
    np.testing.assert_array_equal(np.nan_to_num(np.asarray(scj)),
                                  np.nan_to_num(sct.numpy()))
    ij, sj = J.absorbed_int_km(cj, mj)
    it, st = T.absorbed_int_km(ct, mt)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    dj = np.asarray(J.dequantize_km(cj, mj).astype(jnp.float32))
    dt = T.dequantize_km(ct, mt).float().numpy()
    np.testing.assert_array_equal(np.isnan(dj), np.isnan(dt))
    np.testing.assert_array_equal(np.nan_to_num(dj), np.nan_to_num(dt))
    if nan_at is not None:
        g, col = nan_at
        assert np.isnan(dt[g * 64:(g + 1) * 64, col]).all()
        assert np.isnan(sct[g, col].item())


def test_nan_meta_decodes_to_nan_on_every_path():
    """E6M2 0xFF: unpack + dequantize, decode_e6m2, K-major decode and the
    NaN mask all agree with the reference and yield NaN."""
    xj, xt = _pair(_inputs(6, n=8), "bf16")
    pj, pt = J.quantize_packed(xj), T.quantize_packed(xt)
    meta_np = np.asarray(pj.meta).copy()
    meta_np[2] = (meta_np[2] & 0x00FFFFFF) | 0xFF000000
    pj = J.HiF4Packed(pj.codes, jnp.asarray(meta_np))
    pt = T.HiF4Packed(pt.codes, interop.tensor_from_numpy(meta_np, "cpu"))
    dj = np.asarray(J.dequantize_groups(J.unpack_groups(pj)).astype(jnp.float32))
    dt = T.dequantize_packed(pt).float().numpy()
    np.testing.assert_array_equal(np.isnan(dj), np.isnan(dt))
    assert np.isnan(dt[2]).all() and not np.isnan(dt[[0, 1, 3, 5, 6, 7]]).any()
    np.testing.assert_array_equal(np.asarray(J.meta_nan_mask(pj.meta)),
                                  T.meta_nan_mask(pt.meta).numpy())
    codes = np.arange(256, dtype=np.uint8)
    ej = np.asarray(JR.decode_e6m2(jnp.asarray(codes)))
    et = TR.decode_e6m2(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(np.isnan(ej), np.isnan(et))
    np.testing.assert_array_equal(_bits(np.nan_to_num(ej)), _bits(np.nan_to_num(et)))


def test_e6m2_codec_and_reciprocal_bitwise():
    """Every non-NaN E6M2 code round-trips as in the reference, and the
    reciprocal matches the paper's 4-entry LUT."""
    codes = np.arange(255, dtype=np.uint8)
    vals_t = TR.decode_e6m2(torch.from_numpy(codes))
    np.testing.assert_array_equal(TR.encode_e6m2(vals_t).numpy(), codes)
    vals_j = JR.decode_e6m2(jnp.asarray(codes))
    np.testing.assert_array_equal(_bits(vals_j), _bits(vals_t))
    np.testing.assert_array_equal(_bits(JR.e6m2_reciprocal_bf16(vals_j)),
                                  _bits(TR.e6m2_reciprocal_bf16(vals_t)))
    lut = {0: 1.0, 1: 0.80078125, 2: 0.66796875, 3: 0.5703125}
    for m, frac in lut.items():
        v = torch.tensor([1 + m * 0.25])
        assert TR.e6m2_reciprocal_bf16(v).item() == frac


@pytest.mark.parametrize("value, expected", [
    (1e30, 2.0 ** 15 * 1.5), (1e-30, 2.0 ** -48), (2.0 ** 15 * 1.75, 2.0 ** 15 * 1.5)])
def test_round_e6m2_range(value, expected):
    t = TR.round_e6m2(torch.tensor([value], dtype=torch.float32))
    assert t.item() == expected == float(JR.round_e6m2(jnp.float32(value)))


@pytest.mark.parametrize("value, expected", [(0.125, 0.0), (0.375, 0.5),
                                             (-0.125, -0.0), (2.5, 1.75)])
def test_s1p2_rne_ties(value, expected):
    t = TR.quantize_s1p2(torch.tensor([value]))
    assert t.item() == expected == float(JR.quantize_s1p2(jnp.float32(value)))
    code_t = TR.encode_s1p2(t)
    code_j = JR.encode_s1p2(JR.quantize_s1p2(jnp.float32(value)))
    assert code_t.item() == int(code_j)


@pytest.mark.parametrize("shape, axis", [((3, 128), -1), ((128, 5), 0),
                                         ((2, 100, 3), 1)])
def test_qdq_along_axis_bitwise(shape, axis):
    """Fake quant along an axis (with zero padding to whole groups)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(J.qdq(jnp.asarray(x), axis=axis)),
        _bits(T.qdq(torch.from_numpy(x), axis=axis)))
