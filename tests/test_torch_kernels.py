"""The plain PyTorch versions of the three ported kernels vs the JAX
reference. (The CUDA kernels against their plain versions are in
``tests/test_torch_cuda.py``, which imports no JAX so that it runs on a
machine with a card.)

* ``hif4_quantize``: plain version bitwise vs the reference's
  ``absorbed_activation`` and the interpret-mode Pallas kernel.
* ``fused_packed_matmul``: int32 group partials bitwise vs the reference's
  integer dot; outputs within rtol=1e-6 of the XLA twin and of the
  interpret-mode Pallas kernel, relative to the summed group magnitudes
  (only the f32 order of the sum over 64-groups may differ).
* ``fused_decode_attention``: at one KV tile within one bf16 ulp of the XLA
  twin, the ulp taken at the largest |output| of the head's row: the f32
  sums inside q.k and p.V run in another order, which can flip the last
  bf16 rounding, and where p.V cancels to near zero the output's own ulp is
  finer than that noise; at several tiles float-close (rtol=2^-7,
  atol=1e-3); both head-block geometries (d_head 32 and 64).
* Activation quantization is compared with the reference run op by op:
  under ``jax.jit`` XLA's default excess precision skips intermediate bf16
  roundings of the reference's native-bf16 path, so the jitted reference
  differs from its own eager run and from its Pallas kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as JK
from repro.core.qlinear import PackedW as JPackedW
from repro.kernels import bfp_matmul as JB
from repro.kernels import fused_attention as JA
from repro.kernels import fused_matmul as JM
from repro.kernels.hif4_quant import hif4_quantize as j_hif4_quantize
from repro_torch import interop
from repro_torch.core import kvcache as TK
from repro_torch.core.qlinear import PackedW as TPackedW
from repro_torch.kernels import bfp_matmul as TB
from repro_torch.kernels import build
from repro_torch.kernels import fused_attention as TA
from repro_torch.kernels import fused_matmul as TM
from repro_torch.kernels import hif4_quant as TQ

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), "cpu")


def _act(seed, m, k, dtype=jnp.bfloat16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)) * np.exp2(rng.uniform(-10, 10, (m, k // 64))
                                              ).repeat(64, axis=1)
    return jnp.asarray(x.astype(np.float32)).astype(dtype)


def _weight(seed, k, n):
    rng = np.random.default_rng(seed)
    w = jnp.asarray((rng.standard_normal((k, n)) * 0.02).astype(np.float32))
    return jax.jit(lambda a: JPackedW.from_dense(a).to_kernel_layout())(w)


# ---------------------------------------------------------------------------
# kernel 1: hif4_quantize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("m, k", [(8, 1024), (3, 2816)])
def test_quantize_plain_bitwise_vs_reference(dtype, m, k):
    x = _act(0, m, k, dtype)
    ij, sj = JM.absorbed_activation(x)               # op by op, see above
    it, st = TQ.hif4_quantize(_t(x))                 # CPU tensor: plain version
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_array_equal(np.asarray(sj).view(np.uint32),
                                  st.numpy().view(np.uint32))


def test_quantize_plain_bitwise_vs_interpret_kernel():
    x = _act(1, 8, 128)
    ij, sj = j_hif4_quantize(x, interpret=True)
    it, st = TQ.absorbed_activation(_t(x))
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())


# ---------------------------------------------------------------------------
# kernel 2: fused_packed_matmul
# ---------------------------------------------------------------------------


def _assert_close_to_abs_sum(yt, yj, ai, asc, codes, meta):
    """|dy| <= 1e-6 x the sum over groups of |a_scale * b_scale * dot|: the
    group partials are exact, only the f32 order of their sum differs, so
    the error scales with the summed magnitudes, not with a cancelled y."""
    b_ints, b_sc = TK.hif4.absorbed_int_km(codes, meta)
    abs_sum = TB.bfp_matmul_quantized_plain(ai.abs(), asc.abs(), b_ints.abs(),
                                            b_sc.abs())
    assert (np.abs(yt - yj) <= 1e-6 * abs_sum.numpy()).all()


@pytest.mark.parametrize("m, k, n", [(8, 1024, 96), (40, 256, 64), (4, 2816, 32)])
def test_matmul_plain_vs_reference(m, k, n):
    x = _act(2, m, k)
    pw = _weight(3, k, n)
    ai, asc = jax.jit(JM.absorbed_activation)(x)
    codes, meta = _t(pw.codes), _t(pw.meta)
    # int32 group partials, bitwise
    b_ints, _ = jax.jit(lambda c, mt: JK.hif4.absorbed_int_km(c, mt))(pw.codes, pw.meta)
    g = k // 64
    part_j = jax.lax.dot_general(
        ai.reshape(m, g, 64), b_ints.reshape(g, 64, n),
        dimension_numbers=(((2,), (1,)), ((1,), (0,))),
        preferred_element_type=jnp.int32)
    part_t = TB.group_partials(_t(ai), TK.hif4.absorbed_int_km(codes, meta)[0])
    np.testing.assert_array_equal(np.asarray(part_j), part_t.numpy())
    yj = np.asarray(jax.jit(JM.fused_packed_matmul_xla)(ai, asc, pw.codes, pw.meta))
    yt = TM.fused_packed_matmul(_t(ai), _t(asc), codes, meta).numpy()
    _assert_close_to_abs_sum(yt, yj, _t(ai), _t(asc), codes, meta)


def test_matmul_plain_vs_interpret_kernel():
    x = _act(4, 8, 128)
    pw = _weight(5, 128, 64)
    ai, asc = JM.absorbed_activation(x)
    yj = np.asarray(JM.fused_packed_matmul(ai, asc, pw.codes, pw.meta,
                                           interpret=True))
    yt = TM.fused_packed_matmul_plain(_t(ai), _t(asc), _t(pw.codes),
                                      _t(pw.meta)).numpy()
    _assert_close_to_abs_sum(yt, yj, _t(ai), _t(asc), _t(pw.codes), _t(pw.meta))


@pytest.mark.parametrize("m, n, k", [(8, 1024, 1024), (8, 2816, 1024),
                                     (3840, 1024, 2816), (64, 96, 192)])
def test_block_selection_matches_reference(m, n, k):
    assert TB.select_block_sizes(m, n, k) == JB.select_block_sizes(m, n, k)


# ---------------------------------------------------------------------------
# kernel 3: fused_decode_attention
# ---------------------------------------------------------------------------


def _attn_case(seed, b, s, hkv, rep, d):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: jnp.asarray((rng.standard_normal(shape) * 0.5)
                                    .astype(np.float32)).astype(jnp.bfloat16)
    q, k, v = mk(b, hkv * rep, d), mk(b, s, hkv, d), mk(b, s, hkv, d)
    pk = JK.to_kernel_layout(JK.quantize_kv(k))
    pv = JK.to_kernel_layout(JK.quantize_kv(v))
    lengths = np.array([1, 63, 64, 65, s, s - 1][:b], np.int32)
    return q, pk, pv, lengths


def _to_t(pk):
    return {key: _t(a) for key, a in pk.items()}


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units of the bf16 ulp at the largest |value| of each row
    (last axis) of ``a`` and ``b``."""
    mag = np.maximum(np.abs(a), np.abs(b)).max(axis=-1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return np.abs(a - b) / ulp


@pytest.mark.parametrize("hkv, rep, d", [(2, 1, 64), (2, 2, 64), (4, 1, 32),
                                         (4, 2, 32)])
def test_attention_one_tile_within_one_bf16_ulp(hkv, rep, d):
    q, pk, pv, lengths = _attn_case(6, 6, 128, hkv, rep, d)
    oj = np.asarray(jax.jit(JA.fused_decode_attention_xla, static_argnums=(4, 5))(
        q, pk, pv, jnp.asarray(lengths), hkv, d).astype(jnp.float32))
    ot = TA.fused_decode_attention(_t(q), _to_t(pk), _to_t(pv),
                                   torch.from_numpy(lengths), n_kv_heads=hkv,
                                   d_head=d).float().numpy()
    assert _bf16_ulps(ot, oj).max() <= 1.0


@pytest.mark.parametrize("d, hkv, block", [(64, 2, 64), (32, 4, 32)])
def test_attention_multi_tile_float_close(d, hkv, block):
    q, pk, pv, lengths = _attn_case(7, 6, 256, hkv, 1, d)
    oj = np.asarray(jax.jit(JA.fused_decode_attention_xla, static_argnums=(4, 5),
                            static_argnames=("block_kv",))(
        q, pk, pv, jnp.asarray(lengths), hkv, d, block_kv=block).astype(jnp.float32))
    ot = TA.fused_decode_attention_plain(_t(q), _to_t(pk), _to_t(pv),
                                         torch.from_numpy(lengths), hkv, d,
                                         block_kv=block).float().numpy()
    np.testing.assert_allclose(ot, oj, rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("d, hkv", [(64, 2), (32, 4)])
def test_attention_plain_vs_interpret_kernel(d, hkv):
    q, pk, pv, lengths = _attn_case(8, 2, 64, hkv, 1, d)
    lengths = np.array([5, 64], np.int32)
    oj = np.asarray(JA.fused_decode_attention(
        q, pk, pv, jnp.asarray(lengths), n_kv_heads=hkv, d_head=d,
        interpret=True).astype(jnp.float32))
    ot = TA.fused_decode_attention_plain(_t(q), _to_t(pk), _to_t(pv),
                                         torch.from_numpy(lengths), hkv,
                                         d).float().numpy()
    assert _bf16_ulps(ot, oj).max() <= 1.0


def test_attention_staging_tail_and_artifact_layout_plain():
    """The plain recurrence also serves what the kernel cannot tile."""
    rng = np.random.default_rng(9)
    q = jnp.asarray(rng.standard_normal((2, 3, 24)).astype(np.float32)).astype(jnp.bfloat16)
    kv = jnp.asarray(rng.standard_normal((2, 16, 3, 24)).astype(np.float32)).astype(jnp.bfloat16)
    pk = JK.quantize_kv(kv)
    lengths = np.array([3, 16], np.int32)
    oj = np.asarray(JA.fused_decode_attention_xla(q, pk, pk, jnp.asarray(lengths),
                                                  3, 24).astype(jnp.float32))
    ot = TA.fused_decode_attention_plain(_t(q), _to_t(pk), _to_t(pk),
                                         torch.from_numpy(lengths), 3, 24)
    assert _bf16_ulps(ot.float().numpy(), oj).max() <= 1.0
    assert not TA.kernel_compatible(_to_t(pk), 3, 24)
    with pytest.raises(ValueError):
        TA.fused_decode_attention(_t(q), _to_t(pk), _to_t(pk),
                                  torch.from_numpy(lengths), n_kv_heads=3, d_head=24)


@pytest.mark.parametrize("seq, want", [(128, None), (509, None), (512, None),
                                       (1024, 64), (160, None), (1536, None)])
def test_tile_selection_matches_reference(seq, want):
    assert TA.select_kv_block(seq, want) == JA.select_kv_block(seq, want)


@pytest.mark.parametrize("d", [16, 24, 32, 64, 128])
def test_heads_per_block_matches_reference(d):
    assert TA.heads_per_block(d) == JA.heads_per_block(d)


def test_wrappers_reject_what_the_kernels_do_not_take():
    """No silent fallback: unsupported devices, dtypes and shapes raise."""
    with pytest.raises(ValueError):
        TQ.hif4_quantize(torch.empty(4, 100))
    with pytest.raises(TypeError):
        TQ.hif4_quantize(torch.empty(4, 64, dtype=torch.float16))
    with pytest.raises(ValueError):
        TQ.hif4_quantize(torch.empty(4, 64, device="meta"))
    ai = torch.zeros(4, 128, dtype=torch.int8)
    asc = torch.zeros(4, 2)
    codes = torch.zeros(64, 8, dtype=torch.uint8)
    meta = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        TM.fused_packed_matmul(ai, asc, codes, meta.to(torch.int64))
    with pytest.raises(ValueError):
        TM.fused_packed_matmul(ai, asc, codes[:32], meta)
    with pytest.raises(ValueError):
        TM.fused_packed_matmul(ai.to("meta"), asc.to("meta"), codes.to("meta"),
                               meta.to("meta"))


def test_launch_counters_only_count_kernel_launches():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    build.reset_launches()
    x = _t(_act(10, 4, 128))
    ai, asc = TQ.hif4_quantize(x)
    pw = TPackedW.from_dense(torch.randn(128, 32).to(torch.bfloat16)).to_kernel_layout()
    TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta)
    TM.fused_decode_matmul(x, pw.codes, pw.meta)
    TB.bfp_decode_matmul(ai, asc, torch.randn(32, 128).T)
    pool = TK.init_page_pool(1, 2, 64, 2, 8)                  # (L, NP, F, P)
    kv = torch.randn(1, 1, 2, 64)
    TK.append_kv({t: {k: a[0, :1] for k, a in pool[t].items()}
                  for t in ("k", "v")}, kv, kv, 3)          # contiguous (1, F, 8)
    assert build.LAUNCHES == {"hif4_quantize": 0, "fused_packed_matmul": 0,
                              "fused_decode_matmul": 0,
                              "fused_decode_attention": 0,
                              "fused_paged_decode_attention": 0,
                              "bfp_matmul_quantized": 0,
                              "bfp_decode_matmul": 0, "kv_append": 0}
