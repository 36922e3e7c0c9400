"""The decode form of kernel 2 with kernel 1 as its prologue
(``fused_decode_matmul``, ``csrc/fused_decode_matmul.cu``) on CPU tensors,
where its wrapper runs the plain version, and its host-side launch plan.
(The CUDA kernel against its plain version is in ``tests/test_torch_cuda.py``.)

* The wrapper is bitwise the pair it replaces: ``hif4_quantize`` then
  ``fused_packed_matmul`` then the cast, for bf16 and f32 in and out, M in
  {1, 8, 17, 32}, K in {64, 1024}, a ragged N; a NaN (E6M2 0xFF) meta word
  reaches only its column.
* Against the JAX reference (``absorbed_activation`` op by op, then
  ``fused_packed_matmul_xla``, then ``.astype``): the ints and scales
  bitwise; the f32 output within 1e-6 of the summed group magnitudes (the
  group partials are exact; only the f32 order of their sum differs,
  ROADMAP §3); a cast output equal to the reference's cast wherever the f32
  values agree bitwise and elsewhere within that bound plus one bf16 ulp
  (an f32 difference can cross a rounding boundary of the cast).
* The launch plan: at the main path's decode shapes and at ragged N every
  (column, 64-group) is covered by exactly one CTA, the grid holds at least
  two CTAs per SM of the H100 at the main path's shapes, and a CTA's shared
  memory stays within 227 KB for M <= 32 and K up to 2 816.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qlinear import PackedW as JPackedW
from repro.kernels import fused_matmul as JM
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import hif4
from repro_torch.core.qlinear import PackedW, QuantConfig
from repro_torch.kernels import bfp_matmul as TB
from repro_torch.kernels import build
from repro_torch.kernels import fused_matmul as TM
from repro_torch.kernels import hif4_quant as TQ

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

N_RAGGED = 40                      # not a multiple of the 32-column tile
MAIN_SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024)]   # (K, N)
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


def _x(seed, m, k):
    """(M, K) f32 activations whose 64-groups span 2^-10..2^10."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)) * np.exp2(rng.uniform(-10, 10, (m, k // 64))
                                              ).repeat(64, axis=1)
    return x.astype(np.float32)


def _weight(seed, k, n):
    """A reference PackedW in the kernel layout and the port's operands."""
    rng = np.random.default_rng(seed)
    w = jnp.asarray((rng.standard_normal((k, n)) * 0.02).astype(np.float32))
    pj = jax.jit(lambda a: JPackedW.from_dense(a).to_kernel_layout())(w)
    pt = interop.packed_from_jax(pj, "cpu")
    return pj, pt.codes, pt.meta


def _pair(x, codes, meta, out_dtype):
    ai, asc = TQ.hif4_quantize(x)
    return TM.fused_packed_matmul(ai, asc, codes, meta).to(out_dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 8, 17, 32])
@pytest.mark.parametrize("k", [64, 1024])
def test_decode_form_bitwise_vs_the_pair(k, m, dtype, out):
    x = torch.from_numpy(_x(m * k, m, k)).to(DTYPES[dtype][0])
    _, codes, meta = _weight(k + m, k, N_RAGGED)
    build.reset_launches()
    y = TM.fused_decode_matmul(x, codes, meta, DTYPES[out][0])
    assert y.dtype == DTYPES[out][0] and tuple(y.shape) == (m, N_RAGGED)
    assert torch.equal(_bits(y), _bits(_pair(x, codes, meta, DTYPES[out][0])))
    assert torch.equal(_bits(y), _bits(TM.fused_decode_matmul_plain(
        x, codes, meta, DTYPES[out][0])))
    assert sum(build.LAUNCHES.values()) == 0          # CPU: no kernel launched
    # the default output dtype is the input's
    assert TM.fused_decode_matmul(x, codes, meta).dtype == x.dtype


def test_decode_form_nan_meta_reaches_only_its_column():
    x = torch.from_numpy(_x(3, 8, 256)).to(torch.bfloat16)
    _, codes, meta = _weight(4, 256, N_RAGGED)
    meta = meta.clone()
    meta[2, 37] |= -(1 << 24)                          # E6M2 code 0xFF
    y = TM.fused_decode_matmul(x, codes, meta)
    want = torch.zeros_like(y, dtype=torch.bool)
    want[:, 37] = True
    assert torch.equal(y.isnan(), want)
    assert torch.equal(y.isnan(), _pair(x, codes, meta, torch.bfloat16).isnan())


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 8, 17, 32])
@pytest.mark.parametrize("k", [64, 1024])
def test_decode_form_vs_reference(k, m, dtype):
    tdt, jdt = DTYPES[dtype]
    xn = _x(7 * m + k, m, k)
    xj = jnp.asarray(xn).astype(jdt)
    xt = interop.tensor_from_numpy(np.asarray(xj), "cpu")
    pj, codes, meta = _weight(m + 2 * k, k, N_RAGGED)
    # the prologue: the reference's Algorithm 1 op by op (ROADMAP §3: jitted
    # it skips bf16 roundings), bitwise
    ij, sj = JM.absorbed_activation(xj)
    it, st = TQ.absorbed_activation(xt)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_array_equal(np.asarray(sj).view(np.uint32),
                                  st.numpy().view(np.uint32))
    yj = np.asarray(jax.jit(JM.fused_packed_matmul_xla)(ij, sj, pj.codes, pj.meta))
    y32 = TM.fused_decode_matmul(xt, codes, meta, torch.float32).numpy()
    b_ints, b_sc = hif4.absorbed_int_km(codes, meta)
    abs_sum = TB.bfp_matmul_quantized_plain(it.abs(), st.abs(), b_ints.abs(),
                                            b_sc.abs()).numpy()
    assert (np.abs(y32 - yj) <= 1e-6 * abs_sum).all()
    # the output in the input's dtype against the reference's cast
    yc = TM.fused_decode_matmul(xt, codes, meta).float().numpy()
    ycj = np.asarray(jnp.asarray(yj).astype(jdt).astype(jnp.float32))
    if dtype == "f32":                   # the cast is the identity
        np.testing.assert_array_equal(yc.view(np.uint32), y32.view(np.uint32))
        return
    same = y32.view(np.uint32) == yj.view(np.uint32)
    np.testing.assert_array_equal(yc[same], ycj[same])
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ycj), 2.0 ** -126))) - 7)
    assert (np.abs(yc - ycj) <= 1e-6 * abs_sum + ulp)[~same].all()


def test_engine_decode_linear_on_cpu_is_the_plain_decode_form():
    """On CPU tensors the engine runs the plain pair as before; that is the
    decode form's plain version, bit for bit."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 4, 256, generator=g).to(torch.bfloat16)
    w = (torch.randn(256, 96, generator=g) * 0.02).to(torch.bfloat16)
    pw = PackedW.from_dense(w).to_kernel_layout()
    y = TE.matmul(x, pw, TE.EngineCtx(QuantConfig(fmt="hif4", impl="packed")))
    ref = TM.fused_decode_matmul_plain(x.reshape(8, 256), pw.codes, pw.meta)
    assert torch.equal(_bits(y.reshape(8, 96)), _bits(ref))


def _coverage(m, k, n):
    """How often each (column, 64-group) is covered by the plan's CTAs, with
    the kernel's own index math: CTA ``cta`` takes column tile
    ``cta // split`` and, as rank ``cta % split`` of its cluster, the groups
    [rank * G // split, (rank + 1) * G // split)."""
    plan = TM.decode_plan(m, k, n)
    groups = k // 64
    seen = np.zeros((n, groups), np.int32)
    for cta in range(plan.grid):
        tile, rank = divmod(cta, plan.split)
        g_lo = rank * groups // plan.split
        g_hi = (rank + 1) * groups // plan.split
        assert g_hi > g_lo
        seen[tile * plan.tile_n:(tile + 1) * plan.tile_n, g_lo:g_hi] += 1
    return plan, seen


@pytest.mark.parametrize("k, n", MAIN_SHAPES)
def test_decode_plan_covers_each_column_and_group_once_main_path(k, n):
    plan, seen = _coverage(8, k, n)
    assert (seen == 1).all()
    # ~2 CTAs per SM: 256 at N = 1024 (the largest cluster), 352 at N = 2816
    assert plan.grid >= 2 * TM.H100_SMS or (
        plan.split == TM.DECODE_MAX_SPLIT and plan.grid >= 1.9 * TM.H100_SMS)
    assert plan.grid % plan.split == 0 and plan.split <= TM.DECODE_MAX_SPLIT


@pytest.mark.parametrize("m, k, n", [(8, 1024, 1000), (17, 2816, 40),
                                     (1, 320, 72), (32, 64, 16), (3, 192, 1)])
def test_decode_plan_covers_each_column_and_group_once_ragged(m, k, n):
    _, seen = _coverage(m, k, n)
    assert (seen == 1).all()


def test_decode_plan_shared_bytes_fit_for_every_decode_shape():
    worst = 0
    for m in range(1, TB.DECODE_M_MAX + 1):
        for k in range(64, 2816 + 1, 64):
            for n in (16, 40, 1024, 2816, 151936):
                plan = TM.decode_plan(m, k, n)
                worst = max(worst, plan.smem_bytes)
                assert plan.smem_bytes % 16 == 0
    assert worst <= TM.SMEM_PER_CTA_MAX == 227 * 1024


def test_decode_plan_and_wrapper_refuse_what_the_kernel_does_not_take():
    for m, k, n in ((0, 64, 16), (33, 64, 16), (8, 100, 16), (8, 0, 16),
                    (8, 64, 0)):
        with pytest.raises(ValueError):
            TM.decode_plan(m, k, n)
    x = torch.zeros(4, 128, dtype=torch.bfloat16)
    codes = torch.zeros(64, 16, dtype=torch.uint8)
    meta = torch.zeros(2, 16, dtype=torch.int32)
    with pytest.raises(TypeError):
        TM.fused_decode_matmul(x.half(), codes, meta)
    with pytest.raises(TypeError):
        TM.fused_decode_matmul(x, codes, meta, torch.float16)
    with pytest.raises(TypeError):
        TM.fused_decode_matmul(x, codes, meta.to(torch.int64))
    with pytest.raises(ValueError):
        TM.fused_decode_matmul(x, codes[:32], meta)
    with pytest.raises(ValueError):
        TM.fused_decode_matmul(x.to("meta"), codes.to("meta"), meta.to("meta"))
