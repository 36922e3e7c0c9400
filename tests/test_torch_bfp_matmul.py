"""Kernel 5 (``bfp_matmul_quantized``), the dense ``pallas`` route and the
user-facing quantized matmul of the PyTorch port vs the JAX reference.
(The CUDA kernel against its plain version is in ``tests/test_torch_cuda.py``.)

* The plain version against the reference's interpret-mode Pallas kernel at
  the shapes of ``tests/test_kernels.py``, in one K step and in several:
  the int32 group partials bitwise, the outputs within rtol=1e-6,
  atol=1e-6 (the reference's own tolerance: its tiles sum their groups with
  ``jnp.sum``, the port in group order).
* Kernel 5 on ``packed_to_absorbed(pw)`` is bitwise kernel 2 on ``pw``
  (plain versions here; the kernels on the card), and the absorbed
  expansion is bitwise the reference's.
* The engine's dense ``pallas`` route and ``kernels.ops`` against the
  reference's; the smoke model's prefill logits on raw weights under
  ``uniform:hif4`` / ``pallas`` within rtol=0.05, atol=0.1.
* Serving with a policy that quantizes the tied LM head (the only site the
  dense ``pallas`` route reaches in serving) gives the reference's greedy
  tokens, at weights 5x the init's scale where the tokens vary. The
  reference runs in a process of its own with XLA's excess precision off:
  it would otherwise skip the bf16 rounding of the head's output (ROADMAP
  §3).
"""
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import engine as JE
from repro.core import policy as JP
from repro.core.qlinear import PackedW as JPackedW
from repro.core.qlinear import QuantConfig as JQC
from repro.kernels import bfp_matmul as JB
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.models import lm as JL
from repro.models.common import ModelCtx as JCtx
from repro_torch import interop
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import engine as TE
from repro_torch.core import policy as TP
from repro_torch.core.qlinear import QuantConfig as TQC
from repro_torch.kernels import bfp_matmul as TB
from repro_torch.kernels import build
from repro_torch.kernels import fused_matmul as TM
from repro_torch.kernels import ops as TO
from repro_torch.models import lm as TL
from repro_torch.models.common import ModelCtx as TCtx

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the paper-iv rules without the lm_head exclusion: the tied head quantizes
HEAD_POLICY = {"name": "hif4-with-head", "kv_format": "hif4",
               "rules": [{"pattern": "*", "fmt": "hif4"},
                         {"pattern": "embed", "fmt": "none"},
                         {"pattern": "*.router", "fmt": "none"}]}


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), "cpu")


def _rand(seed, m, k, dtype=jnp.bfloat16, scale=1.0):
    x = np.random.default_rng(seed).standard_normal((m, k)) * scale
    return jnp.asarray(x.astype(np.float32)).astype(dtype)


def _operands(m, k, n, seed):
    """Pre-quantized operands from the reference's Algorithm 1."""
    x, w = _rand(seed, m, k), _rand(seed + 1, k, n, scale=0.05)
    quantize = jax.jit(JR.hif4_quantize_ref)
    ai, asc = quantize(x.astype(jnp.float32))
    bi, bsc = quantize(w.T.astype(jnp.float32))
    return ai, asc, bi.T, bsc.T


@pytest.mark.parametrize("m, k, n", [(8, 64, 8), (16, 128, 32), (32, 256, 64),
                                     (64, 512, 16)])
@pytest.mark.parametrize("k_steps", ["one", "several"])   # K tiles of 64
def test_plain_vs_interpret_kernel(m, k, n, k_steps):
    ai, asc, bi, bsc = _operands(m, k, n, seed=m + k + n)
    g = k // 64
    part_j = jax.lax.dot_general(
        ai.reshape(m, g, 64), bi.reshape(g, 64, n),
        dimension_numbers=(((2,), (1,)), ((1,), (0,))),
        preferred_element_type=jnp.int32)                    # (g, m, n)
    part_t = TB.group_partials(_t(ai), _t(bi))
    np.testing.assert_array_equal(np.asarray(part_j), part_t.numpy())
    block_k = k if k_steps == "one" else 64
    yj = JB.bfp_matmul_quantized(ai, asc, bi, bsc, block_m=min(m, 16),
                                 block_n=min(n, 16), block_k=block_k,
                                 interpret=True)
    yt = TB.bfp_matmul_quantized(_t(ai), _t(asc), _t(bi), _t(bsc))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6, atol=1e-6)


def test_absorbed_weight_is_kernel_2_bitwise():
    """packed_to_absorbed gives the reference's bytes, and kernel 5 on them
    is kernel 2 on the packed weight, bit for bit."""
    w = _rand(3, 256, 96, scale=0.02)
    pj = jax.jit(lambda a: JPackedW.from_dense(a).to_kernel_layout())(w)
    pw = interop.packed_from_jax(pj, "cpu")
    wi, wsc = TE.packed_to_absorbed(pw)
    wij, wscj = JE.packed_to_absorbed(pj)
    np.testing.assert_array_equal(np.asarray(wij), wi.numpy())
    np.testing.assert_array_equal(np.asarray(wscj), wsc.numpy())
    ai, asc = TO.quantize(_t(_rand(4, 40, 256)))
    y5 = TB.bfp_matmul_quantized(ai, asc, wi, wsc)
    y2 = TM.fused_packed_matmul(ai, asc, pw.codes, pw.meta)
    assert torch.equal(y5.view(torch.int32), y2.view(torch.int32))


def test_plain_nan_scale_reaches_its_row_and_column_only():
    ai, asc, bi, bsc = (_t(a) for a in _operands(8, 256, 24, seed=5))
    asc[3, 2] = float("nan")
    bsc[1, 7] = float("nan")
    y = TB.bfp_matmul_quantized(ai, asc, bi, bsc)
    want = torch.zeros_like(y, dtype=torch.bool)
    want[3, :] = True
    want[:, 7] = True
    assert torch.equal(y.isnan(), want)


@pytest.mark.parametrize("m, k, n", [(8, 256, 96), (40, 128, 64)])
def test_engine_pallas_dense_route_matches_reference(m, k, n):
    """Both operands quantized per call, contracted, cast to x.dtype (bf16
    here, as the LM head's logits are)."""
    x, w = _rand(6, m, k, scale=0.1), _rand(7, k, n, scale=0.05)
    yj = JE.matmul(x, w, JE.EngineCtx(quant=JQC(fmt="hif4", impl="pallas")))
    yt = TE.matmul(_t(x), _t(w), TE.EngineCtx(TQC(fmt="hif4", impl="pallas")))
    assert yt.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(yj.astype(jnp.float32)),
                                  yt.float().numpy())


def test_ops_matmul_and_prequantized_match_reference():
    x, w = _rand(8, 32, 512, jnp.float32, 0.5), _rand(9, 512, 32, jnp.float32, 0.05)
    yj = JO.matmul(x, w, interpret=True)
    yt = TO.matmul(_t(x), _t(w))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6, atol=1e-6)
    wi, wsc = JR.hif4_quantize_ref(w.T)
    yj = JO.matmul_prequantized(x, wi.T, wsc.T, interpret=True)
    yt = TO.matmul_prequantized(_t(x), _t(wi).T, _t(wsc).T)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6, atol=1e-6)
    # the reference's accuracy claims (tests/test_kernels.py): within 20% of
    # the f32 product and closer than MXFP4
    from repro_torch.core import mxfp4

    want = _t(x) @ _t(w)
    rel = float(torch.linalg.norm(yt - want) / torch.linalg.norm(want))
    mx = mxfp4.qdq(_t(x), axis=-1) @ mxfp4.qdq(_t(w), axis=0)
    rel_mx = float(torch.linalg.norm(mx - want) / torch.linalg.norm(want))
    assert rel < 0.2 and rel < rel_mx, (rel, rel_mx)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    ai, asc, bi, bsc = (_t(a) for a in _operands(8, 128, 16, seed=10))
    with pytest.raises(TypeError):
        TB.bfp_matmul_quantized(ai.to(torch.int32), asc, bi, bsc)
    with pytest.raises(ValueError):
        TB.bfp_matmul_quantized(ai[:, :96], asc, bi[:96], bsc)
    with pytest.raises(ValueError):
        TB.bfp_matmul_quantized(ai, asc[:, :1], bi, bsc)
    with pytest.raises(ValueError):
        TB.bfp_matmul_quantized(*(t.to("meta") for t in (ai, asc, bi, bsc)))
    build.reset_launches()
    TB.bfp_matmul_quantized(ai, asc, bi, bsc)             # CPU: plain version
    assert build.LAUNCHES["bfp_matmul_quantized"] == 0


def test_prefill_logits_under_uniform_hif4_pallas():
    """Raw (unpacked) weights: every block site runs the dense pallas route
    in both packages."""
    jcfg, tcfg = jget_arch("qwen1.5-0.5b").reduced(), tget_arch("qwen1.5-0.5b").reduced()
    params = JL.init_params(jcfg, jax.random.PRNGKey(0))
    jplan = JL.quant_plan(jcfg, JP.get_policy("uniform:hif4", impl="pallas"))
    tplan = TL.quant_plan(tcfg, TP.get_policy("uniform:hif4", impl="pallas"))
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    jctx = JCtx(quant=jplan.base, plan=jplan, remat=False, attn_q_chunk=32,
                attn_k_chunk=32)
    tctx = TCtx(quant=tplan.base, plan=tplan, attn_q_chunk=32, attn_k_chunk=32)
    lj, _ = jax.jit(lambda p, t: JL.prefill(p, {"tokens": t}, jcfg, jctx))(
        params, jnp.asarray(toks))
    lt, _ = TL.prefill(interop.params_from_jax(params, "cpu"),
                       {"tokens": torch.from_numpy(toks).long()}, tcfg, tctx)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0.05, atol=0.1)


def test_head_policy_plan_matches_reference(tmp_path):
    """The tied lm_head resolves to hif4 / pallas, dense (no artifact can
    exist for it); every block site packs."""
    path = tmp_path / "head.json"
    path.write_text(json.dumps(HEAD_POLICY))
    jcfg, tcfg = jget_arch("qwen1.5-0.5b").reduced(), tget_arch("qwen1.5-0.5b").reduced()
    pj = JL.quant_plan(jcfg, JP.get_policy(str(path), impl="pallas"))
    pt = TL.quant_plan(tcfg, TP.get_policy(str(path), impl="pallas"))
    rows = lambda plan: [(s.path, s.cfg.fmt, s.cfg.impl, s.packed,
                          s.quantize_offline) for s in plan.sites]
    assert rows(pt) == rows(pj)
    head = pt.site("lm_head")
    assert (head.cfg.fmt, head.cfg.impl, head.packed) == ("hif4", "pallas", False)
    assert len(pt.packed_paths) == 7 and pt.kv.kv_format == "hif4"


def _jax_scaled(tree, f):
    return jax.tree_util.tree_map(
        lambda a: a * f if a.dtype == jnp.bfloat16 else a, tree)


def head_policy_tokens_of_both_packages() -> dict:
    """Greedy tokens of the reference's ``serve`` and the port's under the
    head-quantizing policy, impl pallas, HiF4 KV, on the same weights (the
    smoke model at 5x the init's scale). Run by
    :func:`test_head_policy_serve_equals_the_reference` in a process of its
    own."""
    from repro.runtime import serve_loop as JS
    from repro_torch.runtime import serve_loop as TS

    jcfg, tcfg = jget_arch("qwen1.5-0.5b").reduced(), tget_arch("qwen1.5-0.5b").reduced()
    params = JL.init_params(jcfg, jax.random.PRNGKey(1))
    params = dict(params, blocks=_jax_scaled(params["blocks"], 5),
                  embed=params["embed"] * 5)
    prompts = np.random.default_rng(12).integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "head.json")
        with open(path, "w") as f:
            json.dump(HEAD_POLICY, f)
        jplan = JL.quant_plan(jcfg, JP.get_policy(path, impl="pallas"))
        tplan = TL.quant_plan(tcfg, TP.get_policy(path, impl="pallas"))
    jctx = JCtx(quant=jplan.base, plan=jplan, remat=False, attn_q_chunk=32,
                attn_k_chunk=32)
    tctx = TCtx(quant=tplan.base, plan=tplan, attn_q_chunk=32, attn_k_chunk=32)
    # the block sites packed once under jit (eager packing is slow); both
    # packages serve these bytes, the head quantizes the raw embedding
    jparams = jax.jit(lambda p: JS.prepare_params_for_serving(p, jcfg, jplan))(params)
    jtoks = JS.serve(jcfg, jparams, {"tokens": jnp.asarray(prompts)}, jctx,
                     JS.ServeConfig(max_new_tokens=6))
    build.reset_launches()
    ttoks = TS.serve(tcfg, interop.params_from_jax(jparams, "cpu"),
                     {"tokens": torch.from_numpy(prompts).long()}, tctx,
                     TS.ServeConfig(max_new_tokens=6), device="cpu")
    return {"ref": np.asarray(jtoks).tolist(), "port": ttoks.tolist(),
            "launches": dict(build.LAUNCHES)}


def test_head_policy_serve_equals_the_reference():
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            (os.path.join(REPO, "src"), os.path.join(REPO, "tests"))))
    run = subprocess.run(
        [sys.executable, "-c", "import json, test_torch_bfp_matmul as t; "
         "print(json.dumps(t.head_policy_tokens_of_both_packages()))"],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert not any(out["launches"].values())          # CPU: plain versions
    for i, (want, got) in enumerate(zip(out["ref"], out["port"])):
        assert len(set(want)) > 1, (i, want)
        assert got == want, (i, got, want)
