"""The MoE family of the PyTorch port vs the JAX reference, on the CPU.

Inputs are made from numpy seeds and carried into both packages with the
same bits (``repro_torch.interop``).

* ``capacity`` equals the reference's over a grid of group sizes, top-k,
  expert counts and capacity factors.
* ``_dispatch_combine`` is bitwise the reference's, with and without tokens
  dropped beyond an expert's capacity.
* Top-k breaks exact ties like ``jax.lax.top_k`` (lower index first), on
  hand-made rows and on granite's router at full width, whose bf16 logits
  tie.
* ``qdq_einsum``: both quantized operands bitwise the reference's qdq (and
  equal in value to its straight-through form), the product within
  rtol 2^-7.
* ``moe_apply`` at reduced granite and phi3.5 and at a gelu / ``wi``
  variant: expert choices bitwise, output within rtol=0.05, atol=0.1; a
  group's output bitwise the same alone or in a batch, and a prefix's
  whatever follows it.
* The policy resolves the MoE specs site for site as the reference does
  (router fmt none, experts hif4 but never packed); the f32 router leaf
  crosses packages with its dtype.
* A MoE serving artifact saved by either package loads in the other.
* Granite reduced: the paged and the slot scheduler give the lockstep
  serve's tokens (each batch element is its own dispatch group, so batching
  changes no token), and each request's solo tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import engine as JE
from repro.core import kvcache as JK
from repro.core.policy import get_policy as jget_policy
from repro.core.qlinear import QuantConfig as JQC
from repro.core.qlinear import quantize_activation as jqa
from repro.core.qlinear import quantize_weight as jqw
from repro.models import lm as JL
from repro.models import moe as JM
from repro.models.common import ModelCtx as JCtx
from repro.models.common import dense as jdense
from repro.runtime import serve_loop as JS
from repro_torch import interop
from repro_torch.checkpoint.checkpoint import tree_leaves
from repro_torch.configs import get_arch
from repro_torch.core import engine as TE
from repro_torch.core import kvcache
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import QuantConfig, quantize_activation, quantize_weight
from repro_torch.models import lm
from repro_torch.models import moe as TM
from repro_torch.models.common import ModelCtx
from repro_torch.runtime.serve_loop import (ServeConfig, load_serving_artifact,
                                            prepare_params_for_serving,
                                            save_serving_artifact, serve,
                                            serve_requests)

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

GRANITE, PHI = "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"
RTOL, ATOL = 0.05, 0.1


def _bf16(rng, shape, scale=1.0):
    """The same bf16 values as a jax array and a tensor."""
    a = np.asarray(jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16))
    return jnp.asarray(a), interop.tensor_from_numpy(a, "cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.name == "bfloat16" else np.int32)


# ---------------------------------------------------------------------------
# capacity, dispatch/combine, top-k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [GRANITE, PHI])
def test_capacity_equals_reference(arch):
    for factor in (1.0, 1.25, 2.0):
        for reduced in (False, True):
            tc, jc = get_arch(arch), jget_arch(arch)
            if reduced:
                tc, jc = tc.reduced(), jc.reduced()
            tc = dataclasses.replace(tc, moe=dataclasses.replace(
                tc.moe, capacity_factor=factor))
            jc = dataclasses.replace(jc, moe=dataclasses.replace(
                jc.moe, capacity_factor=factor))
            for s in (1, 2, 3, 5, 7, 16, 33, 64, 100, 256, 480, 4096):
                assert TM.capacity(tc, s) == JM.capacity(jc, s), (factor, s)


@pytest.mark.parametrize("C", [4, 8, 32])
def test_dispatch_combine_bitwise(C):
    """At C 4 and 8 tokens overflow their experts and are dropped."""
    rng = np.random.default_rng(C)
    B, S, E, k = 3, 24, 4, 2
    # k distinct experts per token, skewed towards expert 0
    idx = np.stack([np.stack([rng.choice(E, k, replace=False,
                                         p=[0.55, 0.15, 0.15, 0.15])
                              for _ in range(S)]) for _ in range(B)]
                   ).astype(np.int32)
    gates = rng.random((B, S, k)).astype(np.float32)
    jc, jd = JM._dispatch_combine(jnp.asarray(idx), jnp.asarray(gates), E, C)
    tc, td = TM._dispatch_combine(torch.from_numpy(idx), torch.from_numpy(gates),
                                  E, C)
    np.testing.assert_array_equal(_bits(tc), _jbits(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    kept = int(td.sum())
    assert (kept < B * S * k) == (C < 32), kept


def test_top_k_breaks_ties_like_jax():
    rng = np.random.default_rng(3)
    probs = (rng.integers(0, 5, (64, 32)) / 8).astype(np.float32)
    for k in (1, 2, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = TM.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _jctx(jcfg):
    plan = JL.quant_plan(jcfg, jget_policy("paper-iv", impl="packed",
                                           kv=JK.KV_HIF4))
    return JCtx(quant=plan.base, plan=plan, remat=False).scoped("blocks")


def _tctx(tcfg):
    plan = lm.quant_plan(tcfg, get_policy("paper-iv", impl="packed",
                                          kv=kvcache.KV_HIF4))
    return ModelCtx(plan=plan).scoped("blocks")


def _jroute(p, x, cfg, ctx):
    logits = jdense(x, p["router"], quant=ctx.site_quant("moe.router")
                    ).astype(jnp.float32)
    gates, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe.top_k)
    return gates / jnp.maximum(jnp.sum(gates, -1, keepdims=True), 1e-9), idx


def test_router_ties_at_full_width_pick_the_references_experts():
    """Granite's router (d 1024, 32 experts, top 8): its bf16 logits tie at
    the 8th/9th place on some rows, and the port picks the reference's
    experts on every row."""
    cfg, jcfg = get_arch(GRANITE), jget_arch(GRANITE)
    rng = np.random.default_rng(0)
    router = (rng.standard_normal((cfg.d_model, cfg.moe.n_experts)) * 0.02
              ).astype(np.float32)
    xj, xt = _bf16(rng, (4, 16, cfg.d_model))
    jg, ji = _jroute({"router": jnp.asarray(router)}, xj, jcfg, _jctx(jcfg))
    tg, ti = TM.route({"router": torch.from_numpy(router)}, xt, cfg, _tctx(cfg))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=0)
    logits = np.asarray(jdense(xj, jnp.asarray(router)).astype(jnp.float32))
    top9 = -np.sort(-logits, axis=-1)[..., 7:9]
    assert (top9[..., 0] == top9[..., 1]).sum() >= 1


# ---------------------------------------------------------------------------
# qdq_einsum and moe_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["hif4", "nvfp4", "none"])
def test_qdq_einsum_equals_reference(fmt):
    rng = np.random.default_rng(11)
    aj, at = _bf16(rng, (4, 16, 128))
    wj, wt = _bf16(rng, (4, 128, 64), 0.05)
    jq, tq = JQC(fmt=fmt), QuantConfig(fmt=fmt)
    # the operands bitwise the reference's qdq; its quantize_* wrap that in
    # the straight-through form x + (qdq(x) - x), equal in value (a -0 of
    # qdq becomes +0 there)
    for got, x, want, axis in (
            (quantize_activation(at, tq, axis=-1), aj, jqa(aj, jq, axis=-1), -1),
            (quantize_weight(wt, tq, axis=1), wj, jqw(wj, jq, axis=1), 1)):
        qdq = jq.format().qdq(x, axis=axis) if jq.format() else x
        np.testing.assert_array_equal(_bits(got), _jbits(qdq))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    want = np.asarray(JE.qdq_einsum("erd,edf->erf", aj, wj,
                                    JE.EngineCtx(quant=jq))).astype(np.float32)
    ectx = TE.EngineCtx(quant=tq)

    def chunked(a, rows):
        return TE.in_row_chunks(lambda c: TE.qdq_einsum(
            "erd,edf->erf", c, wt, ectx), a, rows, 1)

    whole = TE.qdq_einsum("erd,edf->erf", at, wt, ectx)
    for got in (whole, chunked(at, 3)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max() * 2 ** -8)
    # rows in fixed chunks (as moe_apply runs it): a row's product, with
    # fewer rows beside it, has the same bits
    fewer = chunked(at[:, 2:7], 3)
    np.testing.assert_array_equal(_bits(got[:, 2:5]), _bits(fewer[:, :3]))


def _variant(arch):
    if arch == "gelu":
        return dataclasses.replace(get_arch(GRANITE).reduced(), activation="gelu")
    return get_arch(arch).reduced()


@pytest.mark.parametrize("arch", [GRANITE, PHI, "gelu"])
def test_moe_apply_equals_reference(arch):
    tcfg = _variant(arch)
    jcfg = jget_arch(GRANITE if arch == "gelu" else arch).reduced()
    jcfg = dataclasses.replace(jcfg, activation=tcfg.activation)
    rng = np.random.default_rng(5)
    specs = TM.moe_specs(tcfg)
    assert ("wi" in specs) == (arch == "gelu")
    p = {}
    for name, spec in specs.items():
        a = (rng.standard_normal(spec.shape) * 0.05).astype(np.float32)
        p[name] = a if spec.dtype == torch.float32 else np.asarray(
            jnp.asarray(a, jnp.bfloat16))
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: interop.tensor_from_numpy(v, "cpu") for k, v in p.items()}
    assert pt["router"].dtype == torch.float32
    xj, xt = _bf16(rng, (3, 40, tcfg.d_model))
    jctx, tctx = _jctx(jcfg), _tctx(tcfg)
    _, ji = _jroute(pj, xj, jcfg, jctx)
    _, ti = TM.route(pt, xt, tcfg, tctx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    want = np.asarray(JM.moe_apply(pj, xj, jcfg, jctx)).astype(np.float32)
    got = TM.moe_apply(pt, xt, tcfg, tctx)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    d = np.abs(got.float().numpy() - want)
    assert (d <= ATOL + RTOL * np.abs(want)).all(), d.max()
    assert np.abs(want).max() > 0.1


def test_moe_apply_of_a_prefix_does_not_depend_on_what_follows():
    """Without drops (a roomy capacity), a prompt prefix's outputs are the
    same bits whatever tokens follow it: the paged pool shares its pages
    only then."""
    base = get_arch(GRANITE).reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=4.0))
    rng = np.random.default_rng(9)
    p = {name: interop.tensor_from_numpy(
        (rng.standard_normal(spec.shape) * 0.05).astype(np.float32), "cpu"
    ).to(spec.dtype) for name, spec in TM.moe_specs(cfg).items()}
    _, x = _bf16(rng, (2, 48, cfg.d_model))
    ctx = _tctx(cfg)
    y = TM.moe_apply(p, x, cfg, ctx)
    for n in (16, 33):
        np.testing.assert_array_equal(
            _bits(TM.moe_apply(p, x[:, :n], cfg, ctx)), _bits(y[:, :n]))


def test_moe_apply_of_a_group_does_not_depend_on_the_batch():
    cfg = get_arch(GRANITE).reduced()
    rng = np.random.default_rng(8)
    p = {name: interop.tensor_from_numpy(
        (rng.standard_normal(spec.shape) * 0.05).astype(np.float32), "cpu"
    ).to(spec.dtype) for name, spec in TM.moe_specs(cfg).items()}
    _, x = _bf16(rng, (4, 24, cfg.d_model))
    ctx = _tctx(cfg)
    y = TM.moe_apply(p, x, cfg, ctx)
    for b in range(4):
        np.testing.assert_array_equal(
            _bits(TM.moe_apply(p, x[b:b + 1], cfg, ctx)[0]), _bits(y[b]))


# ---------------------------------------------------------------------------
# policy, params, artifacts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["paper-iv", "sensitive-fallback",
                                    "nvfp4-baseline"])
def test_policy_resolves_moe_sites_like_the_reference(policy):
    for arch in (GRANITE, PHI):
        for reduced in (False, True):
            tc, jc = get_arch(arch), jget_arch(arch)
            if reduced:
                tc, jc = tc.reduced(), jc.reduced()
            tplan = lm.quant_plan(tc, get_policy(policy, impl="packed"))
            jplan = JL.quant_plan(jc, jget_policy(policy, impl="packed"))
            assert len(tplan.sites) == len(jplan.sites) == 10
            for ts, js in zip(tplan.sites, jplan.sites):
                assert (ts.path, ts.cfg.fmt, ts.cfg.impl, ts.packed,
                        ts.quantize_offline, tuple(ts.contract_axes),
                        tuple(ts.shape), ts.n_values) == (
                    js.path, js.cfg.fmt, js.cfg.impl, js.packed,
                    js.quantize_offline, tuple(js.contract_axes),
                    tuple(js.shape), js.n_values)
            router = tplan.get("blocks.moe.router")
            assert not router.packed
            assert router.cfg.fmt == ("none" if policy != "nvfp4-baseline"
                                      else router.cfg.fmt)
            assert not any(s.packed for s in tplan.sites if ".moe." in s.path)


@pytest.fixture(scope="module")
def granite_raw():
    """Reduced granite's raw weights from the reference's seed, as numpy."""
    jcfg = jget_arch(GRANITE).reduced()
    return jax.tree_util.tree_map(
        np.asarray, JL.init_params(jcfg, jax.random.PRNGKey(0)))


def test_router_leaf_keeps_float32_across_packages(granite_raw):
    tparams = interop.params_from_jax(granite_raw, "cpu")
    router = tparams["blocks"]["moe"]["router"]
    assert router.dtype == torch.float32
    np.testing.assert_array_equal(
        router.numpy().view(np.int32),
        granite_raw["blocks"]["moe"]["router"].view(np.int32))
    specs = lm.abstract_params(get_arch(GRANITE).reduced())
    assert specs["blocks"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_moe_artifact_loads_in_the_other_package(granite_raw, tmp_path, saver):
    jcfg, tcfg = jget_arch(GRANITE).reduced(), get_arch(GRANITE).reduced()
    d = str(tmp_path / saver)
    if saver == "reference":
        JS.save_serving_artifact(d, jax.tree_util.tree_map(jnp.asarray, granite_raw),
                                 jcfg, jget_policy("paper-iv", impl="packed",
                                                   kv=JK.KV_HIF4))
        tparams, tpol = load_serving_artifact(d, tcfg, device="cpu")
        jparams, jpol = JS.load_serving_artifact(d, jcfg)
    else:
        save_serving_artifact(d, interop.params_from_jax(granite_raw, "cpu"), tcfg,
                              get_policy("paper-iv", impl="packed",
                                         kv=kvcache.KV_HIF4), device="cpu")
        jparams, jpol = JS.load_serving_artifact(d, jcfg)
        tparams, tpol = load_serving_artifact(d, tcfg, device="cpu")
    assert tpol.to_json_dict() == jpol.to_json_dict()
    jleaves = jax.tree_util.tree_flatten(jparams)[0]
    tleaves = tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    dtypes = set()
    for j, (path, t, is_meta) in zip(jleaves, tleaves):
        want = np.asarray(j)
        got = interop.to_numpy(t, uint32=is_meta)
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=str(path))
        dtypes.add(str(t.dtype))
    assert tparams["blocks"]["moe"]["router"].dtype == torch.float32
    assert {"torch.float32", "torch.bfloat16", "torch.uint8"} <= dtypes


# ---------------------------------------------------------------------------
# the schedulers on a MoE tree
# ---------------------------------------------------------------------------


def _scaled(tree, f):
    if isinstance(tree, dict):
        return {k: _scaled(v, f) for k, v in tree.items()}
    return tree * f if tree.dtype == torch.bfloat16 else tree


def test_granite_schedulers_equal_lockstep_and_solo():
    cfg = get_arch(GRANITE).reduced()
    ctx = ModelCtx(quant=QuantConfig(fmt="hif4", impl="packed",
                                     kv=kvcache.KV_HIF4),
                   attn_q_chunk=4, attn_k_chunk=4)
    raw = lm.init_params(cfg, 0, device="cpu")
    raw = dict(raw, blocks=_scaled(raw["blocks"], 5), embed=raw["embed"] * 5)
    params = prepare_params_for_serving(raw, cfg, ctx.quant, device="cpu")
    g = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, cfg.vocab, (3, 16), generator=g)
    P, budget, cap = 8, 6, 24
    lockstep = serve(cfg, params, {"tokens": prompts},
                     dataclasses.replace(ctx, attn_kv_block=P),
                     ServeConfig(max_new_tokens=budget, cache_capacity=cap,
                                 kv_format="hif4"), device="cpu")
    stats: dict = {}
    paged = serve_requests(cfg, params, list(prompts), ctx,
                           ServeConfig(max_new_tokens=budget, decode_chunk=2,
                                       cache_capacity=cap, kv_format="hif4",
                                       kv_pages=12, kv_page_tokens=P),
                           slots=2, stats=stats, device="cpu")
    assert stats["scheduler"] == "paged" and stats["max_concurrent"] == 2
    slot = serve_requests(cfg, params, list(prompts), ctx,
                          ServeConfig(max_new_tokens=budget, decode_chunk=2,
                                      cache_capacity=cap, kv_format="hif4"),
                          slots=2, device="cpu")
    sc = ServeConfig(max_new_tokens=budget, cache_capacity=cap, kv_format="hif4")
    for i in range(3):
        # the paged pool tiles attention by its pages, the slot cache by
        # select_kv_block: each equals solo serving under its own tiling
        assert torch.equal(paged[i], lockstep[i]), (i, paged[i], lockstep[i])
        solo = serve(cfg, params, {"tokens": prompts[i:i + 1]},
                     dataclasses.replace(ctx, attn_kv_block=P), sc,
                     device="cpu")[0]
        assert torch.equal(paged[i], solo)
        assert len(set(solo.tolist())) > 1
        solo = serve(cfg, params, {"tokens": prompts[i:i + 1]}, ctx, sc,
                     device="cpu")[0]
        assert torch.equal(slot[i], solo), (i, slot[i], solo)
