"""The port's Mamba2 SSM family (mamba2-1.3b) against the JAX reference.

* The config equals the reference's, in full and reduced form.
* ``conv_full`` / ``conv_step`` are bitwise the reference run eagerly
  (bf16 products and sums in order; f32 for the step).
* ``ssd_scan`` / ``ssd_step`` are f32-close to the reference (rtol 1e-5,
  atol 1e-5 on f32 values; a bf16 output within one bf16 ulp; the
  reference jitted, which changes no rounding here: every intermediate is
  f32): the three-operand einsums run as two pairwise products in the
  reference's order, but a matmul sums in another order than XLA's dot.
* A chunked prefill followed by ``ssd_step`` decode equals the full scan
  over the same tokens within rtol 1e-4, atol 1e-5 (port only).
* ``mamba_full`` / ``mamba_step`` per block, unquantized, within atol 2^-6
  + rtol 2^-7 of the reference (bf16 outputs of an f32-close scan).
* Served at ``--reduced`` (paper-iv, impl packed and pallas, HiF4 KV
  requested, which falls back to bf16): greedy tokens equal the
  reference's, the prefill and first decode logits within rtol=0.05,
  atol=0.1, the serving artifact bitwise. The reference runs with XLA's
  excess precision off, in a process of its own (as in
  ``test_torch_scheduler.py``). The weights are the seeded init with the
  bf16 block weights and the embedding at 5x and A / dt biases drawn so
  the SSD state decays slowly (a_log in [-4, 0], dt_bias in [-2, 0]): at
  the init (a_log 0) the state halves every token and the tokens of a
  64-token prompt depend on its last few only.
* The plans, the KV-format fallback, the refusals of the request
  scheduler, the page pool and the HiF4 KV layout, and the launcher's
  lines are the reference's; the serving artifact loads across packages.
* ``cuda``-marked: kernels 1 and 2 at mamba2's full-width shapes bitwise
  their plain versions (skip without a card).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import kvcache as JK
from repro.core.policy import get_policy as jget_policy
from repro.models import lm as JL
from repro.models import mamba2 as JM
from repro.models.common import ModelCtx as JCtx
from repro.runtime import serve_loop as JS
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import kvcache
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import NO_QUANT, QuantConfig
from repro_torch.models import lm
from repro_torch.models import mamba2 as TM
from repro_torch.models.common import ModelCtx
from repro_torch.runtime import serve_loop as TS

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "mamba2-1.3b"
BATCH, PROMPT, NEW = 2, 64, 6


def _t(a) -> torch.Tensor:
    return interop.tensor_from_numpy(np.asarray(a), "cpu")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_config_equals_reference():
    for port, ref in ((get_arch(ARCH), jget_arch(ARCH)),
                      (get_arch(ARCH).reduced(), jget_arch(ARCH).reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params() == ref.n_params()
    s = get_arch(ARCH).reduced().ssm
    assert (s.d_state, s.head_dim, s.chunk) == (16, 32, 32)


def test_specs_equal_reference():
    for cfg, jcfg in ((get_arch(ARCH), jget_arch(ARCH)),
                      (get_arch(ARCH).reduced(), jget_arch(ARCH).reduced())):
        got = {k: (v.shape, v.axes, str(v.dtype).replace("torch.", ""), v.init)
               for k, v in TM.mamba_specs(cfg).items()}
        want = {k: (v.shape, v.axes, jnp.dtype(v.dtype).name, v.init)
                for k, v in JM.mamba_specs(jcfg).items()}
        assert got == want
        assert TM.dims(cfg) == JM.dims(jcfg)
        cache = lm.abstract_cache(cfg, 3, 40)
        jcache = JL.abstract_cache(jcfg, 3, 40)
        assert set(cache) == set(jcache) == {"layers", "pos"}
        assert {k: v.shape for k, v in cache["layers"].items()} == {
            k: v.shape for k, v in jcache["layers"].items()}


# ---------------------------------------------------------------------------
# conv and SSD against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B, S, C, K", [(2, 64, 96, 4), (1, 3, 40, 4),
                                        (3, 17, 256, 2)])
def test_conv_full_bitwise_eager_reference(B, S, C, K):
    rng = np.random.default_rng(S * C)
    x = jnp.asarray(rng.standard_normal((B, S, C)) * 2, jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((K, C)) * 0.2, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(C) * 0.1, jnp.bfloat16)
    with jax.disable_jit():
        want = JM.conv_full(x, w, b)
    got = TM.conv_full(_t(x), _t(w), _t(b))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), _bits(want))


@pytest.mark.parametrize("B, C, K", [(2, 96, 4), (5, 288, 4), (1, 40, 2)])
def test_conv_step_bitwise_eager_reference(B, C, K):
    """The output and the shifted window, written in place."""
    rng = np.random.default_rng(C)
    x1 = jnp.asarray(rng.standard_normal((B, C)) * 2, jnp.bfloat16)
    st = jnp.asarray(rng.standard_normal((B, K - 1, C)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((K, C)) * 0.2, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(C) * 0.1, jnp.bfloat16)
    with jax.disable_jit():
        want_y, want_st = JM.conv_step(x1, st, w, b)
    state = _t(st)
    got = TM.conv_step(_t(x1), state, _t(w), _t(b))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), _bits(want_y))
    np.testing.assert_array_equal(state.view(torch.int16).numpy(), _bits(want_st))


def _ssd_inputs(rng, B, S, H, P, N):
    xh = jnp.asarray(rng.standard_normal((B, S, H, P)), jnp.bfloat16)
    dt = jnp.asarray(np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1)),
                     jnp.float32)
    a = -jnp.exp(jnp.asarray(rng.uniform(-4, 1, H), jnp.float32))
    bv = jnp.asarray(rng.standard_normal((B, S, N)), jnp.float32)
    cv = jnp.asarray(rng.standard_normal((B, S, N)), jnp.float32)
    ds = jnp.asarray(rng.standard_normal(H), jnp.float32)
    return xh, dt, a, bv, cv, ds


def _close_bf16(got: torch.Tensor, want) -> None:
    """Within one bf16 ulp of the reference (f32-close before the cast)."""
    want = np.asarray(want, np.float32)
    got = interop.to_numpy(got)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("S, chunk, init", [(64, 16, True), (64, 64, False),
                                            (24, 32, True), (96, 32, False)])
def test_ssd_scan_f32_close_to_reference(S, chunk, init):
    """chunk < S (several chunks, the inter-chunk recurrence), chunk = S,
    chunk > S (cut to S); with and without an initial state."""
    rng = np.random.default_rng(S + chunk)
    B, H, P, N = 2, 4, 16, 8
    args = _ssd_inputs(rng, B, S, H, P, N)
    s0 = (jnp.asarray(rng.standard_normal((B, H, P, N)), jnp.float32)
          if init else None)
    want_y, want_s = jax.jit(JM.ssd_scan, static_argnums=6)(*args, chunk, s0)
    got_y, got_s = TM.ssd_scan(*(_t(a) for a in args), chunk,
                               None if s0 is None else _t(s0))
    assert got_y.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    _close_bf16(got_y, want_y)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)


def test_ssd_scan_refuses_a_prompt_off_the_chunk():
    args = _ssd_inputs(np.random.default_rng(0), 1, 48, 2, 8, 4)
    with pytest.raises(ValueError, match="not divisible by ssd chunk 32"):
        TM.ssd_scan(*(_t(a) for a in args), 32)


def test_ssd_step_f32_close_to_reference():
    rng = np.random.default_rng(3)
    B, H, P, N = 3, 4, 16, 8
    x1 = jnp.asarray(rng.standard_normal((B, H, P)), jnp.bfloat16)
    dt1 = jnp.asarray(rng.uniform(0.01, 2, (B, H)), jnp.float32)
    a = -jnp.exp(jnp.asarray(rng.uniform(-4, 1, H), jnp.float32))
    b1 = jnp.asarray(rng.standard_normal((B, N)), jnp.float32)
    c1 = jnp.asarray(rng.standard_normal((B, N)), jnp.float32)
    ds = jnp.asarray(rng.standard_normal(H), jnp.float32)
    st = jnp.asarray(rng.standard_normal((B, H, P, N)), jnp.float32)
    want_y, want_s = jax.jit(JM.ssd_step)(x1, dt1, a, b1, c1, ds, st)
    state = _t(st)
    got_y = TM.ssd_step(_t(x1), _t(dt1), _t(a), _t(b1), _t(c1), _t(ds), state)
    _close_bf16(got_y, want_y)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)


def test_chunked_prefill_then_step_decode_equals_the_full_scan():
    """Scan 64 tokens (chunks of 16), then 8 ssd_steps from its final state:
    the outputs and the state equal one scan over all 72 tokens (chunk 8)
    in f32 (x bf16-exact, no bf16 cast compared)."""
    rng = np.random.default_rng(11)
    B, S, T, H, P, N = 2, 64, 8, 4, 16, 8
    xh, dt, a, bv, cv, ds = (_t(v) for v in _ssd_inputs(rng, B, S + T, H, P, N))
    y_all, s_all = TM.ssd_scan(xh.float(), dt, a, bv, cv, ds, 8)
    y_pre, state = TM.ssd_scan(xh[:, :S].float(), dt[:, :S], a, bv[:, :S],
                               cv[:, :S], ds, 16)
    torch.testing.assert_close(y_pre, y_all[:, :S], rtol=1e-4, atol=1e-5)
    for t in range(S, S + T):
        y = TM.ssd_step(xh[:, t].float(), dt[:, t], a, bv[:, t], cv[:, t], ds,
                        state)
        torch.testing.assert_close(y, y_all[:, t], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(state, s_all, rtol=1e-4, atol=1e-5)


def test_softplus_is_logaddexp_without_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 19.0, 20.0, 21.0, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(TM.softplus(x).numpy(), want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# one block, full and step
# ---------------------------------------------------------------------------


def _block_params(cfg, jcfg, seed):
    jp = {k: v[0] for k, v in JL.init_params(jcfg, jax.random.PRNGKey(seed))
          ["blocks"].items()}
    r = np.random.default_rng(seed)
    jp["a_log"] = jnp.asarray(r.uniform(-4, 0, jp["a_log"].shape), jnp.float32)
    jp["dt_bias"] = jnp.asarray(r.uniform(-2, 0, jp["dt_bias"].shape),
                                jnp.float32)
    return jp, {k: _t(v) for k, v in jp.items()}


def test_block_full_and_step_close_to_reference():
    """mamba_full over 64 tokens (two chunks; its cache), then two
    mamba_step decodes, unquantized: each output within atol 2^-6 + rtol
    2^-7 of the reference's (jitted), the caches alike (conv windows
    bitwise, the SSD state within rtol 1e-3, atol 1e-4)."""
    jcfg, cfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jp, tp = _block_params(cfg, jcfg, 4)
    jctx, ctx = JCtx().scoped("blocks"), ModelCtx(quant=NO_QUANT).scoped("blocks")
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal((2, 64, cfg.d_model)), jnp.bfloat16)
    want, jcache = jax.jit(lambda p, v: JM.mamba_full(p, v, jcfg, jctx,
                                                      return_cache=True))(jp, x)
    jstep = jax.jit(lambda p, v, c: JM.mamba_step(p, v, c, jcfg, jctx))
    got, cache = TM.mamba_full(tp, _t(x), cfg, ctx, return_cache=True)
    tol = dict(rtol=2 ** -7, atol=2 ** -6)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want, np.float32),
                               **tol)
    for key in ("conv_x", "conv_bc"):
        np.testing.assert_array_equal(cache[key].view(torch.int16).numpy(),
                                      _bits(jcache[key]))
    np.testing.assert_allclose(cache["ssd"].numpy(), np.asarray(jcache["ssd"]),
                               rtol=1e-3, atol=1e-4)
    for step in range(2):
        x1 = jnp.asarray(rng.standard_normal((2, 1, cfg.d_model)), jnp.bfloat16)
        want, jcache = jstep(jp, x1, jcache)
        got = TM.mamba_step(tp, _t(x1), cache, cfg, ctx)
        np.testing.assert_allclose(interop.to_numpy(got),
                                   np.asarray(want, np.float32), **tol)
        np.testing.assert_allclose(cache["ssd"].numpy(),
                                   np.asarray(jcache["ssd"]), rtol=1e-3,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# serving against the reference (one subprocess)
# ---------------------------------------------------------------------------


def slow_decay_weights(raw, scale: float = 5.0):
    """The test weights: bf16 block, shared-block and embedding weights at
    ``scale`` x the init, a_log in [-4, 0] and dt_bias in [-2, 0] from a
    fixed seed (the reference's init leaves both at 0)."""
    def sc(a):
        return a * scale if a.dtype == jnp.bfloat16 else a

    out = {k: (jax.tree_util.tree_map(sc, v) if k in ("blocks", "shared", "embed")
               else v) for k, v in raw.items()}
    r = np.random.default_rng(5)
    blocks = dict(out["blocks"])
    blocks["a_log"] = jnp.asarray(r.uniform(-4, 0, blocks["a_log"].shape),
                                  jnp.float32)
    blocks["dt_bias"] = jnp.asarray(r.uniform(-2, 0, blocks["dt_bias"].shape),
                                    jnp.float32)
    out["blocks"] = blocks
    return out


def _leaves(tree):
    """Leaves in sorted-key order (the reference's pytree order), PackedW
    whole."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _outside(got: np.ndarray, want: np.ndarray) -> int:
    return int((np.abs(got - want) > 0.1 + 0.05 * np.abs(want)).sum())


def serve_both(arch: str, impls=("packed", "pallas"), artifact: bool = True
               ) -> dict:
    """Per impl: both packages' greedy tokens from the same raw weights
    (:func:`slow_decay_weights`) and prompts, whether the two serving
    artifacts agree bitwise, the prefill and first decode logits (count
    outside rtol=0.05, atol=0.1, max |d|), and the port's decode from the
    reference's prefill cache (``interop.cache_from_jax``); and
    :func:`artifact_round_trip`. Run by a fixture in a process of its
    own."""
    from repro.core.qlinear import PackedW as JPackedW
    from repro_torch.core.qlinear import PackedW

    jcfg, tcfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    raw = slow_decay_weights(JL.init_params(jcfg, jax.random.PRNGKey(0)))
    traw = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, raw), "cpu")
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    out = {}
    for impl in impls:
        jplan = JL.quant_plan(jcfg, jget_policy("paper-iv", impl=impl,
                                                kv=JK.KV_HIF4))
        tplan = lm.quant_plan(tcfg, get_policy("paper-iv", impl=impl,
                                               kv=kvcache.KV_HIF4))
        jparams = jax.jit(lambda p: JS.prepare_params_for_serving(
            p, jcfg, jplan))(raw)
        jctx = JCtx(quant=jplan.base, plan=jplan, remat=False, attn_q_chunk=32,
                    attn_k_chunk=32)
        sc = JS.ServeConfig(max_new_tokens=NEW)
        jtoks = JS.serve(jcfg, jparams, {"tokens": jnp.asarray(prompts)}, jctx, sc)
        tparams = TS.prepare_params_for_serving(traw, tcfg, tplan, device="cpu")
        tctx = ModelCtx(plan=tplan, attn_q_chunk=32, attn_k_chunk=32)
        ttoks = TS.serve(tcfg, tparams, {"tokens": torch.from_numpy(prompts)},
                         tctx, TS.ServeConfig(max_new_tokens=NEW), device="cpu")
        # logits: the prefill's, then one decode step from each package's
        # own cache and from the reference's cache carried into the port
        jsctx, tsctx = JS.serving_ctx(jctx), TS.serving_ctx(tctx)
        jl0, jcache = JS.build_decode_cache(jcfg, jparams,
                                            {"tokens": jnp.asarray(prompts)},
                                            jsctx, sc)
        carried = interop.cache_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                jcache), "cpu")
        tok = jnp.argmax(jl0, axis=-1).astype(jnp.int32)
        jl1, _ = jax.jit(lambda p, t, c: JL.decode_step(p, t, c, jcfg, jsctx))(
            jparams, tok, jcache)
        tl0, tcache = TS.build_decode_cache(tcfg, tparams,
                                            {"tokens": torch.from_numpy(prompts)},
                                            tsctx, TS.ServeConfig(max_new_tokens=NEW))
        ttok = torch.from_numpy(np.asarray(tok))
        tl1, _ = lm.decode_step(tparams, ttok, tcache, tcfg, tsctx)
        cl1, _ = lm.decode_step(tparams, ttok, carried, tcfg, tsctx)
        jl = [np.asarray(v, np.float32) for v in (jl0, jl1)]
        tl = [interop.to_numpy(v) for v in (tl0, tl1, cl1)]
        jleaves = jax.tree_util.tree_leaves(
            jparams, is_leaf=lambda x: isinstance(x, JPackedW))
        tleaves = _leaves(tparams)
        same = []
        for jl_, tl_ in zip(jleaves, tleaves):
            if isinstance(jl_, JPackedW):
                same.append(isinstance(tl_, PackedW) and np.array_equal(
                    np.asarray(jl_.codes), tl_.codes.numpy()) and np.array_equal(
                    np.asarray(jl_.meta), interop.to_numpy(tl_.meta, uint32=True)))
            else:
                same.append(np.array_equal(np.asarray(jl_, np.float32),
                                           interop.to_numpy(tl_)))
        out[impl] = {
            "ref": np.asarray(jtoks).tolist(), "port": ttoks.tolist(),
            "leaves": [len(jleaves), len(tleaves)], "artifact_equal": all(same),
            "n_packed": sum(isinstance(v, PackedW) for v in tleaves),
            "outside": [_outside(tl[0], jl[0]), _outside(tl[1], jl[1]),
                        _outside(tl[2], jl[1])],
            "max_abs": [float(np.abs(tl[0] - jl[0]).max()),
                        float(np.abs(tl[1] - jl[1]).max()),
                        float(np.abs(tl[2] - jl[1]).max())],
            "cache_keys": sorted(tcache), "jcache_keys": sorted(jcache)}
    if artifact:
        out["artifact"] = artifact_round_trip(arch)
    return out


def artifact_round_trip(arch: str, policy: str = "paper-iv") -> dict:
    """Both packages save the serving artifact of the same raw weights (the
    reference packing under jit: eagerly it takes ~15 s an arch); each then
    loads the other's. Returns whether the two directories hold the same
    bytes (the manifest's treedef string aside), whether each loaded tree
    equals the other package's leaf for leaf, and the policy each read."""
    import tempfile

    from repro_torch.checkpoint.checkpoint import tree_leaves

    jcfg, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    raw = JL.init_params(jcfg, jax.random.PRNGKey(3))
    eager = JS.prepare_params_for_serving
    JS.prepare_params_for_serving = lambda p, c, q, **kw: jax.jit(
        lambda v: eager(v, c, q, **kw))(p)
    tmp = tempfile.mkdtemp()
    jdir, tdir = os.path.join(tmp, "ref"), os.path.join(tmp, "port")
    try:
        JS.save_serving_artifact(jdir, raw, jcfg, jget_policy(
            policy, impl="packed", kv=JK.KV_HIF4))
    finally:
        JS.prepare_params_for_serving = eager
    TS.save_serving_artifact(
        tdir, interop.params_from_jax(jax.tree_util.tree_map(np.asarray, raw),
                                      "cpu"),
        cfg, get_policy(policy, impl="packed", kv=kvcache.KV_HIF4), device="cpu")
    step = "step_00000000"
    names = sorted(os.listdir(os.path.join(jdir, step)))
    same_bytes = names == sorted(os.listdir(os.path.join(tdir, step)))
    for fn in names:
        with open(os.path.join(jdir, step, fn), "rb") as f:
            want = f.read()
        with open(os.path.join(tdir, step, fn), "rb") as f:
            got = f.read()
        if fn == "manifest.json":
            same_bytes &= json.loads(got)["arrays"] == json.loads(want)["arrays"]
        else:
            same_bytes &= got == want
    tparams, tpol = TS.load_serving_artifact(jdir, cfg, device="cpu")
    jparams, jpol = JS.load_serving_artifact(tdir, jcfg)
    jleaves = jax.tree_util.tree_flatten(jparams)[0]
    tleaves = tree_leaves(tparams)
    same_leaves = len(jleaves) == len(tleaves) > 0
    for j, (_, t, is_meta) in zip(jleaves, tleaves):
        got = interop.to_numpy(t, uint32=is_meta)
        want = np.asarray(j)
        same_leaves &= got.shape == want.shape and bool(
            np.array_equal(got, want.astype(got.dtype)))
    with open(os.path.join(tdir, step, "extra.json")) as f:
        extra = json.load(f)
    shutil.rmtree(tmp)
    return {"same_bytes": bool(same_bytes), "same_leaves": bool(same_leaves),
            "policies": [tpol.to_json_dict(), jpol.to_json_dict()],
            "family": extra["family"], "n_leaves": len(tleaves),
            "n_integrity": len(extra["integrity"]["leaves"])}


def run_in_reference_process(module: str, call: str) -> dict:
    """``module.call`` in a fresh process with XLA's excess precision off;
    its last stdout line is JSON."""
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            (os.path.join(REPO, "src"), os.path.join(REPO, "tests"))))
    run = subprocess.run(
        [sys.executable, "-c", f"import json, {module} as t; "
         f"print(json.dumps(t.{call}))"],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both():
    return run_in_reference_process("test_torch_mamba2",
                                    f"serve_both({ARCH!r})")


def test_artifact_round_trip_across_packages(both):
    """The port's artifact is the reference's bytes; each package loads the
    other's, leaf for leaf; six packed leaves carry integrity records."""
    got = both["artifact"]
    assert got["same_bytes"] and got["same_leaves"]
    assert got["policies"][0] == got["policies"][1]
    assert got["family"] == "ssm" and got["n_integrity"] == 6


@pytest.mark.parametrize("impl", ["packed", "pallas"])
def test_greedy_tokens_equal_the_reference(both, impl):
    got = both[impl]
    assert np.array(got["ref"]).shape == (BATCH, NEW)
    assert got["port"] == got["ref"]
    # tokens that vary within a request, so a wrong layer shows in them
    assert all(len(set(r)) > 1 for r in got["ref"]), got["ref"]


@pytest.mark.parametrize("impl", ["packed", "pallas"])
def test_logits_and_artifact_equal_the_reference(both, impl):
    """Prefill and decode logits within rtol=0.05, atol=0.1 of the
    reference's, every one (also decoding from the reference's own cache,
    carried over by ``cache_from_jax``); mamba2 packs all six linears."""
    got = both[impl]
    assert got["outside"] == [0, 0, 0], got["max_abs"]
    assert got["leaves"][0] == got["leaves"][1] and got["artifact_equal"]
    assert got["n_packed"] == 6
    assert got["cache_keys"] == got["jcache_keys"] == ["layers", "pos"]


# ---------------------------------------------------------------------------
# plans, KV format, refusals
# ---------------------------------------------------------------------------


def plans_equal(arch: str, impl: str) -> list:
    """Both packages' resolved SitePlans under paper-iv with ``impl``, as
    comparable tuples."""
    def rows(plan):
        return [(s.path, s.cfg.fmt, s.cfg.impl, s.cfg.weights_only, s.packed,
                 s.quantize_offline, tuple(s.contract_axes), tuple(s.shape),
                 s.n_values) for s in plan.sites]

    jplan = JL.quant_plan(jget_arch(arch), jget_policy("paper-iv", impl=impl,
                                                       kv=JK.KV_HIF4))
    tplan = lm.quant_plan(get_arch(arch), get_policy("paper-iv", impl=impl,
                                                     kv=kvcache.KV_HIF4))
    assert rows(tplan) == rows(jplan)
    return rows(tplan)


@pytest.mark.parametrize("impl", ["packed", "pallas"])
def test_plan_equals_reference_and_packs_all_six_linears(impl):
    rows = plans_equal(ARCH, impl)
    packed = sorted(r[0] for r in rows if r[4])
    assert packed == [f"blocks.w_{k}" for k in ("b", "c", "dt", "out", "x", "z")]


def test_kv_format_falls_back_like_the_reference():
    cfg, jcfg = get_arch(ARCH).reduced(), jget_arch(ARCH).reduced()
    for fmt in ("bf16", "hif4"):
        q = QuantConfig(fmt="hif4", impl="packed", kv=kvcache.KVCacheConfig(fmt))
        from repro.core.qlinear import QuantConfig as JQ
        jq = JQ(fmt="hif4", impl="packed", kv=JK.KVCacheConfig(fmt))
        assert TS.resolve_kv_format(cfg, q, TS.ServeConfig()) == \
            JS.resolve_kv_format(jcfg, jq, JS.ServeConfig()) == "bf16"
        assert TS.kv_format_fallback(cfg, q, TS.ServeConfig()) == \
            JS.kv_format_fallback(jcfg, jq, JS.ServeConfig()) == (fmt == "hif4")


def test_one_fallback_warning_per_serve_call():
    cfg = get_arch(ARCH).reduced()
    plan = lm.quant_plan(cfg, get_policy("paper-iv", impl="packed",
                                         kv=kvcache.KV_HIF4))
    params = lm.init_params(cfg, 0, device="cpu")
    tokens = torch.zeros((1, 32), dtype=torch.long)
    with pytest.warns(TS.KVFallbackWarning, match="'ssm'") as rec:
        TS.serve(cfg, params, {"tokens": tokens}, ModelCtx(plan=plan),
                 TS.ServeConfig(max_new_tokens=3), device="cpu")
    assert len([w for w in rec if w.category is TS.KVFallbackWarning]) == 1


def test_request_scheduler_page_pool_and_hif4_kv_refuse_the_family():
    cfg = get_arch(ARCH).reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="KV-cache families, got 'ssm'"):
        TS.serve_requests(cfg, params, [torch.zeros(8, dtype=torch.long)],
                          ModelCtx(), TS.ServeConfig(max_new_tokens=2),
                          device="cpu")
    with pytest.raises(ValueError, match="got 'ssm'"):
        lm.init_paged_cache(cfg, 2, 4, 8, 2, device="cpu")
    with pytest.raises(ValueError, match="got 'ssm'"):
        lm.quantize_kv_cache({"layers": {}, "pos": 1}, cfg)


def test_prompt_off_the_chunk_raises_and_decode_cache_is_not_padded():
    cfg = get_arch(ARCH).reduced()              # chunk 32
    params = lm.init_params(cfg, 0, device="cpu")
    ctx = ModelCtx()
    with pytest.raises(ValueError, match="not divisible by ssd chunk 32"):
        lm.prefill(params, {"tokens": torch.zeros((1, 48), dtype=torch.long)},
                   cfg, ctx)
    for S in (5, 32, 64):
        _, cache = TS.build_decode_cache(
            cfg, params, {"tokens": torch.zeros((2, S), dtype=torch.long)}, ctx,
            TS.ServeConfig(max_new_tokens=4))
        assert cache["pos"] == S and set(cache) == {"layers", "pos"}
        L = cfg.n_layers
        di, H, G, N, P, K = TM.dims(cfg)
        assert cache["layers"]["conv_x"].shape == (L, 2, K - 1, di)
        assert cache["layers"]["ssd"].shape == (L, 2, H, P, N)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ("--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "32",
          "--new-tokens", "2", "--policy", "paper-iv", "--impl", "packed",
          "--kv-format", "hif4")
# the reference launcher's lines at these flags (``python -m
# repro.launch.serve --arch mamba2-1.3b`` with LAUNCH but --device; ~40 s on
# this CPU, so they are pinned here)
REF_LINES = """\
policy plan [paper-iv] (6/8 sites packed):
  site               fmt        impl    resident artifact                         bytes
  blocks.w_b         hif4       packed  PackedW 4.5-bit (0.5625 B/value)          2,304
  blocks.w_c         hif4       packed  PackedW 4.5-bit (0.5625 B/value)          2,304
  blocks.w_dt        hif4       packed  PackedW 4.5-bit (0.5625 B/value)          1,152
  blocks.w_out       hif4       packed  PackedW 4.5-bit (0.5625 B/value)         36,864
  blocks.w_x         hif4       packed  PackedW 4.5-bit (0.5625 B/value)         36,864
  blocks.w_z         hif4       packed  PackedW 4.5-bit (0.5625 B/value)         36,864
  embed              none       packed  bfloat16                                131,072
  lm_head            none       packed  (tied -> embed)                               0
packed weight residency: 0.11 MiB for 206848 values = 0.5625 B/value (bf16 would be 0.39 MiB)
kv cache residency: n/a (attention-free family)"""
# the reference's reasons (its asserts) for the flags it refuses here
REF_REFUSALS = {"--kv-pages": "--kv-pages requires --kv-format hif4 on a "
                              "KV-cache family",
                "--guard": "continuous batching supports KV-cache families"}


def report_lines(text: str) -> list:
    """The launcher's plan, residency and KV lines (not the dispatch line,
    whose execution differs by package, nor the tokens, whose weights
    differ by package)."""
    keep = ("policy plan", "  ", "packed weight residency", "impl=",
            "kv cache residency")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def launcher_report(arch: str, capsys, *flags) -> tuple:
    """(exit code, stdout, stderr) of the port's launcher in this process."""
    from repro_torch.launch import serve as launcher

    capsys.readouterr()
    rc = launcher.main(["--arch", arch, *LAUNCH, *flags])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_launcher_lines_equal_the_reference(capsys):
    rc, out, _ = launcher_report(ARCH, capsys)
    assert rc == 0
    assert report_lines(out) == REF_LINES.splitlines()
    lines = [ln for ln in out.splitlines() if ln.startswith("request ")]
    assert len(lines) == 2 and all(len(json.loads(ln.split(": ", 1)[1])) == 2
                                   for ln in lines)


@pytest.mark.parametrize("flags, reason", [
    (("--kv-pages", "8"), REF_REFUSALS["--kv-pages"]),
    (("--guard",), REF_REFUSALS["--guard"] + ", got 'ssm'"),
    (("--inject-fault", "nan_activation"), REF_REFUSALS["--guard"]),
    (("--journal-dir", "never-written"), REF_REFUSALS["--guard"])])
def test_launcher_refuses_like_the_reference(capsys, flags, reason):
    rc, out, err = launcher_report(ARCH, capsys, *flags)
    assert rc != 0 and reason in err, err
    assert not any(ln.startswith("request ") for ln in out.splitlines())


# ---------------------------------------------------------------------------
# the kernels at mamba2's full-width shapes (card only)
# ---------------------------------------------------------------------------

# (K, N) of mamba2-1.3b's six linears: w_z, w_x; w_b, w_c; w_dt; w_out
SHAPES = ((2048, 4096), (2048, 128), (2048, 64), (4096, 2048))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _word_bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k, n", SHAPES)
def test_packed_linear_kernels_bitwise_at_mamba2_shapes(cuda, k, n):
    """Kernel 1 then kernel 2's prefill form (tile 128: N 64 and 128 are
    one partial or whole column tile) at 300 rows, and the decode form at
    8 rows, each bitwise its plain version on the same card tensors."""
    from repro_torch.core.qlinear import PackedW
    from repro_torch.kernels.fused_matmul import (
        fused_decode_matmul, fused_decode_matmul_plain, fused_packed_matmul,
        fused_packed_matmul_plain)
    from repro_torch.kernels.hif4_quant import absorbed_activation, hif4_quantize

    g = torch.Generator(device=cuda).manual_seed(k + n)
    w = (torch.randn(k, n, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    pw = PackedW.from_dense(w).to_kernel_layout()
    x = torch.randn(300, k, generator=g, device=cuda).to(torch.bfloat16)
    ai, asc = hif4_quantize(x)
    pi, ps = absorbed_activation(x)
    assert torch.equal(ai, pi) and torch.equal(asc.view(torch.int32),
                                               ps.view(torch.int32))
    y = fused_packed_matmul(ai, asc, pw.codes, pw.meta, torch.bfloat16)
    ref = fused_packed_matmul_plain(ai, asc, pw.codes, pw.meta, torch.bfloat16)
    assert torch.equal(_word_bits(y), _word_bits(ref))
    x8 = x[:8].contiguous()
    y = fused_decode_matmul(x8, pw.codes, pw.meta)
    ref = fused_decode_matmul_plain(x8, pw.codes, pw.meta)
    assert torch.equal(_word_bits(y), _word_bits(ref))
