"""The port's audio encoder-decoder family (whisper-tiny: a non-causal
encoder over precomputed frame embeddings, a decoder with self- and
cross-attention, LayerNorm with bias, sinusoidal positions) against the
JAX reference.

* The config, the param specs (``enc_blocks`` included) and the cache
  specs ({"self", "cross" of ``ENC_FRAMES_DECODE`` frames, "pos"}) equal
  the reference's; the plan packs the reference's 16 sites.
* ``layer_norm`` equals the reference's within one bf16 ulp (f32 inputs:
  rtol 1e-6), ``sinusoid`` within atol 1e-6 + 2.4e-7 x position (lockstep
  and per-slot positions give the same rows); the non-causal
  ``flash_attention`` with Sq != Sk within rtol 2^-7, atol 2^-7 of the
  reference's (over 99% of outputs equal) and of a plain softmax over every
  key (no KV chunk dropped).
* Served at ``--reduced`` from seeded frames (the reference runs with XLA's
  excess precision off, in a process of its own, as in
  ``test_torch_mamba2.py``; weights at 5x, the embedding and the encoder
  blocks too, or every request repeats one token): greedy tokens equal the
  reference's under paper-iv packed with HiF4 KV and under paper-iv qdq
  with bf16 KV; the prefill and first decode logits within rtol=0.05,
  atol=0.1 (also decoding from the reference's cache); the serving
  artifact bitwise; the HiF4 self and cross KV bytes after
  ``quantize_kv_cache`` bitwise the reference's on the same K/V; the
  artifact round trip across packages.
* A decode step projects the cross-attention's q only (8 linears per
  layer); ``pad_cache`` grows "self", never "cross"; ``resolve_kv_format``
  keeps HiF4 as the reference does; the request scheduler and the page
  pool refuse the family; the launcher prints the reference's lines and
  refuses like it.
* ``cuda``-marked: kernels 1 and 2 at whisper's full-width linears and
  kernel 3 at its self and cross caches against their plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import kvcache as JK
from repro.core.policy import get_policy as jget_policy
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import lm as JL
from repro.runtime import serve_loop as JS
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import kvcache
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import QuantConfig
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import lm
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelCtx
from repro_torch.models.params import spec_leaves
from repro_torch.runtime import serve_loop as TS
from test_torch_mamba2 import (_leaves, _outside, artifact_round_trip,
                               launcher_report, plans_equal, reference_fixtures,
                               report_lines)

torch.set_num_threads(1)

ARCH = "whisper-tiny"
BATCH, FRAMES, NEW = 2, 32, 6
# (impl, kv format) of the served comparisons
SERVES = (("packed", "hif4"), ("qdq", "bf16"))


def test_config_equals_reference():
    for port, ref in ((get_arch(ARCH), jget_arch(ARCH)),
                      (get_arch(ARCH).reduced(), jget_arch(ARCH).reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params() == ref.n_params()
    assert get_arch(ARCH).reduced().enc_layers == 2


def spec_table(specs):
    """(path, shape, axes, dtype, init) per leaf; a packed KV "meta" leaf's
    int32 is the port's carrier of the reference's uint32 words."""
    def dtype(path, p):
        name = str(p.dtype).replace("torch.", "")
        return "uint32" if path[-1] == "meta" and name == "int32" else name

    return [(".".join(path), tuple(p.shape), tuple(p.axes), dtype(path, p),
             p.init) for path, p in spec_leaves(specs)]


def jspec_table(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: hasattr(x, "axes"))[0]
    return [(".".join(k.key for k in path), tuple(p.shape), tuple(p.axes),
             jnp.dtype(p.dtype).name, p.init) for path, p in flat]


@pytest.mark.parametrize("reduced", [False, True])
def test_specs_equal_reference(reduced):
    cfg, jcfg = get_arch(ARCH), jget_arch(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert spec_table(lm.abstract_params(cfg)) == jspec_table(
        JL.abstract_params(jcfg))
    for fmt in ("bf16", "hif4"):
        assert spec_table(lm.abstract_cache(cfg, 2, 40, fmt)) == jspec_table(
            JL.abstract_cache(jcfg, 2, 40, fmt))
    assert lm.ENC_FRAMES_DECODE == JL.ENC_FRAMES_DECODE == 1536


@pytest.mark.parametrize("impl", ["packed", "qdq"])
def test_plan_equals_reference(impl):
    rows = plans_equal(ARCH, impl)
    packed = sorted(r[0] for r in rows if r[4])
    want = ([f"blocks.{a}.w{p}" for a in ("attn", "xattn") for p in "koqv"]
            + ["blocks.mlp.wi", "blocks.mlp.wo"]
            + [f"enc_blocks.attn.w{p}" for p in "koqv"]
            + ["enc_blocks.mlp.wi", "enc_blocks.mlp.wo"])
    assert packed == (sorted(want) if impl == "packed" else [])


# ---------------------------------------------------------------------------
# layer_norm, sinusoid, non-causal flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layer_norm_close_to_reference(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 7, 384)) * 3 + 0.5).astype(np.float32)
    w = (rng.standard_normal(384) * 0.2 + 1).astype(np.float32)
    b = (rng.standard_normal(384) * 0.1).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    jw, jb = jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(JC.layer_norm(jx, jw, jb), np.float32)
    got = interop.to_numpy(TC.layer_norm(interop.tensor_from_numpy(jx, "cpu"),
                                         interop.tensor_from_numpy(jw, "cpu"),
                                         interop.tensor_from_numpy(jb, "cpu")))
    if dtype == "bfloat16":
        # at most one bf16 ulp, where the f32 sums round the other way
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)
        assert np.mean(got == want) > 0.99
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    no_bias = JC.layer_norm(jx, jw, None)
    np.testing.assert_allclose(
        interop.to_numpy(TC.layer_norm(interop.tensor_from_numpy(jx, "cpu"),
                                       interop.tensor_from_numpy(jw, "cpu"), None)),
        np.asarray(no_bias, np.float32), rtol=1e-2, atol=1e-2)


def test_sinusoid_close_to_reference_per_slot_and_lockstep():
    """The frequencies come from each library's f32 ``exp``, which differ
    in the last bit at some of them; the angle pos x freq carries that
    (at most ~2^-23 relative) into sin and cos: atol 1e-6 + 2.4e-7 x pos."""
    for d in (128, 384):
        pos = np.arange(1600)
        want = np.asarray(JL.sinusoid(jnp.asarray(pos), d))
        got = lm.sinusoid(torch.from_numpy(pos), d).numpy()
        assert got.shape == want.shape == (1600, d)
        assert np.all(np.abs(got - want) <= 1e-6 + 2.4e-7 * pos[:, None])
        assert np.array_equal(got[0], want[0])          # BOS: sin 0, cos 0
    # the decode step's per-slot rows (B, 1, d) equal the lockstep row
    slot = lm.sinusoid(torch.tensor([5, 5, 5])[:, None], 384)
    lock = lm.sinusoid(torch.tensor(5) + torch.arange(1), 384)
    assert slot.shape == (3, 1, 384) and torch.equal(slot[1], lock)


def _attn_inputs(seed, B, Sq, Sk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Sq, H, D)) * 2).astype(np.float32)
    k = (rng.standard_normal((B, Sk, Hkv, D)) * 2).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    return [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]


@pytest.mark.parametrize("Sq, Sk, qc, kc", [(1, 64, 1, 16), (32, 96, 16, 32),
                                            (64, 64, 32, 16)])
def test_noncausal_flash_attention_close_to_reference(Sq, Sk, qc, kc):
    """Sq != Sk (the decoder's cross-attention, one query or many) and the
    encoder's Sq == Sk with more KV chunks than query chunks: every KV
    chunk folds in (the causal early exit would drop the later ones)."""
    jq, jk, jv = _attn_inputs(Sq + Sk, 2, Sq, Sk, 6, 3, 64)
    chunk = JA.AttnChunking(q_chunk=qc, k_chunk=kc)
    want = np.asarray(JA.flash_attention(jq, jk, jv, causal=False,
                                         chunking=chunk), np.float32)
    tq, tk, tv = (interop.tensor_from_numpy(a, "cpu") for a in (jq, jk, jv))
    got = TA.flash_attention(tq, tk, tv, causal=False,
                             chunking=TA.AttnChunking(qc, kc))
    assert got.dtype == torch.bfloat16 and got.shape == (2, Sq, 6, 64)
    got = interop.to_numpy(got)
    # the f32 sums run in another order: a bf16 output may round the other
    # way, one ulp of the larger terms it was summed from
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)
    assert np.mean(got == want) > 0.99
    # a plain softmax over every key
    qf, kf, vf = (t.float().reshape(t.shape[0], t.shape[1], 3, -1, 64)
                  if i == 0 else t.float() for i, t in enumerate((tq, tk, tv)))
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kf) / 8.0
    dense = torch.einsum("bgrqk,bkgd->bqgrd", torch.softmax(s, -1), vf)
    np.testing.assert_allclose(got, dense.reshape(2, Sq, 6, 64).numpy(),
                               rtol=2 ** -6, atol=2 ** -7)


def test_causal_flash_attention_unchanged():
    jq, jk, jv = _attn_inputs(9, 1, 64, 64, 4, 2, 32)
    chunk = JA.AttnChunking(q_chunk=16, k_chunk=16)
    want = np.asarray(JA.flash_attention(jq, jk, jv, causal=True,
                                         chunking=chunk), np.float32)
    tq, tk, tv = (interop.tensor_from_numpy(a, "cpu") for a in (jq, jk, jv))
    got = interop.to_numpy(TA.flash_attention(tq, tk, tv,
                                              chunking=TA.AttnChunking(16, 16)))
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)
    assert np.mean(got == want) > 0.99


# ---------------------------------------------------------------------------
# serving against the reference (one subprocess)
# ---------------------------------------------------------------------------


def scaled_weights(raw, scale: float = 5.0):
    """The bf16 weights of every stacked collection and the embedding at
    ``scale`` x the init (the norms' weights too; their zero biases stay)."""
    def sc(a):
        return a * scale if a.dtype == jnp.bfloat16 else a

    return {k: (jax.tree_util.tree_map(sc, v)
                if k in ("blocks", "enc_blocks", "shared", "embed") else v)
            for k, v in raw.items()}


def stub_inputs(cfg, batch: int, length: int, seed: int = 1) -> np.ndarray:
    """Seeded f32 normals (batch, length, d_model): frames or embeds."""
    return np.random.default_rng(seed).standard_normal(
        (batch, length, cfg.d_model)).astype(np.float32)


def _kv_keys(cfg):
    return ("self", "cross") if cfg.family == "audio" else ("kv",)


def serve_both_stub(arch: str, serves=SERVES, length: int = FRAMES,
                    artifact: bool = True) -> dict:
    """Per (impl, kv format): both packages' greedy tokens from the same raw
    weights (:func:`scaled_weights`) and seeded frames or embeds, whether
    the two serving artifacts agree bitwise, the prefill and first decode
    logits (count outside rtol=0.05, atol=0.1, max |d|), the port's decode
    from the reference's cache; for HiF4 KV whether the port's
    ``quantize_kv_cache`` of the reference's prefill K/V is bitwise the
    reference's; and :func:`artifact_round_trip`. Run by a fixture in a
    process of its own."""
    from repro.core.qlinear import PackedW as JPackedW
    from repro_torch.core.qlinear import PackedW

    jcfg, tcfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    key = "frames" if jcfg.family == "audio" else "embeds"
    raw = scaled_weights(JL.init_params(jcfg, jax.random.PRNGKey(0)))
    traw = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, raw), "cpu")
    x = stub_inputs(jcfg, BATCH, length)
    jbatch, tbatch = {key: jnp.asarray(x)}, {key: torch.from_numpy(x)}
    out = {}
    for impl, fmt in serves:
        jplan = JL.quant_plan(jcfg, jget_policy(
            "paper-iv", impl=impl, kv=JK.KVCacheConfig(fmt)))
        tplan = lm.quant_plan(tcfg, get_policy(
            "paper-iv", impl=impl, kv=kvcache.KVCacheConfig(fmt)))
        jparams = jax.jit(lambda p: JS.prepare_params_for_serving(
            p, jcfg, jplan))(raw)
        jctx = JC.ModelCtx(quant=jplan.base, plan=jplan, remat=False,
                           attn_q_chunk=32, attn_k_chunk=32)
        sc = JS.ServeConfig(max_new_tokens=NEW)
        jtoks = JS.serve(jcfg, jparams, jbatch, jctx, sc)
        tparams = TS.prepare_params_for_serving(traw, tcfg, tplan, device="cpu")
        tctx = ModelCtx(plan=tplan, attn_q_chunk=32, attn_k_chunk=32)
        tsc = TS.ServeConfig(max_new_tokens=NEW)
        ttoks = TS.serve(tcfg, tparams, tbatch, tctx, tsc, device="cpu")
        jsctx, tsctx = JS.serving_ctx(jctx), TS.serving_ctx(tctx)
        jl0, jcache = JS.build_decode_cache(jcfg, jparams, jbatch, jsctx, sc)
        carried = interop.cache_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                jcache), "cpu")
        tok = jnp.argmax(jl0, axis=-1).astype(jnp.int32)
        jl1, _ = jax.jit(lambda p, t, c: JL.decode_step(p, t, c, jcfg, jsctx))(
            jparams, tok, jcache)
        tl0, tcache = TS.build_decode_cache(tcfg, tparams, tbatch, tsctx, tsc)
        ttok = torch.from_numpy(np.array(tok))
        tl1, _ = lm.decode_step(tparams, ttok, tcache, tcfg, tsctx)
        cl1, _ = lm.decode_step(tparams, ttok, carried, tcfg, tsctx)
        jl = [np.asarray(v, np.float32) for v in (jl0, jl1)]
        tl = [interop.to_numpy(v) for v in (tl0, tl1, cl1)]
        jleaves = jax.tree_util.tree_leaves(
            jparams, is_leaf=lambda v: isinstance(v, JPackedW))
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
        rec = {"ref": np.asarray(jtoks).tolist(), "port": ttoks.tolist(),
               "leaves": [len(jleaves), len(tleaves)],
               "artifact_equal": all(same),
               "n_packed": sum(isinstance(v, PackedW) for v in tleaves),
               "outside": [_outside(tl[0], jl[0]), _outside(tl[1], jl[1]),
                           _outside(tl[2], jl[1])],
               "max_abs": [float(np.abs(tl[0] - jl[0]).max()),
                           float(np.abs(tl[1] - jl[1]).max()),
                           float(np.abs(tl[2] - jl[1]).max())],
               "cache_keys": sorted(tcache), "jcache_keys": sorted(jcache),
               "pos": [int(tcache["pos"]), int(jcache["pos"])]}
        if fmt == "hif4":
            # the packed KV bytes from the same bf16 K/V: the reference's
            # prefill cache, packed by each package
            _, jraw = jax.jit(lambda p, b: JL.prefill(p, b, jcfg, jsctx))(
                jparams, jbatch)
            jpacked = jax.jit(lambda c: JL.quantize_kv_cache(c, jcfg))(jraw)
            tpacked = lm.quantize_kv_cache(interop.cache_from_jax(
                jax.tree_util.tree_map(np.asarray, jraw), "cpu"), tcfg)
            kv_same, shapes = [], []
            for name in _kv_keys(jcfg):
                for kv in ("k", "v"):
                    for leaf in ("codes", "meta", "tail"):
                        j = np.asarray(jpacked[name][kv][leaf])
                        t = interop.to_numpy(tpacked[name][kv][leaf],
                                             uint32=leaf == "meta")
                        if leaf == "tail":      # bf16 -> f32 is exact
                            j, t = (np.asarray(a, np.float32).view(np.uint32)
                                    for a in (j, t))
                        kv_same.append(j.shape == t.shape
                                       and bool(np.array_equal(j, t)))
                        shapes.append([name, kv, leaf, list(t.shape)])
            rec["kv_bytes_equal"] = kv_same
            rec["kv_shapes"] = shapes
        out[f"{impl}/{fmt}"] = rec
    if artifact:
        out["artifact"] = artifact_round_trip(arch)
    return out


_reference_process, both = reference_fixtures(
    "test_torch_audio", f"serve_both_stub({ARCH!r})")


@pytest.mark.parametrize("serve", [f"{i}/{f}" for i, f in SERVES])
def test_greedy_tokens_equal_the_reference(both, serve):
    got = both[serve]
    assert np.array(got["ref"]).shape == (BATCH, NEW)
    assert got["port"] == got["ref"]
    # tokens that vary within a request, so a wrong layer shows in them
    assert all(len(set(r)) > 1 for r in got["ref"]), got["ref"]


@pytest.mark.parametrize("serve", [f"{i}/{f}" for i, f in SERVES])
def test_logits_and_artifact_equal_the_reference(both, serve):
    got = both[serve]
    assert got["outside"] == [0, 0, 0], got["max_abs"]
    assert got["leaves"][0] == got["leaves"][1] and got["artifact_equal"]
    assert got["n_packed"] == (16 if serve.startswith("packed") else 0)
    assert got["cache_keys"] == got["jcache_keys"] == ["cross", "pos", "self"]
    # the decoder consumed BOS alone
    assert got["pos"] == [1, 1]


def test_self_and_cross_kv_bytes_equal_the_reference(both):
    got = both["packed/hif4"]
    assert len(got["kv_bytes_equal"]) == 12 and all(got["kv_bytes_equal"])
    shapes = {(n, kv, leaf): s for n, kv, leaf, s in got["kv_shapes"]}
    # 4 heads x 32 = 128 features: two 64-groups, no tail; cross holds the
    # frames, self the BOS token
    assert shapes[("cross", "k", "codes")] == [2, BATCH, 64, FRAMES]
    assert shapes[("self", "v", "meta")] == [2, BATCH, 2, 1]


def test_artifact_round_trip_across_packages(both):
    got = both["artifact"]
    assert got["same_bytes"] and got["same_leaves"]
    assert got["policies"][0] == got["policies"][1]
    assert got["family"] == "audio" and got["n_integrity"] == 16


# ---------------------------------------------------------------------------
# decode, cache growth, KV format, refusals
# ---------------------------------------------------------------------------


def _served(cfg, impl="packed", fmt="hif4"):
    plan = lm.quant_plan(cfg, get_policy("paper-iv", impl=impl,
                                         kv=kvcache.KVCacheConfig(fmt)))
    ctx = ModelCtx(plan=plan, attn_q_chunk=32, attn_k_chunk=32)
    params = TS.prepare_params_for_serving(lm.init_params(cfg, 0, device="cpu"),
                                           cfg, plan, device="cpu")
    return params, ctx


def test_decode_projects_only_q_for_cross_attention(monkeypatch):
    """Per layer a decode step runs 8 linears (self q, k, v, o; cross q, o;
    the MLP's two), and the decoder prefill the same 8 on BOS: the cross
    K/V come from the encoder once."""
    cfg = get_arch(ARCH).reduced()
    params, ctx = _served(cfg)
    sites = []
    dense = tf.dense

    def counting(x, w, *, quant, accum_dtype=None):
        sites.append((tuple(x.shape[:-1]), w.shape2d))
        return dense(x, w, quant=quant, accum_dtype=accum_dtype)

    monkeypatch.setattr(tf, "dense", counting)
    frames = torch.randn(2, FRAMES, cfg.d_model)
    logits, cache = TS.build_decode_cache(cfg, params, {"frames": frames},
                                          TS.serving_ctx(ctx),
                                          TS.ServeConfig(max_new_tokens=4))
    L, E = cfg.n_layers, cfg.enc_layers
    # encoder 6 a layer, cross K/V 2 a decoder layer, decoder 8 a layer
    assert sum(rows == (2, FRAMES) for rows, _ in sites) == 6 * E + 2 * L
    assert sum(rows == (2, 1) for rows, _ in sites) == 8 * L
    sites.clear()
    lm.decode_step(params, torch.argmax(logits, -1).to(torch.int32), cache, cfg,
                   TS.serving_ctx(ctx))
    assert len(sites) == 8 * L and all(rows == (2, 1) for rows, _ in sites)


def test_pad_cache_grows_self_never_cross():
    cfg = get_arch(ARCH).reduced()
    params, ctx = _served(cfg)
    frames = torch.randn(2, FRAMES, cfg.d_model)
    _, cache = TS.build_decode_cache(cfg, params, {"frames": frames},
                                     TS.serving_ctx(ctx),
                                     TS.ServeConfig(max_new_tokens=5))
    assert cache["pos"] == 1
    assert kvcache.seq_capacity(cache["self"]["k"]) == 6
    assert kvcache.seq_capacity(cache["cross"]["k"]) == FRAMES
    nbytes, slots = TS.kv_cache_bytes(cache)
    assert slots == 2 * 6
    assert nbytes == sum(kvcache.packed_kv_nbytes(cache[n][kv])
                         for n in ("self", "cross") for kv in ("k", "v"))
    # bf16: the same growth on the dense leaves
    params, ctx = _served(cfg, "qdq", "bf16")
    _, cache = TS.build_decode_cache(cfg, params, {"frames": frames},
                                     TS.serving_ctx(ctx),
                                     TS.ServeConfig(max_new_tokens=5))
    assert cache["self"]["k"].shape == (2, 2, 6, 4, 32)
    assert cache["cross"]["v"].shape == (2, 2, FRAMES, 4, 32)


def test_kv_format_is_the_references_per_family():
    from repro.core.qlinear import QuantConfig as JQ

    for arch in ("whisper-tiny", "llava-next-34b", "qwen1.5-0.5b",
                 "mamba2-1.3b", "zamba2-2.7b"):
        cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
        for fmt in ("bf16", "hif4"):
            q = QuantConfig(fmt="hif4", impl="packed",
                            kv=kvcache.KVCacheConfig(fmt))
            jq = JQ(fmt="hif4", impl="packed", kv=JK.KVCacheConfig(fmt))
            assert TS.resolve_kv_format(cfg, q, TS.ServeConfig()) == \
                JS.resolve_kv_format(jcfg, jq, JS.ServeConfig()), (arch, fmt)
            assert TS.kv_format_fallback(cfg, q, TS.ServeConfig()) == \
                JS.kv_format_fallback(jcfg, jq, JS.ServeConfig())
    assert TS.resolve_kv_format(get_arch(ARCH), QuantConfig(
        kv=kvcache.KV_HIF4), TS.ServeConfig()) == "hif4"


def test_request_scheduler_and_page_pool_refuse_the_family():
    cfg = get_arch(ARCH).reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="KV-cache families, got 'audio'"):
        TS.serve_requests(cfg, params, [torch.zeros(8, dtype=torch.long)],
                          ModelCtx(), TS.ServeConfig(max_new_tokens=2),
                          device="cpu")
    with pytest.raises(ValueError, match="got 'audio'"):
        lm.init_paged_cache(cfg, 2, 4, 8, 2, device="cpu")
    with pytest.raises(ValueError, match="got 'audio'"):
        lm.init_cache(cfg, 2, 8, device="cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

# the reference launcher's lines (``python -m repro.launch.serve --arch
# whisper-tiny`` with the flags of ``test_torch_mamba2.LAUNCH`` but --device;
# pinned: it takes ~40 s on this CPU). Its residency line counts
# prompt_len + new_tokens slots of the self cache and no cross cache.
REF_LINES = """\
policy plan [paper-iv] (16/18 sites packed):
  site               fmt        impl    resident artifact                         bytes
  blocks.attn.wk     hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  blocks.attn.wo     hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  blocks.attn.wq     hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  blocks.attn.wv     hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  blocks.mlp.wi      hif4       packed  PackedW 4.5-bit (0.5625 B/value)         36,864
  blocks.mlp.wo      hif4       packed  PackedW 4.5-bit (0.5625 B/value)         36,864
  blocks.xattn.wk    hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  blocks.xattn.wo    hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  blocks.xattn.wq    hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  blocks.xattn.wv    hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  embed              none       packed  bfloat16                                131,072
  enc_blocks.attn.wk hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  enc_blocks.attn.wo hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  enc_blocks.attn.wq hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  enc_blocks.attn.wv hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  enc_blocks.mlp.wi  hif4       packed  PackedW 4.5-bit (0.5625 B/value)         36,864
  enc_blocks.mlp.wo  hif4       packed  PackedW 4.5-bit (0.5625 B/value)         36,864
  lm_head            none       packed  bfloat16                                131,072
packed weight residency: 0.35 MiB for 655360 values = 0.5625 B/value (bf16 would be 1.25 MiB)
kv cache residency [hif4]: 288 B/token (bf16: 1024) x 34 capacity x 2 slots = 0.02 MiB  [3.56x more slots per byte]"""
REF_DISPATCH = "packed matmul: fused [{}] on e.g. (K=128, N=128)"
# the reference launcher's reasons (its asserts) for the scheduler flags
REF_REFUSALS = {
    "--kv-pages": "--kv-pages serves token requests (dense/vlm-embeds not "
                  "supported by the paged scheduler entry)",
    "--guard": "--guard/--inject-fault/--journal-dir serve token requests "
               "through the request scheduler (dense/vlm-embeds not supported)"}


def test_launcher_lines_equal_the_reference(capsys):
    rc, out, _ = launcher_report(ARCH, capsys)
    assert rc == 0
    assert report_lines(out) == REF_LINES.splitlines()
    assert REF_DISPATCH.format("plain PyTorch fused contraction (CPU)") in out
    lines = [ln for ln in out.splitlines() if ln.startswith("request ")]
    assert len(lines) == 2 and all(len(eval(ln.split(": ", 1)[1])) == 2
                                   for ln in lines)


@pytest.mark.parametrize("flags, reason", [
    (("--kv-pages", "8"), REF_REFUSALS["--kv-pages"]),
    (("--guard",), REF_REFUSALS["--guard"]),
    (("--inject-fault", "nan_activation"), REF_REFUSALS["--guard"]),
    (("--journal-dir", "never-written"), REF_REFUSALS["--guard"])])
def test_launcher_refuses_like_the_reference(capsys, flags, reason):
    rc, out, err = launcher_report(ARCH, capsys, *flags)
    assert rc == 2 and reason in err, err
    assert not any(ln.startswith("request ") for ln in out.splitlines())


def test_launcher_draws_frames_on_the_device_from_the_seed():
    from repro_torch.launch.serve import prefill_batch

    cfg = get_arch(ARCH).reduced()
    a = prefill_batch(cfg, 2, 8, 1, torch.device("cpu"))
    b = prefill_batch(cfg, 2, 8, 1, torch.device("cpu"))
    assert set(a) == {"frames"} and a["frames"].dtype == torch.float32
    assert a["frames"].shape == (2, 8, cfg.d_model)
    assert torch.equal(a["frames"], b["frames"])
    assert not torch.equal(a["frames"], prefill_batch(cfg, 2, 8, 2, "cpu")["frames"])


# ---------------------------------------------------------------------------
# the kernels at whisper-tiny's full-width shapes (card only)
# ---------------------------------------------------------------------------

# (K, N) of whisper-tiny's linears: q/k/v/o and the cross projections; wi; wo
SHAPES = ((384, 384), (384, 1536), (1536, 384))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _word_bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def packed_kernels_bitwise(dev, k, n, mp, m=8):
    """Kernel 1 then kernel 2's prefill form at ``mp`` rows, and the decode
    form at ``m``, each bitwise its plain version on the same card
    tensors."""
    from repro_torch.core.qlinear import PackedW
    from repro_torch.kernels.fused_matmul import (
        fused_decode_matmul, fused_decode_matmul_plain, fused_packed_matmul,
        fused_packed_matmul_plain)
    from repro_torch.kernels.hif4_quant import absorbed_activation, hif4_quantize

    g = torch.Generator(device=dev).manual_seed(k + n)
    w = (torch.randn(k, n, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    pw = PackedW.from_dense(w).to_kernel_layout()
    x = torch.randn(mp, k, generator=g, device=dev).to(torch.bfloat16)
    ai, asc = hif4_quantize(x)
    pi, ps = absorbed_activation(x)
    assert torch.equal(ai, pi) and torch.equal(asc.view(torch.int32),
                                               ps.view(torch.int32))
    y = fused_packed_matmul(ai, asc, pw.codes, pw.meta, torch.bfloat16)
    ref = fused_packed_matmul_plain(ai, asc, pw.codes, pw.meta, torch.bfloat16)
    assert torch.equal(_word_bits(y), _word_bits(ref))
    x8 = x[:m].contiguous()
    y = fused_decode_matmul(x8, pw.codes, pw.meta)
    ref = fused_decode_matmul_plain(x8, pw.codes, pw.meta)
    assert torch.equal(_word_bits(y), _word_bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("k, n", SHAPES)
def test_packed_linear_kernels_bitwise_at_whisper_shapes(cuda, k, n):
    packed_kernels_bitwise(cuda, k, n, 1536)


def decode_attention_close(dev, b, hkv, h, d, cap, length):
    """Kernel 3 on a packed cache of ``cap`` slots within rtol 2^-7, atol
    1e-3 of its plain version."""
    from repro_torch.kernels.fused_attention import (
        fused_decode_attention, fused_decode_attention_plain)

    g = torch.Generator().manual_seed(cap + h)
    caches = [kvcache.to_kernel_layout(kvcache.quantize_kv(
        torch.randn(b, cap, hkv, d, generator=g).to(torch.bfloat16)))
        for _ in range(2)]
    pk, pv = ({k: t.to(dev) for k, t in c.items()} for c in caches)
    q = (torch.randn(b, h, d, generator=g) * 0.5).to(torch.bfloat16).to(dev)
    length = torch.tensor(length, dtype=torch.int32, device=dev)
    out = fused_decode_attention(q, pk, pv, length, n_kv_heads=hkv, d_head=d)
    ref = fused_decode_attention_plain(q, pk, pv, length, hkv, d)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 1e-3 + 2 ** -7 * ref.float().abs()).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("cap, length", [(33, [1, 2, 17, 32, 33, 33, 5, 9]),
                                         (1536, [1536] * 8)])
def test_decode_attention_close_at_whisper_caches(cuda, cap, length):
    """The self cache (1 + 32 slots: one tile, a width not a multiple of 4)
    and the read-only cross cache (1 536 frames, every slot full)."""
    decode_attention_close(cuda, 8, 6, 6, 64, cap, length)
