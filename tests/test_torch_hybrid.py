"""The port's hybrid family (zamba2-2.7b: a Mamba2 backbone and ONE shared
attention+MLP block before each group of ``hybrid_attn_every`` Mamba
layers, each invocation with its own KV cache) against the JAX reference.

* The config, the doubly stacked specs (n_super, per, ...) and the cache
  specs equal the reference's.
* Served at ``--reduced`` (paper-iv, impl packed: all QDQ; HiF4 KV
  requested, which falls back to bf16): greedy tokens equal the
  reference's, the prefill and first decode logits within rtol=0.05,
  atol=0.1 (also decoding from the reference's prefill cache), the
  serving artifact bitwise and loadable across packages. The reference
  runs with XLA's excess precision off in a process of its own; weights as
  in ``test_torch_mamba2.py`` (5x, slow SSD decay). Impl pallas and
  the kernels at zamba2's shapes: ``test_torch_hybrid_pallas.py``.
* Groups of more than one Mamba layer (4 layers, a shared block every 2):
  prefill and two decode steps' logits within rtol=0.05, atol=0.1 of the
  reference (jitted, in this process, unquantized), each invocation
  appending to its own KV cache.
* The plan packs nothing and QDQs offline only ``shared.mlp.*`` and the
  untied ``lm_head``, as the reference's; ``hif4`` KV falls back to bf16
  with one ``KVFallbackWarning`` per serve call; the request scheduler,
  the page pool and the HiF4 KV layout refuse the family; ``pad_cache``
  grows only the shared block's KV; the launcher prints the reference's
  lines and refusals.
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
from repro.models import lm as JL
from repro.models.common import ModelCtx as JCtx
from repro.runtime import serve_loop as JS
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import kvcache
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import QuantConfig
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.models.params import spec_leaves
from repro_torch.runtime import serve_loop as TS
from test_torch_mamba2 import (BATCH, NEW, _outside, launcher_report,
                               plans_equal, report_lines,
                               run_in_reference_process, slow_decay_weights)

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"


def test_config_equals_reference():
    for port, ref in ((get_arch(ARCH), jget_arch(ARCH)),
                      (get_arch(ARCH).reduced(), jget_arch(ARCH).reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params() == ref.n_params()
    assert get_arch(ARCH).reduced().hybrid_attn_every == 1


def _spec_table(specs):
    return [(".".join(path), tuple(p.shape), tuple(p.axes),
             str(p.dtype).replace("torch.", ""), p.init)
            for path, p in spec_leaves(specs)]


def _jspec_table(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: hasattr(x, "axes"))[0]
    return [(".".join(k.key for k in path), tuple(p.shape), tuple(p.axes),
             jnp.dtype(p.dtype).name, p.init) for path, p in flat]


@pytest.mark.parametrize("reduced", [False, True])
def test_doubly_stacked_specs_equal_reference(reduced):
    cfg, jcfg = get_arch(ARCH), jget_arch(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert _spec_table(lm.abstract_params(cfg)) == _jspec_table(
        JL.abstract_params(jcfg))
    assert _spec_table(lm.abstract_cache(cfg, 2, 40, "hif4")) == _jspec_table(
        JL.abstract_cache(jcfg, 2, 40, "hif4"))
    if not reduced:
        assert lm.abstract_params(cfg)["blocks"]["w_z"].shape == (9, 6, 2560, 5120)
        assert lm.abstract_cache(cfg, 8, 544)["kv"]["k"].shape == (9, 8, 544, 32, 80)


# ---------------------------------------------------------------------------
# serving against the reference (one subprocess)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both():
    return run_in_reference_process("test_torch_mamba2",
                                    f"serve_both({ARCH!r}, ('packed',))")


def test_greedy_tokens_equal_the_reference(both):
    got = both["packed"]
    assert np.array(got["ref"]).shape == (BATCH, NEW)
    assert got["port"] == got["ref"]
    assert all(len(set(r)) > 1 for r in got["ref"]), got["ref"]


def test_logits_and_artifact_equal_the_reference(both):
    got = both["packed"]
    assert got["outside"] == [0, 0, 0], got["max_abs"]
    assert got["leaves"][0] == got["leaves"][1] and got["artifact_equal"]
    assert got["n_packed"] == 0
    assert got["cache_keys"] == got["jcache_keys"] == ["kv", "layers", "pos"]


def test_artifact_round_trip_across_packages(both):
    got = both["artifact"]
    assert got["same_bytes"] and got["same_leaves"]
    assert got["policies"][0] == got["policies"][1]
    assert got["family"] == "hybrid" and got["n_integrity"] == 0


# ---------------------------------------------------------------------------
# groups of several Mamba layers
# ---------------------------------------------------------------------------


def test_groups_of_two_layers_close_to_the_reference():
    """4 layers, the shared block before each group of 2 (two invocations,
    two KV caches): prefill and two decode steps, unquantized (in this
    process the jitted reference skips bf16 roundings, and HiF4's
    activation quantization would amplify them), every logit within
    rtol=0.05, atol=0.1 of the reference's."""
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), n_layers=4,
                               hybrid_attn_every=2)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=4,
                              hybrid_attn_every=2)
    raw = slow_decay_weights(JL.init_params(jcfg, jax.random.PRNGKey(6)))
    assert raw["blocks"]["w_x"].shape[:2] == (2, 2)
    jctx = JCtx(remat=False, attn_q_chunk=32, attn_k_chunk=32)
    tctx = ModelCtx(attn_q_chunk=32, attn_k_chunk=32)
    jparams = raw
    tparams = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, raw),
                                      "cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 32)).astype(
        np.int32)
    sc = JS.ServeConfig(max_new_tokens=3)
    jl, jcache = JS.build_decode_cache(jcfg, jparams, {"tokens": jnp.asarray(
        prompts)}, jctx, sc)
    tl, tcache = TS.build_decode_cache(cfg, tparams, {"tokens": torch.from_numpy(
        prompts)}, tctx, TS.ServeConfig(max_new_tokens=3))
    assert tcache["kv"]["k"].shape == (2, 2, 35, 4, 32)
    assert tcache["layers"]["ssd"].shape == (2, 2, 2, 8, 32, 16)
    step = jax.jit(lambda p, t, c: JL.decode_step(p, t, c, jcfg, jctx))
    for i in range(3):
        want = np.asarray(jl, np.float32)
        assert _outside(interop.to_numpy(tl), want) == 0, i
        tok = np.array(jnp.argmax(jl, axis=-1).astype(jnp.int32))
        if i < 2:
            jl, jcache = step(jparams, jnp.asarray(tok), jcache)
            tl, tcache = lm.decode_step(tparams, torch.from_numpy(tok), tcache,
                                        cfg, tctx)
    # each invocation appended its own token at positions 32 and 33
    for s in range(2):
        assert bool(tcache["kv"]["k"][s, :, 32:34].abs().sum(-1).gt(0).all())
    assert not torch.equal(tcache["kv"]["k"][0, :, 32], tcache["kv"]["k"][1, :, 32])
    assert tcache["pos"] == 34


# ---------------------------------------------------------------------------
# plans, KV format, cache growth, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["packed", "pallas"])
def test_plan_equals_reference_packs_nothing(impl):
    rows = plans_equal(ARCH, impl)
    assert not any(r[4] for r in rows)
    assert sorted(r[0] for r in rows if r[5]) == [
        "lm_head", "shared.mlp.wi", "shared.mlp.wo"]


def test_kv_format_falls_back_like_the_reference():
    from repro.core.qlinear import QuantConfig as JQ

    cfg, jcfg = get_arch(ARCH).reduced(), jget_arch(ARCH).reduced()
    for fmt in ("bf16", "hif4"):
        q = QuantConfig(fmt="hif4", impl="pallas", kv=kvcache.KVCacheConfig(fmt))
        jq = JQ(fmt="hif4", impl="pallas", kv=JK.KVCacheConfig(fmt))
        assert TS.resolve_kv_format(cfg, q, TS.ServeConfig()) == \
            JS.resolve_kv_format(jcfg, jq, JS.ServeConfig()) == "bf16"
        assert TS.kv_format_fallback(cfg, q, TS.ServeConfig()) == \
            JS.kv_format_fallback(jcfg, jq, JS.ServeConfig()) == (fmt == "hif4")


def test_serve_builds_a_bf16_cache_with_one_fallback_warning():
    cfg = get_arch(ARCH).reduced()
    plan = lm.quant_plan(cfg, get_policy("paper-iv", impl="pallas",
                                         kv=kvcache.KV_HIF4))
    params = lm.init_params(cfg, 0, device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.long)
    with pytest.warns(TS.KVFallbackWarning, match="'hybrid'") as rec:
        toks = TS.serve(cfg, params, {"tokens": tokens}, ModelCtx(plan=plan),
                        TS.ServeConfig(max_new_tokens=3), device="cpu")
    assert toks.shape == (2, 3)
    assert len([w for w in rec if w.category is TS.KVFallbackWarning]) == 1
    _, cache = TS.build_decode_cache(cfg, params, {"tokens": tokens},
                                     TS.serving_ctx(ModelCtx(plan=plan)),
                                     TS.ServeConfig(max_new_tokens=5))
    # the shared block's KV grows to prompt + new tokens, bf16; the SSM
    # state does not grow
    assert cache["kv"]["k"].dtype == torch.bfloat16
    assert cache["kv"]["k"].shape == (2, 2, 13, 4, 32)
    assert cache["layers"]["conv_x"].shape == (2, 1, 2, 3, 256)


def test_request_scheduler_page_pool_and_hif4_kv_refuse_the_family():
    cfg = get_arch(ARCH).reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="KV-cache families, got 'hybrid'"):
        TS.serve_requests(cfg, params, [torch.zeros(8, dtype=torch.long)],
                          ModelCtx(), TS.ServeConfig(max_new_tokens=2),
                          device="cpu")
    with pytest.raises(ValueError, match="got 'hybrid'"):
        lm.init_paged_cache(cfg, 2, 4, 8, 2, device="cpu")
    with pytest.raises(ValueError, match="got 'hybrid'"):
        lm.quantize_kv_cache({"layers": {}, "kv": {}, "pos": 1}, cfg)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

# the reference launcher's lines (``python -m repro.launch.serve --arch
# zamba2-2.7b`` with the flags of ``test_torch_mamba2.LAUNCH`` but --device;
# pinned: the reference takes ~40 s to print them on this CPU)
REF_LINES = """\
policy plan [paper-iv] (0/14 sites packed):
  site               fmt        impl    resident artifact                         bytes
  blocks.w_b         hif4       packed  bfloat16                                  8,192
  blocks.w_c         hif4       packed  bfloat16                                  8,192
  blocks.w_dt        hif4       packed  bfloat16                                  4,096
  blocks.w_out       hif4       packed  bfloat16                                131,072
  blocks.w_x         hif4       packed  bfloat16                                131,072
  blocks.w_z         hif4       packed  bfloat16                                131,072
  embed              none       packed  bfloat16                                131,072
  lm_head            none       packed  bfloat16                                131,072
  shared.attn.wk     hif4       packed  bfloat16                                 32,768
  shared.attn.wo     hif4       packed  bfloat16                                 32,768
  shared.attn.wq     hif4       packed  bfloat16                                 32,768
  shared.attn.wv     hif4       packed  bfloat16                                 32,768
  shared.mlp.wi      hif4       packed  qdq bfloat16 (offline PTQ)               65,536
  shared.mlp.wo      hif4       packed  qdq bfloat16 (offline PTQ)               65,536
impl=packed: no packed weights resident (fake-quant bf16 artifact)
kv cache residency [bf16]: 1024 B/token (bf16: 1024) x 34 capacity x 2 slots = 0.07 MiB"""
# the reference's KVFallbackWarning text
REF_FALLBACK = ("kv_format=hif4 has no packed layout for family 'hybrid' (SSM "
                "recurrent state) — serving falls back to bf16 KV")


def test_launcher_lines_and_fallback_equal_the_reference(capsys):
    with pytest.warns(TS.KVFallbackWarning) as rec:
        rc, out, _ = launcher_report(ARCH, capsys)
    assert rc == 0
    assert report_lines(out) == REF_LINES.splitlines()
    # the launcher's line, then the serve call's
    assert [str(w.message) for w in rec
            if w.category is TS.KVFallbackWarning] == [REF_FALLBACK] * 2
    assert len([ln for ln in out.splitlines() if ln.startswith("request ")]) == 2


@pytest.mark.parametrize("flags, reason", [
    (("--kv-pages", "8"), "--kv-pages requires --kv-format hif4 on a KV-cache "
                          "family"),
    (("--guard",), "continuous batching supports KV-cache families, got "
                   "'hybrid'"),
    (("--journal-dir", "never-written"), "continuous batching supports "
                                         "KV-cache families")])
def test_launcher_refuses_like_the_reference(capsys, flags, reason):
    with pytest.warns(TS.KVFallbackWarning):
        rc, out, err = launcher_report(ARCH, capsys, *flags)
    assert rc != 0 and reason in err, err
