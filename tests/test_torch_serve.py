"""The serving slice of the PyTorch port vs the JAX reference, end to end.

``qwen1.5-0.5b --reduced`` (2 layers, d_model 128) under ``paper-iv`` /
impl packed / HiF4 KV cache, with the reference's weights carried across by
``repro_torch.interop``; the port runs on the CPU (plain versions).

* ``prepare_params_for_serving``: every leaf bitwise.
* Prefill logits and each decode step's logits (teacher-forced with the
  reference's greedy tokens): within rtol=0.05, atol=0.1, the documented
  decode tolerance (docs/FORMATS.md); max |d| is printed.
* The packed decode cache: packing the reference's own dense prefill K/V
  gives the reference's bytes, bitwise. The reference is run op by op here:
  under ``jax.jit`` XLA's default excess precision skips intermediate bf16
  roundings of Algorithm 1, so the jitted reference packs ~2% of codes
  differently from its own eager run. (The two prefills are float-close,
  not bitwise: see ROADMAP §3.)
* Greedy tokens from ``serve()`` equal the reference's.
* The launcher runs on the CPU in a subprocess, lockstep and paged, and
  refuses an architecture the port does not carry yet.
"""
import json
import os
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
from repro.core.qlinear import PackedW as JPackedW
from repro.models import lm as JL
from repro.models.common import ModelCtx as JCtx
from repro.runtime import serve_loop as JS
from repro_torch import interop
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import kvcache as TK
from repro_torch.core.policy import get_policy as tget_policy
from repro_torch.core.qlinear import PackedW as TPackedW
from repro_torch.models import lm as TL
from repro_torch.models.common import ModelCtx as TCtx
from repro_torch.runtime import serve_loop as TS

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, PROMPT, NEW = 2, 8, 4
RTOL, ATOL = 0.05, 0.1


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def ref():
    """Both packages on the same weights, prompts and plan; the reference's
    results are computed once (jit compiles dominate this file's time)."""
    jcfg = jget_arch("qwen1.5-0.5b").reduced()
    tcfg = tget_arch("qwen1.5-0.5b").reduced()
    params = JL.init_params(jcfg, jax.random.PRNGKey(0))
    jplan = JL.quant_plan(jcfg, jget_policy("paper-iv", impl="packed", kv=JK.KV_HIF4))
    tplan = TL.quant_plan(tcfg, tget_policy("paper-iv", impl="packed", kv=TK.KV_HIF4))
    jctx = JCtx(quant=jplan.base, plan=jplan, remat=False, attn_q_chunk=32,
                attn_k_chunk=32)
    tctx = TCtx(quant=tplan.base, plan=tplan, attn_q_chunk=32, attn_k_chunk=32)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab, (BATCH, PROMPT)
                                                ).astype(np.int32)
    sc = JS.ServeConfig(max_new_tokens=NEW)
    jtoks = np.asarray(JS.serve(jcfg, params, {"tokens": jnp.asarray(prompts)},
                                jctx, sc))
    jparams = JS.prepare_params_for_serving(params, jcfg, jplan)
    jsctx = JS.serving_ctx(jctx)
    jlogits, jcache = JS.build_decode_cache(jcfg, jparams,
                                            {"tokens": jnp.asarray(prompts)},
                                            jsctx, sc)
    # the reference's dense prefill cache, from its already-compiled prefill
    dense_prefill = JS._jit_prefill(jcfg, jsctx)(
        jparams, {"tokens": jnp.asarray(prompts)})[1]
    eager_packed = JL.pad_cache(JL.quantize_kv_cache(dense_prefill, jcfg), jcfg,
                                PROMPT + NEW)
    step = jax.jit(lambda p, t, c: JL.decode_step(p, t, c, jcfg, jsctx))
    step_logits, cache = [np.asarray(jlogits)], jcache
    for i in range(NEW - 1):
        lg, cache = step(jparams, jnp.asarray(jtoks[:, i]), cache)
        step_logits.append(np.asarray(lg))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return dict(jcfg=jcfg, tcfg=tcfg, params=np_params, jparams=jparams,
                tplan=tplan, tctx=tctx, prompts=prompts, jtoks=jtoks,
                jcache=jcache, dense_prefill=dense_prefill,
                eager_packed=eager_packed,
                step_logits=step_logits)


def _port_params(ref):
    tparams = interop.params_from_jax(ref["params"], "cpu")
    return TS.prepare_params_for_serving(tparams, ref["tcfg"], ref["tplan"],
                                         device="cpu")


def test_prepare_params_for_serving_bitwise(ref):
    tparams = _port_params(ref)
    jleaves = dict(_walk(jax.tree_util.tree_map(
        lambda x: x, ref["jparams"], is_leaf=lambda x: isinstance(x, JPackedW))))
    tleaves = dict(_walk(tparams))
    assert sorted(jleaves) == sorted(tleaves)
    n_packed = 0
    for path, jl in jleaves.items():
        tl = tleaves[path]
        if isinstance(jl, JPackedW):
            assert isinstance(tl, TPackedW) and tl.kernel_layout == jl.kernel_layout
            np.testing.assert_array_equal(np.asarray(jl.codes), tl.codes.numpy())
            np.testing.assert_array_equal(np.asarray(jl.meta),
                                          interop.to_numpy(tl.meta, uint32=True))
            n_packed += 1
        else:
            np.testing.assert_array_equal(np.asarray(jl, np.float32),
                                          interop.to_numpy(tl))
    assert n_packed == 7
    jb, jn = JS.packed_weight_bytes(ref["jparams"])
    assert TS.packed_weight_bytes(tparams) == (jb, jn) and jb / jn == 0.5625


def _close(name, got, want):
    d = np.abs(got - want)
    print(f"{name}: max |d| {d.max():.4g} (|ref| max {np.abs(want).max():.3f})")
    assert (d <= ATOL + RTOL * np.abs(want)).all(), d.max()


def test_prefill_and_decode_logits_close(ref):
    """Teacher-forced with the reference's tokens, every step's logits stay
    within the documented tolerance."""
    tparams = _port_params(ref)
    sctx = TS.serving_ctx(ref["tctx"])
    logits, cache = TS.build_decode_cache(
        ref["tcfg"], tparams, {"tokens": torch.from_numpy(ref["prompts"]).long()},
        sctx, TS.ServeConfig(max_new_tokens=NEW))
    _close("prefill", logits.numpy(), ref["step_logits"][0])
    for i in range(NEW - 1):
        tok = torch.from_numpy(ref["jtoks"][:, i].copy())
        logits, cache = TL.decode_step(tparams, tok, cache, ref["tcfg"], sctx)
        _close(f"decode step {i + 1}", logits.numpy(), ref["step_logits"][i + 1])


def test_decode_cache_packing_bitwise(ref):
    """The port's pack + pad of the reference's dense prefill K/V is the
    reference's packed decode cache, byte for byte, in every layer."""
    dense = interop.cache_from_jax(
        jax.tree_util.tree_map(np.asarray, ref["dense_prefill"]), "cpu")
    assert dense["pos"] == PROMPT
    packed = TL.pad_cache(TL.quantize_kv_cache(dense, ref["tcfg"]), ref["tcfg"],
                          PROMPT + NEW)
    for name in ("k", "v"):
        for key in ("codes", "meta", "tail"):
            want = np.asarray(ref["eager_packed"]["kv"][name][key])
            got = interop.to_numpy(packed["kv"][name][key],
                                   uint32=want.dtype == np.uint32)
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=key)
    jbytes = JS.kv_cache_bytes(ref["jcache"])
    assert TS.kv_cache_bytes(packed) == jbytes


def test_serve_greedy_tokens_equal_reference(ref):
    tparams = interop.params_from_jax(ref["params"], "cpu")
    toks = TS.serve(ref["tcfg"], tparams,
                    {"tokens": torch.from_numpy(ref["prompts"]).long()},
                    ref["tctx"], TS.ServeConfig(max_new_tokens=NEW), device="cpu")
    np.testing.assert_array_equal(toks.numpy(), ref["jtoks"])


def test_serve_eos_and_decode_chunks(ref):
    """With ``eos_id`` a request repeats eos from its first eos on (the
    reference's ``where(done, eos, next)``), the others are untouched, and
    one-token decode chunks change no token."""
    eos = int(ref["jtoks"][0, 1])
    want = ref["jtoks"].copy()
    for row in want:
        hit = np.flatnonzero(row == eos)
        if len(hit):
            row[hit[0]:] = eos
    tparams = interop.params_from_jax(ref["params"], "cpu")
    toks = TS.serve(ref["tcfg"], tparams,
                    {"tokens": torch.from_numpy(ref["prompts"]).long()},
                    ref["tctx"], TS.ServeConfig(max_new_tokens=NEW, eos_id=eos,
                                                decode_chunk=1), device="cpu")
    np.testing.assert_array_equal(toks.numpy(), want)


def _launch(*args, module="repro_torch.launch.serve"):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)


def test_launcher_serves_on_cpu():
    out = _launch("--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "8", "--new-tokens", "3",
                  "--policy", "paper-iv", "--impl", "packed",
                  "--kv-format", "hif4")
    assert out.returncode == 0, out.stderr
    text = out.stdout
    assert "policy plan [paper-iv] (7/9 sites packed)" in text
    assert "packed weight residency" in text and "0.5625 B/value" in text
    assert "kv cache residency [hif4]: 288 B/token" in text
    assert "packed attention:" in text and "packed matmul: fused" in text
    lines = [ln for ln in text.splitlines() if ln.startswith("request ")]
    assert len(lines) == 2 and all(len(eval(ln.split(": ", 1)[1])) == 3
                                   for ln in lines)


def test_launcher_refuses_flags_not_yet_ported(tmp_path):
    """Every serve flag and family, the train mode and the dry run with its
    vec_q attention form are ported: ``--attn vec_q`` costs a cell and
    records the form; an arch neither package has exits 2."""
    out = _launch("--arch", "whisper-tiny", "--shape", "decode_32k",
                  "--attn", "vec_q", "--out", str(tmp_path),
                  module="repro_torch.launch.dryrun")
    assert out.returncode == 0, out.stderr
    assert "1 cells passed, 0 failed" in out.stdout
    (path,) = tmp_path.iterdir()
    assert json.loads(path.read_text())["attn_impl"] == "vec_q"
    out = _launch("--arch", "whisper-base", "--reduced", "--device", "cpu")
    assert out.returncode == 2 and "unknown arch 'whisper-base'" in out.stderr


def test_launcher_serves_paged_on_cpu():
    """``--kv-pages`` serves the requests through the paged scheduler and
    prints the pool residency and scheduler lines of the JAX launcher; the
    tokens equal the lockstep serve's (tiles of a 16-token page partition a
    capacity of 16 exactly like the single tile of the lockstep cache)."""
    args = ("--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--new-tokens", "8",
            "--policy", "paper-iv", "--impl", "packed", "--kv-format", "hif4")
    out = _launch(*args, "--kv-pages", "4", "--kv-page-tokens", "16",
                  "--decode-chunk", "3")
    assert out.returncode == 0, out.stderr
    text = out.stdout
    assert "kv page pool [hif4]: 4 pages x 16 tokens (4608 B/page)" in text
    # on the CPU the paged wrapper runs its plain version
    assert "fused_paged_decode_attention_plain, kv tile 16 of 1 pages" in text
    assert ("paged scheduler: max 2 concurrent, 0 shared-page hits, "
            "0 preemptions, 0 LRU evictions, peak 2/4 pages live") in text
    lockstep = _launch(*args)
    assert lockstep.returncode == 0, lockstep.stderr
    req = [ln for ln in text.splitlines() if ln.startswith("request ")]
    assert len(req) == 2
    assert req == [ln for ln in lockstep.stdout.splitlines()
                   if ln.startswith("request ")]


def test_launcher_serves_the_dense_pallas_head_on_cpu(tmp_path):
    """A policy JSON that quantizes the tied LM head under ``--impl pallas``:
    the block sites pack, the head runs the dense pallas route, and the plan
    prints it as the JAX launcher does."""
    policy = tmp_path / "head.json"
    policy.write_text(json.dumps({
        "name": "hif4-with-head", "kv_format": "hif4",
        "rules": [{"pattern": "*", "fmt": "hif4"},
                  {"pattern": "embed", "fmt": "none"},
                  {"pattern": "*.router", "fmt": "none"}]}))
    out = _launch("--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "8", "--new-tokens", "3",
                  "--impl", "pallas", "--kv-format", "hif4",
                  "--policy", str(policy))
    assert out.returncode == 0, out.stderr
    text = out.stdout
    assert "policy plan [hif4-with-head] (7/9 sites packed)" in text
    head = [ln.split() for ln in text.splitlines() if ln.strip().startswith("lm_head")]
    assert head == [["lm_head", "hif4", "pallas", "(tied", "->", "embed)", "0"]]
    lines = [ln for ln in text.splitlines() if ln.startswith("request ")]
    assert len(lines) == 2 and all(len(eval(ln.split(": ", 1)[1])) == 3
                                   for ln in lines)


@pytest.mark.parametrize("flags, plan", [
    (("--policy", "nvfp4-baseline", "--impl", "pallas", "--kv-format", "hif4"),
     "policy plan [nvfp4-baseline] (0/9 sites packed)"),
    (("--quant", "mxfp4"), None)])
def test_launcher_serves_baseline_formats_on_cpu(flags, plan):
    out = _launch("--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "8", "--new-tokens", "3", *flags)
    assert out.returncode == 0, out.stderr
    assert "no packed weights resident (fake-quant bf16 artifact)" in out.stdout
    if plan:
        assert plan in out.stdout
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("request ")]
    assert len(lines) == 2
