"""The request schedulers of the PyTorch port: ``serve_requests`` with the
slot scheduler and with the paged HiF4 pool scheduler.

Within the port, on the CPU, bitwise:

* paged scheduler == solo ``serve`` of each request at ``attn_kv_block = P``
  and the same capacity (pages partition the token axis like the contiguous
  KV tiles): a shared prefix, a prompt ending on a page boundary, a
  copy-on-write divergence inside a shared tail page, a preemption with a
  byte snapshot restored later, and eos;
* slot scheduler == solo ``serve`` at the same capacity.

The weights are the seeded init scaled by 5 so that greedy tokens change
from step to step (at the init's own scale they repeat one token), and a
wrong KV byte shows in the tokens. Prompt lengths are multiples of the
prefill flash chunk, so a prefix's K/V bytes do not depend on the length of
the prompt around it (the byte check before a page is shared).

Against the JAX package: the ``PAGED_TRACE`` of
``benchmarks/serve_throughput.py`` reproduces the admission counts recorded
in ``benchmarks/BENCH_serve.json`` ``paged_serve``, and on a 3-request
shared-prefix trace at the scaled weights the port's paged scheduler gives
the reference's greedy tokens bitwise (the reference run with XLA's excess
precision off, in a process of its own).
"""
import dataclasses
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
from repro.core.qlinear import QuantConfig as JQC
from repro.models import lm as JL
from repro.models.common import ModelCtx as JCtx
from repro.runtime import serve_loop as JS
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import kvcache
from repro_torch.core.qlinear import QuantConfig
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.runtime.guard import RecoveryError, ServeError
from repro_torch.runtime.serve_loop import (PoolExhaustedError, ServeConfig,
                                            kv_format_fallback,
                                            prepare_params_for_serving, serve,
                                            serve_requests)

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_arch("qwen1.5-0.5b").reduced()
CTX = ModelCtx(quant=QuantConfig(fmt="hif4", impl="packed", kv=kvcache.KV_HIF4),
               attn_q_chunk=2, attn_k_chunk=2)


def _scaled(tree, f):
    if isinstance(tree, dict):
        return {k: _scaled(v, f) for k, v in tree.items()}
    return tree * f if tree.dtype == torch.bfloat16 else tree


@pytest.fixture(scope="module")
def params():
    raw = lm.init_params(CFG, 0, device="cpu")
    raw = dict(raw, blocks=_scaled(raw["blocks"], 5), embed=raw["embed"] * 5)
    return prepare_params_for_serving(raw, CFG, CTX.quant, device="cpu")


def _prompts(seed, lens, prefix_len=0):
    g = torch.Generator().manual_seed(seed)
    prefix = torch.randint(0, CFG.vocab, (prefix_len,), generator=g)
    return [torch.cat([prefix, torch.randint(0, CFG.vocab, (n,), generator=g)])
            for n in lens]


def _solo(params, r, P, cap, budget, eos=None):
    sc = ServeConfig(max_new_tokens=budget, cache_capacity=cap,
                     kv_format="hif4", eos_id=eos)
    ctx = dataclasses.replace(CTX, attn_kv_block=P) if P else CTX
    return serve(CFG, params, {"tokens": r[None]}, ctx, sc, device="cpu")[0]


def _paged(params, reqs, P, cap, budget, pages, slots, chunk=2, eos=None,
           sharing=True):
    sc = ServeConfig(max_new_tokens=budget, decode_chunk=chunk,
                     cache_capacity=cap, kv_format="hif4", kv_pages=pages,
                     kv_page_tokens=P, eos_id=eos, prefix_sharing=sharing)
    stats: dict = {}
    res = serve_requests(CFG, params, reqs, CTX, sc, slots=slots, stats=stats,
                         device="cpu")
    assert stats["scheduler"] == "paged"
    assert stats["pool_audit"]["live"] == 0          # serve-end audit
    return res, stats


def _assert_solo(params, reqs, res, P, cap, budget, eos=None):
    for i, r in enumerate(reqs):
        solo = _solo(params, r, P, cap, budget, eos)
        assert torch.equal(res[i], solo), (i, res[i].tolist(), solo.tolist())
        assert len(set(solo.tolist())) > 1 or eos is not None


@pytest.mark.parametrize("sharing", [True, False])
def test_paged_matches_solo_shared_prefix(params, sharing):
    reqs = _prompts(5, (4, 6, 8), prefix_len=12)      # prompts 16, 18, 20
    P, budget, cap = 8, 6, 32
    res, stats = _paged(params, reqs, P, cap, budget, pages=12, slots=3,
                        sharing=sharing)
    assert (stats["shared_page_hits"] >= 2) == sharing
    assert stats["max_concurrent"] == 3
    _assert_solo(params, reqs, res, P, cap, budget)


def test_paged_prompt_on_page_boundary(params):
    """A prompt filling its pages exactly puts its first decode token at
    offset 0 of a fresh page."""
    reqs = _prompts(9, (16,))
    P, budget, cap = 8, 4, 24
    res, _ = _paged(params, reqs, P, cap, budget, pages=6, slots=1)
    _assert_solo(params, reqs, res, P, cap, budget)


def test_paged_cow_divergence(params):
    """B's prompt is a strict prefix of A's ending inside A's live tail page:
    B shares that page through the partial registry, and its first append
    copies it first; A's bytes never change."""
    a = _prompts(13, (20,))[0]
    reqs = [a, a[:18]]
    P, budget, cap = 8, 6, 32
    res, stats = _paged(params, reqs, P, cap, budget, pages=10, slots=2)
    assert stats["shared_page_hits"] >= 3            # 2 full + the tail page
    _assert_solo(params, reqs, res, P, cap, budget)


def test_paged_preemption_restores_bytes(params):
    """A pool too small for both sequences' growth: the younger one is
    preempted (its page bytes copied to the host), restored after the older
    one retires, and still finishes bitwise equal to solo serving."""
    reqs = _prompts(15, (8, 8))
    P, budget, cap = 4, 8, 16
    res, stats = _paged(params, reqs, P, cap, budget, pages=6, slots=2)
    assert stats["preemptions"] >= 1
    _assert_solo(params, reqs, res, P, cap, budget)


def test_paged_eos_matches_solo(params):
    r = _prompts(21, (12,))
    P, budget, cap = 8, 6, 24
    eos = int(_solo(params, r[0], P, cap, budget)[2])   # stop at the 3rd token
    res, _ = _paged(params, r, P, cap, budget, pages=8, slots=1, eos=eos)
    _assert_solo(params, r, res, P, cap, budget, eos=eos)
    assert res[0].tolist()[3:] == [eos] * 3


def test_paged_pool_too_small_raises(params):
    with pytest.raises(ValueError, match="usable"):
        _paged(params, _prompts(1, (8,)), 4, 16, 8, pages=4, slots=1)
    with pytest.raises(ValueError, match="HiF4"):
        serve_requests(CFG, params, _prompts(1, (8,)), CTX,
                       ServeConfig(kv_format="bf16", kv_pages=8), device="cpu")
    assert issubclass(PoolExhaustedError, RuntimeError)


@pytest.mark.parametrize("kv_format", ["hif4", "bf16"])
def test_slot_scheduler_matches_solo(params, kv_format):
    """Three mixed-length requests through two slots, eos from one
    request's own output: every result equals its solo serve at the same
    capacity."""
    reqs = _prompts(50, (8, 12, 16))
    budget, cap = 6, 24
    sc = ServeConfig(max_new_tokens=budget, cache_capacity=cap,
                     kv_format=kv_format)
    eos = int(serve(CFG, params, {"tokens": reqs[0][None]}, CTX, sc,
                    device="cpu")[0, 3])
    sc = dataclasses.replace(sc, decode_chunk=2, eos_id=eos)
    stats: dict = {}
    res = serve_requests(CFG, params, reqs, CTX, sc, slots=2, stats=stats,
                         device="cpu")
    assert stats["scheduler"] == "slots" and stats["max_concurrent"] == 2
    for i, r in enumerate(reqs):
        solo = serve(CFG, params, {"tokens": r[None]}, CTX, sc, device="cpu")[0]
        assert torch.equal(res[i], solo), i


def test_kv_format_fallback_matches_reference():
    jcfg = jget_arch("qwen1.5-0.5b").reduced()
    for fmt in ("bf16", "hif4", None):
        for kv in ("bf16", "hif4"):
            want = JS.kv_format_fallback(
                jcfg, JQC(fmt="hif4", impl="packed", kv=JK.KVCacheConfig(kv)),
                JS.ServeConfig(kv_format=fmt))
            got = kv_format_fallback(
                CFG, QuantConfig(fmt="hif4", impl="packed",
                                 kv=kvcache.KVCacheConfig(kv)),
                ServeConfig(kv_format=fmt))
            assert got == want is False


def test_not_yet_ported_scheduler_arguments_raise(params):
    """The journal is ported: resume=True without a journal_dir raises the
    reference's typed RecoveryError (a ServeError) on both schedulers."""
    for pages in (0, 8):
        with pytest.raises(RecoveryError, match="journal_dir"):
            serve_requests(CFG, params, _prompts(1, (8,)), CTX,
                           ServeConfig(kv_format="hif4", kv_pages=pages,
                                       kv_page_tokens=8, cache_capacity=24,
                                       max_new_tokens=4),
                           device="cpu", resume=True)
    assert issubclass(RecoveryError, ServeError)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

# benchmarks/serve_throughput.py PAGED_TRACE (the port keeps its own copy)
PAGED_TRACE = {"page_tokens": 16, "budget": 8, "prefix_len": 24,
               "tail_lens": (8, 12, 16, 8, 12, 16, 80), "slot_slots": 2,
               "decode_chunk": 2}


def test_paged_trace_reproduces_bench_serve():
    """The reference's paged-vs-slot trace at equal KV bytes: the counts
    recorded in BENCH_serve.json ``paged_serve``, and every paged result
    equal to its slot-scheduler result."""
    with open(os.path.join(REPO, "benchmarks", "BENCH_serve.json")) as f:
        want = json.load(f)["paged_serve"]
    t = PAGED_TRACE
    P, budget = t["page_tokens"], t["budget"]
    # the benchmark's prompts, from the same jax.random keys
    prefix = jax.random.randint(jax.random.PRNGKey(7), (t["prefix_len"],), 0,
                                CFG.vocab)
    reqs = [torch.from_numpy(np.array(jnp.concatenate([prefix, jax.random.randint(
        jax.random.PRNGKey(40 + i), (n,), 0, CFG.vocab)]))).long()
        for i, n in enumerate(t["tail_lens"])]
    assert [len(r) for r in reqs] == want["prompt_lens"]
    assert (P, budget, t["prefix_len"]) == (
        want["page_tokens"], want["new_tokens"], want["shared_prefix_len"])
    ctx = ModelCtx(quant=QuantConfig(fmt="hif4", impl="packed"),
                   attn_q_chunk=4, attn_k_chunk=4)
    params = prepare_params_for_serving(lm.init_params(CFG, 0, device="cpu"),
                                        CFG, ctx.quant, device="cpu")
    cap = max(len(r) for r in reqs) + budget
    a = CFG.attn
    per_tok = kvcache.kv_bytes_per_token(a.n_kv_heads, a.d_head, "hif4") * CFG.n_layers
    slot_bytes = t["slot_slots"] * cap * per_tok
    page_bytes = kvcache.page_nbytes(a.n_kv_heads, a.d_head, P, CFG.n_layers)
    kv_pages = slot_bytes // page_bytes
    assert kv_pages * page_bytes == slot_bytes == want["pool_bytes"]
    assert kv_pages == want["kv_pages"]
    sc = ServeConfig(max_new_tokens=budget, decode_chunk=t["decode_chunk"],
                     kv_format="hif4", cache_capacity=cap)
    slot_stats: dict = {}
    res_slot = serve_requests(CFG, params, reqs, ctx, sc, slots=t["slot_slots"],
                              stats=slot_stats, device="cpu")
    paged_stats: dict = {}
    res_paged = serve_requests(
        CFG, params, reqs, ctx,
        dataclasses.replace(sc, kv_pages=int(kv_pages), kv_page_tokens=P),
        slots=len(reqs), stats=paged_stats, device="cpu")
    assert slot_stats["max_concurrent"] == want["max_concurrent_slot"] == 2
    assert paged_stats["max_concurrent"] == want["max_concurrent_paged"] == 6
    assert paged_stats["shared_page_hits"] == want["shared_page_hits"] == 6
    assert paged_stats["preemptions"] == want["preemptions"] == 0
    assert paged_stats["evictions"] == want["lru_evictions"] == 2
    assert paged_stats["peak_live_pages"] == want["peak_live_pages"] == 13
    assert paged_stats["pool_bytes"] == want["pool_bytes"] == 64512
    for a_res, b_res in zip(res_paged, res_slot):
        assert torch.equal(a_res, b_res)


def _jax_scaled(tree, f):
    return jax.tree_util.tree_map(
        lambda a: a * f if a.dtype == jnp.bfloat16 else a, tree)


def paged_tokens_of_both_packages() -> dict:
    """The reference's paged ``serve_requests`` and the port's, on the same
    packed weights (carried through numpy) and a 3-request shared-prefix
    trace: greedy tokens and scheduler counters of each. Run by
    :func:`test_paged_tokens_equal_the_reference` in a process of its own."""
    jcfg = jget_arch("qwen1.5-0.5b").reduced()
    jctx = JCtx(quant=JQC(fmt="hif4", impl="packed", kv=JK.KVCacheConfig("hif4")),
                remat=False, attn_q_chunk=2, attn_k_chunk=2)
    # the scaled weights of the tests above, packed once under jit (eager
    # packing takes ~25 s); both packages then serve these same packed bytes
    jparams = jax.jit(lambda key: JS.prepare_params_for_serving(
        (lambda p: dict(p, blocks=_jax_scaled(p["blocks"], 5), embed=p["embed"] * 5))(
            JL.init_params(jcfg, key)), jcfg, jctx.quant))(jax.random.PRNGKey(0))
    # one prompt length: the reference compiles one prefill
    reqs = [np.asarray(r, np.int32) for r in _prompts(3, (6, 6, 6), prefix_len=8)]
    kw = dict(max_new_tokens=5, decode_chunk=2, cache_capacity=24,
              kv_format="hif4", kv_pages=16, kv_page_tokens=4)
    jstats: dict = {}
    jres = JS.serve_requests(jcfg, jparams, [jnp.asarray(r) for r in reqs], jctx,
                             JS.ServeConfig(**kw), slots=3, stats=jstats)
    tstats: dict = {}
    tres = serve_requests(CFG, interop.params_from_jax(jparams, "cpu"),
                          [torch.from_numpy(r) for r in reqs], CTX,
                          ServeConfig(**kw), slots=3, stats=tstats, device="cpu")
    keys = ("max_concurrent", "shared_page_hits", "preemptions", "evictions",
            "peak_live_pages", "pool_bytes")
    return {"ref": [np.asarray(r).tolist() for r in jres],
            "port": [r.tolist() for r in tres],
            "ref_stats": {k: int(jstats[k]) for k in keys},
            "port_stats": {k: int(tstats[k]) for k in keys}}


def test_paged_tokens_equal_the_reference():
    """The port's paged scheduler gives the reference's greedy tokens, which
    vary within each request, and the reference's scheduler counters.

    The reference runs with XLA's excess precision off: under ``jax.jit``
    XLA otherwise drops the intermediate bf16 roundings of the reference's
    own eager ops (ROADMAP §3), and at the scaled weights, where greedy
    tokens change from step to step, that parts the jitted run from its
    eager run within a few tokens. The port follows the eager ops bitwise.
    The flag must be set before JAX starts its backend, so this comparison
    runs in a process of its own."""
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            (os.path.join(REPO, "src"), os.path.join(REPO, "tests"))))
    run = subprocess.run(
        [sys.executable, "-c", "import json, test_torch_scheduler as t; "
         "print(json.dumps(t.paged_tokens_of_both_packages()))"],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["port_stats"] == out["ref_stats"]
    assert out["ref_stats"]["shared_page_hits"] >= 4
    for i, (want, got) in enumerate(zip(out["ref"], out["port"])):
        # tokens that vary within a request, so a wrong KV byte or page
        # mapping shows in them
        assert len(set(want)) > 1, (i, want)
        assert got == want, (i, got, want)
