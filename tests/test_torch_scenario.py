"""The port's serve-cell harness (``repro_torch.runtime.scenario``) against the
reference's ``repro.runtime.scenario`` on the CPU.

* ``EXPECTATIONS`` is the reference's set, and ``check_expect`` gives the
  reference's verdict for every expectation on a set of dispatch dicts.
* On reduced cells of the dense, audio, ssm, hybrid, moe and vlm families
  (packed hif4; and dense packed bf16, dense qdq bf16, dense paged), built
  by each package's own ``_build_cell`` and ``build_decode_cache``:
  ``probe_dispatch`` equals the reference's (the reference's ``_xla``
  routes are the port's ``_plain`` ones), and ``decode_step_bytes`` equals
  it exactly in all four fields.
* The probe agrees with ``engine.attention_dispatch_info`` on the cache
  leaves the cell actually served (the reference's
  ``test_probe_agrees_with_served_cache``).
* Decoding past the cache's capacity, as the timing loop does, gives the
  reference's tokens (writes clamp at the last slot in both).
* One ``run_scenarios(..., device="cpu", repeats=1)`` over a scan cell, its
  guarded twin as a gate pair and the recovery cell: the records carry the
  keys of the reference's, the dispatch holds, the timing kinds, the gate
  timing, a crash that resumes bitwise, and no journal directory left.

The reference's cells are built once per module, in threads; its XLA
compiles dominate this file's time.
"""
import dataclasses
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.models import lm as JL
from repro.runtime import scenario as JSc
from repro.runtime import serve_loop as JS
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.runtime import scenario as TSc
from repro_torch.runtime import serve_loop as TS

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

HIF4 = ("kv:hif4", "kv:no-fallback", "attn:fused_decode_attention",
        "matmul:fused")
CELLS = (
    TSc.Scenario("dense-hif4", "qwen1.5-0.5b", "packed", "hif4", expect=HIF4),
    TSc.Scenario("audio-hif4", "whisper-tiny", "packed", "hif4", expect=HIF4),
    TSc.Scenario("ssm-hif4", "mamba2-1.3b", "packed", "hif4",
                 expect=("kv:bf16", "kv:fallback", "attn:none",
                         "matmul:fused")),
    TSc.Scenario("hybrid-hif4", "zamba2-2.7b", "packed", "hif4",
                 expect=("kv:bf16", "kv:fallback", "attn:dense")),
    TSc.Scenario("moe-hif4", "granite-moe-1b-a400m", "packed", "hif4",
                 expect=HIF4),
    # reduced llava has one KV head of 32: a staging tail, so the plain
    # recurrence is its only route
    TSc.Scenario("vlm-hif4", "llava-next-34b", "packed", "hif4",
                 expect=("kv:hif4", "kv:no-fallback", "attn:twin",
                         "matmul:fused")),
    TSc.Scenario("dense-bf16", "qwen1.5-0.5b", "packed", "bf16",
                 expect=("kv:bf16", "kv:no-fallback", "attn:dense",
                         "matmul:fused")),
    TSc.Scenario("dense-qdq-bf16", "qwen1.5-0.5b", "qdq", "bf16",
                 expect=("kv:bf16", "attn:dense", "matmul:qdq")),
    TSc.Scenario("dense-paged", "qwen1.5-0.5b", "packed", "hif4", paged=True,
                 expect=("kv:hif4", "attn:fused_paged_decode_attention",
                         "matmul:fused")),
)
CELL_IDS = [c.name for c in CELLS]


def _ref_scenario(scn):
    """The reference's Scenario with the same fields (it has no ``reduced``:
    it always serves the reduced config)."""
    kw = dataclasses.asdict(scn)
    assert kw.pop("reduced") is True
    return JSc.Scenario(**kw)


def _ref_cell(scn) -> dict:
    jscn = _ref_scenario(scn)
    cfg, ctx, sp = JSc._build_cell(jscn)
    sc = JSc._serve_cfg(jscn)
    probe = JSc.probe_dispatch(cfg, ctx.quant, sc, sp, paged=scn.paged,
                               batch=scn.batch, prompt_len=scn.prompt_len)
    sctx = JS.serving_ctx(ctx)
    _, cache = JS.build_decode_cache(
        cfg, sp, JSc.prefill_batch(cfg, scn.batch, scn.prompt_len), sctx, sc,
        quant=ctx.quant)
    entry = cache.get("self") or cache.get("kv")
    served = None
    if cfg.attn is not None and isinstance(entry["k"], dict):
        a = cfg.attn
        served = JE.attention_dispatch_info(ctx.quant, entry["k"],
                                            n_kv_heads=a.n_kv_heads,
                                            d_head=a.d_head)
    valid = scn.prompt_len + scn.new_tokens // 2
    return {"probe": probe, "served": served,
            "bytes": JSc.decode_step_bytes(cfg, sp, cache, valid)}


def _port_cell(scn) -> dict:
    cfg, ctx, sp = TSc._build_cell(scn, "cpu")
    sc = TSc._serve_cfg(scn)
    probe = TSc.probe_dispatch(cfg, ctx.quant, sc, sp, paged=scn.paged,
                               batch=scn.batch, prompt_len=scn.prompt_len,
                               device="cpu")
    sctx = TS.serving_ctx(ctx)
    _, cache = TS.build_decode_cache(
        cfg, sp, TSc.prefill_batch(cfg, scn.batch, scn.prompt_len, 1, "cpu"),
        sctx, sc)
    entry = cache.get("self") or cache.get("kv")
    served = None
    if cfg.attn is not None and isinstance(entry["k"], dict):
        a = cfg.attn
        served = TE.attention_dispatch_info(ctx.quant, entry["k"],
                                            n_kv_heads=a.n_kv_heads,
                                            d_head=a.d_head, device="cpu")
    valid = scn.prompt_len + scn.new_tokens // 2
    return {"probe": probe, "served": served,
            "bytes": TSc.decode_step_bytes(cfg, sp, cache, valid)}


@pytest.fixture(scope="module")
def cells():
    # the reference's cells in three threads: their time is XLA compiles,
    # which run outside the GIL
    with ThreadPoolExecutor(3) as pool:
        refs = list(pool.map(_ref_cell, CELLS))
    return {scn.name: (ref, _port_cell(scn)) for scn, ref in zip(CELLS, refs)}


# ---------------------------------------------------------------------------
# the expectation vocabulary
# ---------------------------------------------------------------------------


def _dispatch(resolved, fallback, paged, attn, matmul) -> dict:
    return {"kv_format_resolved": resolved, "kv_format_fallback": fallback,
            "paged": paged, "attn": attn, "matmul": {"route": matmul}}


ELIGIBLE = {"route": "fused_decode_attention", "kernel_eligible": True}
TWIN = {"route": "fused_decode_attention_plain", "kernel_eligible": False}
DISPATCHES = {
    "hif4-fused": _dispatch("hif4", False, False, ELIGIBLE, "fused"),
    "hif4-paged": _dispatch("hif4", False, True, ELIGIBLE, "fused"),
    "hif4-twin": _dispatch("hif4", False, False, TWIN, "qdq"),
    "paged-twin": _dispatch("hif4", False, True, TWIN, "dequant-dot"),
    "bf16-dense": _dispatch("bf16", False, False, {"route": "dense"}, "fused"),
    "bf16-fallback": _dispatch("bf16", True, False, {"route": "none"}, "fused"),
    "hybrid": _dispatch("bf16", True, False, {"route": "dense"}, "qdq"),
}


def test_expectations_are_the_reference_set():
    assert set(TSc.EXPECTATIONS) == set(JSc.EXPECTATIONS)
    assert TSc.EXPECTATIONS == tuple(sorted(TSc.EXPECTATIONS))


@pytest.mark.parametrize("name", list(DISPATCHES))
def test_check_expect_equals_the_reference(name):
    d = DISPATCHES[name]
    for e in TSc.EXPECTATIONS + ("attn:bogus",):
        assert TSc.check_expect([e], d) == JSc.check_expect([e], d), e
    every = list(TSc.EXPECTATIONS)
    assert TSc.check_expect(every, d) == JSc.check_expect(every, d)


# ---------------------------------------------------------------------------
# probes and bytes, cell by cell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CELL_IDS)
def test_probe_dispatch_equals_the_reference(cells, name):
    ref, port = cells[name]
    rp, tp = ref["probe"], port["probe"]
    for key in ("kv_format_resolved", "kv_format_fallback", "paged"):
        assert tp[key] == rp[key], key
    for key in ("kernel_eligible", "block_kv"):
        assert tp["attn"].get(key) == rp["attn"].get(key), key
    assert tp["attn"]["route"] == rp["attn"]["route"].replace("_xla", "_plain")
    assert tp["matmul"]["route"] == rp["matmul"]["route"]
    scn = CELLS[CELL_IDS.index(name)]
    assert TSc.check_expect(scn.expect, tp) == []
    assert JSc.check_expect(scn.expect, rp) == []


@pytest.mark.parametrize("name", CELL_IDS)
def test_decode_step_bytes_equal_the_reference_exactly(cells, name):
    ref, port = cells[name]
    assert port["bytes"] == ref["bytes"]
    b = port["bytes"]
    assert b["bytes_per_step"] == (b["weight_bytes"] + b["kv_bytes"]
                                   + b["state_bytes"])
    assert b["weight_bytes"] > 0


@pytest.mark.parametrize("name", ["dense-hif4", "audio-hif4", "moe-hif4",
                                  "vlm-hif4"])
def test_probe_agrees_with_served_cache(cells, name):
    """probe_dispatch == attention_dispatch_info on the served leaves."""
    ref, port = cells[name]
    for side in (ref, port):
        actual, probe = side["served"], side["probe"]["attn"]
        for key in ("kernel_eligible", "route", "execution"):
            assert actual[key] == probe[key], key


# ---------------------------------------------------------------------------
# decode past the cache's capacity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["hif4", "bf16"])
def test_decode_past_capacity_gives_the_reference_tokens(kv):
    """Three chunks of 4 into a cache of capacity prompt + 4: positions run
    8 past the capacity, where both packages clamp the write to the last
    slot and attend over the whole cache."""
    scn = TSc.Scenario("past", "qwen1.5-0.5b", "packed", kv, batch=2,
                       prompt_len=16, new_tokens=4)
    jscn = _ref_scenario(scn)
    jcfg, jctx, _ = JSc._build_cell(jscn)
    raw = JL.init_params(jcfg, jax.random.PRNGKey(0))
    jsp = JS.prepare_params_for_serving(raw, jcfg, jctx.plan)
    sc = JSc._serve_cfg(jscn)
    jsctx = JS.serving_ctx(jctx)
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 16))
    jlogits, jcache = JS.build_decode_cache(
        jcfg, jsp, {"tokens": jnp.asarray(prompts, jnp.int32)}, jsctx, sc,
        quant=jctx.quant)
    jstep = JS._jit_decode_scan(jcfg, jsctx, 4, None)
    token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    done = jnp.zeros(token.shape, bool)
    want = []
    for _ in range(3):
        toks, token, jcache, done = jstep(jsp, token, jcache, done)
        want.append(np.asarray(toks))

    tcfg, tctx, _ = TSc._build_cell(scn, "cpu")
    tsp = TS.prepare_params_for_serving(
        interop.params_from_jax(jax.tree_util.tree_map(np.asarray, raw), "cpu"),
        tcfg, tctx.plan, device="cpu")
    tsctx = TS.serving_ctx(tctx)
    tlogits, tcache = TS.build_decode_cache(
        tcfg, tsp, {"tokens": torch.from_numpy(prompts).long()}, tsctx, sc)
    token = torch.argmax(tlogits, dim=-1).to(torch.int32)
    done = torch.zeros(token.shape, dtype=torch.bool)
    got = []
    for _ in range(3):
        toks, token, tcache, done = TS._decode_chunk(tsp, token, tcache, done,
                                                     4, tcfg, tsctx, None)
        got.append(toks.numpy())
    k = tcache["kv"]["k"]
    cap = TSc.kvcache.seq_capacity(k) if kv == "hif4" else k.shape[2]
    assert (cap, int(tcache["pos"])) == (16 + 4, 16 + 12)
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


# ---------------------------------------------------------------------------
# run_scenarios on the CPU
# ---------------------------------------------------------------------------


RUN_CELLS = (
    TSc.Scenario("scan", "qwen1.5-0.5b", "packed", "hif4", batch=2,
                 prompt_len=16, new_tokens=4, expect=HIF4),
    TSc.Scenario("scan-guarded", "qwen1.5-0.5b", "packed", "hif4",
                 guarded=True, batch=2, prompt_len=16, new_tokens=4,
                 expect=HIF4),
    TSc.Scenario("recovery", "qwen1.5-0.5b", "packed", "hif4", paged=True,
                 journaled=True, recovery=True, decode_chunk=2, batch=2,
                 prompt_len=16, new_tokens=6,
                 expect=("kv:hif4", "attn:fused_paged_decode_attention",
                         "matmul:fused")),
)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    made = []
    real = tempfile.mkdtemp

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    tempfile.mkdtemp = spy
    try:
        recs = TSc.run_scenarios(RUN_CELLS, repeats=1,
                                 gate_pairs=[("scan", "scan-guarded")],
                                 log=lambda *_: None, device="cpu")
    finally:
        tempfile.mkdtemp = real
    # the reference's record of the same scan cell, for its keys
    jrec = JSc.run_scenarios([_ref_scenario(RUN_CELLS[0])], repeats=1,
                             log=lambda *_: None)[0]
    return {"records": {r["name"]: r for r in recs}, "dirs": made,
            "ref_keys": set(jrec)}


def test_run_records_carry_the_reference_keys(run):
    recs = run["records"]
    assert list(recs) == [c.name for c in RUN_CELLS]
    for name, rec in recs.items():
        extra = {"gate_timing"} if name == "scan-guarded" else set()
        if name == "recovery":
            extra = {"recovery"}
        assert set(rec) == run["ref_keys"] | {"reduced"} | extra, name
        assert rec["dispatch_ok"] is True, rec["dispatch_failures"]
        assert rec["dispatch_failures"] == []
        assert rec["decode_step_ms"] > 0
        ro = rec["roofline"]
        assert ro["bytes_per_step"] == (ro["weight_bytes"] + ro["kv_bytes"]
                                        + ro["state_bytes"])


def test_run_timing_kinds_and_gate_timing(run):
    recs = run["records"]
    assert recs["scan"]["timing"] == "scan-interleaved"
    assert recs["scan-guarded"]["timing"] == "scan-interleaved"
    assert recs["recovery"]["timing"] == "e2e-paged"
    assert recs["scan"]["prefill_ms"] > 0 and recs["recovery"]["prefill_ms"] is None
    gate = recs["scan-guarded"]["gate_timing"]["scan"]
    assert gate["baseline_ms"] > 0 and gate["subject_ms"] > 0
    assert "gate_timing" not in recs["scan"]


def test_run_recovery_resumes_bitwise(run):
    rec = run["records"]["recovery"]["recovery"]
    assert rec["crashed"] is True and rec["bitwise"] is True
    assert rec["resume_ms"] > 0


def test_run_leaves_no_journal_dir(run):
    assert len(run["dirs"]) == 1
    assert os.path.basename(run["dirs"][0]).startswith("matrix_recovery_")
    assert not any(os.path.exists(d) for d in run["dirs"])


def test_run_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSc.run_scenarios(RUN_CELLS[:1], repeats=1, log=lambda *_: None)
