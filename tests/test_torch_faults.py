"""Fault injection through the guarded serve stack of the PyTorch port,
against the JAX reference (mirrors ``tests/test_faults.py``).

For every fault class of ``repro_torch.runtime.faults``: the fault fires,
the victim ends ``retried`` / ``quarantined`` / ``rejected`` (never
silently wrong), and every survivor's tokens are bitwise the uninjected
run's. The same cases run once through the reference in a process of its
own (XLA's excess precision off, as in ``tests/test_torch_scheduler.py``),
on the same weights and prompts: the port's injector logs the same events
(same page, index and bit), the reports carry the same statuses and
details, and the tokens are the same. The injectors are also compared
hook by hook on identical pool state in this process. The launcher prints
the reference launcher's report lines for an injected ``page_corruption``.
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

from repro.core import kvcache as JK
from repro.runtime import faults as JF
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import kvcache
from repro_torch.core.qlinear import QuantConfig
from repro_torch.models.common import ModelCtx
from repro_torch.runtime.faults import (FAULT_CLASSES, FaultInjector, FaultSpec,
                                        parse_fault)
from repro_torch.runtime.guard import GuardConfig, PoolExhaustedError
from repro_torch.runtime.serve_loop import (ServeConfig, prepare_params_for_serving,
                                            serve, serve_requests)

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_arch("qwen1.5-0.5b").reduced()
P, BUDGET, CAP = 8, 6, 32
PAGE_CASES = [("code_flip", 0), ("meta_flip", 3), ("meta_flip", 7),
              ("page_corruption", 1)]


def _prompt_arrays():
    """The reference test's three requests sharing a 12-token prefix, and
    the two 8-token requests of its preemption case."""
    prefix = jax.random.randint(jax.random.PRNGKey(5), (12,), 0, 512)
    reqs = [np.asarray(jnp.concatenate([prefix, jax.random.randint(
        jax.random.PRNGKey(30 + i), (4 + 2 * i,), 0, 512)]), np.int32)
        for i in range(3)]
    pre = [np.asarray(jax.random.randint(jax.random.PRNGKey(15 + i), (8,), 0, 512),
                      np.int32) for i in range(2)]
    return reqs, pre


def _cases():
    """(name, scheduler geometry, ctx kind, guard kwargs, fault spec kwargs)."""
    out = [("paged_base", "paged", "packed", None, None),
           ("paged_guarded", "paged", "packed", {}, None)]
    out += [(f"{k}_{s}", "paged", "packed", {},
             dict(kind=k, seed=s, target_request=1, after_chunk=1))
            for k, s in PAGE_CASES]
    out += [("slots_base", "slots", "qdq", None, None),
            ("nan_activation", "slots", "qdq", {},
             dict(kind="nan_activation", target_request=0, after_chunk=1)),
            ("nan_no_retry", "slots", "qdq", {"retry_fallback": False},
             dict(kind="nan_activation", target_request=0, after_chunk=1)),
            ("pool_starvation", "paged", "packed", {},
             dict(kind="pool_starvation"))]
    out += [(f"snapshot_{b}", "preempt", "packed", {},
             dict(kind="snapshot_truncation", target_request=1, bits=b))
            for b in (0, 1)]
    return out


def _serve_cfg(mod, geometry, guard_kw):
    guard = None if guard_kw is None else mod.GuardConfig(**guard_kw)
    if geometry == "paged":
        return mod.ServeConfig(max_new_tokens=BUDGET, decode_chunk=2,
                               cache_capacity=CAP, kv_format="hif4", kv_pages=12,
                               kv_page_tokens=P, guard=guard)
    if geometry == "slots":
        return mod.ServeConfig(max_new_tokens=BUDGET, decode_chunk=2,
                               cache_capacity=CAP, kv_format="bf16", guard=guard)
    # 5 usable pages, each sequence needs 4: the younger one is preempted
    return mod.ServeConfig(max_new_tokens=8, decode_chunk=2, cache_capacity=16,
                           kv_format="hif4", kv_pages=6, kv_page_tokens=4,
                           guard=guard)


def _summary(res, stats, inj):
    out = {"toks": [np.asarray(r).tolist() for r in res],
           "reports": {str(k): v for k, v in stats["reports"].items()},
           "counts": {k: stats[k] for k in ("quarantined", "retried", "rejected",
                                           "timeouts")},
           "preemptions": stats["preemptions"],
           "snapshot_drops": stats.get("snapshot_drops", 0)}
    if inj is not None:
        out["events"] = json.loads(json.dumps(inj.events))
        out["fired"] = inj.fired
    return out


def reference_fault_runs() -> dict:
    """Every case of :func:`_cases` through the reference's serve_requests
    (run in a process of its own by :func:`_reference_process`)."""
    from repro.configs import get_arch as jget_arch
    from repro.core.qlinear import QuantConfig as JQC
    from repro.models import lm as JL
    from repro.models.common import ModelCtx as JCtx
    from repro.runtime import guard as JG
    from repro.runtime import serve_loop as JS

    class mod:                                   # the reference's config types
        ServeConfig, GuardConfig = JS.ServeConfig, JG.GuardConfig

    jcfg = jget_arch("qwen1.5-0.5b").reduced()
    packed = jax.jit(lambda key: JS.prepare_params_for_serving(
        JL.init_params(jcfg, key), jcfg, JQC(fmt="hif4", impl="packed")))(
            jax.random.PRNGKey(0))
    reqs, pre = _prompt_arrays()
    out = {}
    for name, geom, impl, guard_kw, spec in _cases():
        kv = "bf16" if geom == "slots" else "hif4"
        ctx = JCtx(quant=JQC(fmt="hif4", impl=impl, kv=JK.KVCacheConfig(kv)),
                   remat=False, attn_q_chunk=2, attn_k_chunk=2)
        inj = JF.FaultInjector(JF.FaultSpec(**spec)) if spec else None
        stats: dict = {}
        res = JS.serve_requests(
            jcfg, packed, [jnp.asarray(r) for r in (pre if geom == "preempt"
                                                    else reqs)],
            ctx, _serve_cfg(mod, geom, guard_kw),
            slots=2 if geom != "paged" else 3, stats=stats, injector=inj)
        out[name] = _summary(res, stats, inj)
    return out


_REF: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _reference_process():
    """Start the reference's runs in a process of their own as the module
    begins, so they overlap the port's; :func:`_ref` collects them."""
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            (os.path.join(REPO, "src"), os.path.join(REPO, "tests"))))
    _REF["proc"] = subprocess.Popen(
        [sys.executable, "-c", "import json, test_torch_faults as t; "
         "print(json.dumps(t.reference_fault_runs()))"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield
    if _REF["proc"].poll() is None:
        _REF["proc"].kill()
        _REF["proc"].communicate()
    _REF.clear()


def _ref() -> dict:
    if "out" not in _REF:
        out, err = _REF["proc"].communicate(timeout=600)
        assert _REF["proc"].returncode == 0, err[-4000:]
        _REF["out"] = json.loads(out.strip().splitlines()[-1])
    return _REF["out"]


@pytest.fixture(scope="module")
def params():
    from repro.models import lm as JL
    from repro.configs import get_arch as jget_arch

    raw = jax.tree_util.tree_map(np.asarray, JL.init_params(
        jget_arch("qwen1.5-0.5b").reduced(), jax.random.PRNGKey(0)))
    return prepare_params_for_serving(interop.params_from_jax(raw, "cpu"), CFG,
                                      QuantConfig(fmt="hif4", impl="packed"),
                                      device="cpu")


class _port:
    ServeConfig, GuardConfig = ServeConfig, GuardConfig


def _ctx(impl="packed", kv="hif4", **kw):
    return ModelCtx(quant=QuantConfig(fmt="hif4", impl=impl,
                                      kv=kvcache.KVCacheConfig(kv)),
                    attn_q_chunk=2, attn_k_chunk=2, **kw)


def _run(params, name):
    geom, impl, guard_kw, spec = next(c[1:] for c in _cases() if c[0] == name)
    reqs, pre = _prompt_arrays()
    prompts = [torch.tensor(r) for r in (pre if geom == "preempt" else reqs)]
    inj = FaultInjector(FaultSpec(**spec)) if spec else None
    stats: dict = {}
    res = serve_requests(CFG, params, prompts, _ctx(impl, "bf16" if geom == "slots"
                                                    else "hif4"),
                         _serve_cfg(_port, geom, guard_kw),
                         slots=2 if geom != "paged" else 3, stats=stats,
                         device="cpu", injector=inj)
    return res, stats, inj, prompts


def _assert_contained(res, stats, inj, baseline, victim):
    """The fault fired, the victim never silently produced wrong tokens, and
    every survivor is bitwise the uninjected run."""
    assert inj.fired, inj.events
    rep = stats["reports"][victim]
    assert rep["status"] in ("retried", "quarantined") and rep["detail"], rep
    for i in range(len(baseline)):
        if i != victim:
            assert stats["reports"][i]["status"] == "ok"
            assert torch.equal(res[i], baseline[i]), i
    if rep["status"] == "retried":
        # the fallback retry re-serves solo; greedy decode is deterministic
        assert torch.equal(res[victim], baseline[victim])
    return rep


def _assert_as_reference(name, res, stats, inj):
    assert _summary(res, stats, inj) == _ref()[name], name


def test_guarded_baseline_equals_unguarded_and_reference(params):
    base = _run(params, "paged_base")
    guarded = _run(params, "paged_guarded")
    for a, b in zip(base[0], guarded[0]):
        assert torch.equal(a, b)
    assert all(r["status"] == "ok" for r in guarded[1]["reports"].values())
    assert guarded[1]["pool_audit"]["live"] == 0
    _assert_as_reference("paged_base", *base[:3])
    _assert_as_reference("paged_guarded", *guarded[:3])


@pytest.mark.parametrize("kind,seed", PAGE_CASES)
def test_page_fault_detected_and_contained(params, kind, seed):
    baseline = _run(params, "paged_guarded")[0]
    res, stats, inj, _ = _run(params, f"{kind}_{seed}")
    rep = _assert_contained(res, stats, inj, baseline, victim=1)
    detector = rep["detail"].split(":")[0]
    assert detector in ("page_checksum", "meta_nan", "nan_logits"), rep
    if kind == "code_flip":
        # values perturb silently (finite): ONLY the checksum can see it
        assert detector == "page_checksum", rep
    _assert_as_reference(f"{kind}_{seed}", res, stats, inj)


def test_same_spec_same_fault_same_bits(params):
    runs = [_run(params, "meta_flip_3") for _ in range(2)]
    assert runs[0][2].events == runs[1][2].events
    assert runs[0][1]["reports"] == runs[1][1]["reports"]
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)


def test_nan_activation_detected_and_contained(params):
    base = _run(params, "slots_base")
    res, stats, inj, _ = _run(params, "nan_activation")
    rep = _assert_contained(res, stats, inj, base[0], victim=0)
    assert rep["detail"].startswith("nan_logits"), rep
    _assert_as_reference("slots_base", *base[:3])
    _assert_as_reference("nan_activation", res, stats, inj)


def test_nan_activation_without_retry_quarantines(params):
    res, stats, inj, _ = _run(params, "nan_no_retry")
    assert stats["reports"][0]["status"] == "quarantined"
    assert stats["quarantined"] == 1
    assert res[0].tolist() == [-1] * BUDGET      # the fill, never garbage
    _assert_as_reference("nan_no_retry", res, stats, inj)


def test_pool_starvation_guarded_rejects(params):
    res, stats, inj, _ = _run(params, "pool_starvation")
    assert inj.fired and stats["rejected"] == 3
    for i in range(3):
        rep = stats["reports"][i]
        assert rep["status"] == "rejected"
        assert rep["retries"] == GuardConfig().max_admission_retries
        assert res[i].shape == (BUDGET,)
    _assert_as_reference("pool_starvation", res, stats, inj)


def test_pool_starvation_unguarded_raises_typed(params):
    reqs, _ = _prompt_arrays()
    inj = FaultInjector(FaultSpec(kind="pool_starvation"))
    with pytest.raises(PoolExhaustedError):
        serve_requests(CFG, params, [torch.tensor(r) for r in reqs], _ctx(),
                       _serve_cfg(_port, "paged", None), slots=3, device="cpu",
                       injector=inj)


@pytest.mark.parametrize("bits", [0, 1])   # 0 = truncate, 1 = bit flip
def test_snapshot_corruption_requeues_bitwise(params, bits):
    """The victim's host snapshot is corrupted after its fingerprint was
    stamped: re-admission drops it and re-serves from the prompt, still
    bitwise equal to solo serving at attn_kv_block = P."""
    res, stats, inj, prompts = _run(params, f"snapshot_{bits}")
    assert stats["preemptions"] >= 1 and inj.fired and stats["snapshot_drops"] >= 1
    rep = stats["reports"][1]
    assert rep["status"] == "retried"
    assert rep["detail"].startswith("snapshot_integrity"), rep
    for i, r in enumerate(prompts):
        solo = serve(CFG, params, {"tokens": r[None].long()}, _ctx(attn_kv_block=4),
                     ServeConfig(max_new_tokens=8, cache_capacity=16,
                                 kv_format="hif4"), device="cpu")[0]
        assert torch.equal(res[i], solo), i
    _assert_as_reference(f"snapshot_{bits}", res, stats, inj)


# ---------------------------------------------------------------------------
# The injector's hooks against the reference's, on identical state
# ---------------------------------------------------------------------------


def _pools(seed=0, L=2, NP=6, rows=64, G=2, T=16, Pp=8):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (L, NP, rows, Pp), dtype=np.uint8)
    meta = rng.integers(0, 1 << 32, (L, NP, G, Pp), dtype=np.uint32)
    tail = rng.integers(0, 1 << 16, (L, NP, T, Pp), dtype=np.uint16)
    j = {"codes": jnp.asarray(codes), "meta": jnp.asarray(meta),
         "tail": jnp.asarray(tail.view(jnp.bfloat16))}
    t = {"codes": torch.from_numpy(codes.copy()),
         "meta": torch.from_numpy(meta.view(np.int32).copy()),
         "tail": torch.from_numpy(tail.view(np.int16).copy()).view(torch.bfloat16)}
    return {"k": j, "v": dict(j)}, {"k": t, "v": {k: a.clone() for k, a in t.items()}}


def _bookkeeping(pool_cls):
    pool = pool_cls(6, 8)
    pages = [[pool.alloc(owner=0), pool.alloc(owner=0)],
             [pool.alloc(owner=1), pool.alloc(owner=1), pool.alloc(owner=1)]]
    pool.owner[pages[1][0]] = 0                  # a shared page, not owned
    return pool, [0, 1], pages


def _same_pool(jkv, tkv):
    for name in ("k", "v"):
        for key in ("codes", "meta", "tail"):
            want = np.asarray(jkv[name][key])
            got = interop.to_numpy(tkv[name][key], uint32=key == "meta")
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=key)


@pytest.mark.parametrize("kind,seed,bits", [("code_flip", 0, 16),
                                            ("meta_flip", 3, 16),
                                            ("meta_flip", 11, 16),
                                            ("page_corruption", 1, 16),
                                            ("page_corruption", 5, 3)])
def test_poison_pool_hits_the_references_bits(kind, seed, bits):
    jkv, tkv = _pools(seed)
    jpool, slot_req, jpages = _bookkeeping(JK.PagePool)
    tpool, _, tpages = _bookkeeping(kvcache.PagePool)
    spec = dict(kind=kind, seed=seed, target_request=1, after_chunk=1, bits=bits)
    jinj, tinj = JF.FaultInjector(JF.FaultSpec(**spec)), FaultInjector(FaultSpec(**spec))
    for chunk in (0, 1, 2):                      # fires at after_chunk, once
        jkv = jinj.poison_pool(jkv, jpool, slot_req, jpages, chunk)
        tkv = tinj.poison_pool(tkv, tpool, slot_req, tpages, chunk)
    assert tinj.fired and tinj.events == jinj.events
    assert tinj.events[0][1]["page"] == tpages[1][1]         # the first OWNED
    _same_pool(jkv, tkv)


def test_meta_flip_of_bit_31_matches_the_reference():
    seed = next(s for s in range(200) if _meta_bit(s) == 31)
    jkv, tkv = _pools(seed)
    jpool, slot_req, jpages = _bookkeeping(JK.PagePool)
    tpool, _, tpages = _bookkeeping(kvcache.PagePool)
    spec = dict(kind="meta_flip", seed=seed, target_request=0)
    jinj, tinj = JF.FaultInjector(JF.FaultSpec(**spec)), FaultInjector(FaultSpec(**spec))
    jkv = jinj.poison_pool(jkv, jpool, slot_req, jpages, 0)
    tinj.poison_pool(tkv, tpool, slot_req, tpages, 0)
    assert tinj.events == jinj.events and tinj.events[0][1]["bit"] == 31
    _same_pool(jkv, tkv)


def _meta_bit(seed, rows=2):
    rng = np.random.default_rng(seed)
    rng.integers(rows)
    return int(rng.integers(32))


@pytest.mark.parametrize("bits", [0, 1])
def test_poison_snapshot_matches_reference(bits):
    jkv, tkv = _pools(3)
    jsnap = {n: {k: np.asarray(a) for k, a in t.items()} for n, t in jkv.items()}
    tsnap = {n: dict(t) for n, t in tkv.items()}
    spec = dict(kind="snapshot_truncation", seed=4, target_request=2, bits=bits)
    jinj, tinj = JF.FaultInjector(JF.FaultSpec(**spec)), FaultInjector(FaultSpec(**spec))
    assert tinj.poison_snapshot(tsnap, 1) is tsnap and not tinj.fired
    jout, tout = jinj.poison_snapshot(jsnap, 2), tinj.poison_snapshot(tsnap, 2)
    assert tinj.events == jinj.events
    _same_pool(jout, tout)
    assert torch.equal(tkv["k"]["codes"], tsnap["k"]["codes"])   # a copy


def test_poison_cache_and_steal_pages_match_reference():
    v = np.random.default_rng(0).standard_normal((2, 3, 5, 2, 4)).astype(np.float32)
    jkv = {"k": jnp.asarray(v).astype(jnp.bfloat16), "v": jnp.asarray(v).astype(
        jnp.bfloat16)}
    tkv = {"k": torch.from_numpy(v).to(torch.bfloat16),
           "v": torch.from_numpy(v).to(torch.bfloat16)}
    spec = dict(kind="nan_activation", target_request=7, after_chunk=1)
    jinj, tinj = JF.FaultInjector(JF.FaultSpec(**spec)), FaultInjector(FaultSpec(**spec))
    for chunk in (0, 1):
        jkv = jinj.poison_cache(jkv, [None, 7, 3], chunk)
        tkv = tinj.poison_cache(tkv, [None, 7, 3], chunk)
    assert tinj.events == jinj.events == [("nan_activation", {"slot": 1,
                                                               "idx": (0, 1, 0, 0, 0)})]
    np.testing.assert_array_equal(np.isnan(tkv["v"].float().numpy()),
                                  np.isnan(np.asarray(jkv["v"], np.float32)))
    for hold in (0, 3):
        jpool, tpool = JK.PagePool(6, 8), kvcache.PagePool(6, 8)
        spec = dict(kind="pool_starvation", hold_pages=hold)
        jinj, tinj = JF.FaultInjector(JF.FaultSpec(**spec)), FaultInjector(FaultSpec(**spec))
        jinj.steal_pages(jpool)
        tinj.steal_pages(tpool)
        assert tinj.events == jinj.events and tpool.free == jpool.free


def test_parse_fault_spec_matches_reference():
    assert FAULT_CLASSES == JF.FAULT_CLASSES
    for text in ("meta_flip:seed=3,target_request=1,after_chunk=2",
                 "pool_starvation", "snapshot_truncation:bits=0,target_request=1"):
        assert dataclasses.asdict(parse_fault(text)) == dataclasses.asdict(
            JF.parse_fault(text))
    assert parse_fault("pool_starvation") == FaultSpec("pool_starvation")
    with pytest.raises(ValueError, match="unknown fault kind"):
        parse_fault("bitrot:seed=1")


def test_launcher_guard_with_injected_fault():
    """The launcher's report lines are the reference launcher's for the same
    command (its weights and prompts differ; the fault is caught and the
    victim retried in both)."""
    args = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--new-tokens", "6",
            "--decode-chunk", "2", "--kv-format", "hif4", "--kv-pages", "12",
            "--kv-page-tokens", "8", "--guard", "--inject-fault",
            "page_corruption:seed=1,target_request=1,after_chunk=1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert ("guarded serving: {'quarantined': 0, 'retried': 1, 'rejected': 0, "
            "'timeouts': 0}") in lines
    assert "request 0: status=ok" in lines
    assert ("request 1: status=retried (meta_nan: page 2 carries 1 E6M2 NaN "
            "sentinel(s); re-served solo on the qdq/bf16 fallback path)") in lines
    assert any(ln.startswith("injected fault: page_corruption {'page': 2, "
                             "'flips': [((0, 2, 30, 4), 6)") for ln in lines)
