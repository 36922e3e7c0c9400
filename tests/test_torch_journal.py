"""The write-ahead journal and crash recovery of the PyTorch port vs the JAX
reference (mirrors ``tests/test_journal.py`` and
``tests/test_crash_recovery.py``).

Against the reference, on the CPU:

* ``encode_record`` bytes, ``prompt_sha256``, ``replay`` and the torn-tail
  framing equal the reference's; pool checkpoints (``.npz``, meta as
  uint32, bf16 tails as uint16 bits) load across packages bitwise;
* a journaled serve's ``serve.journal`` is byte-equal to the reference's
  for the same requests (paged and slot schedulers, no checkpoints: a
  checkpoint record carries the ``.npz``'s sha256, and numpy stamps the
  write time into the zip);
* a journal (with a pool checkpoint) written by the reference resumes in
  the port, and one written by the port resumes in the reference, both
  bitwise the uninterrupted run. The reference runs in a process of its own
  with XLA's excess precision off.

Within the port: each of the four crash classes, killed and resumed,
recovers bitwise on the paged scheduler, and ``crash_mid_decode`` on the
slot scheduler; the launcher's crash-then-``--resume`` pair prints the
recovery report and the uninterrupted tokens.
"""
import glob
import json
import os
import shutil
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as JK
from repro.runtime import journal as JJ
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import kvcache
from repro_torch.core.qlinear import QuantConfig
from repro_torch.models.common import ModelCtx
from repro_torch.runtime import journal as J
from repro_torch.runtime.faults import (CRASH_CLASSES, FaultInjector, FaultSpec,
                                        SimulatedCrash)
from repro_torch.runtime.guard import GuardConfig, JournalError, RecoveryError
from repro_torch.runtime.serve_loop import (ServeConfig, prepare_params_for_serving,
                                            serve_requests)

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_arch("qwen1.5-0.5b").reduced()
P, BUDGET, CAP = 8, 6, 32


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------


def _events(n=5):
    evs = [{"ev": "start", "v": J.JOURNAL_VERSION, "n_requests": 2, "budget": 8,
            "eos": None, "prompts": ["a" * 64, "b" * 64]}]
    for i in range(n):
        evs.append({"ev": "chunk", "idx": i, "emitted": {10: [i, i + 1], 2: [7 * i]}})
    evs.append({"ev": "checkpoint", "chunk": 3, "file": "ckpt_00000003.npz",
                "sha256": "0" * 64, "residents": {11: {"token": 5, "toks": [5]},
                                                  3: {"token": 1, "toks": []}}})
    evs.append({"ev": "done", "rid": 0, "status": "retried", "detail": "x; y",
                "retries": 1, "toks": [1, 2, 3]})
    return evs


def test_encode_record_bytes_equal_reference():
    """Integer keys sort as integers (10 after 2), as in the reference."""
    for e in _events():
        assert J.encode_record(e) == JJ.encode_record(e)
    assert J.MAGIC == JJ.MAGIC and J.JOURNAL_VERSION == JJ.JOURNAL_VERSION
    assert J.EVENT_KINDS == JJ.EVENT_KINDS


def test_codec_round_trip_and_first_bad_frame():
    evs = json.loads(json.dumps(_events(3)))          # keys as the reader sees
    blob = b"".join(J.encode_record(e) for e in evs)
    assert J.decode_records(blob) == (evs, 0) == JJ.decode_records(blob)
    cut = len(J.encode_record(evs[0]) + J.encode_record(evs[1]))
    bad = bytearray(blob)
    bad[cut + len(J.MAGIC) + 8 + 2] ^= 0xFF
    out, dropped = J.decode_records(bytes(bad))
    assert out == evs[:2] and dropped == len(blob) - cut
    payload = json.dumps({"ev": "gremlin"}).encode()
    frame = (J.MAGIC + len(payload).to_bytes(4, "little")
             + zlib.crc32(payload).to_bytes(4, "little") + payload)
    assert J.decode_records(frame) == ([], len(frame))


def test_every_truncation_point_yields_the_references_prefix():
    blob = b"".join(J.encode_record(e) for e in _events(4))
    for cut in range(len(blob) + 1):
        assert J.decode_records(blob[:cut]) == JJ.decode_records(blob[:cut])


def test_prompt_sha256_matches_reference():
    toks = [3, 1, 4, 1, 5, 511]
    want = JJ.prompt_sha256(jnp.asarray(toks, jnp.int32))
    for form in (toks, np.asarray(toks, np.int64), torch.tensor(toks),
                 torch.tensor([toks], dtype=torch.int32)):
        assert J.prompt_sha256(form) == want
    assert J.prompt_sha256([3, 1, 4, 1, 5, 510]) != want


def _write(directory, evs):
    j = J.RequestJournal(str(directory))
    for e in evs:
        j.append(e["ev"], **{k: v for k, v in e.items() if k != "ev"})
    j.activate()
    j.close()
    return j


def test_journal_staging_torn_tail_and_typed_errors(tmp_path):
    j = J.RequestJournal(str(tmp_path / "a"))
    j.append("start", v=J.JOURNAL_VERSION, n_requests=0, budget=1, eos=None,
             prompts=[])
    j.commit()
    with pytest.raises(JournalError, match="nothing to resume"):
        J.read_journal(str(tmp_path / "a"))            # still staged
    j.activate()
    assert J.read_journal(str(tmp_path / "a"))[0][0]["ev"] == "start"
    j.close()
    evs = json.loads(json.dumps(_events(3)))
    jw = _write(tmp_path / "b", evs)
    with open(jw.path, "r+b") as f:
        f.truncate(os.path.getsize(jw.path) - 5)
    got = J.read_journal(str(tmp_path / "b"))
    assert got == JJ.read_journal(str(tmp_path / "b"))
    assert got[0] == evs[:-1] and got[1] == len(J.encode_record(evs[-1])) - 5
    # truncate_tail is a real truncation
    jt = J.RequestJournal(str(tmp_path / "c"))
    for e in evs:
        jt.append(e["ev"], **{k: v for k, v in e.items() if k != "ev"})
    jt.activate()
    jt.truncate_tail(9)
    jt.close()
    full = b"".join(J.encode_record(e) for e in evs)
    assert open(jt.path, "rb").read() == full[:-9]
    os.makedirs(tmp_path / "d")
    with open(os.path.join(str(tmp_path / "d"), J.JOURNAL_NAME), "wb") as f:
        f.write(J.encode_record({"ev": "done", "rid": 0, "status": "ok",
                                 "toks": []}))
    with pytest.raises(JournalError, match="start record"):
        J.read_journal(str(tmp_path / "d"))


# ---------------------------------------------------------------------------
# Pool checkpoints, across packages
# ---------------------------------------------------------------------------


def _pages(rng, t=16):
    """One resident's page blocks in the port's form and the reference's."""
    tp, jp = {}, {}
    for name in ("k", "v"):
        codes = rng.integers(0, 256, (2, 3, 64, 8), dtype=np.uint8)
        meta = rng.integers(0, 1 << 32, (2, 3, 2, 8), dtype=np.uint32)
        tail = rng.integers(0, 1 << 16, (2, 3, t, 8), dtype=np.uint16)
        tp[name] = {"codes": torch.from_numpy(codes.copy()),
                    "meta": torch.from_numpy(meta.view(np.int32).copy()),
                    "tail": torch.from_numpy(tail.view(np.int16).copy()
                                             ).view(torch.bfloat16)}
        jp[name] = {"codes": codes, "meta": meta, "tail": tail.view(jnp.bfloat16)}
    return tp, jp


def _same_pages(tpages, jpages):
    for name in ("k", "v"):
        for key in ("codes", "meta", "tail"):
            want = np.ascontiguousarray(np.asarray(jpages[name][key])).view(np.uint8)
            t = tpages[name][key]
            got = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
            np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                          want, err_msg=key)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_pool_checkpoint_loads_across_packages(tmp_path, writer):
    rng = np.random.default_rng(0)
    both = {0: _pages(rng), 3: _pages(rng, t=0)}
    mod = J if writer == "port" else JJ
    residents = {rid: {"pages": p[0 if writer == "port" else 1], "token": 17,
                       "toks": [4, 5, 6]} for rid, p in both.items()}
    fname, digest = mod.save_pool_checkpoint(str(tmp_path), 7, residents)
    assert fname == "ckpt_00000007.npz"
    rec = {"file": fname, "sha256": digest,
           "residents": {str(r): {"token": 17, "toks": [4, 5, 6]} for r in both}}
    tout = J.load_pool_checkpoint(str(tmp_path), rec)
    jout = JJ.load_pool_checkpoint(str(tmp_path), rec)
    assert set(tout) == set(jout) == {0, 3}
    for rid, (tp, jp) in both.items():
        _same_pages(tout[rid], jp)
        _same_pages(tp, jout[rid])
        assert tout[rid]["k"]["meta"].dtype == torch.int32
        assert J.snapshot_fingerprint(tout[rid]) == JJ.snapshot_fingerprint(jout[rid])
    with np.load(os.path.join(str(tmp_path), fname)) as z:
        assert z["r0_k_meta"].dtype == np.uint32 and z["r0_k_tail"].dtype == np.uint16
    # bit rot, a missing file or a missing resident degrade to None
    path = os.path.join(str(tmp_path), fname)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 1
    open(path, "wb").write(bytes(data))
    assert J.load_pool_checkpoint(str(tmp_path), rec) is None
    os.remove(path)
    assert J.load_pool_checkpoint(str(tmp_path), rec) is None


# ---------------------------------------------------------------------------
# Replay + recover validation
# ---------------------------------------------------------------------------


def test_replay_and_expected_prefix_match_reference():
    evs = [{"ev": "start", "v": 1, "n_requests": 2, "budget": 4, "eos": 9,
            "prompts": ["x", "y"]},
           {"ev": "admitted", "rid": 0, "src": "prefill", "toks": [10]},
           {"ev": "admitted", "rid": 1, "src": "prefill", "toks": [20]},
           {"ev": "chunk", "idx": 0, "emitted": {"0": [11, 9], "1": [21, 22]}},
           {"ev": "checkpoint", "chunk": 1, "file": "f", "sha256": "s",
            "residents": {}},
           {"ev": "preempted", "rid": 1},
           {"ev": "admitted", "rid": 1, "src": "prefill", "toks": [20, 21]},
           {"ev": "done", "rid": 0, "status": "ok", "toks": [10, 11, 9, 9]}]
    for k in range(1, len(evs) + 1):
        assert J.replay(evs[:k]) == JJ.replay(evs[:k])
    plan, jplan = J.RecoveryPlan(meta=evs[0]), JJ.RecoveryPlan(meta=evs[0])
    plan.emitted = jplan.emitted = J.replay(evs)[0]
    for rid in (0, 1, 7):
        assert plan.expected_prefix(rid) == jplan.expected_prefix(rid)
    assert plan.expected_prefix(0) == [10, 11, 9]


def test_recover_validates_like_the_reference(tmp_path):
    prompts = [[1, 2, 3], [4, 5, 6]]
    j = J.RequestJournal(str(tmp_path))
    j.append("start", v=J.JOURNAL_VERSION, kind="paged", n_requests=2, budget=8,
             eos=None, chunk=2, prompts=[J.prompt_sha256(p) for p in prompts],
             kv_pages=4, page_tokens=4)
    j.activate()
    j.append("admitted", rid=0, src="prefill", toks=[7])
    j.append("done", rid=1, status="ok", detail=None, retries=0, toks=[8, 9])
    j.close()
    for mod in (J, JJ):
        with pytest.raises(RecoveryError if mod is J else JJ.RecoveryError,
                           match="covers 2 requests"):
            mod.recover(str(tmp_path), prompts[:1], budget=8, eos=None)
        with pytest.raises(Exception, match=r"id\(s\) \[1\]"):
            mod.recover(str(tmp_path), [prompts[0], [4, 5, 7]], budget=8, eos=None)
        with pytest.raises(Exception, match="budget=3"):
            mod.recover(str(tmp_path), prompts, budget=3, eos=None)
    plan = J.recover(str(tmp_path), prompts, budget=8, eos=None)
    jplan = JJ.recover(str(tmp_path), prompts, budget=8, eos=None)
    assert plan.completed == jplan.completed and plan.emitted == jplan.emitted
    assert {k: v for k, v in plan.report().items() if k != "recovery_ms"} == \
        {k: v for k, v in jplan.report().items() if k != "recovery_ms"}
    assert J.journal_residency(str(tmp_path)) == JJ.journal_residency(str(tmp_path))


def test_release_without_keep_cached_matches_reference():
    pools = [kvcache.PagePool(6, 4), JK.PagePool(6, 4)]
    for pool in pools:
        a, b = pool.alloc("r"), pool.alloc("r")
        pool.register_full(a, (1, 2, 3, 4))
        pool.register_full(b, (5, 6, 7, 8))
        pool.release(a)                        # parks in the LRU cache
        pool.release(b, keep_cached=False)     # the quarantine: hash goes too
    for attr in ("free", "ref", "owner", "full_hash", "key_of", "cached"):
        assert getattr(pools[0], attr) == getattr(pools[1], attr), attr
    assert pools[0].audit() == pools[1].audit()


# ---------------------------------------------------------------------------
# Serves: the port within itself, and across packages
# ---------------------------------------------------------------------------


def _prompt_arrays():
    """The reference crash tests' three requests sharing a 12-token prefix."""
    prefix = jax.random.randint(jax.random.PRNGKey(5), (12,), 0, 512)
    return [np.asarray(jnp.concatenate([prefix, jax.random.randint(
        jax.random.PRNGKey(30 + i), (4 + 2 * i,), 0, 512)]), np.int32)
        for i in range(3)]


def _serve_cfg(mod, kind, jdir=None, checkpoint_every=0):
    if kind == "paged":
        return mod.ServeConfig(max_new_tokens=BUDGET, decode_chunk=2,
                               cache_capacity=CAP, kv_format="hif4", kv_pages=12,
                               kv_page_tokens=P, guard=mod.GuardConfig(),
                               journal_dir=jdir, checkpoint_every=checkpoint_every)
    return mod.ServeConfig(max_new_tokens=BUDGET, decode_chunk=2, cache_capacity=CAP,
                           kv_format="hif4", guard=mod.GuardConfig(),
                           journal_dir=jdir)


def _slots(kind):
    return 3 if kind == "paged" else 2


def _journal_bytes(directory):
    with open(os.path.join(directory, J.JOURNAL_NAME), "rb") as f:
        return f.read()


def reference_journal_runs(work: str, port_crash_dir: str) -> dict:
    """The reference's side (run in a process of its own): journaled serves
    of both schedulers into ``work/ref-<kind>`` (their journal bytes), a
    crash mid-decode with a checkpoint every chunk into ``work/ref-crash``
    (for the port to resume), and the resume of the port's crashed journal
    in ``port_crash_dir``."""
    from repro.configs import get_arch as jget_arch
    from repro.core.qlinear import QuantConfig as JQC
    from repro.models import lm as JL
    from repro.models.common import ModelCtx as JCtx
    from repro.runtime import faults as JF
    from repro.runtime import guard as JG
    from repro.runtime import serve_loop as JS

    class mod:
        ServeConfig, GuardConfig = JS.ServeConfig, JG.GuardConfig

    jcfg = jget_arch("qwen1.5-0.5b").reduced()
    packed = jax.jit(lambda key: JS.prepare_params_for_serving(
        JL.init_params(jcfg, key), jcfg, JQC(fmt="hif4", impl="packed")))(
            jax.random.PRNGKey(0))
    ctx = JCtx(quant=JQC(fmt="hif4", impl="packed", kv=JK.KV_HIF4), remat=False,
               attn_q_chunk=2, attn_k_chunk=2)
    reqs = [jnp.asarray(r) for r in _prompt_arrays()]
    out = {}
    for kind in ("paged", "slots"):
        d = os.path.join(work, f"ref-{kind}")
        res = JS.serve_requests(jcfg, packed, reqs, ctx, _serve_cfg(mod, kind, d),
                                slots=_slots(kind))
        out[kind] = [np.asarray(r).tolist() for r in res]
    crash = os.path.join(work, "ref-crash")
    inj = JF.FaultInjector(JF.FaultSpec(kind="crash_mid_decode", after_chunk=1))
    try:
        JS.serve_requests(jcfg, packed, reqs, ctx,
                          _serve_cfg(mod, "paged", crash, 1), slots=3, injector=inj)
    except JF.SimulatedCrash:
        out["crashed"] = True
    stats: dict = {}
    res = JS.serve_requests(jcfg, packed, reqs, ctx,
                            _serve_cfg(mod, "paged", port_crash_dir, 1), slots=3,
                            stats=stats, resume=True)
    out["resumed_port"] = {"toks": [np.asarray(r).tolist() for r in res],
                           "recovery": {k: v for k, v in stats["recovery"].items()
                                        if k != "recovery_ms"},
                           "statuses": [r["status"] for r in
                                        stats["reports"].values()]}
    return out


@pytest.fixture(scope="module")
def params():
    from repro.configs import get_arch as jget_arch
    from repro.models import lm as JL

    raw = jax.tree_util.tree_map(np.asarray, JL.init_params(
        jget_arch("qwen1.5-0.5b").reduced(), jax.random.PRNGKey(0)))
    return prepare_params_for_serving(interop.params_from_jax(raw, "cpu"), CFG,
                                      QuantConfig(fmt="hif4", impl="packed"),
                                      device="cpu")


CTX = ModelCtx(quant=QuantConfig(fmt="hif4", impl="packed", kv=kvcache.KV_HIF4),
               attn_q_chunk=2, attn_k_chunk=2)


class _port:
    ServeConfig, GuardConfig = ServeConfig, GuardConfig


def _reqs():
    return [torch.tensor(r) for r in _prompt_arrays()]


def _serve(params, kind, jdir=None, checkpoint_every=0, **kw):
    return serve_requests(CFG, params, _reqs(), CTX,
                          _serve_cfg(_port, kind, jdir, checkpoint_every),
                          slots=_slots(kind), device="cpu", **kw)


@pytest.fixture(scope="module")
def cross(params, tmp_path_factory):
    """The port crashes a journaled serve (a checkpoint every chunk), then
    the reference's process runs :func:`reference_journal_runs`; both
    crashed directories are copied before anyone resumes them."""
    work = str(tmp_path_factory.mktemp("journals"))
    port_crash = os.path.join(work, "port-crash")
    inj = FaultInjector(FaultSpec(kind="crash_mid_decode", after_chunk=1))
    with pytest.raises(SimulatedCrash):
        _serve(params, "paged", port_crash, 1, injector=inj)
    shutil.copytree(port_crash, port_crash + "-pristine")
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            (os.path.join(REPO, "src"), os.path.join(REPO, "tests"))))
    run = subprocess.run(
        [sys.executable, "-c", "import json, sys, test_torch_journal as t; "
         "print(json.dumps(t.reference_journal_runs(sys.argv[1], sys.argv[2])))",
         work, port_crash], env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    shutil.copytree(os.path.join(work, "ref-crash"),
                    os.path.join(work, "ref-crash-pristine"))
    return dict(out, work=work)


@pytest.mark.parametrize("kind", ["paged", "slots"])
def test_journal_bytes_equal_reference(params, cross, tmp_path, kind):
    res = _serve(params, kind, str(tmp_path))
    assert [r.tolist() for r in res] == cross[kind]
    want = _journal_bytes(os.path.join(cross["work"], f"ref-{kind}"))
    got = _journal_bytes(str(tmp_path))
    assert got == want
    evs, dropped = J.read_journal(str(tmp_path))
    assert dropped == 0 and evs[0]["kind"] == kind
    assert [e["ev"] for e in evs].count("done") == 3


def test_checkpoints_of_both_packages_hold_the_same_pages(cross):
    """The crashed journals' last checkpoints: the same record (but for the
    .npz's sha256) and the same page bytes."""
    recs = []
    for name in ("port-crash-pristine", "ref-crash-pristine"):
        d = os.path.join(cross["work"], name)
        evs, _ = J.read_journal(d)
        ck = [e for e in evs if e["ev"] == "checkpoint"][-1]
        recs.append((d, ck))
        assert [e["ev"] for e in evs] == [e["ev"] for e in JJ.read_journal(d)[0]]
    (dp, cp), (dr, cr) = recs
    assert {k: v for k, v in cp.items() if k != "sha256"} == \
        {k: v for k, v in cr.items() if k != "sha256"}
    tpages = J.load_pool_checkpoint(dp, cp)
    jpages = JJ.load_pool_checkpoint(dr, cr)
    assert set(tpages) == set(jpages) and tpages
    for rid in tpages:
        _same_pages(tpages[rid], jpages[rid])


def test_reference_journal_resumes_in_the_port(params, cross):
    assert cross["crashed"]
    stats: dict = {}
    res = _serve(params, "paged", os.path.join(cross["work"], "ref-crash"), 1,
                 stats=stats, resume=True)
    assert [r.tolist() for r in res] == cross["paged"]
    rec = stats["recovery"]
    assert rec["replayed"] >= 1 and rec["verified"] >= 1, rec
    assert all(r["status"] == "ok" for r in stats["reports"].values())


def test_port_journal_resumes_in_the_reference(params, cross):
    got = cross["resumed_port"]
    assert got["toks"] == cross["paged"]
    assert got["recovery"]["replayed"] >= 1 and got["recovery"]["verified"] >= 1
    assert got["statuses"] == ["ok"] * 3


# ---------------------------------------------------------------------------
# Kill and recover within the port, every crash class
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def baseline(params):
    return _serve(params, "paged")


def _assert_bitwise(res, baseline):
    for i, (a, b) in enumerate(zip(res, baseline)):
        assert torch.equal(a, b), i


def _crash_then_resume(params, jdir, spec, checkpoint_every=2):
    inj = FaultInjector(spec)
    with pytest.raises(SimulatedCrash):
        _serve(params, "paged", jdir, checkpoint_every, injector=inj)
    assert inj.fired, "crash point never reached"
    stats: dict = {}
    res = _serve(params, "paged", jdir, checkpoint_every, stats=stats, resume=True)
    assert all(r["status"] == "ok" for r in stats["reports"].values())
    assert stats["pool_audit"]["live"] == 0
    return res, stats["recovery"]


def test_journaled_serve_matches_unjournaled(params, baseline, tmp_path):
    stats: dict = {}
    res = _serve(params, "paged", str(tmp_path), 2, stats=stats)
    _assert_bitwise(res, baseline)
    assert glob.glob(str(tmp_path / "ckpt_*.npz"))
    assert stats["pool_audit"]["live"] == 0
    # a resume of the finished serve re-serves nothing
    stats = {}
    res = _serve(params, "paged", str(tmp_path), 2, stats=stats, resume=True)
    _assert_bitwise(res, baseline)
    rec = stats["recovery"]
    assert rec["completed"] == 3 and rec["replayed"] == rec["re_prefilled"] == 0
    assert rec["verified"] == 0


def test_resume_without_journal_raises_typed(params, tmp_path):
    with pytest.raises(JournalError, match="nothing to resume"):
        _serve(params, "paged", str(tmp_path), resume=True)
    with pytest.raises(RecoveryError, match="journal_dir"):
        _serve(params, "paged", None, resume=True)


@pytest.mark.parametrize("kind", CRASH_CLASSES)
def test_crash_class_killed_and_recovered_bitwise(params, baseline, tmp_path, kind):
    res, rec = _crash_then_resume(params, str(tmp_path),
                                  FaultSpec(kind=kind, target_request=1,
                                            after_chunk=1, bits=20))
    _assert_bitwise(res, baseline)
    assert rec["verified"] >= 1, rec
    if kind == "crash_after_admit":
        assert rec["replayed"] == 0 and rec["re_prefilled"] >= 1
    elif kind == "crash_mid_decode":
        assert rec["replayed"] >= 1                   # from the checkpoint
    elif kind == "crash_during_checkpoint":
        assert glob.glob(str(tmp_path / "ckpt_*.npz"))  # the orphan, ignored
        assert rec["replayed"] == 0 and rec["re_prefilled"] >= 1
    else:
        assert rec["dropped_bytes"] > 0


def test_slot_scheduler_crash_and_resume_bitwise(params, tmp_path):
    base = _serve(params, "slots")
    inj = FaultInjector(FaultSpec(kind="crash_mid_decode", after_chunk=1))
    with pytest.raises(SimulatedCrash):
        _serve(params, "slots", str(tmp_path), injector=inj)
    stats: dict = {}
    res = _serve(params, "slots", str(tmp_path), stats=stats, resume=True)
    _assert_bitwise(res, base)
    rec = stats["recovery"]
    assert rec["verified"] >= 1 and rec["replayed"] == 0


def test_launcher_crash_then_resume(tmp_path):
    args = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--batch",
            "2", "--prompt-len", "8", "--new-tokens", "6", "--decode-chunk", "2",
            "--kv-format", "hif4", "--kv-pages", "12", "--kv-page-tokens", "8"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

    def launch(*extra):
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                              *args, *extra], capture_output=True, text=True,
                             env=env, cwd=REPO, timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout

    def tokens(text):
        return [ln for ln in text.splitlines() if ln.startswith("request ")
                and ": [" in ln]

    jdir = str(tmp_path / "j")
    plain = launch()
    crashed = launch("--journal-dir", jdir, "--checkpoint-every", "1",
                     "--inject-fault", "crash_mid_decode:after_chunk=1")
    assert "simulated crash:" in crashed and "resume with: --journal-dir" in crashed
    assert not tokens(crashed)
    resumed = launch("--journal-dir", jdir, "--checkpoint-every", "1", "--resume")
    line = next(ln for ln in resumed.splitlines() if ln.startswith("recovery report:"))
    assert "2 residents restored from checkpoint" in line
    assert "2 replay prefixes verified bitwise" in line
    assert f"journal residency [{jdir}]:" in resumed
    assert tokens(resumed) == tokens(plain) and len(tokens(plain)) == 2
