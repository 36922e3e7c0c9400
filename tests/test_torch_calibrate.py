"""Calibration of the port (``repro_torch.calibrate``, ``repro_torch.core.tap``)
held against a live run of the reference (``repro.calibrate``).

* One shared reference run: ``repro.calibrate.calibrate("qwen1.5-0.5b",
  reduced=True, target_bpv="sensitive-fallback", seed=0)``. The port runs on
  the same weights (the reference's init through ``repro_torch.interop``)
  and the same calibration batches (the reference's ``prefill_batch``
  through numpy). The site rows (path, shape, values, packable, in budget,
  captured), the bytes, the assignment, the baselines' bytes and the
  report's keys must be equal; the per-format errors within rtol 2e-2 (the
  bf16 forward's matmuls sum in another order than XLA's).
* The search: the reference's hypothesis properties, ported as they are,
  and the port's search equal to the reference's on the same random tables;
  at 0.7 B/value each package's search on its own score table.
* Policy files: one emitted by either package loads in the other's
  ``get_policy`` and resolves to the same packed paths.
* The tap on the other families (granite: moe, mamba2: ssm, whisper-tiny:
  audio) at reduced width, 1 batch of (1, 64), against the reference's own
  forward under its tap (scoring skipped): the same captured paths, records
  per path and rows, the rows float-close. granite's experts and router are
  in budget but not captured (their plan's contraction width is not the
  activation's, so the reference's stale-mark guard drops them); the port
  drops them too.
* The launcher: ``python -m repro_torch calibrate ... --device cpu`` writes a
  policy and a report the reference loads, and exits 2 on an infeasible
  target.
"""
import json

import jax
import numpy as np
import pytest
import torch

try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:          # the property tests skip; the rest still run
    hypothesis = st = None

from repro.calibrate import calibrate as ref_calibrate
from repro.calibrate import probe as ref_probe
from repro.calibrate import search as ref_search
from repro.configs import get_arch as ref_get_arch
from repro.core import tap as ref_tap
from repro.core.policy import get_policy as ref_get_policy
from repro.models import lm as ref_lm
from repro.models.common import ModelCtx as RefModelCtx
from repro.runtime.scenario import prefill_batch as ref_prefill_batch

from repro_torch import __main__ as front_door
from repro_torch import interop
from repro_torch.calibrate import calibrate, emit_policy, probe
from repro_torch.calibrate.search import (
    FormatOption,
    SiteScore,
    _hull,
    assignment_cost,
    frontier_search,
)
from repro_torch.configs import get_arch
from repro_torch.core import tap
from repro_torch.core.policy import get_policy
from repro_torch.launch import calibrate as launch_calibrate
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx

torch.set_num_threads(1)

ARCH = "qwen1.5-0.5b"
ERRORS_RTOL = 2e-2
FORMATS = ("hif4", "hif4_direct", "nvfp4", "nvfp4_pts", "mxfp4", "bf16")
ROW_KEYS = ("path", "shape", "n_values", "packable", "in_budget", "captured")


def _quiet(*_):
    pass


def _reference_inputs(arch, n_batches, batch, seq_len, seed=0):
    """The reference's probe inputs (its seeded init and prefill batches)
    and the port's copies of them."""
    cfg = ref_get_arch(arch).reduced()
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(seed))
    batches = [ref_prefill_batch(cfg, batch, seq_len, seed=seed + i)
               for i in range(n_batches)]
    port_params = interop.params_from_jax(params, device="cpu")
    port_batches = [{k: np.asarray(v) for k, v in b.items()} for b in batches]
    return cfg, params, batches, port_params, port_batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's calibrate and the port's on the same inputs."""
    d = tmp_path_factory.mktemp("calibrate")
    ref = ref_calibrate(ARCH, reduced=True, target_bpv="sensitive-fallback",
                        seed=0, out=str(d / "ref.json"),
                        report_out=str(d / "ref_report.json"), log=_quiet)
    _, _, _, params, batches = _reference_inputs(ARCH, 2, 2, 64)
    port = calibrate(ARCH, reduced=True, target_bpv="sensitive-fallback",
                     seed=0, params=params, batches=batches, device="cpu",
                     out=str(d / "port.json"),
                     report_out=str(d / "port_report.json"), log=_quiet)
    return {"ref": ref, "port": port, "dir": d}


def _rows(summary):
    return {r["path"]: r for r in summary["report"]["sites"]}


def test_site_rows_and_bytes_equal_the_reference(runs):
    ref, port = _rows(runs["ref"]), _rows(runs["port"])
    assert list(ref) == list(port)
    for path in ref:
        for key in ROW_KEYS + ("bytes",):
            assert port[path][key] == ref[path][key], (path, key)
    captured = {p for p, r in port.items() if r["captured"]}
    assert captured == {f"blocks.{s}" for s in (
        "attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wg", "mlp.wu",
        "mlp.wo")} | {"lm_head"}
    assert runs["port"]["report"]["calibration"] == runs["ref"]["report"]["calibration"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_errors_agree_with_the_reference(runs, fmt):
    ref, port = _rows(runs["ref"]), _rows(runs["port"])
    for path, r in ref.items():
        if r["errors"] is None:
            assert port[path]["errors"] is None
            continue
        np.testing.assert_allclose(port[path]["errors"][fmt], r["errors"][fmt],
                                   rtol=ERRORS_RTOL, err_msg=path)


def test_assignment_and_baselines_equal_the_reference(runs):
    ref, port = runs["ref"], runs["port"]
    for key in ("assignment", "total_bytes", "achieved_bpv", "feasible",
                "n_sites", "n_packed", "target_bpv", "target_spec"):
        assert port[key] == ref[key], key
    assert set(port["baselines"]) == set(ref["baselines"])
    for name, b in ref["baselines"].items():
        assert port["baselines"][name]["assignment"] == b["assignment"]
        assert port["baselines"][name]["total_bytes"] == b["total_bytes"]
        np.testing.assert_allclose(port["baselines"][name]["total_error"],
                                   b["total_error"], rtol=ERRORS_RTOL)
    # a mixed plan at the fallback's 0.99375 B/value
    assert 0 < port["n_packed"] < port["n_sites"]


def _keys(node):
    if isinstance(node, dict):
        return {k: _keys(v) for k, v in node.items()}
    if isinstance(node, list) and node and isinstance(node[0], dict):
        return [_keys(node[0]), len(node)]
    return None


def test_report_has_the_reference_keys(runs):
    ref = json.load(open(runs["dir"] / "ref_report.json"))
    port = json.load(open(runs["dir"] / "port_report.json"))
    assert _keys(port) == _keys(ref)
    assert port["version"] == ref["version"] == 1
    assert len(port["pareto_curve"]) == len(ref["pareto_curve"])


def test_higptq_no_worse_than_direct_cast(runs):
    """The reference's bound (tests/test_calibrate.py): on the calibration
    set it optimizes, HiGPTQ is within 1.25x of the direct cast."""
    for path, r in _rows(runs["port"]).items():
        if r["packable"] and r["captured"]:
            assert 0 < r["errors"]["hif4"] <= 1.25 * r["errors"]["hif4_direct"], path
            assert r["errors"]["bf16"] == 0.0


def test_search_at_the_fallback_budget_dominates_the_preset(runs):
    """Searched AT the fallback preset's residency: <= its bytes and <= its
    error on the same table; the curve's bytes fall strictly."""
    rep = runs["port"]["report"]
    fb = rep["baselines"]["sensitive-fallback"]
    assert rep["search"]["feasible"]
    assert rep["search"]["total_bytes"] <= fb["total_bytes"]
    assert rep["search"]["total_error"] <= fb["total_error"] + 1e-6
    curve = rep["pareto_curve"]
    assert len(curve) >= 2
    assert all(b["total_bytes"] < a["total_bytes"] for a, b in zip(curve, curve[1:]))


def _tables(report, option, score):
    """The searchable table of a report, in one package's vocabulary."""
    sites = []
    for r in report["sites"]:
        if not r["in_budget"]:
            continue
        opts = [option("bf16", 2.0, 0.0)]
        if r["packable"]:
            opts.append(option("hif4", 0.5625, r["errors"]["hif4"]))
        sites.append(score(r["path"], r["n_values"], tuple(opts)))
    return sites


def test_search_at_0p7_matches_the_reference(runs):
    port = frontier_search(_tables(runs["port"]["report"], FormatOption,
                                   SiteScore), 0.7)
    ref = ref_search.frontier_search(_tables(
        runs["ref"]["report"], ref_search.FormatOption, ref_search.SiteScore), 0.7)
    assert port.assignment == ref.assignment
    assert port.feasible == ref.feasible
    assert port.total_bytes == ref.total_bytes
    np.testing.assert_allclose(port.total_error, ref.total_error, rtol=ERRORS_RTOL)
    assert [c["moved"] for c in port.curve] == [c["moved"] for c in ref.curve]


@pytest.mark.parametrize("direction", ["port_file_in_reference",
                                       "reference_file_in_port"])
def test_policy_files_load_across_packages(runs, direction):
    d = runs["dir"]
    path = str(d / ("port.json" if direction.startswith("port") else "ref.json"))
    ref_plan = ref_lm.quant_plan(ref_get_arch(ARCH).reduced(),
                                 ref_get_policy(path, impl="packed"))
    port_plan = lm.quant_plan(get_arch(ARCH).reduced(),
                              get_policy(path, impl="packed"))
    assert set(port_plan.packed_paths) == set(ref_plan.packed_paths)
    want = {p for p, f in runs["ref"]["assignment"].items() if f == "hif4"}
    assert set(port_plan.packed_paths) == want
    assert open(d / "port.json").read().count("\n") > 1


def test_emit_policy_roundtrip_resolves_to_assignment(tmp_path):
    cfg = get_arch(ARCH).reduced()
    assignment = {"blocks.attn.wq": "bf16", "blocks.attn.wk": "hif4",
                  "blocks.attn.wv": "hif4", "blocks.attn.wo": "bf16",
                  "blocks.mlp.wg": "hif4", "blocks.mlp.wu": "bf16",
                  "blocks.mlp.wo": "hif4"}
    out = str(tmp_path / "policy.json")
    emit_policy(assignment, name="t", kv_format="hif4",
                provenance={"tool": "test"}, out=out)
    pol = get_policy(out, impl="packed")
    assert pol.provenance_dict()["tool"] == "test"
    assert pol.kv.kv_format == "hif4"
    plan = lm.quant_plan(cfg, pol)
    assert plan.packed_paths == frozenset(
        p for p, f in assignment.items() if f == "hif4")
    for path, fmt in assignment.items():
        assert plan.at(path).fmt == ("none" if fmt == "bf16" else fmt), path
    # the reference's emitter writes the same bytes for the same policy
    from repro.calibrate.emit import emit_policy as ref_emit_policy

    ref_out = str(tmp_path / "ref.json")
    ref_emit_policy(assignment, name="t", kv_format="hif4",
                    provenance={"tool": "test"}, out=ref_out)
    assert open(out).read() == open(ref_out).read()


# ---------------------------------------------------------------------------
# the search: the reference's properties, and equality with the reference
# ---------------------------------------------------------------------------

FMTS = ("bf16", "hif4", "nvfp4", "mxfp4", "int8")
BPV = {"bf16": 2.0, "int8": 1.0, "nvfp4": 0.75, "mxfp4": 0.75, "hif4": 0.5625}


def _as_reference(sites):
    return [ref_search.SiteScore(s.path, s.n_values, tuple(
        ref_search.FormatOption(o.fmt, o.bytes_per_value, o.error)
        for o in s.options)) for s in sites]


def _assert_same_search(sites, target):
    port = frontier_search(sites, target)
    ref = ref_search.frontier_search(_as_reference(sites), target)
    assert port.assignment == ref.assignment
    assert port.total_bytes == ref.total_bytes
    assert port.total_error == ref.total_error
    assert port.feasible == ref.feasible
    assert port.curve == ref.curve
    assert assignment_cost(sites, port.assignment) == ref_search.assignment_cost(
        _as_reference(sites), ref.assignment)


def _random_table(rng):
    sites = []
    for i in range(int(rng.integers(1, 7))):
        fmts = sorted(set(rng.choice(FMTS, size=int(rng.integers(1, 6)))))
        opts = tuple(FormatOption(f, BPV[f], float(rng.uniform(0.0, 10.0)))
                     for f in fmts)
        sites.append(SiteScore(f"site{i}", int(rng.integers(64, 8193)), opts))
    return sites


@pytest.mark.parametrize("seed", range(8))
def test_search_equals_the_reference_on_random_tables(seed):
    rng = np.random.default_rng(seed)
    sites = _random_table(rng)
    for target in (0.4, 0.6, 0.9, 1.3, 2.2, float(rng.uniform(0.4, 2.2))):
        _assert_same_search(sites, target)


if hypothesis is not None:
    hypothesis.settings.register_profile(
        "torch_calibrate", deadline=None, max_examples=60, derandomize=True)

    @st.composite
    def site_tables(draw):
        n_sites = draw(st.integers(min_value=1, max_value=6))
        sites = []
        for i in range(n_sites):
            fmts = draw(st.sets(st.sampled_from(FMTS), min_size=1, max_size=5))
            opts = tuple(
                FormatOption(f, BPV[f], draw(st.floats(
                    min_value=0.0, max_value=10.0, allow_nan=False)))
                for f in sorted(fmts))
            sites.append(SiteScore(
                path=f"site{i}",
                n_values=draw(st.integers(min_value=64, max_value=8192)),
                options=opts))
        return sites

    @hypothesis.settings(hypothesis.settings.get_profile("torch_calibrate"))
    @hypothesis.given(site_tables(), st.floats(min_value=0.4, max_value=2.2),
                      st.floats(min_value=0.0, max_value=0.8))
    def test_frontier_monotone_in_target(sites, t_lo, dt):
        """Raising --target-bpv never increases error nor shrinks bytes."""
        lo = frontier_search(sites, t_lo)
        hi = frontier_search(sites, t_lo + dt)
        assert hi.total_error <= lo.total_error + 1e-9
        assert hi.total_bytes >= lo.total_bytes - 1e-9

    @hypothesis.settings(hypothesis.settings.get_profile("torch_calibrate"))
    @hypothesis.given(site_tables(), st.floats(min_value=0.4, max_value=2.2))
    def test_frontier_internal_consistency(sites, target):
        """Totals match the assignment, budget semantics hold, and the curve
        is monotone (bytes strictly down, error up)."""
        r = frontier_search(sites, target)
        b, e = assignment_cost(sites, r.assignment)
        assert abs(b - r.total_bytes) < 1e-6
        assert abs(e - r.total_error) < 1e-6
        n_total = sum(s.n_values for s in sites)
        if r.feasible:
            assert r.total_bytes <= target * n_total + 1e-6
        else:
            assert abs(r.total_bytes - r.curve[-1]["total_bytes"]) < 1e-6
        for a, c in zip(r.curve, r.curve[1:]):
            assert c["total_bytes"] < a["total_bytes"]
            assert c["total_error"] >= a["total_error"] - 1e-9

    @hypothesis.settings(hypothesis.settings.get_profile("torch_calibrate"))
    @hypothesis.given(site_tables(), st.floats(min_value=0.4, max_value=2.2))
    def test_frontier_equals_the_reference(sites, target):
        _assert_same_search(sites, target)


def test_hull_dominance():
    h = _hull([
        FormatOption("bf16", 2.0, 0.0),
        FormatOption("worse-same-bytes", 2.0, 1.0),     # dominated
        FormatOption("bigger-and-worse", 3.0, 0.5),     # dominated
        FormatOption("hif4", 0.5625, 0.3),
        FormatOption("concave", 1.0, 0.29),             # off the hull
    ])
    assert [o.fmt for o in h] == ["bf16", "hif4"]
    for a, b in zip(h, h[1:]):
        assert b.bytes_per_value < a.bytes_per_value
        assert b.error > a.error


def test_greedy_stops_at_budget():
    sites = [
        SiteScore("a", 1000, (FormatOption("bf16", 2.0, 0.0),
                              FormatOption("hif4", 0.5625, 1.0))),
        SiteScore("b", 1000, (FormatOption("bf16", 2.0, 0.0),
                              FormatOption("hif4", 0.5625, 5.0))),
    ]
    r = frontier_search(sites, 1.3)
    assert r.feasible
    assert r.assignment == {"a": "hif4", "b": "bf16"}
    assert len(r.curve) == 3
    r2 = frontier_search(sites, 2.0)
    assert r2.assignment == {"a": "bf16", "b": "bf16"}
    assert r2.total_error == 0.0


def test_assignment_cost_unknown_fmt_falls_back():
    s = SiteScore("a", 100, (FormatOption("bf16", 2.0, 0.5),
                             FormatOption("hif4", 0.5625, 1.0)))
    b, e = assignment_cost([s], {"a": "int8"})     # not offered
    assert (b, e) == (200.0, 0.5 * 100)            # min-error option


# ---------------------------------------------------------------------------
# the tap
# ---------------------------------------------------------------------------

EXPECTED_CAPTURED = {
    "granite-moe-1b-a400m": {"blocks.attn.wq", "blocks.attn.wk",
                             "blocks.attn.wv", "blocks.attn.wo", "lm_head"},
    "mamba2-1.3b": {f"blocks.{w}" for w in ("w_b", "w_c", "w_dt", "w_out",
                                            "w_x", "w_z")} | {"lm_head"},
    "whisper-tiny": None,      # every attention and MLP site of both stacks
}


def _tapped_forwards(arch, expect_k=None):
    """The reference's forward under its tap and the port's under its own,
    on the same weights and one batch of (1, 64); ``expect_k`` defaults to
    the probe's."""
    cfg, params, batches, port_params, port_batches = _reference_inputs(
        arch, 1, 1, 64)
    plan = ref_lm.quant_plan(cfg, ref_get_policy("uniform:hif4", impl="packed"))
    if expect_k is None:
        expect_k = {s.path: ref_probe._site_k(s) for s in plan.sites
                    if s.path != "embed" and ref_probe._site_k(s) is not None}
    ref_t = ref_tap.ActivationTap(expect_k=expect_k)
    ctx = RefModelCtx(remat=False, attn_q_chunk=8, attn_k_chunk=8)
    with jax.disable_jit(), ref_tap.capture(ref_t):
        jax.block_until_ready(ref_probe._forward(params, batches[0], cfg, ctx))
    port_cfg = get_arch(arch).reduced()
    port_t = tap.ActivationTap(expect_k=expect_k)
    with torch.no_grad(), tap.capture(port_t):
        probe._forward(port_params, probe._batch_to(port_batches[0],
                                                    torch.device("cpu")),
                       port_cfg, ModelCtx(attn_q_chunk=8, attn_k_chunk=8))
    return ref_t, port_t


def _assert_same_records(ref_t, port_t):
    assert port_t.paths() == ref_t.paths()
    for path in ref_t.paths():
        ref_recs, port_recs = ref_t.records[path], port_t.records[path]
        assert len(port_recs) == len(ref_recs), path
        for r, p in zip(ref_recs, port_recs):
            assert p.dtype == torch.float32 and p.device.type == "cpu"
            assert tuple(p.shape) == r.shape, path
            np.testing.assert_allclose(p.numpy(), r, rtol=0.05, atol=0.05,
                                       err_msg=path)


@pytest.mark.parametrize("arch", list(EXPECTED_CAPTURED))
def test_tap_captures_the_reference_sites(arch):
    ref_t, port_t = _tapped_forwards(arch)
    _assert_same_records(ref_t, port_t)
    want = EXPECTED_CAPTURED[arch]
    if want is None:
        want = {f"{stack}.{s}" for stack in ("blocks", "enc_blocks")
                for s in ("attn.wq", "attn.wk", "attn.wv", "attn.wo",
                          "mlp.wi", "mlp.wo")}
        want |= {f"blocks.xattn.{w}" for w in ("wq", "wk", "wv", "wo")}
        want |= {"lm_head"}
    assert set(port_t.paths()) == want


def test_moe_buffer_records_in_the_reference_row_order():
    """With the expert sites' widths set to the activations', both taps
    capture the router and the expert buffers: one record per call, the
    buffer's rows in (batch, expert, capacity) order, whatever the port's
    row chunks."""
    d = get_arch("granite-moe-1b-a400m").reduced().d_model
    fe = get_arch("granite-moe-1b-a400m").reduced().moe.d_expert
    ref_t, port_t = _tapped_forwards("granite-moe-1b-a400m", expect_k={
        "blocks.moe.router": d, "blocks.moe.wg": d, "blocks.moe.wu": d,
        "blocks.moe.wo": fe})
    moe = ["blocks.moe.router", "blocks.moe.wg", "blocks.moe.wo",
           "blocks.moe.wu"]
    assert [p for p in port_t.paths() if ".moe." in p] == moe
    _assert_same_records(ref_t, port_t)


def test_tap_guards_and_subsamples():
    t = tap.ActivationTap(expect_k={"a": 4}, max_rows=3)
    x = torch.arange(40, dtype=torch.bfloat16).reshape(10, 4)
    tap.consume_pending(x, -1)                 # no tap installed: nothing
    with tap.capture(t):
        with pytest.raises(RuntimeError, match="already installed"):
            with tap.capture(tap.ActivationTap()):
                pass
        tap.consume_pending(x, -1)             # no mark: nothing
        tap.mark_site("a")
        tap.consume_pending(x.T, -1)           # width 10 != 4: dropped
        tap.mark_site("a")
        tap.consume_pending(x, -1)             # 10 rows, stride 4
        tap.mark_site("b")
        tap.consume_pending(x, 0)              # contraction axis 0
    assert tap.active() is None
    assert t.paths() == ["a", "b"]
    assert torch.equal(t.rows("a"), x[::4].float())
    assert t.rows("b").shape == (2, 10)          # 4 rows, stride 2
    assert torch.equal(t.rows("b"), x.T[::2].float())


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-1b-a400m",
                                  "mamba2-1.3b", "zamba2-2.7b", "whisper-tiny",
                                  "llava-next-34b"])
def test_train_mode_is_the_prefill_forward_without_its_cache(arch):
    """The probe's ``mode="train"`` forward, every family: the prefill's
    hidden states bitwise, and no cache."""
    cfg = get_arch(arch).reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    ctx = ModelCtx(attn_q_chunk=8, attn_k_chunk=8)
    g = torch.Generator().manual_seed(1)
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = torch.randn(1, 64, cfg.d_model, generator=g)
        x = torch.randn(1, 4, cfg.d_model, generator=g).to(torch.bfloat16)
    else:
        x = torch.randn(1, 64, cfg.d_model, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        h, caches = lm._backbone(params, x, cfg, ctx, mode="train", **kw)
        h_prefill, _ = lm._backbone(params, x, cfg, ctx, mode="prefill", **kw)
    assert caches is None
    assert torch.equal(h.view(torch.int16), h_prefill.view(torch.int16))
    with pytest.raises(ValueError, match="mode"):
        lm._backbone(params, x, cfg, ctx, mode="loss")


# ---------------------------------------------------------------------------
# the launcher and the front door
# ---------------------------------------------------------------------------


def test_launcher_writes_a_policy_the_reference_loads(tmp_path, capsys):
    out, rep = str(tmp_path / "p.json"), str(tmp_path / "r.json")
    rc = front_door.main(["calibrate", "--arch", ARCH, "--reduced", "--device",
                          "cpu", "--target-bpv", "0.9", "--kv-format", "hif4",
                          "--out", out, "--report", rep])
    assert rc == 0
    text = capsys.readouterr().out
    assert "== searched policy: qwen1.5-0.5b-smoke @ 0.9 B/value ==" in text
    report = json.load(open(rep))
    assert report["search"]["feasible"] and report["target_bpv"] == 0.9
    ref_pol = ref_get_policy(out, impl="packed")
    assert ref_pol.kv.kv_format == "hif4"
    ref_plan = ref_lm.quant_plan(ref_get_arch(ARCH).reduced(), ref_pol)
    assert set(ref_plan.packed_paths) == {
        p for p, f in report["search"]["assignment"].items() if f == "hif4"}


def test_launcher_exits_2_on_an_infeasible_target(tmp_path):
    with pytest.raises(SystemExit) as e:
        launch_calibrate.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                               "--target-bpv", "0.3",
                               "--out", str(tmp_path / "p.json")])
    assert e.value.code == 2


def test_front_door_lists_its_commands(capsys):
    assert front_door.main([]) == 2
    listing = capsys.readouterr().out
    assert "calibrate" in listing and "train" in listing
    assert front_door.main(["dryrun"]) == 2
