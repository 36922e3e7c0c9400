"""The dry run of the port (``repro_torch.launch.dryrun``, ``cost_analysis``,
``breakdown``, ``specs``, ``mesh``, ``sharding.rules``) against the
reference's ``repro.launch.dryrun`` and ``hlo_analysis``.

* The cost model on toy functions (the reference's ``TestFlops`` and
  ``TestRooflineShape``): an (M, K) @ (K, N) costs 2MKN FLOPs and its
  operands' plus result's bytes, a view nothing, a backward is counted, a
  tensor off ``meta`` raises.
* The loop-aware count (the step costed at a few depths, extrapolated)
  equals a full-depth dispatch exactly (FLOPs, bytes, ops) on every
  family's reduced config, deepened, for train, prefill and decode; the
  MoE row-chunk replay equals the chunk loop exactly where nothing is
  recorded, and in FLOPs and bytes under autograd.
* Residency per device (params, packed params, opt_state, kv_cache) equals
  the reference's byte for byte for every arch x applicable shape on the
  card's 1 x 1 and the reference's 16x16 and 2x16x16 meshes; so do
  ``n_params``, ``n_active_params`` and ``model_flops``. The reference runs
  in one subprocess with 512 XLA host devices (no compile of a full cell).
* The matmul FLOPs of reduced qwen1.5-0.5b's prefill and decode steps equal
  the reference's ``dot`` FLOPs (``hlo_analysis.HloModule`` on a
  one-device CPU compile, loop multiplicities applied) exactly.
* The CLI at full width (``python -m repro_torch dryrun|breakdown``) runs
  without a card and without ``--device cpu``, writes its record to a
  temporary ``--out``, and no tensor off ``meta`` appears.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import all_archs as jall_archs
from repro.configs import applicable_shapes as japplicable
from repro.configs import get_arch as jget_arch
from repro.configs.base import SHAPES as JSHAPES
from repro_torch.configs import (SHAPES, ShapeConfig, all_archs,
                                 applicable_shapes, get_arch)
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as hw
from repro_torch.sharding.rules import ShardCtx

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("card", "16x16", "2x16x16")
# one reduced config of each family, deepened so the extrapolation is tested
# beyond the depths it samples
FAMILY_ARCHS = ("qwen1.5-0.5b", "granite-moe-1b-a400m", "mamba2-1.3b",
                "zamba2-2.7b", "whisper-tiny", "llava-next-34b")
DOT_SHAPES = {"prefill": (2, 64), "decode": (2, 64)}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the cost model on toy functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(8, 16, 32), (128, 64, 256), (1, 1024, 7)])
def test_matmul_flops_and_bytes(m, k, n):
    _, c = ca.count(torch.mm, _meta(m, k), _meta(k, n))
    assert c.flops == c.matmul_flops == 2 * m * k * n
    assert c.bytes == 4 * (m * k + k * n + m * n)
    assert c.ops == 1


def test_batched_and_bf16_out_dtype_matmul():
    a, b = _meta(3, 8, 16, dtype=torch.bfloat16), _meta(3, 16, 4, dtype=torch.bfloat16)
    _, c = ca.count(torch.bmm, a, b)
    assert c.matmul_flops == 2 * 3 * 8 * 16 * 4
    assert c.bytes == 2 * (3 * 8 * 16 + 3 * 16 * 4 + 3 * 8 * 4)
    _, c = ca.count(lambda x, w: torch.mm(x, w, out_dtype=torch.float32),
                    a[0], b[0])
    assert c.matmul_flops == 2 * 8 * 16 * 4
    assert c.bytes == 2 * (8 * 16 + 16 * 4) + 4 * 8 * 4


def test_views_are_free():
    x = _meta(4, 6, 8)

    def views(x):
        return (x.view(24, 8), x.transpose(0, 2), x[:, 1:3], x.expand(2, 4, 6, 8),
                x.detach(), x.reshape(4, 48), x.as_strided((2, 2), (1, 1)))

    _, c = ca.count(views, x)
    assert c.flops == c.bytes == c.peak_live == 0
    assert c.ops >= 7


def test_elementwise_and_reduction():
    x, y = _meta(16, 32), _meta(16, 32)
    _, c = ca.count(torch.add, x, y)
    assert (c.flops, c.bytes) == (16 * 32, 3 * 4 * 16 * 32)
    _, c = ca.count(lambda t: t.sum(dim=-1), x)
    assert (c.flops, c.bytes) == (16 * 32, 4 * (16 * 32 + 16))
    _, c = ca.count(lambda t: t.to(torch.bfloat16), x)      # a copy: bytes only
    assert (c.flops, c.bytes) == (0, 6 * 16 * 32)


def test_backward_is_counted():
    x = _meta(8, 16).requires_grad_(True)
    w = _meta(16, 4).requires_grad_(True)

    def fwd_bwd(x, w):
        return torch.autograd.grad(torch.mm(x, w).sum(), [x, w])

    _, c = ca.count(fwd_bwd, x, w)
    # forward, then dx = g w^T and dw = x^T g
    assert c.matmul_flops == 3 * 2 * 8 * 16 * 4


def test_live_bytes_and_peak():
    def f(x):
        a = x * 2                     # 256 B
        b = a + 1                     # 256 B; a dies after the next line
        del a
        return b.sum()                # 4 B

    out, c = ca.count(f, _meta(64))
    assert c.peak_live == 512
    assert c.out_live == 4
    mem = ca.memory_stats(c, argument_bytes=256)
    assert mem["peak_bytes_est"] == 256 + 512
    assert mem["output_bytes"] == 4 and mem["alias_bytes"] == 0


def test_a_tensor_off_meta_raises():
    with pytest.raises(RuntimeError, match="cpu tensor"):
        ca.count(torch.add, _meta(4), torch.ones(4))


def test_roofline_shape():
    c = ca.Cost(flops=989e12, bytes=3.35e12 / 2)
    r = ca.analyze(c)
    assert r["t_compute_s"] == pytest.approx(1.0)
    assert r["t_memory_s"] == pytest.approx(0.5)
    assert r["dominant"] == "compute"
    assert r["wire_bytes_per_device"] == 0 and r["collective_ops"] == {}
    assert ca.analyze(ca.Cost(flops=1, bytes=1e12))["dominant"] == "memory"
    assert (hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.HBM_BYTES) == (
        989e12, 3.35e12, 80e9)


def test_exact_polynomial_fit():
    samples = [(k, ca.Cost(flops=3 + 5 * k[0] + 7 * k[0] ** 2, bytes=11 * k[0],
                           ops=2 + k[0]))
               for k in ca.sample_points(1, 2)]
    got, _ = ca.extrapolate(samples, (96,), 2)
    assert (got.flops, got.bytes, got.ops) == (3 + 5 * 96 + 7 * 96 ** 2,
                                               11 * 96, 98)
    assert ca.sample_points(2, 1) == [(2, 2), (3, 2), (2, 3)]


# ---------------------------------------------------------------------------
# loop-aware counts against full-depth dispatches
# ---------------------------------------------------------------------------


def _deep(arch):
    cfg = get_arch(arch).reduced()
    if cfg.family == "audio":
        return dataclasses.replace(cfg, enc_layers=5, n_layers=6)
    return dataclasses.replace(cfg, n_layers=6)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loop_aware_equals_full_dispatch(arch, kind):
    cfg = _deep(arch)
    shape = ShapeConfig("t", 64, 2, kind)
    full = dryrun.dispatch_cost(cfg, shape)
    fit, mult = dryrun.loop_aware_cost(cfg, shape)
    for name in ("flops", "bytes", "ops", "matmul_flops"):
        assert getattr(fit, name) == getattr(full, name), name
    assert full.flops > 0 and full.matmul_flops > 0
    # peak memory is extrapolated the same way, a line per phase (forward,
    # backward); a train step of the two-knob audio family peaks in AdamW at
    # the larger of its encoder's and decoder's leaves, which the additive
    # fit over-estimates (+25% at 5 + 6 layers here; cost_analysis.extrapolate)
    if cfg.family == "audio" and kind == "train":
        assert full.peak_live <= fit.peak_live <= 1.3 * full.peak_live
    else:
        assert fit.peak_live == pytest.approx(full.peak_live, rel=0.05)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_row_chunk_replay_equals_the_loop(kind):
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    shape = ShapeConfig("t", 96, 2, kind)       # 6 chunks of 32 rows a layer
    loop = dryrun.dispatch_cost(cfg, shape, replay_chunks=False)
    rep = dryrun.dispatch_cost(cfg, shape)
    for name in ("flops", "bytes", "matmul_flops"):
        assert getattr(rep, name) == getattr(loop, name), name
    if kind == "train":
        # the replay's gradient plumbing is not the loop's op for op
        assert rep.ops == pytest.approx(loop.ops, rel=0.01)
        assert rep.peak_live == pytest.approx(loop.peak_live, rel=0.05)
    else:
        assert (rep.ops, rep.peak_live) == (loop.ops, loop.peak_live)


def test_no_kernel_launch_and_only_meta_in_a_cell():
    """A served (packed) cell dispatches on meta only; the wrappers' plain
    routes run, never a kernel."""
    from repro_torch.kernels import build

    before = dict(build.LAUNCHES)
    cfg = get_arch("qwen1.5-0.5b").reduced()
    for kind in ("prefill", "decode"):
        c = dryrun.dispatch_cost(cfg, ShapeConfig("t", 64, 2, kind), packed=True)
        assert c.matmul_flops > 0
    assert build.LAUNCHES == before


# ---------------------------------------------------------------------------
# against the reference (one subprocess)
# ---------------------------------------------------------------------------


def _dot_flops(mod) -> float:
    """Sum of ``dot`` FLOPs of an HloModule, fused ones included, each
    computation times its loop multiplicity."""
    import repro.launch.hlo_analysis as H

    def local(comp, seen):
        if comp in seen or comp not in mod.comps:
            return 0.0
        seen.add(comp)
        types = mod._types(comp)
        total = 0.0
        for i in mod.comps[comp]:
            if i.op == "dot":
                total += mod._dot_flops(i, types)
            elif i.op == "fusion":
                m = H._CALLS_RE.search(i.line)
                if m:
                    total += local(m.group(1), seen)
        return total

    total = 0.0

    def visit(comp, mult):
        nonlocal total
        if comp not in mod.comps:
            return
        total += local(comp, set()) * mult
        for callee, m in mod._edges[comp]:
            visit(callee, mult * m)

    visit(mod.entry, 1.0)
    return total


def reference_side() -> dict:
    """The reference's residency per arch x shape x mesh, its parameter
    counts and model FLOPs, and the dot FLOPs of reduced qwen1.5-0.5b's
    prefill and decode steps. Run by :func:`ref` in a process of its own."""
    import jax
    import jax.numpy as jnp

    import repro.launch.dryrun as JD
    import repro.launch.hlo_analysis as H
    from repro.configs import get_shape as jget_shape
    from repro.core.qlinear import QuantConfig as JQ
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import decode_specs as jdecode_specs
    from repro.launch.steps import make_prefill_step, make_serve_step
    from repro.models import lm as JL
    from repro.models.common import ModelCtx as JCtx
    from repro.models.params import shape_structs
    from repro.optim.adamw import adamw_init_specs as jadamw

    meshes = {"card": None, "16x16": make_production_mesh(multi_pod=False),
              "2x16x16": make_production_mesh(multi_pod=True)}
    out = {"cells": {}, "archs": {}}
    for arch in jall_archs():
        cfg = jget_arch(arch)
        seq_shard = cfg.n_params() >= JD.SEQ_SHARD_MIN_PARAMS
        pspecs = JL.abstract_params(cfg)
        plan = JL.quant_plan(cfg, JQ(fmt="hif4", impl="packed"))
        packed = JL.packed_overlay(pspecs, plan) if plan.packed_paths else None
        flops = {}
        for s in japplicable(cfg):
            shape = jget_shape(s)
            toks = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                         else 1)
            flops[s] = (6.0 if shape.kind == "train" else 2.0) \
                * cfg.n_active_params() * toks
        out["archs"][arch] = {"n_params": cfg.n_params(),
                              "n_active_params": cfg.n_active_params(),
                              "model_flops": flops}
        for name, mesh in meshes.items():
            shard = JD.make_ctx(mesh, "hif4", fsdp=True,
                                seq_shard=seq_shard).shard
            for s in japplicable(cfg):
                shape = jget_shape(s)
                rec = {"params": JD.resident_bytes_per_device(pspecs, shard)}
                if packed is not None and shape.kind != "train":
                    rec["params_packed"] = JD.resident_bytes_per_device(packed, shard)
                if shape.kind == "train":
                    rec["opt_state"] = JD.resident_bytes_per_device(
                        jadamw(pspecs), shard)
                if shape.kind == "decode":
                    rec["kv_cache"] = JD.resident_bytes_per_device(
                        jdecode_specs(cfg, shape)["cache"], shard)
                out["cells"][f"{arch}|{s}|{name}"] = rec

    cfg = jget_arch("qwen1.5-0.5b").reduced()
    ctx = JCtx(quant=JQ(fmt="hif4", offline_weights=True), remat=False)
    p = shape_structs(JL.abstract_params(cfg))
    b, s = DOT_SHAPES["prefill"]
    prefill = jax.jit(make_prefill_step(cfg, ctx)).lower(
        p, {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}).compile()
    b, s = DOT_SHAPES["decode"]
    decode = jax.jit(make_serve_step(cfg, ctx)).lower(
        p, shape_structs(JL.abstract_cache(cfg, b, s)),
        jax.ShapeDtypeStruct((b,), jnp.int32)).compile()
    out["dots"] = {k: _dot_flops(H.HloModule(c.as_text()))
                   for k, c in (("prefill", prefill), ("decode", decode))}
    return out


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.pathsep.join((os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests"))))
    run = subprocess.run(
        [sys.executable, "-c", "import json, test_torch_dryrun as t; "
         "print(json.dumps(t.reference_side()))"],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in all_archs():
        assert applicable_shapes(get_arch(arch)) == japplicable(jget_arch(arch))
    assert "long_500k" in applicable_shapes(get_arch("zamba2-2.7b"))
    assert "long_500k" not in applicable_shapes(get_arch("qwen1.5-0.5b"))


@pytest.mark.parametrize("arch", sorted(jall_archs()))
def test_residency_equals_the_reference(ref, arch):
    cfg = get_arch(arch)
    want = ref["archs"][arch]
    assert cfg.n_params() == want["n_params"]
    assert cfg.n_active_params() == want["n_active_params"]
    for shape in applicable_shapes(cfg):
        for mesh in MESHES:
            rec = dryrun.residency_record(arch, shape, mesh=mesh)
            got = dict(rec["resident_bytes_per_device"])
            if rec["kind"] != "train":
                prec = dryrun.residency_record(arch, shape, mesh=mesh,
                                               packed=True)
                if prec["packed_weights"]:
                    got["params_packed"] = prec["resident_bytes_per_device"]["params"]
            assert got == ref["cells"][f"{arch}|{shape}|{mesh}"], (shape, mesh)
            assert rec["model_flops"] == want["model_flops"][shape]
            assert rec["roofline"] is None and rec["memory"] is None


def test_sharding_rules_resolve_as_the_reference():
    """A few specs by hand: divisibility fallback, one use per mesh axis,
    the card's 1 x 1 and no mesh replicate."""
    s = ShardCtx(mesh=hw.MULTI_POD_MESH)
    assert s.pspec(("batch", "act_seq"), (256, 4096)) == (("pod", "data"), "model")
    assert s.pspec(("batch",), (1,)) == (None,)
    assert s.pspec(("batch",), (2,)) == ("pod",)          # prefix fallback
    assert s.pspec(("heads", "kv_heads"), (32, 16)) == ("model", None)
    assert s.shard_shape(("vocab", "fsdp"), (151936, 1024)) == (9496, 64)
    for card in (ShardCtx(mesh=hw.CARD_MESH), ShardCtx()):
        assert card.shard_shape(("vocab", "fsdp"), (151936, 1024)) == (151936, 1024)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_matmul_flops_equal_the_reference_dots(ref, kind):
    cfg = get_arch("qwen1.5-0.5b").reduced()
    b, s = DOT_SHAPES[kind]
    c = dryrun.dispatch_cost(cfg, ShapeConfig("t", s, b, kind))
    assert c.matmul_flops == ref["dots"][kind]


# ---------------------------------------------------------------------------
# the CLI at full width
# ---------------------------------------------------------------------------

_WATCHED = """
import sys, torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from repro_torch.__main__ import main
devices = set()
class Watch(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                devices.add(t.device.type)
        return out
with Watch():
    rc = main(sys.argv[1:])
assert not torch.cuda.is_initialized()
print("DEVICES", sorted(devices))
sys.exit(rc)
"""


def _run_watched(*argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", _WATCHED, *argv], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "DEVICES ['meta']" in run.stdout, run.stdout[-2000:]
    return run.stdout


@pytest.mark.parametrize("arch,shape", [("qwen1.5-0.5b", "decode_32k"),
                                        ("mamba2-1.3b", "long_500k")])
def test_cli_dryrun_at_full_width_on_meta(tmp_path, arch, shape):
    out = _run_watched("dryrun", "--arch", arch, "--shape", shape,
                       "--out", str(tmp_path))
    assert f"OK   {arch} x {shape} [card]" in out and "1 cells passed, 0 failed" in out
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    assert rec["mesh"] == "card" and rec["kind"] == "decode"
    assert rec["fits_card"] == (rec["memory"]["peak_bytes_est"] <= 80e9)
    assert rec["roofline"]["flops_per_device"] > 0
    if arch == "qwen1.5-0.5b":
        # a hif4 serve of the cell would pack its KV; the cell costs bf16
        assert (rec["kv_format"], rec["kv_format_fallback"]) == ("hif4", False)
        # the reference's record: 1 610 612 740 B per device x 256 devices
        assert rec["resident_bytes_per_device"]["kv_cache"] == 412316860420
        assert rec["fits_card"] is False
    else:
        assert (rec["kv_format"], rec["kv_format_fallback"]) == ("bf16", True)
        assert rec["fits_card"]


def test_cli_breakdown_prints_its_tables():
    out = _run_watched("breakdown", "--arch", "mamba2-1.3b", "--shape",
                       "long_500k")
    assert "region" in out and "--- " in out and "mult=" in out
    assert "aten." in out


def test_cli_module_entry_and_refusals(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch", "dryrun",
                          "--arch", "mamba2-1.3b", "--shape", "long_500k",
                          "--mesh", "both", "--out", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "(residency only)" in run.stdout
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.iterdir())]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["roofline"] is None and "partitioner" in r["roofline_note"]
               for r in recs)
    # --attn vec_q costs the vec_q form: every (q, k) tile of a causal
    # train_4k cell, so at least scan_q's FLOPs, which skips the tiles past
    # the diagonal
    flops = {}
    for attn in ("vec_q", "scan_q"):
        out = tmp_path / attn
        assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k",
                            "--attn", attn, "--out", str(out)]) == 0
        (path,) = out.iterdir()
        rec = json.loads(path.read_text())
        assert rec["attn_impl"] == attn and path.name.endswith(f"_{attn}.json")
        flops[attn] = rec["roofline"]["flops_per_device"]
    assert flops["vec_q"] >= flops["scan_q"], flops


@pytest.mark.parametrize("mesh", MESHES)
def test_auto_attention_form_follows_the_reference_rule(mesh):
    """``--attn auto``: vec_q where the heads do not divide the mesh's
    tensor-parallel axis (the reference's lower_cell rule: qwen1.5-4b's 20,
    llava's 56, whisper's 6 heads on 16-way TP), scan_q on the card."""
    tp = hw.MESHES[mesh].get("model", 1)
    for arch in all_archs():
        ja = jget_arch(arch).attn
        want = ("vec_q" if ja is not None and ja.n_heads % tp != 0
                else "scan_q")
        rec = dryrun.residency_record(arch, applicable_shapes(get_arch(arch))[0],
                                      mesh=mesh)
        assert rec["attn_impl"] == want, (arch, mesh)
        for mode in ("scan_q", "vec_q"):
            assert dryrun.residency_record(
                arch, applicable_shapes(get_arch(arch))[0], mesh=mesh,
                attn_mode=mode)["attn_impl"] == mode
    if mesh == "card":
        assert all(dryrun.residency_record(a, "decode_32k")["attn_impl"]
                   == "scan_q" for a in ("qwen1.5-4b", "llava-next-34b"))


def test_a_depth_cut_is_the_cut_config():
    """``lower_cell(..., layers=n)``: the record and the cost of the config
    cut to n layers (a card run's cut): parameters those of the cut
    config, the layers' matmul FLOPs linear in n."""
    full = dryrun.residency_record("qwen1.5-0.5b", "prefill_32k", batch=1)
    cut = dryrun.residency_record("qwen1.5-0.5b", "prefill_32k", batch=1,
                                  layers=6)
    cfg = dryrun.cell_config("qwen1.5-0.5b", 6)
    assert cfg.n_layers == 6 and cut["n_params"] == cfg.n_params()
    assert cut["n_params"] < full["n_params"]
    flops = [dryrun.lower_cell("qwen1.5-0.5b", "decode_32k", batch=8,
                               layers=n)[0]["roofline"]["matmul_flops_per_device"]
             for n in (2, 3, 4)]
    assert flops[2] - flops[1] == flops[1] - flops[0] > 0, flops
    with pytest.raises(ValueError, match="depth knob"):
        dryrun.cell_config("whisper-tiny", 2)
