"""The five architectures the port gained with the MoE family, vs the JAX
reference, and the two repairs their full widths need.

* Each config equals the reference's field for field, in full and reduced
  form (whisper-tiny and llava-next-34b too); every reference arch
  resolves in the port.
* Greedy tokens at ``--reduced`` (paper-iv, impl packed, HiF4 KV) equal the
  reference's for qwen1.5-4b, qwen3-4b, nemotron-4-340b,
  granite-moe-1b-a400m and phi3.5-moe-42b-a6.6b, and so does the serving
  artifact each package prepares, bitwise. The reference runs with XLA's
  excess precision off, in a process of its own (as in
  ``test_torch_scheduler.py``); weights are the seeded init at 5x, so the
  tokens vary.
* The decode form's launch plan at nemotron's FFN down-projection (M 8,
  K 73 728, N 18 432) no longer raises: it names kernel 1, then kernel 2's
  ``__dp4a`` body; every plan that fitted before is unchanged, and the
  engine's route on the card is held bitwise to the decode form's plain
  version at K 73 728 (``cuda`` marker).
* ``PackedW.from_dense`` in column slabs is bitwise a one-shot pack.
* The launcher serves granite reduced on the CPU and names the two-launch
  route on the card.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import all_archs as jall_archs
from repro.configs import get_arch as jget_arch
from repro_torch.configs import all_archs, get_arch
from repro_torch.core import engine as TE
from repro_torch.core import qlinear
from repro_torch.core.qlinear import PackedW, QuantConfig
from repro_torch.kernels import bfp_matmul as TB
from repro_torch.kernels import fused_matmul as TM

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen1.5-4b", "qwen3-4b", "nemotron-4-340b", "granite-moe-1b-a400m",
         "phi3.5-moe-42b-a6.6b")
BATCH, PROMPT, NEW = 2, 8, 6


@pytest.mark.parametrize("arch", ARCHS + ("whisper-tiny", "llava-next-34b"))
def test_config_equals_reference(arch):
    for port, ref in ((get_arch(arch), jget_arch(arch)),
                      (get_arch(arch).reduced(), jget_arch(arch).reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()


def test_archs_still_to_port_raise():
    """None is left: every reference arch resolves, under its own name; an
    arch neither package has raises."""
    assert all_archs() == jall_archs() and len(all_archs()) == 10
    for arch in jall_archs():
        assert get_arch(arch).name == arch
    with pytest.raises(ValueError, match="unknown arch"):
        get_arch("whisper-base")


# ---------------------------------------------------------------------------
# greedy tokens against the reference (one subprocess for the five archs)
# ---------------------------------------------------------------------------


def tokens_of_both_packages() -> dict:
    """Per arch: the reference's and the port's greedy tokens from the same
    raw weights and prompts, and whether the two serving artifacts agree
    bitwise. Run by :func:`both` in a process of its own."""
    import jax
    import jax.numpy as jnp

    from repro.core import kvcache as JK
    from repro.core.policy import get_policy as jget_policy
    from repro.core.qlinear import PackedW as JPackedW
    from repro.models import lm as JL
    from repro.models.common import ModelCtx as JCtx
    from repro.runtime import serve_loop as JS
    from repro_torch import interop
    from repro_torch.core import kvcache
    from repro_torch.core.policy import get_policy
    from repro_torch.models import lm
    from repro_torch.models.common import ModelCtx
    from repro_torch.runtime import serve_loop as TS

    def scaled(p):
        blocks = jax.tree_util.tree_map(
            lambda a: a * 5 if a.dtype == jnp.bfloat16 else a, p["blocks"])
        return dict(p, blocks=blocks, embed=p["embed"] * 5)

    out = {}
    for arch in ARCHS:
        jcfg, tcfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
        jplan = JL.quant_plan(jcfg, jget_policy("paper-iv", impl="packed",
                                                kv=JK.KV_HIF4))
        tplan = lm.quant_plan(tcfg, get_policy("paper-iv", impl="packed",
                                               kv=kvcache.KV_HIF4))
        raw = scaled(JL.init_params(jcfg, jax.random.PRNGKey(0)))
        # packed once under jit (eager packing takes ~15 s an arch)
        jparams = jax.jit(lambda p: JS.prepare_params_for_serving(
            p, jcfg, jplan))(raw)
        prompts = np.random.default_rng(1).integers(
            0, jcfg.vocab, (BATCH, PROMPT)).astype(np.int32)
        jctx = JCtx(quant=jplan.base, plan=jplan, remat=False, attn_q_chunk=32,
                    attn_k_chunk=32)
        jtoks = JS.serve(jcfg, jparams, {"tokens": jnp.asarray(prompts)}, jctx,
                         JS.ServeConfig(max_new_tokens=NEW))
        traw = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, raw),
                                       "cpu")
        tparams = TS.prepare_params_for_serving(traw, tcfg, tplan, device="cpu")
        tctx = ModelCtx(plan=tplan, attn_q_chunk=32, attn_k_chunk=32)
        ttoks = TS.serve(tcfg, tparams, {"tokens": torch.from_numpy(prompts)},
                         tctx, TS.ServeConfig(max_new_tokens=NEW), device="cpu")
        jleaves = jax.tree_util.tree_leaves(
            jparams, is_leaf=lambda x: isinstance(x, JPackedW))
        same = []
        tleaves = _leaves(tparams)
        for jl, tl in zip(jleaves, tleaves):
            if isinstance(jl, JPackedW):
                same.append(np.array_equal(np.asarray(jl.codes), tl.codes.numpy())
                            and np.array_equal(
                                np.asarray(jl.meta),
                                interop.to_numpy(tl.meta, uint32=True)))
            else:
                same.append(str(np.asarray(jl).dtype) == str(tl.dtype).replace(
                    "torch.", "") and np.array_equal(
                    np.asarray(jl, np.float32), interop.to_numpy(tl)))
        out[arch] = {"ref": np.asarray(jtoks).tolist(), "port": ttoks.tolist(),
                     "leaves": [len(jleaves), len(tleaves)],
                     "artifact_equal": all(same)}
    return out


def _leaves(tree):
    """Leaves in sorted-key order (the reference's pytree order), PackedW
    whole."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


@pytest.fixture(scope="module")
def both():
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            (os.path.join(REPO, "src"), os.path.join(REPO, "tests"))))
    run = subprocess.run(
        [sys.executable, "-c", "import json, test_torch_families as t; "
         "print(json.dumps(t.tokens_of_both_packages()))"],
        env=env, capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_reference(both, arch):
    got = both[arch]
    assert got["leaves"][0] == got["leaves"][1]
    assert got["artifact_equal"]
    assert np.array(got["ref"]).shape == (BATCH, NEW)
    assert got["port"] == got["ref"]
    # tokens that vary within a request, so a wrong layer shows in them
    assert all(len(set(r)) > 1 for r in got["ref"]), got["ref"]


# ---------------------------------------------------------------------------
# the decode form at any K
# ---------------------------------------------------------------------------


def _plan_before(m, k, n):
    """The decode form's plan as it was before the two-launch route: None
    where it raised."""
    groups, tiles, split = k // 64, -(-n // TM.DECODE_TILE_N), 1
    while (split < TM.DECODE_MAX_SPLIT and 2 * split <= groups
           and tiles * split < 2 * TB.H100_SMS):
        split *= 2
    while True:
        smem = TM._decode_smem_bytes(m, groups, split, -(-groups // split))
        if smem <= TM.SMEM_PER_CTA_MAX:
            return TM.DecodePlan(TM.DECODE_TILE_N, split, tiles * split, smem)
        if split == TM.DECODE_MAX_SPLIT or 2 * split > groups:
            return None
        split *= 2


def _linear_shapes(arch):
    """(K, N) of every packed linear of an arch at full width."""
    c = get_arch(arch)
    a, d = c.attn, c.d_model
    shapes = {(d, a.n_heads * a.d_head), (d, a.n_kv_heads * a.d_head),
              (a.n_heads * a.d_head, d)}
    if c.moe is None:
        shapes |= {(d, c.d_ff), (c.d_ff, d)}
    return shapes


def test_decode_plan_takes_nemotrons_ffn_down_projection():
    plan = TM.decode_plan(8, 73728, 18432)
    assert plan.kernels == TM.DECODE_TWO_LAUNCHES and not plan.one_launch
    assert (plan.tile_n, plan.split, plan.grid, plan.smem_bytes) == (
        TB.cuda_tiles(8)[1], 1, 18432 // 32, 0)
    assert _plan_before(8, 73728, 18432) is None
    # at the serve's 8 rows every other linear of the five archs keeps the
    # one-launch decode form; at 32 rows nemotron's K = 18 432 takes the two
    # launches too (the quantized rows grow with M)
    for arch in ARCHS:
        for k, n in _linear_shapes(arch):
            assert TM.decode_plan(8, k, n).one_launch == (
                (k, n) != (73728, 18432)), (arch, k, n)
            for m in (1, 32):
                p = TM.decode_plan(m, k, n)
                assert p.one_launch == (_plan_before(m, k, n) is not None)


def test_decode_plan_unchanged_wherever_it_fitted():
    ks = list(range(64, 2816 + 1, 64)) + [4096, 9728, 18432, 73728]
    n_before = 0
    for m in (1, 2, 7, 8, 16, 17, 32):
        for k in ks:
            for n in (16, 40, 512, 1024, 2816, 9728, 18432, 151936):
                before = _plan_before(m, k, n)
                plan = TM.decode_plan(m, k, n)
                if before is None:
                    assert plan.kernels == TM.DECODE_TWO_LAUNCHES
                else:
                    n_before += 1
                    assert plan == before and plan.one_launch
    assert n_before > 2000


def test_dispatch_info_names_the_two_launch_route():
    def probe(k, n):
        return PackedW(torch.empty((k // 2, n), dtype=torch.uint8, device="meta"),
                       torch.empty((k // 64, n), dtype=torch.int32, device="meta"),
                       (k, n), torch.bfloat16, kernel_layout=True)

    q = QuantConfig(fmt="hif4", impl="packed")
    info = TE.packed_dispatch_info(q, probe(73728, 18432), decode_m=8,
                                   prefill_m=3840, device="cuda")
    assert info["execution"] == "CUDA fused kernel"
    assert info["decode_kernel"].startswith("hif4_quantize, then "
                                            "fused_packed_matmul")
    assert info["decode_tiles"] == TB.cuda_tiles(8)
    info = TE.packed_dispatch_info(q, probe(18432, 73728), decode_m=8,
                                   prefill_m=3840, device="cuda")
    assert info["decode_kernel"].startswith("fused_decode_matmul")
    assert info["decode_tiles"] == (8, 32, 8)


def test_decode_form_wrapper_refuses_the_two_launch_shapes():
    x = torch.zeros(8, 73728, dtype=torch.bfloat16, device="meta")
    codes = torch.zeros(36864, 32, dtype=torch.uint8, device="meta")
    meta = torch.zeros(1152, 32, dtype=torch.int32, device="meta")
    assert not TM.decode_plan(8, 73728, 32).one_launch
    with pytest.raises(ValueError):
        TM.fused_decode_matmul(x, codes, meta)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 32])
def test_long_k_decode_route_is_bitwise_its_plain_version(cuda, m):
    """At K 73 728 the engine launches kernel 1, then kernel 2 (no decode
    form): bitwise the decode form's plain version, in bf16 and f32."""
    from repro_torch.kernels import build

    g = torch.Generator().manual_seed(19)
    k, n = 73728, 256
    w = (torch.randn(k, n, generator=g) * 0.02).to(torch.bfloat16)
    pw = PackedW.from_dense(w).to_kernel_layout()
    q = TE.EngineCtx(QuantConfig(fmt="hif4", impl="packed"))
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(m, k, generator=g).to(dt)
        want = TM.fused_decode_matmul_plain(x, pw.codes, pw.meta)
        build.reset_launches()
        got = TE.matmul(x.to(cuda), PackedW(pw.codes.to(cuda), pw.meta.to(cuda),
                                           pw.shape2d, pw.dtype,
                                           kernel_layout=True), q)
        torch.cuda.synchronize()
        assert build.LAUNCHES["hif4_quantize"] == 1
        assert build.LAUNCHES["fused_packed_matmul"] == 1
        assert build.LAUNCHES["fused_decode_matmul"] == 0
        assert got.dtype == want.dtype
        assert torch.equal(got.cpu().view(torch.int16 if dt == torch.bfloat16
                                          else torch.int32),
                           want.view(torch.int16 if dt == torch.bfloat16
                                     else torch.int32))


# ---------------------------------------------------------------------------
# packing in column slabs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, contract, slab", [
    ((256, 96), (0,), 256 * 7),         # 14 slabs of 7 columns, one of 5
    ((128, 4, 32), (0,), 1),            # a column a slab
    ((4, 32, 192), (0, 1), 128 * 50),   # attention's wo: K = H x Dh
    ((512, 40), (0,), 10 ** 9)])        # one slab
def test_pack_in_slabs_is_bitwise_one_shot(monkeypatch, shape, contract, slab):
    g = torch.Generator().manual_seed(7)
    w = (torch.randn(*shape, generator=g) * 0.05).to(torch.bfloat16)
    monkeypatch.setattr(qlinear, "PACK_SLAB_VALUES", 10 ** 12)
    one = PackedW.from_dense(w, contract)
    monkeypatch.setattr(qlinear, "PACK_SLAB_VALUES", slab)
    slabs = PackedW.from_dense(w, contract)
    assert torch.equal(one.codes, slabs.codes) and torch.equal(one.meta, slabs.meta)
    assert slabs.shape2d == one.shape2d


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_serves_granite_reduced_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-moe-1b-a400m", "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "8", "--new-tokens", "3", "--policy", "paper-iv",
         "--impl", "packed", "--kv-format", "hif4"],
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    # the reference launcher's plan lines: the router stays f32 and
    # unquantized, the experts unpacked bf16 (wo quantized offline)
    assert "policy plan [paper-iv] (4/10 sites packed)" in text
    assert "blocks.moe.router  none       packed  float32" in text
    assert "blocks.moe.wg      hif4       packed  bfloat16 " in text
    assert "blocks.moe.wo      hif4       packed  qdq bfloat16 (offline PTQ)" in text
    assert "kv cache residency [hif4]: 144 B/token" in text
    lines = [ln for ln in text.splitlines() if ln.startswith("request ")]
    assert len(lines) == 2 and all(len(json.loads(ln.split(": ", 1)[1])) == 3
                                   for ln in lines)
