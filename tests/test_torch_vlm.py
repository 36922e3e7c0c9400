"""The port's vlm family (llava-next-34b: the dense GQA backbone on
precomputed patch embeddings, the anyres vision tower being a stub in the
reference too) against the JAX reference.

* The config and the param specs equal the reference's; the plan packs the
  dense family's 7 sites.
* Served at ``--reduced`` from seeded embeds (the reference in a process of
  its own with XLA's excess precision off, weights at 5x; as in
  ``test_torch_audio.py``): greedy tokens equal the reference's under
  paper-iv packed with HiF4 KV and under paper-iv qdq with bf16 KV; the
  prefill and first decode logits within rtol=0.05, atol=0.1 (also decoding
  from the reference's cache); the serving artifact bitwise; the HiF4 KV
  bytes after ``quantize_kv_cache`` bitwise the reference's on the same K/V
  (reduced, 1 KV head of 32: all of it the bf16 tail) and, at llava's full
  head layout (8 KV heads of 128: sixteen 64-groups), on seeded K/V.
* The prefill casts the embeds to the compute dtype and its position is
  their length; decode embeds tokens. ``resolve_kv_format`` keeps HiF4; the
  request scheduler refuses embeds; the launcher prints the reference's
  lines and refuses like it.
* ``cuda``-marked: kernels 1 and 2 at llava's full-width linears and
  kernel 3 at its head layout (rep 7) against their plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import lm as JL
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import kvcache
from repro_torch.core.policy import get_policy
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.runtime import serve_loop as TS
from test_torch_audio import (REF_REFUSALS, SERVES, decode_attention_close,
                              jspec_table, packed_kernels_bitwise, spec_table)
from test_torch_mamba2 import (launcher_report, plans_equal, report_lines,
                               run_in_reference_process)

torch.set_num_threads(1)

ARCH = "llava-next-34b"
BATCH, PROMPT, NEW = 2, 32, 6


def test_config_equals_reference():
    for port, ref in ((get_arch(ARCH), jget_arch(ARCH)),
                      (get_arch(ARCH).reduced(), jget_arch(ARCH).reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params() == ref.n_params()
    assert get_arch(ARCH).embeds_input and get_arch(ARCH).family == "vlm"


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


@pytest.mark.parametrize("impl", ["packed", "qdq"])
def test_plan_equals_reference(impl):
    rows = plans_equal(ARCH, impl)
    packed = sorted(r[0] for r in rows if r[4])
    assert packed == ([f"blocks.attn.w{p}" for p in "koqv"]
                      + [f"blocks.mlp.w{p}" for p in "gou"]
                      if impl == "packed" else [])


# ---------------------------------------------------------------------------
# serving against the reference (one subprocess)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both():
    return run_in_reference_process("test_torch_audio",
                                    f"serve_both_stub({ARCH!r})")


@pytest.mark.parametrize("serve", [f"{i}/{f}" for i, f in SERVES])
def test_greedy_tokens_equal_the_reference(both, serve):
    got = both[serve]
    assert np.array(got["ref"]).shape == (BATCH, NEW)
    assert got["port"] == got["ref"]
    assert all(len(set(r)) > 1 for r in got["ref"]), got["ref"]


@pytest.mark.parametrize("serve", [f"{i}/{f}" for i, f in SERVES])
def test_logits_and_artifact_equal_the_reference(both, serve):
    got = both[serve]
    assert got["outside"] == [0, 0, 0], got["max_abs"]
    assert got["leaves"][0] == got["leaves"][1] and got["artifact_equal"]
    assert got["n_packed"] == (7 if serve.startswith("packed") else 0)
    assert got["cache_keys"] == got["jcache_keys"] == ["kv", "pos"]
    # the prefill's position is the embeds' length
    assert got["pos"] == [PROMPT, PROMPT]


def test_kv_bytes_equal_the_reference(both):
    got = both["packed/hif4"]
    assert len(got["kv_bytes_equal"]) == 6 and all(got["kv_bytes_equal"])
    shapes = {(n, kv, leaf): s for n, kv, leaf, s in got["kv_shapes"]}
    # one KV head of 32 features: no 64-group, all of it the bf16 tail
    assert shapes[("kv", "k", "codes")] == [2, BATCH, 0, PROMPT]
    assert shapes[("kv", "k", "tail")] == [2, BATCH, 32, PROMPT]


def test_artifact_round_trip_across_packages(both):
    got = both["artifact"]
    assert got["same_bytes"] and got["same_leaves"]
    assert got["policies"][0] == got["policies"][1]
    assert got["family"] == "vlm" and got["n_integrity"] == 7


def test_kv_bytes_at_the_full_head_layout_equal_the_reference():
    """8 KV heads of 128 (1 024 features: sixteen 64-groups, no tail): the
    packed bytes of seeded K/V, the reference run eagerly (op by op, no
    excess precision), bitwise."""
    rng = np.random.default_rng(11)
    kv = {name: jnp.asarray(rng.standard_normal((2, 2, 24, 8, 128)) * 3,
                            jnp.bfloat16) for name in ("k", "v")}
    jcfg, cfg = jget_arch(ARCH), get_arch(ARCH)
    want = JL.quantize_kv_cache({"kv": kv, "pos": jnp.asarray(24)}, jcfg)
    got = lm.quantize_kv_cache({"kv": {n: interop.tensor_from_numpy(a, "cpu")
                                       for n, a in kv.items()}, "pos": 24}, cfg)
    for name in ("k", "v"):
        for leaf in ("codes", "meta", "tail"):
            w = np.asarray(want["kv"][name][leaf])
            g = interop.to_numpy(got["kv"][name][leaf], uint32=leaf == "meta")
            assert g.shape == w.shape, (name, leaf)
            if leaf == "tail":
                w, g = (np.asarray(a, np.float32).view(np.uint32) for a in (w, g))
            assert np.array_equal(g, w), (name, leaf)
    assert got["kv"]["k"]["codes"].shape == (2, 2, 16 * 32, 24)


# ---------------------------------------------------------------------------
# embeds, KV format, refusals
# ---------------------------------------------------------------------------


def test_prefill_casts_embeds_and_decode_embeds_tokens():
    cfg = get_arch(ARCH).reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    ctx = ModelCtx(attn_q_chunk=32, attn_k_chunk=32)
    emb = torch.randn(2, 32, cfg.d_model)
    logits, cache = lm.prefill(params, {"embeds": emb}, cfg, ctx)
    same, _ = lm.prefill(params, {"embeds": emb.to(torch.bfloat16)}, cfg, ctx)
    assert torch.equal(logits, same) and cache["pos"] == 32
    assert cache["kv"]["k"].shape == (2, 2, 32, 1, 32)
    # decode takes token ids through the embedding table
    cache = lm.pad_cache(cache, cfg, 34)
    tok = torch.argmax(logits, -1).to(torch.int32)
    out, cache = lm.decode_step(params, tok, cache, cfg, ctx)
    assert out.shape == (2, cfg.vocab) and cache["pos"] == 33
    with pytest.raises(KeyError):
        lm.prefill(params, {"tokens": torch.zeros(2, 8, dtype=torch.long)},
                   cfg, ctx)


def test_request_scheduler_refuses_embeds():
    cfg = get_arch(ARCH).reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="dense/vlm-embeds not supported"):
        TS.serve_requests(cfg, params, [torch.zeros(8, dtype=torch.long)],
                          ModelCtx(), TS.ServeConfig(max_new_tokens=2),
                          device="cpu")
    plan = lm.quant_plan(cfg, get_policy("paper-iv", impl="packed",
                                         kv=kvcache.KV_HIF4))
    assert TS.resolve_kv_format(cfg, plan.base, TS.ServeConfig()) == "hif4"


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

# the reference launcher's lines (``python -m repro.launch.serve --arch
# llava-next-34b`` with the flags of ``test_torch_mamba2.LAUNCH`` but
# --device; pinned: it takes ~40 s on this CPU)
REF_LINES = """\
policy plan [paper-iv] (7/9 sites packed):
  site               fmt        impl    resident artifact                         bytes
  blocks.attn.wk     hif4       packed  PackedW 4.5-bit (0.5625 B/value)          4,608
  blocks.attn.wo     hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  blocks.attn.wq     hif4       packed  PackedW 4.5-bit (0.5625 B/value)         18,432
  blocks.attn.wv     hif4       packed  PackedW 4.5-bit (0.5625 B/value)          4,608
  blocks.mlp.wg      hif4       packed  PackedW 4.5-bit (0.5625 B/value)         36,864
  blocks.mlp.wo      hif4       packed  PackedW 4.5-bit (0.5625 B/value)         36,864
  blocks.mlp.wu      hif4       packed  PackedW 4.5-bit (0.5625 B/value)         36,864
  embed              none       packed  bfloat16                                131,072
  lm_head            none       packed  bfloat16                                131,072
packed weight residency: 0.15 MiB for 278528 values = 0.5625 B/value (bf16 would be 0.53 MiB)
kv cache residency [hif4]: 256 B/token (bf16: 256) x 34 capacity x 2 slots = 0.02 MiB  [1.00x more slots per byte]"""
# the first packed leaf in the reference's pytree order: blocks.attn.wk
REF_DISPATCH = "packed matmul: fused [{}] on e.g. (K=128, N=32)"


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
    (("--journal-dir", "never-written"), REF_REFUSALS["--guard"])])
def test_launcher_refuses_like_the_reference(capsys, flags, reason):
    rc, out, err = launcher_report(ARCH, capsys, *flags)
    assert rc == 2 and reason in err, err
    assert not any(ln.startswith("request ") for ln in out.splitlines())


# ---------------------------------------------------------------------------
# the kernels at llava-next-34b's full-width shapes (card only)
# ---------------------------------------------------------------------------

# (K, N) of llava's linears: wq / wo, wk / wv, wg / wu, the FFN's wo
SHAPES = ((7168, 7168), (7168, 1024), (7168, 20480), (20480, 7168))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k, n", SHAPES)
def test_packed_linear_kernels_bitwise_at_llava_shapes(cuda, k, n):
    packed_kernels_bitwise(cuda, k, n, 512)


@pytest.mark.cuda
def test_decode_attention_close_at_llava_heads(cuda):
    """56 query heads on 8 KV heads (a group of 7), D 128, 512 slots."""
    decode_attention_close(cuda, 8, 8, 56, 128, 512,
                           [1, 63, 64, 65, 512, 511, 2, 480])
