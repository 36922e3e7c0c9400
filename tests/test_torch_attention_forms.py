"""The attention forms of ``repro_torch.models.attention`` beyond the scan_q
flash and the bf16 decode, against the reference's
``repro.models.attention`` on the same inputs (numpy seeds).

* ``flash_mha_vec`` (the vec_q form): the forward, causal and not, GQA,
  within atol 2e-5 of the reference's ``flash_mha_vec``; dq, dk, dv of the
  sum of sin of its output within atol 3e-5 of the reference's custom VJP
  (the reference's own tolerances, ``tests/test_attention.py``).
* ``flash_attention(kv_valid_len=)`` within atol 2e-5 of the reference's.
* ``decode_attention_packed`` and ``flash_mha_vec_packed`` on a packed cache
  handed over bitwise (artifact and kernel-tile layouts, ragged lengths)
  within rtol 2^-7, atol 1e-3 of the reference and of the port's
  ``fused_decode_attention_plain``.
* A reduced qwen1.5-0.5b ``train_loss`` and its gradients under
  ``attn_impl="vec_q"`` against the reference's under the same form, at
  ``tests/test_torch_train.py``'s tolerances for scan_q (loss rtol 1e-4,
  each leaf's gradient by relative norm 5e-2).
"""
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
from repro.core.qlinear import QuantConfig as JQ
from repro.models import attention as JA
from repro.models import lm as JL
from repro.models.common import ModelCtx as JCtx
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core.qlinear import QuantConfig
from repro_torch.kernels.fused_attention import fused_decode_attention_plain
from repro_torch.launch.steps import _grads
from repro_torch.checkpoint.checkpoint import tree_flatten
from repro_torch.models import attention as TA
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FWD_ATOL, GRAD_ATOL = 2e-5, 3e-5
PACKED_RTOL, PACKED_ATOL = 2 ** -7, 1e-3
# tests/test_torch_train.py's port-vs-reference limits for one hif4 step
LOSS_RTOL, GRAD_REL = 1e-4, 5e-2
# (B, S, H, Hkv, D, q_chunk, k_chunk): the reference test's shape, and
# chunks that do not align q and kv chunk boundaries
VEC_CASES = {"gqa2": (2, 64, 4, 2, 16, 16, 32), "mqa": (2, 64, 4, 1, 16, 16, 32),
             "mha-uneven": (1, 96, 2, 2, 8, 32, 48)}


def _inputs(seed, B, S, H, Hkv, D, sq=None):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, sq or S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32)]


def _close(got: torch.Tensor, want, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


# ---------------------------------------------------------------------------
# vec_q: forward and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", list(VEC_CASES))
def test_flash_mha_vec_forward_matches_the_reference(case, causal):
    B, S, H, Hkv, D, cq, ck = VEC_CASES[case]
    arrays = _inputs(5, B, S, H, Hkv, D)
    want = JA.flash_mha_vec(*(jnp.asarray(a) for a in arrays), causal, 0,
                            JA.AttnChunking(cq, ck))
    got = TA.flash_mha_vec(*(torch.from_numpy(a) for a in arrays), causal, 0,
                           TA.AttnChunking(cq, ck))
    _close(got, want, FWD_ATOL)
    # no autograd recorded: the forward alone, the same values
    assert torch.equal(got, TA.FlashMHAVec.apply(
        *(torch.from_numpy(a) for a in arrays), causal, 0,
        TA.AttnChunking(cq, ck)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", list(VEC_CASES))
def test_flash_mha_vec_grads_match_the_reference(case, causal):
    B, S, H, Hkv, D, cq, ck = VEC_CASES[case]
    arrays = _inputs(6, B, S, H, Hkv, D)

    def jloss(q, k, v):
        o = JA.flash_mha_vec(q, k, v, causal, 0, JA.AttnChunking(cq, ck))
        return jnp.sum(jnp.sin(o.astype(jnp.float32)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    out = TA.flash_mha_vec(q, k, v, causal, 0, TA.AttnChunking(cq, ck))
    got = torch.autograd.grad(torch.sum(torch.sin(out.float())), (q, k, v))
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, GRAD_ATOL, msg=f"d{name} ({case}, causal={causal})")


def test_flash_mha_vec_bf16_matches_the_reference():
    """bf16 operands: p and ds rounded to bf16 before their products, in
    both packages."""
    arrays = _inputs(7, 2, 64, 4, 2, 16)
    ch = (16, 32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)

    def jloss(q, k, v):
        o = JA.flash_mha_vec(q, k, v, True, 0, JA.AttnChunking(*ch))
        return jnp.sum(jnp.sin(o.astype(jnp.float32)))

    jout = JA.flash_mha_vec(jq, jk, jv, True, 0, JA.AttnChunking(*ch))
    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
               for a in arrays)
    out = TA.flash_mha_vec(q, k, v, True, 0, TA.AttnChunking(*ch))
    got = torch.autograd.grad(torch.sum(torch.sin(out.float())), (q, k, v))
    # bf16 outputs: one ulp at |o| <= 1 is 2^-8
    _close(out, jnp.asarray(jout, jnp.float32), 2 ** -7)
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        _close(g, w, 2 ** -7 * float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# flash_attention(kv_valid_len=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,q_offset,sq", [(True, 0, 64), (False, 0, 64),
                                                (True, 48, 16), (False, 0, 8)])
def test_flash_attention_kv_valid_len_matches_the_reference(causal, q_offset, sq):
    B, S, H, Hkv, D = 3, 64, 4, 2, 16
    arrays = _inputs(8, B, S, H, Hkv, D, sq=sq)
    lens = np.array([64, 37, 1], np.int32)
    ch = (min(16, sq), 32)
    want = JA.flash_attention(*(jnp.asarray(a) for a in arrays), causal=causal,
                              q_offset=q_offset, kv_valid_len=jnp.asarray(lens),
                              chunking=JA.AttnChunking(*ch))
    got = TA.flash_attention(*(torch.from_numpy(a) for a in arrays),
                             causal=causal, q_offset=q_offset,
                             kv_valid_len=torch.from_numpy(lens),
                             chunking=TA.AttnChunking(*ch))
    _close(got, want, FWD_ATOL)
    # a full valid length is the unmasked attention
    full = TA.flash_attention(*(torch.from_numpy(a) for a in arrays),
                              causal=causal, q_offset=q_offset,
                              kv_valid_len=torch.full((B,), S),
                              chunking=TA.AttnChunking(*ch))
    plain = TA.flash_attention(*(torch.from_numpy(a) for a in arrays),
                               causal=causal, q_offset=q_offset,
                               chunking=TA.AttnChunking(*ch))
    _close(full, plain.numpy(), 1e-6)


# ---------------------------------------------------------------------------
# the packed forms
# ---------------------------------------------------------------------------


PACKED_CASES = {  # (B, S, Hkv, D, lengths): one KV chunk; three of 512
    "one-chunk": (4, 96, 2, 32, [96, 1, 50, 95]),
    "three-chunks": (3, 1536, 4, 16, [1536, 700, 3]),
}


def _packed(case, layout):
    B, S, Hkv, D, lens = PACKED_CASES[case]
    rng = np.random.default_rng(9)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32) * 0.5
    jk, jv = (JK.quantize_kv(jnp.asarray(a).astype(jnp.bfloat16)) for a in (k, v))
    if layout == "kernel":
        jk, jv = JK.to_kernel_layout(jk), JK.to_kernel_layout(jv)
    tk, tv = ({n: interop.tensor_from_numpy(np.asarray(a), "cpu")
               for n, a in c.items()} for c in (jk, jv))
    return jk, jv, tk, tv, np.array(lens, np.int32), (Hkv, D)


@pytest.mark.parametrize("layout", ["artifact", "kernel"])
@pytest.mark.parametrize("case", list(PACKED_CASES))
def test_decode_attention_packed_matches_the_reference(case, layout):
    jk, jv, tk, tv, lens, (Hkv, D) = _packed(case, layout)
    B = len(lens)
    q = (np.random.default_rng(10).standard_normal((B, 4 * Hkv, D)) * 0.5
         ).astype(np.float32)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    want = JA.decode_attention_packed(jq, jk, jv, jnp.asarray(lens), Hkv, D)
    got = TA.decode_attention_packed(tq, tk, tv, torch.from_numpy(lens), Hkv, D)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 4 * Hkv, D)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    _close(got, want, PACKED_ATOL, PACKED_RTOL)
    plain = fused_decode_attention_plain(tq, tk, tv, torch.from_numpy(lens),
                                         Hkv, D)
    _close(got, plain.float().numpy(), PACKED_ATOL, PACKED_RTOL)


@pytest.mark.parametrize("layout", ["artifact", "kernel"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_mha_vec_packed_matches_the_reference(layout, causal):
    """Four query tokens at positions 92-95 (a chunked-prefill
    continuation) against the packed cache, ragged valid lengths."""
    jk, jv, tk, tv, lens, (Hkv, D) = _packed("one-chunk", layout)
    B = len(lens)
    q = (np.random.default_rng(11).standard_normal((B, 4, 2 * Hkv, D)) * 0.5
         ).astype(np.float32)
    ch = (2, 32)
    want = JA.flash_mha_vec_packed(
        jnp.asarray(q).astype(jnp.bfloat16), jk, jv, Hkv, D, causal=causal,
        q_offset=92, kv_valid_len=jnp.asarray(lens),
        chunking=JA.AttnChunking(*ch))
    got = TA.flash_mha_vec_packed(
        torch.from_numpy(q).to(torch.bfloat16), tk, tv, Hkv, D, causal=causal,
        q_offset=92, kv_valid_len=torch.from_numpy(lens),
        chunking=TA.AttnChunking(*ch))
    _close(got, np.asarray(jnp.asarray(want, jnp.float32)), PACKED_ATOL,
           PACKED_RTOL)
    # each query row alone against the plain decode at its own length
    # (causal: position 92 + i sees keys 0 .. 92 + i, within the length)
    for i in range(4):
        n = np.minimum(lens, 93 + i) if causal else lens
        one = fused_decode_attention_plain(
            torch.from_numpy(q[:, i]).to(torch.bfloat16), tk, tv,
            torch.from_numpy(n), Hkv, D)
        _close(got[:, i], one.float().numpy(), PACKED_ATOL, PACKED_RTOL)


# ---------------------------------------------------------------------------
# ModelCtx.attn_impl="vec_q" through train_loss
# ---------------------------------------------------------------------------


SEQ, BATCH = 32, 2


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


def reference_vec_train(out: str) -> None:
    """The reference's loss and gradients of reduced qwen under vec_q, on
    its own init, to ``out`` (.npz). Run by :func:`vec_train` in a process
    of its own with XLA's excess precision off (as
    ``tests/test_torch_train.py``): with it on, XLA skips the bf16 roundings
    the port performs."""
    cfg = jget_arch("qwen1.5-0.5b").reduced()
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (BATCH, SEQ))
    ctx = JCtx(quant=JQ(fmt="hif4"), remat=False, attn_q_chunk=8,
               attn_k_chunk=16, attn_impl="vec_q")
    loss, grads = jax.jit(jax.value_and_grad(lambda p: JL.train_loss(
        p, {"tokens": jnp.asarray(tokens, jnp.int32)}, cfg, ctx)))(params)
    arrays = {f"param/{k}": np.asarray(v, np.float32)
              for k, v in _flat(params).items()}
    arrays.update({f"grad/{k}": np.asarray(v, np.float32)
                   for k, v in _flat(grads).items()})
    np.savez(out, tokens=tokens, loss=np.float64(loss), **arrays)


@pytest.fixture(scope="module", autouse=True)
def _reference_train(tmp_path_factory):
    """Starts the reference's run of :func:`reference_vec_train` with the
    module's first test, so it overlaps the tests before the ones that read
    it; yields (process, its output path)."""
    out = str(tmp_path_factory.mktemp("vec_train") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            (os.path.join(REPO, "src"), os.path.join(REPO, "tests"))))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_attention_forms as t; "
         "t.reference_vec_train(sys.argv[1])", out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def vec_train(_reference_train):
    proc, out = _reference_train
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    ref = dict(np.load(out))
    like = lm.init_params(get_arch("qwen1.5-0.5b").reduced(), 0, device="cpu")
    params = _unflat({k: torch.from_numpy(ref[f"param/{k}"]).to(v.dtype)
                      for k, v in _flat(like).items()})
    return {"params": params, "tokens": ref["tokens"],
            "loss": float(ref["loss"]),
            "grads": {k[len("grad/"):]: v for k, v in ref.items()
                      if k.startswith("grad/")}}


def _rel(a: torch.Tensor, b: np.ndarray) -> float:
    a, b = a.double(), torch.from_numpy(b).double()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)),
                                                1e-30))


def _port_loss_and_grads(vec_train, attn_impl):
    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = {k: v.clone() for k, v in _flat(vec_train["params"]).items()}
    params = _unflat(params)
    ctx = ModelCtx(quant=QuantConfig(fmt="hif4"), remat=False, attn_q_chunk=8,
                   attn_k_chunk=16, attn_impl=attn_impl)
    leaves = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = lm.train_loss(params, {"tokens": torch.from_numpy(
        vec_train["tokens"]).long()}, cfg, ctx)
    return loss.detach(), dict(zip(_flat(params), _grads(loss, leaves)))


def test_train_loss_and_gradients_under_vec_q_match_the_reference(vec_train):
    loss, grads = _port_loss_and_grads(vec_train, "vec_q")
    want = vec_train["loss"]
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want), (float(loss), want)
    assert set(grads) == set(vec_train["grads"])
    rels = {path: _rel(g, vec_train["grads"][path]) for path, g in grads.items()}
    print(f"loss {float(loss)} vs {want}; gradient rel {rels}")
    assert max(rels.values()) <= GRAD_REL, rels


def test_vec_q_and_scan_q_train_the_same_function(vec_train):
    """The two forms compute one attention: the same loss and gradients up
    to their orders of sums."""
    lv, gv = _port_loss_and_grads(vec_train, "vec_q")
    ls, gs = _port_loss_and_grads(vec_train, "scan_q")
    assert abs(float(lv) - float(ls)) <= LOSS_RTOL * abs(float(ls))
    rels = {p: _rel(gv[p], gs[p].detach().float().numpy()) for p in gv}
    assert max(rels.values()) <= GRAD_REL, rels
