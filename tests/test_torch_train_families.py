"""The port's ``train_loss`` and its gradients for the other five families
against the JAX reference, at reduced size (2 layers, d 128, batch 4,
seq 32), hif4 fake quantization (impl qdq):

* moe (granite-moe-1b-a400m), ssm (mamba2-1.3b), hybrid (zamba2-2.7b):
  tokens from the reference's synthetic dataset;
* audio (whisper-tiny): seeded f32 frames (the stub frontend's output)
  and decoder tokens;
* vlm (llava-next-34b): seeded f32 embeds and labels.

The port runs with layer remat on (the reference with it off: remat
changes no value), so each family's remat path is exercised. The reference
runs once, in a process of its own with XLA's excess precision off.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.qlinear import QuantConfig
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx

import test_torch_train as TT

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

ARCHS = ("granite-moe-1b-a400m", "mamba2-1.3b", "zamba2-2.7b", "whisper-tiny",
         "llava-next-34b")
BATCH, SEQ, FRAMES = 4, 32, 64
# the loss, and each leaf's gradient by the relative L2 norm of the
# difference (as test_torch_train.py; a leaf whose exact gradient is 0 is
# compared against the model's gradient norm instead)
LOSS_RTOL = 1e-4
GRAD_REL = 5e-2


def _inputs(cfg, tokens: np.ndarray) -> dict:
    """The batch of one family, as numpy: tokens, or frames and tokens
    (audio), or embeds and labels (vlm)."""
    rng = np.random.default_rng(7)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (BATCH, FRAMES, cfg.d_model)).astype(np.float32), "tokens": tokens}
    if cfg.embeds_input:
        return {"embeds": (0.02 * rng.standard_normal(
            (BATCH, SEQ, cfg.d_model))).astype(np.float32), "labels": tokens}
    return {"tokens": tokens}


def reference_grads(out: str) -> dict:
    """Per arch: the reference's init, loss and gradients; arrays to
    ``out/ref.npz``. Run by :func:`ref` in a process of its own, the archs
    in threads of their own (XLA compiles them side by side)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget_arch
    from repro.core.qlinear import QuantConfig as JQ
    from repro.data import SyntheticLMDataset as JData
    from repro.models import lm as JL
    from repro.models.common import ModelCtx as JCtx

    def one(arch):
        cfg = jget_arch(arch).reduced()
        ctx = JCtx(quant=JQ(fmt="hif4"), remat=False, attn_q_chunk=SEQ,
                   attn_k_chunk=SEQ)
        params = JL.init_params(cfg, jax.random.PRNGKey(0))
        tokens = np.asarray(JData(cfg.vocab, SEQ, BATCH, seed=0).batch_at(0)[
            "tokens"])
        batch = {k: jnp.asarray(v) for k, v in _inputs(cfg, tokens).items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: JL.train_loss(p, batch, cfg, ctx)))(params)
        arrays = {f"{arch}/tokens": tokens.astype(np.float32)}
        for prefix, tree in (("init", params), ("grad", grads)):
            for k, v in TT._flat(tree).items():
                arrays[f"{arch}/{prefix}/{k}"] = np.asarray(v, np.float32)
        return float(loss), arrays

    with ThreadPoolExecutor(len(ARCHS)) as pool:
        results = dict(zip(ARCHS, pool.map(one, ARCHS)))
    arrays = {k: v for _, a in results.values() for k, v in a.items()}
    np.savez(os.path.join(out, "ref.npz"), **arrays)
    return {arch: loss for arch, (loss, _) in results.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_families_ref"))
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            (os.path.join(TT.REPO, "src"), os.path.join(TT.REPO, "tests"))))
    run = subprocess.run(
        [sys.executable, "-c", "import json, sys, test_torch_train_families "
         "as t; print(json.dumps(t.reference_grads(sys.argv[1])))", out],
        env=env, capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    return {"losses": json.loads(run.stdout.strip().splitlines()[-1]),
            "arrays": dict(np.load(os.path.join(out, "ref.npz")))}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(ref, arch):
    cfg = get_arch(arch).reduced()
    a = ref["arrays"]
    like = TT._flat(lm.init_params(cfg, 0, device="cpu"))
    params = TT._unflat({k: torch.from_numpy(a[f"{arch}/init/{k}"]).to(
        v.dtype) for k, v in like.items()})
    tokens = a[f"{arch}/tokens"].astype(np.int64)
    batch = {k: torch.from_numpy(v) for k, v in _inputs(cfg, tokens).items()}
    ctx = ModelCtx(quant=QuantConfig(fmt="hif4"), remat=True,
                   attn_q_chunk=SEQ, attn_k_chunk=SEQ)
    loss, grads = TT._loss_and_grads(params, batch, ctx, cfg)
    want = ref["losses"][arch]
    ref_grads = {k: torch.from_numpy(a[f"{arch}/grad/{k}"]) for k in grads}
    total = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                 for g in ref_grads.values())))
    rels = {}
    for path, g in grads.items():
        d = float(torch.linalg.norm(g.double() - ref_grads[path].double()))
        rels[path] = d / max(float(torch.linalg.norm(ref_grads[path].double())),
                             1e-3 * total)
    worst = max(rels, key=rels.get)
    print(f"{arch}: loss {float(loss)} vs {want}; worst gradient {worst} "
          f"rel {rels[worst]}")
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want)
    assert rels[worst] <= GRAD_REL, rels
