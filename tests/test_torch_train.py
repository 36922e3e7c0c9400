"""The port's training path on the dense smoke arch against the JAX reference.

* The flash attention ``autograd.Function`` against autograd of a naive f32
  softmax attention (causal and not, even and uneven chunks) at the
  reference test's atol 3e-5, and against the reference's ``flash_mha``
  VJP on the same inputs.
* The straight-through estimator: the QDQ's gradient is the identity, and
  its forward equals the QDQ (HiF4, NVFP4, MXFP4) in value.
* One train step (qwen1.5-0.5b reduced, hif4, impl qdq): the loss, every
  leaf's gradient and the params after one AdamW step against the
  reference's ``make_train_step`` on the same params and batch;
  microbatches 1 and 2 agree; layer remat changes no bit.
* A 10-step trajectory of the train loop on the reference's batches from
  the reference's init, kill at 6 (checkpoint at 4) and resume, as
  ``tests/test_substrate.py`` checks the reference, and the port resuming
  from a checkpoint the reference's loop wrote (its step 8).
* The launcher trains on the CPU when asked and refuses cuda without a card.

The reference runs once, in a process of its own with XLA's excess
precision off (as ``test_torch_families.py``), and hands its results over
through ``.npz`` files.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import __main__ as front_door
from repro_torch.checkpoint import latest_step
from repro_torch.checkpoint.checkpoint import tree_flatten
from repro_torch.configs import get_arch
from repro_torch.core.formats import get_format
from repro_torch.core.qlinear import QuantConfig, qmatmul, quantize_activation
from repro_torch.launch.steps import (_grads, make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import lm
from repro_torch.models.attention import AttnChunking, flash_attention, flash_mha
from repro_torch.models.common import ModelCtx
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.train_loop import TrainLoopConfig, train

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen1.5-0.5b"
BATCH, SEQ = 4, 32
OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 10}
LOOP = {"global_batch": BATCH, "seq_len": SEQ, "checkpoint_every": 4}
# (seq, q_chunk, k_chunk): the reference test's even and uneven chunks
FLASH_CASES = {"even": (64, 16, 32), "uneven": (96, 32, 48)}
# port vs reference, one step at hif4: the loss, and each leaf's gradient,
# first moment and updated weight by the relative L2 norm of the difference
# (HiF4's activation QDQ turns last-bit differences into whole quantization
# steps at the few values on a rounding boundary; measured: loss 8e-8,
# gradients at most 1.6e-2, the key bias's, whose exact gradient is 0)
LOSS_RTOL = 1e-4
GRAD_REL = 5e-2
PARAM_REL = 1e-2
# the 10-step trajectory: each step's loss
TRAJ_RTOL = 2e-3


# qmatmul at hif4, x (4, 8, 128) @ w (128, 64), the sum of sin of its output:
# the output and both gradients by the relative norm (f32 operands; bf16
# operands, dotted in f32 and cast back to bf16 as the reference does). QDQ
# is bitwise across the packages, so the differences are the dots' order
# of sums (measured: the outputs equal, f32 gradients 4.9e-8, bf16 equal;
# the bf16 limit allows a few flipped bf16 roundings).
QMATMUL_DTYPES = ("float32", "bfloat16")
QMATMUL_REL = {"float32": 1e-6, "bfloat16": 1e-3}


def _qmatmul_inputs():
    rng = np.random.default_rng(11)
    return [rng.standard_normal((4, 8, 128)).astype(np.float32),
            rng.standard_normal((128, 64)).astype(np.float32)]


def _flash_inputs(seq: int):
    rng = np.random.default_rng(seq)
    return [rng.standard_normal((2, seq, 4, 16)).astype(np.float32),
            rng.standard_normal((2, seq, 2, 16)).astype(np.float32),
            rng.standard_normal((2, seq, 2, 16)).astype(np.float32)]


def _flat(tree, prefix="") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _ref_ctx(JCtx, JQ):
    return JCtx(quant=JQ(fmt="hif4"), remat=False, attn_q_chunk=SEQ,
                attn_k_chunk=SEQ)


def reference_runs(out: str) -> dict:
    """The reference's flash gradients, one train step and the loop's
    trajectory; arrays to ``out/ref.npz`` (f32: every bf16 value is exact
    there), checkpoints under ``out``. Run by :func:`ref` in a process of
    its own."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget_arch
    from repro.core.qlinear import QuantConfig as JQ
    from repro.core.qlinear import qmatmul as jqmatmul
    from repro.data import SyntheticLMDataset as JData
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.models import lm as JL
    from repro.models.attention import AttnChunking as JChunk
    from repro.models.attention import flash_mha as jflash
    from repro.models.common import ModelCtx as JCtx
    from repro.models.params import init_from_specs
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.optim.adamw import adamw_init_specs
    from repro.runtime import TrainLoopConfig as JLoop
    from repro.runtime import train as jtrain

    arrays, summary = {}, {}

    def put(prefix, tree):
        for k, v in _flat(tree).items():
            arrays[f"{prefix}/{k}"] = np.asarray(v, np.float32)

    for name, (seq, cq, ck) in FLASH_CASES.items():
        q, k, v = (jnp.asarray(a) for a in _flash_inputs(seq))
        for causal in (True, False):
            def loss(q, k, v):
                o = jflash(q, k, v, causal, 0, JChunk(cq, ck))
                return jnp.sum(jnp.sin(o.astype(jnp.float32)))
            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
            for n, g in zip("qkv", grads):
                arrays[f"flash/{name}/{causal}/d{n}"] = np.asarray(g)

    for name in QMATMUL_DTYPES:
        x, w = (jnp.asarray(a).astype(name) for a in _qmatmul_inputs())

        def qloss(x, w):
            y = jqmatmul(x, w, JQ(fmt="hif4"), accum_dtype=jnp.float32)
            return jnp.sum(jnp.sin(y)), y
        (_, y), grads = jax.jit(jax.value_and_grad(
            qloss, argnums=(0, 1), has_aux=True))(x, w)
        arrays[f"qmatmul/{name}/y"] = np.asarray(y.astype(jnp.float32))
        for n, g in zip("xw", grads):
            arrays[f"qmatmul/{name}/d{n}"] = np.asarray(g.astype(jnp.float32))

    cfg = jget_arch(ARCH).reduced()
    ctx = _ref_ctx(JCtx, JQ)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    put("init", params)
    data = JData(cfg.vocab, SEQ, BATCH, seed=0)
    batches = [np.asarray(data.batch_at(i)["tokens"]) for i in range(10)]
    arrays["batches"] = np.stack(batches).astype(np.float32)
    batch = {"tokens": jnp.asarray(batches[0])}

    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JL.train_loss(p, batch, cfg, ctx)))(params)
    summary["loss"] = float(loss)
    put("grad", grads)
    opt = JOpt(**OPT)
    for m in (1, 2):
        ostate = init_from_specs(adamw_init_specs(JL.abstract_params(cfg)),
                                 jax.random.PRNGKey(0))
        new_p, new_o, stats = jax.jit(jmake_train_step(
            cfg, ctx, opt, num_microbatches=m))(params, ostate, batch)
        summary[f"step_loss{m}"] = float(stats["loss"])
        summary[f"grad_norm{m}"] = float(stats["grad_norm"])
        put(f"step{m}", new_p)
        put(f"m{m}", new_o["m"])

    loop = dict(LOOP)
    _, _, hist = jtrain(cfg, ctx, JLoop(steps=10, checkpoint_dir=os.path.join(
        out, "ref"), **loop), opt_cfg=opt)
    summary["traj"] = hist["loss"]
    np.savez(os.path.join(out, "ref.npz"), **arrays)
    return summary


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_ref"))
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            (os.path.join(REPO, "src"), os.path.join(REPO, "tests"))))
    run = subprocess.run(
        [sys.executable, "-c", "import json, sys, test_torch_train as t; "
         "print(json.dumps(t.reference_runs(sys.argv[1])))", out],
        env=env, capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    summary = json.loads(run.stdout.strip().splitlines()[-1])
    arrays = dict(np.load(os.path.join(out, "ref.npz")))
    return {"dir": out, "summary": summary, "arrays": arrays}


def _tree(ref, prefix: str, like: dict) -> dict:
    """The reference's tree ``prefix`` as tensors in the dtypes of ``like``."""
    flat = _flat(like)
    return _unflat({k: torch.from_numpy(ref["arrays"][f"{prefix}/{k}"]).to(
        flat[k].dtype) for k in flat})


CFG = get_arch(ARCH).reduced()


def _port_params(ref) -> dict:
    return _tree(ref, "init", lm.init_params(CFG, 0, device="cpu"))


def _ctx(remat=False):
    return ModelCtx(quant=QuantConfig(fmt="hif4"), remat=remat,
                    attn_q_chunk=SEQ, attn_k_chunk=SEQ)


def _batch(ref, i: int) -> dict:
    return {"tokens": torch.from_numpy(ref["arrays"]["batches"][i]).long()}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)),
                                                1e-30))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def naive_attention(q, k, v, causal=True):
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    rep = H // Hkv
    qf = q.to(torch.float32).reshape(B, Sq, Hkv, rep, D) / (D ** 0.5)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.to(torch.float32))
    if causal:
        mask = torch.arange(Sq)[:, None] >= torch.arange(Sk)[None, :]
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, D).to(q.dtype)


def _flash_grads(fn, seq):
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _flash_inputs(seq))
    loss = torch.sum(torch.sin(fn(q, k, v).to(torch.float32)))
    return torch.autograd.grad(loss, (q, k, v))


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_naive_attention(case, causal):
    seq, cq, ck = FLASH_CASES[case]
    got = _flash_grads(lambda q, k, v: flash_mha(q, k, v, causal, 0,
                                                 AttnChunking(cq, ck)), seq)
    want = _flash_grads(lambda q, k, v: naive_attention(q, k, v, causal), seq)
    for a, b, name in zip(got, want, "qkv"):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0,
                                   msg=f"d{name} (causal={causal}, {case})")


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_the_reference_vjp(ref, case, causal):
    seq, cq, ck = FLASH_CASES[case]
    got = _flash_grads(lambda q, k, v: flash_mha(q, k, v, causal, 0,
                                                 AttnChunking(cq, ck)), seq)
    for g, name in zip(got, "qkv"):
        want = torch.from_numpy(ref["arrays"][f"flash/{case}/{causal}/d{name}"])
        torch.testing.assert_close(g, want, atol=3e-5, rtol=0)


def test_flash_forward_is_the_serving_forward_bitwise():
    """Recording autograd changes no bit of the forward, bf16 operands."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _flash_inputs(96))
    ch = AttnChunking(32, 48)
    for causal in (True, False):
        with torch.no_grad():
            served = flash_attention(q, k, v, causal=causal, chunking=ch)
        trained = flash_attention(q.clone().requires_grad_(True), k, v,
                                  causal=causal, chunking=ch)
        assert trained.grad_fn is not None
        assert torch.equal(served.view(torch.int16),
                           trained.detach().view(torch.int16))


def test_flash_grads_with_a_query_offset():
    """q_offset shifts the causal mask: the last 32 queries of a 64-token
    sequence against all 64 keys equal the full run's rows."""
    q, k, v = (torch.from_numpy(a)[:, :64] for a in _flash_inputs(96))
    full = flash_mha(q, k, v, True, 0, AttnChunking(16, 32))
    tail = flash_mha(q[:, 32:], k, v, True, 32, AttnChunking(16, 32))
    torch.testing.assert_close(tail, full[:, 32:], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the straight-through estimator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["hif4", "nvfp4", "mxfp4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ste_forward_is_the_qdq_and_its_gradient_the_identity(fmt, dtype):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(8, 256, generator=g) * torch.logspace(
        -6, 3, 256)).to(dtype)
    x[0, :64] = 0.0
    cfg = QuantConfig(fmt=fmt)
    want = get_format(fmt).qdq(x, axis=-1)          # the serving path's QDQ
    xr = x.clone().requires_grad_(True)
    got = quantize_activation(xr, cfg)
    assert got.dtype == dtype and got.grad_fn is not None
    # equal in value; a QDQ -0 comes back +0 (the reference's x + (q - x))
    assert torch.equal(got.detach(), want)
    same_bits = got.detach().view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32) == want.view(
        torch.int16 if dtype == torch.bfloat16 else torch.int32)
    assert bool(torch.all(same_bits | (want == 0)))
    w = torch.randn(x.shape, generator=g).to(dtype)
    (grad,) = torch.autograd.grad(torch.sum(got * w), xr)
    assert torch.equal(grad, w)
    with torch.no_grad():                           # serving: the QDQ itself
        assert torch.equal(quantize_activation(xr, cfg).view(torch.uint8),
                           want.view(torch.uint8))


@pytest.mark.parametrize("name", QMATMUL_DTYPES)
def test_qmatmul_and_its_gradients_match_the_reference(ref, name):
    """``qmatmul`` at hif4 (impl qdq): both operands through the STE, an
    f32 dot, the output in the operands' dtype; its output and the
    gradients of both operands."""
    dtype = getattr(torch, name)
    x, w = (torch.from_numpy(a).to(dtype).requires_grad_(True)
            for a in _qmatmul_inputs())
    y = qmatmul(x, w, QuantConfig(fmt="hif4"), accum_dtype=torch.float32)
    assert y.dtype == dtype and y.shape == (4, 8, 64)
    grads = torch.autograd.grad(torch.sum(torch.sin(y)), (x, w))
    assert all(g.dtype == dtype for g in grads)
    want = {k: torch.from_numpy(ref["arrays"][f"qmatmul/{name}/{k}"])
            for k in ("y", "dx", "dw")}
    for k, got in zip(("y", "dx", "dw"), (y, *grads)):
        assert _rel(got.detach().float(), want[k]) <= QMATMUL_REL[name], k


# ---------------------------------------------------------------------------
# one train step against the reference
# ---------------------------------------------------------------------------


def _loss_and_grads(params, batch, ctx, cfg=CFG):
    leaves = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = lm.train_loss(params, batch, cfg, ctx)
    return loss.detach(), dict(zip(_flat(params), _grads(loss, leaves)))


def test_loss_and_every_gradient_match_the_reference(ref):
    loss, grads = _loss_and_grads(_port_params(ref), _batch(ref, 0), _ctx())
    want = ref["summary"]["loss"]
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want), (float(loss), want)
    assert set(grads) == {k[len("grad/"):] for k in ref["arrays"]
                          if k.startswith("grad/")}
    rels = {path: _rel(g, torch.from_numpy(ref["arrays"][f"grad/{path}"]))
            for path, g in grads.items()}
    print(f"loss {float(loss)} vs {want}; gradient rel {rels}")
    assert max(rels.values()) <= GRAD_REL, rels


def test_remat_changes_no_bit():
    params = lm.init_params(CFG, 0, device="cpu")
    batch = {"tokens": torch.randint(0, CFG.vocab, (2, SEQ),
                                     generator=torch.Generator().manual_seed(0))}
    l0, g0 = _loss_and_grads(params, batch, _ctx(remat=False))
    l1, g1 = _loss_and_grads(params, batch, _ctx(remat=True))
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("m", [1, 2])
def test_train_step_matches_the_reference(ref, m):
    params = _port_params(ref)
    opt_state = adamw_init(params)
    step = make_train_step(CFG, _ctx(), AdamWConfig(**OPT), num_microbatches=m)
    params, opt_state, stats = step(params, opt_state, _batch(ref, 0))
    want = ref["summary"][f"step_loss{m}"]
    assert abs(float(stats["loss"]) - want) <= LOSS_RTOL * abs(want)
    assert abs(float(stats["grad_norm"]) - ref["summary"][f"grad_norm{m}"]) \
        <= GRAD_REL * ref["summary"][f"grad_norm{m}"]
    assert int(opt_state["step"]) == 1
    # AdamW's first step moves each element by about lr_1 = lr / warmup
    # (m / sqrt(v) = sign(g)); an element may differ by two such steps where
    # the gradient's sign differs (a bias the softmax cancels has a
    # gradient of rounding noise) and by bf16's rounding of the result
    lr_1 = OPT["lr"] / OPT["warmup_steps"]
    worst, rel_w, rel_m = 0.0, {}, {}
    for path, p in _flat(params).items():
        want_p = torch.from_numpy(ref["arrays"][f"step{m}/{path}"])
        d = (p.detach().float() - want_p).abs() - 2 ** -7 * want_p.abs()
        worst = max(worst, float(d.max()) / lr_1)
        if path.rsplit("/", 1)[-1].startswith("w") or path == "embed":
            rel_w[path] = _rel(p.detach(), want_p)
        rel_m[path] = _rel(_get(opt_state["m"], path),
                           torch.from_numpy(ref["arrays"][f"m{m}/{path}"]))
    print(f"m={m}: loss {float(stats['loss'])} vs {want}; params within "
          f"{worst:.3f} steps, weights rel {max(rel_w.values())}, first "
          f"moment rel {max(rel_m.values())}")
    assert worst <= 2.05
    assert max(rel_w.values()) <= PARAM_REL, rel_w
    assert max(rel_m.values()) <= GRAD_REL, rel_m


def _get(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def test_prefill_and_serve_steps_are_greedy_over_lm():
    params = lm.init_params(CFG, 0, device="cpu")
    ctx = ModelCtx(attn_q_chunk=8, attn_k_chunk=8)
    tokens = torch.randint(0, CFG.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        token, cache = make_prefill_step(CFG, ctx)(params, {"tokens": tokens})
        logits, _ = lm.prefill(params, {"tokens": tokens}, CFG, ctx)
        assert token.dtype == torch.int32
        assert torch.equal(token, torch.argmax(logits, -1).to(torch.int32))
        cache = lm.pad_cache(cache, CFG, 16)
        nxt, _ = make_serve_step(CFG, ctx)(params, cache, token)
        assert nxt.shape == (2,) and nxt.dtype == torch.int32


def test_microbatches_agree():
    params = lm.init_params(CFG, 0, device="cpu")
    batch = {"tokens": torch.randint(0, CFG.vocab, (BATCH, SEQ),
                                     generator=torch.Generator().manual_seed(1))}
    out = []
    for m in (1, 2):
        p = _unflat({k: t.clone() for k, t in _flat(params).items()})
        o = adamw_init(p)
        p, o, stats = make_train_step(CFG, _ctx(), AdamWConfig(**OPT),
                                      num_microbatches=m)(p, o, batch)
        out.append((float(stats["loss"]), p, o))
    assert abs(out[0][0] - out[1][0]) <= 1e-6 * abs(out[0][0])
    # f32 sums in another order; the key bias's gradient is rounding noise
    for path in _flat(params):
        assert _rel(_get(out[1][2]["m"], path), _get(out[0][2]["m"], path)) \
            <= 1e-2, path


# ---------------------------------------------------------------------------
# the train loop: trajectory, kill and resume
# ---------------------------------------------------------------------------


class ReferenceBatches:
    """The reference dataset's batches as the port's loop's data source."""

    def __init__(self, ref):
        self.ref, self.seed, self.step = ref, 0, 0

    def batch_at(self, step: int) -> dict:
        return _batch(self.ref, step)

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: dict) -> None:
        assert int(d["seed"]) == self.seed
        self.step = int(d["step"])


def _train(ref, steps, ckpt_dir=None, params=None):
    return train(CFG, _ctx(), TrainLoopConfig(steps=steps, checkpoint_dir=ckpt_dir,
                                              **LOOP),
                 opt_cfg=AdamWConfig(**OPT), device="cpu",
                 params=params if params is not None else _port_params(ref),
                 data=ReferenceBatches(ref))


@pytest.fixture(scope="module")
def trajectory(ref, tmp_path_factory):
    """The port's 10-step run, its run killed after 6 and resumed, and its
    resume from the reference's killed run's checkpoint."""
    root = tmp_path_factory.mktemp("train_port")
    _, _, full = _train(ref, 10, str(root / "full"))
    _train(ref, 6, str(root / "killed"))
    assert latest_step(str(root / "killed")) == 6
    _, _, resumed = _train(ref, 10, str(root / "killed"))
    # the reference's run keeps steps 4, 8 and 10: resume from its step 8
    from_ref = root / "from_ref"
    shutil.copytree(os.path.join(ref["dir"], "ref", "step_00000008"),
                    from_ref / "step_00000008")
    _, _, crossed = _train(ref, 10, str(from_ref))
    return {"full": full, "resumed": resumed, "crossed": crossed,
            "root": root}


def test_trajectory_follows_the_reference(ref, trajectory):
    want = ref["summary"]["traj"]
    got = trajectory["full"]["loss"]
    print(f"port {got}\nreference {want}")
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert np.mean(got[-3:]) < np.mean(got[:3])


def test_kill_and_resume_repeats_the_uninterrupted_losses(trajectory):
    """The port's own kill-and-resume: steps 6..9 again, the same losses
    bitwise on the CPU (the reference holds its own at rtol 1e-5)."""
    full, resumed = trajectory["full"]["loss"], trajectory["resumed"]["loss"]
    assert len(resumed) == 4
    assert resumed == full[-4:]


def test_resume_from_a_reference_checkpoint(ref, trajectory):
    """The reference's checkpoint at step 8 (params, AdamW state, data
    iterator) resumes in the port, which then follows the reference's run."""
    crossed = trajectory["crossed"]["loss"]
    assert len(crossed) == 2
    np.testing.assert_allclose(crossed, ref["summary"]["traj"][-2:],
                               rtol=TRAJ_RTOL)


def test_checkpoints_keep_the_newest_three(trajectory):
    names = sorted(os.listdir(trajectory["root"] / "full"))
    assert names == ["step_00000004", "step_00000008", "step_00000010"]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    rc = front_door.main(["train", "--arch", ARCH, "--reduced", "--device",
                          "cpu", "--steps", "3", "--global-batch", "2",
                          "--seq-len", "16", "--log-every", "1",
                          "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    text = capsys.readouterr().out
    assert text.count(" loss ") == 3
    assert "final loss:" in text and "tokens/s" in text
    assert latest_step(str(tmp_path)) == 3


def test_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        front_door.main(["train", "--arch", ARCH, "--reduced", "--steps", "1"])


def test_launcher_layers_cuts_the_depth(monkeypatch, capsys):
    """``--layers N`` trains the config's first N layers at its width; a
    depth beyond the config's is refused."""
    from repro_torch.runtime import train_loop

    seen = {}

    def fake_train(cfg, ctx, loop, **kw):
        seen["cfg"] = cfg
        return None, None, {"loss": [1.0], "step_time": [0.1], "stragglers": []}

    monkeypatch.setattr(train_loop, "train", fake_train)
    args = ["train", "--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
            "--steps", "1"]
    assert front_door.main(args + ["--layers", "2"]) == 0
    full = get_arch("zamba2-2.7b").reduced()
    assert seen["cfg"].n_layers == 2 and seen["cfg"].d_model == full.d_model
    assert front_door.main(args + ["--layers", str(full.n_layers + 1)]) == 2
    assert "has" in capsys.readouterr().err
