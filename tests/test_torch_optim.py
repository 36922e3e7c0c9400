"""The port's optimizer, gradient compression and synthetic data against the
JAX reference.

* AdamW: three steps (warmup, clipped, cosine) given the same params and
  gradients, ``lr_schedule`` over a warmup and a cosine, ``global_norm``.
* ``aux_load_balance_loss`` on the same router logits and choices.
* ``qdq_flat`` values and ``pack_flat`` bytes bitwise the reference's;
  error feedback keeps the sum of sent gradients unbiased (as
  ``tests/test_substrate.py`` checks the reference).
* ``compressed_psum`` on 4 gloo ranks (``torch.distributed``, a process
  each): within the reference test's rel < 0.15 of the mean, each rank's
  packed bytes equal to the reference's, and the result beside the
  reference's on 4 XLA host devices; the data-parallel train step at world
  size 1.
* The synthetic dataset: determinism, resume from ``state_dict``, and the
  affine recurrence's agreement > 0.85.

The reference runs once, in a process of its own (excess precision off,
four XLA host devices).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.qlinear import QuantConfig
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.models.moe import aux_load_balance_loss
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm, lr_schedule
from repro_torch.optim.grad_compress import (
    compressed_psum,
    ef_compress_step,
    make_dp_compressed_train_step,
    pack_flat,
    qdq_flat,
    unpack_flat,
)

import test_torch_train as TT

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

OPT = {"lr": 1e-2, "warmup_steps": 2, "total_steps": 6, "clip_norm": 1.0}
# the gradient scale of each step: under the clip, over it, under it
GRAD_SCALES = (0.01, 10.0, 0.1)
SHAPES = {"a": (64, 32), "b/c": (3, 5), "b/d": (130,)}
DTYPES = {"a": "bfloat16", "b/c": "float32", "b/d": "bfloat16"}
# AdamW's f32 update differs from XLA's by the last bits of pow and cos
ADAMW_RTOL = 1e-5
N_DEV = 4


def _adamw_inputs():
    rng = np.random.default_rng(11)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for scale in GRAD_SCALES]
    return params, grads


def _router_inputs():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((2, 16, 8)).astype(np.float32)
    idx = np.argsort(-logits, axis=-1, kind="stable")[..., :2].astype(np.int32)
    return logits, idx


def _flat_inputs():
    rng = np.random.default_rng(13)
    return {"small": (rng.standard_normal(777) * 1e-6).astype(np.float32),
            "wide": (rng.standard_normal((33, 70)) * np.logspace(
                -8, 4, 70)).astype(np.float32)}


def _psum_inputs():
    return (np.random.default_rng(14).standard_normal((N_DEV, 1024))
            * 0.1).astype(np.float32)


def reference_optim() -> dict:
    """The reference's AdamW steps, schedule, norm, aux loss, flat
    compression and 4-device compressed_psum. Run by :func:`ref` in a
    process of its own."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.models.moe import aux_load_balance_loss as jaux
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.optim.adamw import adamw_update as jupdate
    from repro.optim.adamw import global_norm as jnorm
    from repro.optim.adamw import lr_schedule as jlr
    from repro.optim.grad_compress import compressed_psum as jpsum
    from repro.optim.grad_compress import pack_flat as jpack
    from repro.optim.grad_compress import qdq_flat as jqdq
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    # whole functions jitted: op by op, JAX compiles each of Algorithm 1's
    # ops on its own
    jpack, jqdq = jax.jit(jpack), jax.jit(jqdq)
    out = {}
    opt = JOpt(**OPT)
    params, grads = _adamw_inputs()
    p = TT._unflat({k: jnp.asarray(v, DTYPES[k]) for k, v in params.items()})
    o = {"m": jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, jnp.float32), p),
         "v": jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, jnp.float32), p),
         "step": jnp.zeros((), jnp.int32)}
    steps = []
    for g in grads:
        gt = TT._unflat({k: jnp.asarray(v, DTYPES[k]) for k, v in g.items()})
        p, o, stats = jax.jit(lambda p, g, o: jupdate(p, g, o, opt))(p, gt, o)
        steps.append({"params": {k: np.asarray(v, np.float32).tolist()
                                 for k, v in TT._flat(p).items()},
                      "m": {k: np.asarray(v).tolist()
                            for k, v in TT._flat(o["m"]).items()},
                      "v": {k: np.asarray(v).tolist()
                            for k, v in TT._flat(o["v"]).items()},
                      "grad_norm": float(stats["grad_norm"]),
                      "lr": float(stats["lr"])})
    out["adamw"] = steps
    out["lr"] = [float(jlr(opt, jnp.asarray(s, jnp.int32))) for s in range(9)]
    out["norm"] = float(jnorm(TT._unflat({k: jnp.asarray(v) for k, v in
                                          grads[1].items()})))
    logits, idx = _router_inputs()
    out["aux"] = float(jaux(jnp.asarray(logits), jnp.asarray(idx), 8))
    flat = {}
    for name, x in _flat_inputs().items():
        codes, meta, n = jpack(jnp.asarray(x))
        flat[name] = {"qdq": np.asarray(jqdq(jnp.asarray(x))).tolist(),
                      "codes": np.asarray(codes).tolist(),
                      "meta": np.asarray(meta).tolist(), "n": int(n)}
    out["flat"] = flat
    x = _psum_inputs()
    mesh = jax.make_mesh((N_DEV,), ("data",))

    def body(v):
        return jpsum(v[0], "data", N_DEV)[None]
    try:
        f = shard_map(body, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                      check_vma=False)
    except TypeError:
        f = shard_map(body, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                      check_rep=False)
    out["psum"] = np.asarray(jax.jit(f)(jnp.asarray(x))).tolist()
    out["psum_sent"] = [np.asarray(jpack(jnp.asarray(x[i]))[0]).tolist()
                        for i in range(N_DEV)]
    return out


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false",
        f"--xla_force_host_platform_device_count={N_DEV}"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            (os.path.join(TT.REPO, "src"), os.path.join(TT.REPO, "tests"))))
    run = subprocess.run(
        [sys.executable, "-c", "import json, test_torch_optim as t; "
         "print(json.dumps(t.reference_optim()))"],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tensor(a, name):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, DTYPES[name]))


def test_adamw_steps_match_the_reference(ref):
    params, grads = _adamw_inputs()
    p = TT._unflat({k: _tensor(v, k) for k, v in params.items()})
    o = adamw_init(p)
    opt = AdamWConfig(**OPT)
    for i, g in enumerate(grads):
        stats = adamw_update(p, TT._unflat({k: _tensor(v, k)
                                            for k, v in g.items()}), o, opt)
        want = ref["adamw"][i]
        assert int(o["step"]) == i + 1
        assert float(stats["lr"]) == pytest.approx(want["lr"], rel=ADAMW_RTOL)
        assert float(stats["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                          rel=ADAMW_RTOL)
        for k in SHAPES:
            # by each moment's relative norm: global_norm's f32 sums run in
            # another order (1e-6 relative), and an element where the
            # moment's two terms cancel carries that as a larger relative
            # error of its own
            for name, tree in (("m", o["m"]), ("v", o["v"])):
                got, want_t = TT._get(tree, k), torch.tensor(want[name][k])
                assert TT._rel(got, want_t) <= ADAMW_RTOL, (name, k, i)
            # the params' own dtype: at most one bf16 rounding step apart
            got = TT._get(p, k).float().numpy()
            ulp = 2.0 ** -7 if DTYPES[k] == "bfloat16" else 2.0 ** -20
            np.testing.assert_allclose(got, np.asarray(want["params"][k]),
                                       rtol=ulp, atol=0, err_msg=f"{k} step {i}")


def test_opt_state_from_jax_carries_the_bits():
    import jax.numpy as jnp

    from repro_torch import interop

    params, grads = _adamw_inputs()
    state = {"m": TT._unflat({k: jnp.asarray(v) for k, v in params.items()}),
             "v": TT._unflat({k: jnp.asarray(v) for k, v in grads[0].items()}),
             "step": jnp.asarray(3, jnp.int32)}
    got = interop.opt_state_from_jax(state, device="cpu")
    assert got["step"].dtype == torch.int32 and got["step"].shape == ()
    assert int(got["step"]) == 3
    for k in SHAPES:
        assert torch.equal(TT._get(got["m"], k), torch.from_numpy(params[k]))
        assert torch.equal(TT._get(got["v"], k), torch.from_numpy(grads[0][k]))
    with pytest.raises(ValueError, match="m, v and step"):
        interop.opt_state_from_jax({"m": {}}, device="cpu")


def test_lr_schedule_and_global_norm_match_the_reference(ref):
    opt = AdamWConfig(**OPT)
    got = [float(lr_schedule(opt, torch.tensor(s, dtype=torch.int32)))
           for s in range(9)]
    np.testing.assert_allclose(got, ref["lr"], rtol=ADAMW_RTOL)
    assert got[0] == 0.0 and got[2] == pytest.approx(OPT["lr"])
    assert got[-1] == pytest.approx(OPT["lr"] * 0.1)       # the floor
    _, grads = _adamw_inputs()
    norm = global_norm(TT._unflat({k: torch.from_numpy(v)
                                   for k, v in grads[1].items()}))
    assert float(norm) == pytest.approx(ref["norm"], rel=1e-6)


def test_aux_load_balance_loss_matches_the_reference(ref):
    logits, idx = _router_inputs()
    got = aux_load_balance_loss(torch.from_numpy(logits), torch.from_numpy(idx),
                                8)
    assert float(got) == pytest.approx(ref["aux"], rel=1e-6)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(_flat_inputs()))
def test_flat_compression_is_the_reference_bitwise(ref, name):
    x = torch.from_numpy(_flat_inputs()[name])
    want = ref["flat"][name]
    assert torch.equal(qdq_flat(x), torch.tensor(want["qdq"], dtype=torch.float32))
    codes, meta, n = pack_flat(x)
    assert n == want["n"] == x.numel()
    assert np.array_equal(codes.numpy(), np.asarray(want["codes"], np.uint8))
    assert np.array_equal(meta.numpy().view(np.uint32),
                          np.asarray(want["meta"], np.uint32))
    back = unpack_flat(codes, meta, n, x.shape)
    assert torch.equal(back, qdq_flat(x))


def test_error_feedback_is_unbiased_over_steps():
    g = torch.Generator().manual_seed(0)
    g_true, g_sent, err = torch.zeros(1000), torch.zeros(1000), torch.zeros(1000)
    for i in range(20):
        grad = torch.randn(1000, generator=g) * 10.0 ** ((i % 5) - 2)
        q, err = ef_compress_step(grad, err)
        g_true += grad
        g_sent += q
    resid = float(torch.linalg.norm(g_true - g_sent - err))
    assert resid < 1e-3 * float(torch.linalg.norm(g_true)), resid


def _rank(rank: int, port: int, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=N_DEV, rank=rank)
    x = torch.from_numpy(_psum_inputs()[rank])
    got = compressed_psum(x)
    sent = pack_flat(x)[0]
    torch.save({"got": got, "sent": sent}, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_compressed_psum_on_four_gloo_ranks(ref, tmp_path):
    code = ("import sys, torch.multiprocessing as mp, test_torch_optim as t\n"
            "mp.spawn(t._rank, args=(int(sys.argv[1]), sys.argv[2]), "
            f"nprocs={N_DEV})\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        (os.path.join(TT.REPO, "src"), os.path.join(TT.REPO, "tests"))))
    run = subprocess.run([sys.executable, "-c", code, str(_free_port()),
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    x = _psum_inputs()
    mean = x.mean(axis=0)
    ref_out = np.asarray(ref["psum"], np.float32)
    results = [torch.load(tmp_path / f"rank{r}.pt") for r in range(N_DEV)]
    for r, res in enumerate(results):
        got = res["got"].numpy()
        assert np.linalg.norm(got - mean) / np.linalg.norm(mean) < 0.15
        assert np.array_equal(res["sent"].numpy(),
                              np.asarray(ref["psum_sent"][r], np.uint8))
        assert np.array_equal(got, results[0]["got"].numpy())  # all ranks agree
        # the reference's 4-device result: the same up to the f32 mean's
        # summation order re-rounding a value at a HiF4 rounding boundary
        assert np.mean(got == ref_out[r]) > 0.99


def test_dp_compressed_step_at_world_size_one():
    """Without a process group the DP step is one rank: its gradient is
    the error-fed HiF4 QDQ of the local gradient, and its error feedback
    holds what the QDQ dropped."""
    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    ctx = ModelCtx(quant=QuantConfig(fmt="hif4"), remat=False,
                   attn_q_chunk=16, attn_k_chunk=16)
    batch = next(SyntheticLMDataset(cfg.vocab, 16, 2, seed=1))
    step = make_dp_compressed_train_step(
        lambda p, b: lm.train_loss(p, b, cfg, ctx),
        lambda p, g, o: adamw_update(p, g, o, AdamWConfig(lr=1e-2,
                                                         warmup_steps=1)))
    before = TT._flat({k: v for k, v in params.items()})
    before = {k: v.clone() for k, v in before.items()}
    err = TT._unflat({k: torch.zeros(v.shape) for k, v in before.items()})
    _, opt, err, stats = step(params, adamw_init(params), err, batch)
    assert int(opt["step"]) == 1 and torch.isfinite(stats["loss"])
    moved = [not torch.equal(before[k], v.detach())
             for k, v in TT._flat(params).items()]
    assert all(moved), moved
    assert any(float(e.abs().max()) > 0 for e in TT._flat(err).values())


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------


def test_dataset_is_deterministic():
    d1, d2 = (SyntheticLMDataset(512, 32, 4, seed=7) for _ in range(2))
    for _ in range(3):
        assert torch.equal(next(d1)["tokens"], next(d2)["tokens"])
    other = SyntheticLMDataset(512, 32, 4, seed=8)
    assert not torch.equal(other.batch_at(0)["tokens"], d1.batch_at(0)["tokens"])


def test_dataset_resumes_from_its_state():
    d1 = SyntheticLMDataset(512, 32, 4, seed=7)
    for _ in range(5):
        next(d1)
    state = d1.state_dict()
    want = next(d1)
    d2 = SyntheticLMDataset(512, 32, 4, seed=7)
    d2.load_state_dict(state)
    assert torch.equal(next(d2)["tokens"], want["tokens"])
    with pytest.raises(ValueError, match="seed"):
        SyntheticLMDataset(512, 32, 4, seed=8).load_state_dict(state)


def test_dataset_follows_the_affine_recurrence():
    b = next(SyntheticLMDataset(512, 64, 8, seed=0))["tokens"]
    assert b.shape == (8, 64) and int(b.max()) < 512
    agree = torch.mean(((31 * b[:, :-1] + 17) % 512 == b[:, 1:]).float())
    assert float(agree) > 0.85, float(agree)
