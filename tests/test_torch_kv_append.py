"""The per-token HiF4 KV append (``repro_torch.core.kvcache.append_kv`` /
``append_token`` / ``append_token_paged``; the CUDA kernel
``csrc/kv_append.cu`` behind ``repro_torch.kernels.kv_append``).

On the CPU the appends take their plain versions, which must write the
reference's bytes BITWISE (``repro.core.kvcache.append_token`` /
``append_token_paged``, jitted in one shared subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``), in every leaf of the
cache, the bytes around the token included. The cases cover zeros, bf16
subnormals, +-Inf, NaN, values at bf16's top and -0; per-slot and lockstep
positions and positions past the capacity; a token width F % 64 != 0 with
a bf16 tail; the kernel-tile and artifact layouts; pools of 16- and 64-token
pages under a ragged table with a clamped logical index.

The tests marked ``cuda`` hold the kernel bitwise to the plain version on
the card on the same cases (and at qwen1.5-0.5b's decode shape, f32 new
tokens, and retired slots colliding in the scratch page 0, which the
comparison leaves out); they skip without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kv_append.py

The wrapper's refusals (dtypes, shapes, a device mix) are checked on the
CPU, a device mix with the ``meta`` device standing in for the card.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import kvcache as TK
from repro_torch.kernels import kv_append as KA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bf16 bit patterns of the special values
BF16_MAX, BF16_INF, BF16_NAN, BF16_NEG0 = 0x7F7F, 0x7F80, 0x7FC0, 0x8000


def _bits(rng, shape, scale=1.0) -> np.ndarray:
    """bf16 bit patterns (uint16) of normal values times ``scale``."""
    f = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (f.view(np.uint32) >> 16).astype(np.uint16)


def _special(x: np.ndarray) -> np.ndarray:
    """Put the special values into new tokens x (B, n, Hkv, Dh) bits, one
    64-group each where the width allows: zeros, subnormals, +Inf, -Inf,
    NaN, bf16's top, -0 among normals."""
    b, n, h, d = x.shape
    flat = x.reshape(b * n, h * d)
    f = flat.shape[1]
    groups = [
        np.zeros(64, np.uint16),                                   # zeros
        (np.arange(1, 65, dtype=np.uint16) | np.where(
            np.arange(64) % 2, 0x8000, 0).astype(np.uint16)),      # subnormals
        None, None, None, None, None]
    for i, grp in enumerate(groups):
        row, g = divmod(i, max(f // 64, 1))
        if row >= flat.shape[0] or f < 64:
            break
        sl = flat[row, 64 * g: 64 * g + 64]
        if grp is not None:
            sl[:] = grp
        elif i == 2:
            sl[7] = BF16_INF
        elif i == 3:
            sl[40] = BF16_INF | 0x8000
        elif i == 4:
            sl[5] = BF16_NAN
        elif i == 5:
            sl[::3] = BF16_MAX
            sl[1::3] = BF16_MAX | 0x8000
        else:
            sl[::4] = BF16_NEG0
    if f % 64:                                  # the tail keeps specials too
        flat[0, -1], flat[-1, -2] = BF16_NAN, BF16_INF
    return flat.reshape(x.shape)


# The caches start as random bytes, so that a write anywhere but the token's
# bytes shows; the tails hold finite bf16 values (XLA quiets a signalling
# NaN's payload where it moves bf16 data; a cache holds no such pattern).
def _pool_cache(rng, np_pages, g, t, p) -> dict:
    return {"codes": rng.integers(0, 256, (np_pages, g * 32, p), dtype=np.uint8),
            "meta": rng.integers(0, 2 ** 32, (np_pages, g, p), dtype=np.uint32),
            "tail": _bits(rng, (np_pages, t, p))}


def _contig_cache(rng, b, g, t, s, layout) -> dict:
    if layout == "kernel":
        return _pool_cache(rng, b, g, t, s)
    return {"codes": rng.integers(0, 256, (b, s, g, 32), dtype=np.uint8),
            "meta": rng.integers(0, 2 ** 32, (b, s, g), dtype=np.uint32),
            "tail": _bits(rng, (b, s, t))}


def cases() -> dict:
    """name -> {"new": (2, B, n, Hkv, Dh) uint16 bits of K and V for n
    appends, "pos": (n, B) int64 (or a lockstep int per append), "pages":
    (B, max_pages) int32 or None, "k"/"v": the initial cache leaves (random
    bytes; meta uint32, tail bf16 bits)}; made with numpy from a seed."""
    rng = np.random.default_rng(20261018)
    out = {}

    def new(b, n, h, d, special=True):
        x = np.stack([_bits(rng, (b, n, h, d), 2.0), _bits(rng, (b, n, h, d))])
        if special:
            x[0] = _special(x[0])
            x[1, :, ::-1] = _special(x[1, :, ::-1].copy())
        return x

    # contiguous: B 4, Hkv 2, Dh 64 (F 128: 2 groups), S 8
    for layout in ("kernel", "artifact"):
        out[f"contig-{layout}-perslot"] = dict(
            new=new(4, 3, 2, 64),
            pos=np.array([[0, 3, 7, 11], [1, 4, 8, 12], [2, 5, 9, 13]]),
            pages=None, k=_contig_cache(rng, 4, 2, 0, 8, layout),
            v=_contig_cache(rng, 4, 2, 0, 8, layout))
        # Hkv 3, Dh 40: F 120 = one group and a 56-feature bf16 tail
        out[f"contig-{layout}-tail-lockstep"] = dict(
            new=new(3, 3, 3, 40), pos=[4, 5, 9], pages=None,
            k=_contig_cache(rng, 3, 1, 56, 6, layout),
            v=_contig_cache(rng, 3, 1, 56, 6, layout))
    # paged, P 16: a ragged table whose short rows end in the scratch page 0;
    # slot 2's position 60 is past its 3-page row (logical page 3 clamps to
    # 2, its page 7); slot 3's empty row writes page 0 (no other slot does)
    out["paged-16"] = dict(
        new=new(4, 2, 2, 64),
        pos=np.array([[0, 17, 60, 5], [1, 18, 61, 6]]),
        pages=np.array([[1, 2, 3], [4, 5, 0], [6, 8, 7], [0, 0, 0]], np.int32),
        k=_pool_cache(rng, 9, 2, 0, 16), v=_pool_cache(rng, 9, 2, 0, 16))
    # paged, P 64 with the tail width; slot 1's position 200 clamps to
    # logical page 1 of its row
    out["paged-64-tail"] = dict(
        new=new(3, 2, 3, 40),
        pos=np.array([[63, 200, 64], [64, 201, 65]]),
        pages=np.array([[1, 2], [3, 4], [5, 6]], np.int32),
        k=_pool_cache(rng, 7, 1, 56, 64), v=_pool_cache(rng, 7, 1, 56, 64))
    return out


def reference_appends(path: str) -> None:
    """The reference's caches after every case's appends (jitted, one
    append per tensor per step), saved to ``path`` as .npz."""
    import jax
    import jax.numpy as jnp
    from repro.core import kvcache as JK

    dense = jax.jit(JK.append_token)
    paged = jax.jit(JK.append_token_paged)
    saved = {}
    for name, c in cases().items():
        for ti, tensor in enumerate(("k", "v")):
            pk = {"codes": jnp.asarray(c[tensor]["codes"]),
                  "meta": jnp.asarray(c[tensor]["meta"]),
                  "tail": jax.lax.bitcast_convert_type(
                      jnp.asarray(c[tensor]["tail"]), jnp.bfloat16)}
            for i, pos in enumerate(c["pos"]):
                x = jax.lax.bitcast_convert_type(
                    jnp.asarray(c["new"][ti][:, i:i + 1]), jnp.bfloat16)
                if c["pages"] is None:
                    pk = dense(pk, x, jnp.asarray(pos, jnp.int32))
                else:
                    pk = paged(pk, x, jnp.asarray(pos, jnp.int32),
                               jnp.asarray(c["pages"]))
            for key, a in pk.items():
                if key == "tail":
                    a = jax.lax.bitcast_convert_type(a, jnp.uint16)
                saved[f"{name}/{tensor}/{key}"] = np.asarray(a)
    np.savez(path, **saved)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results, from one subprocess with XLA's excess
    precision off (the decode path runs the append under jit)."""
    path = str(tmp_path_factory.mktemp("kv_append") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            (os.path.join(REPO, "src"), os.path.join(REPO, "tests"))))
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, test_torch_kv_append as t; "
         "t.reference_appends(sys.argv[1])", path],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _torch_leaves(leaves: dict, dev) -> dict:
    return {"codes": torch.from_numpy(leaves["codes"].copy()).to(dev),
            "meta": torch.from_numpy(leaves["meta"].view(np.int32).copy()).to(dev),
            "tail": torch.from_numpy(leaves["tail"].view(np.int16).copy())
            .view(torch.bfloat16).to(dev)}


def _numpy_leaves(pk: dict) -> dict:
    return {"codes": pk["codes"].cpu().numpy(),
            "meta": pk["meta"].cpu().numpy().view(np.uint32),
            "tail": pk["tail"].view(torch.int16).cpu().numpy().view(np.uint16)}


def _new(bits: np.ndarray, dev, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).to(dev).to(dtype)


def port_appends(c: dict, dev, api: str = "append_kv",
                 dtype=torch.bfloat16) -> dict:
    """The port's caches after a case's appends on ``dev`` through ``api``:
    "append_kv" (K and V in one call), "per_tensor" (``append_token`` /
    ``append_token_paged`` once per tensor) or "plain"
    (``kv_append_plain``)."""
    cache = {t: _torch_leaves(c[t], dev) for t in ("k", "v")}
    pages = None if c["pages"] is None else torch.from_numpy(c["pages"]).to(dev)
    for i, pos in enumerate(c["pos"]):
        k, v = (_new(c["new"][ti][:, i:i + 1], dev, dtype) for ti in (0, 1))
        p = int(pos) if np.ndim(pos) == 0 else torch.from_numpy(
            np.asarray(pos)).to(dev)
        if api == "append_kv":
            TK.append_kv(cache, k, v, p, pages)
        elif api == "plain":
            TK.kv_append_plain([cache["k"], cache["v"]], [k, v], p, pages)
        else:
            for pk, x in ((cache["k"], k), (cache["v"], v)):
                if pages is None:
                    TK.append_token(pk, x, p)
                else:
                    TK.append_token_paged(pk, x, p, pages)
    return {t: _numpy_leaves(cache[t]) for t in ("k", "v")}


@pytest.mark.parametrize("api", ["append_kv", "per_tensor"])
@pytest.mark.parametrize("name", sorted(cases()))
def test_plain_append_bitwise_the_reference(reference, name, api):
    got = port_appends(cases()[name], "cpu", api)
    for t in ("k", "v"):
        for key, a in got[t].items():
            want = reference[f"{name}/{t}/{key}"]
            diff = np.argwhere(a != want)
            assert not len(diff), f"{name} {t}.{key}: {len(diff)} bytes differ, " \
                f"first at {diff[:4].tolist()}"


def test_special_values_pack_as_the_format_says():
    """The NaN group packs codes 0 and E6M2 code 0xBC (a NaN scale's frexp
    exponent 0), never the 0xFF sentinel; +Inf clamps the scale to E6M2's
    top (code 0xFE) and itself to S1P2 code 7; -0 keeps its sign bit (code
    8). Slot 0 holds the special groups at positions 0-2, slot 1 the -0s at
    position 3 (kernel-tile leaves (B, G*32 | G, S))."""
    got = port_appends(cases()["contig-kernel-perslot"], "cpu")["k"]
    meta, codes = got["meta"], got["codes"]
    assert meta[0, 0, 2] == 0xBC000000 and not codes[0, :32, 2].any()
    assert meta[0, 0, 1] >> 24 == 0xFE and codes[0, 3, 1] >> 4 == 7
    assert codes[1, 0, 3] & 0xF == 8
    assert not (meta[:2, :, :4] >> 24 == 0xFF).any()


def test_wrapper_refuses_dtypes_shapes_and_devices():
    c = cases()["contig-kernel-perslot"]
    cache = _torch_leaves(c["k"], "cpu")
    x = _new(c["new"][0][:, :1], "cpu")
    pos = torch.zeros(4, dtype=torch.long)
    with pytest.raises(TypeError, match="bf16 or f32"):
        KA.kv_append([cache], [x.to(torch.float16)], pos)
    with pytest.raises(TypeError, match="meta must be"):
        KA.kv_append([dict(cache, meta=cache["meta"].to(torch.int64))], [x], pos)
    with pytest.raises(ValueError, match=r"\(B, 1, Hkv, Dh\)"):
        KA.kv_append([cache], [x[:, 0]], pos)
    with pytest.raises(ValueError, match="cache leaf codes"):
        KA.kv_append([cache], [x[:, :, :1]], pos)              # F 64 != 128
    with pytest.raises(ValueError, match="pos must be"):
        KA.kv_append([cache], [x], pos[:2])
    with pytest.raises(ValueError, match="dense"):
        KA.kv_append([cache], [x.transpose(2, 3).contiguous().transpose(2, 3)],
                     pos)
    with pytest.raises(ValueError, match="one CUDA device"):
        KA.kv_append([cache], [x], pos)                        # all on the CPU
    # a device mix goes to the kernel's wrapper, which refuses it (the
    # ``meta`` device stands in for the card here)
    with pytest.raises(ValueError, match="one CUDA device"):
        TK.append_token(cache, x.to("meta"), 3)
    with pytest.raises(ValueError, match="one CUDA device"):
        TK.append_kv({"k": cache, "v": cache}, x, x.to("meta"),
                     torch.zeros(4, dtype=torch.long))


def test_artifact_codes_that_do_not_merge_raise():
    c = cases()["contig-artifact-perslot"]
    cache = _torch_leaves(c["k"], "cpu")
    cache["codes"] = cache["codes"].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="merge in place"):
        KA.leaf_views(cache)


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no interpret mode")
    return torch.device("cuda")


def _assert_equal(got: dict, want: dict, label: str, skip_page0=False):
    for t in ("k", "v"):
        for key, a in got[t].items():
            b = want[t][key]
            if skip_page0:
                a, b = a[1:], b[1:]
            diff = np.argwhere(a != b)
            assert not len(diff), f"{label} {t}.{key}: {len(diff)} differ, " \
                f"first at {diff[:4].tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(cases()))
def test_kernel_bitwise_its_plain_version(cuda, name):
    from repro_torch.kernels import build

    c = cases()[name]
    build.reset_launches()
    got = port_appends(c, cuda, "append_kv")
    assert build.LAUNCHES["kv_append"] == len(c["pos"])
    _assert_equal(got, port_appends(c, cuda, "plain"), name)
    _assert_equal(port_appends(c, cuda, "per_tensor"), got, f"{name} per tensor")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(cases()))
def test_kernel_takes_f32_tokens_as_the_plain_version(cuda, name):
    c = cases()[name]
    _assert_equal(port_appends(c, cuda, "append_kv", torch.float32),
                  port_appends(c, cuda, "plain", torch.float32), name)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_kernel_at_qwens_decode_shape(cuda, paged):
    """B 8, Hkv 16, Dh 64; the paged pool with retired slots (empty rows)
    colliding in page 0, left out of the comparison."""
    rng = np.random.default_rng(7)
    x = np.stack([_bits(rng, (8, 4, 16, 64), 3.0), _bits(rng, (8, 4, 16, 64))])
    x[0] = _special(x[0])
    if paged:
        pages = np.zeros((8, 8), np.int32)
        pages[:5] = np.arange(1, 41, dtype=np.int32).reshape(5, 8)
        c = dict(new=x, pos=np.array([[480 + i + 37 * b for b in range(8)]
                                      for i in range(4)]) % 512,
                 pages=pages, k=_pool_cache(rng, 41, 16, 0, 64),
                 v=_pool_cache(rng, 41, 16, 0, 64))
    else:
        c = dict(new=x, pos=[480, 481, 482, 483], pages=None,
                 k=_pool_cache(rng, 8, 16, 0, 488),
                 v=_pool_cache(rng, 8, 16, 0, 488))
    _assert_equal(port_appends(c, cuda, "append_kv"),
                  port_appends(c, cuda, "plain"), "qwen", skip_page0=paged)


@pytest.mark.cuda
def test_kernel_refuses_a_device_mix(cuda):
    c = cases()["contig-kernel-perslot"]
    cache = _torch_leaves(c["k"], cuda)
    x = _new(c["new"][0][:, :1], "cpu")
    with pytest.raises(ValueError, match="one CUDA device"):
        TK.append_token(cache, x, 3)
    pool = _torch_leaves(cases()["paged-16"]["k"], cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        TK.append_token_paged(pool, x.to(cuda), torch.zeros(4, dtype=torch.long),
                              torch.from_numpy(cases()["paged-16"]["pages"]))
