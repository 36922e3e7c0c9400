"""Serving artifacts of the PyTorch port vs the JAX reference.

``qwen1.5-0.5b --reduced``, the reference's seeded weights carried into the
port through ``repro_torch.interop``; everything runs on the CPU.

* ``save_serving_artifact`` of the same raw weights writes the reference's
  artifact under ``paper-iv`` and ``sensitive-fallback``: the same manifest
  arrays (file, shape, dtype, sha256), the same ``extra.json`` bytes
  (family, quant_policy, integrity block). Only the manifest's
  ``treedef`` string, which names JAX's pytree classes, differs.
* Each package loads the other's artifact, leaf for leaf.
* The leaf order and the integrity block's leaf names are the reference's
  ``jax.tree_util`` order and ``keystr`` names, computed without JAX.
* A loaded artifact serves the greedy tokens of the in-memory
  ``prepare_params_for_serving``, lockstep and paged.
* A flipped byte in a packed leaf raises ``ArtifactIntegrityError`` naming
  the leaf the reference names for the same flip; an already-packed tree
  raises ``ArtifactLayoutError``; an empty directory
  ``ArtifactNotFoundError``; ``load_checkpoint(verify=True)`` on a changed
  array ``CheckpointCorruptError``.
"""
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JC
from repro.configs import get_arch as jget_arch
from repro.core import kvcache as JK
from repro.core.policy import get_policy as jget_policy
from repro.core.qlinear import PackedW as JPackedW
from repro.models import lm as JL
from repro.runtime import guard as JG
from repro.runtime import serve_loop as JS
from repro_torch import interop
from repro_torch.checkpoint import (CheckpointCorruptError, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpoint import tree_leaves
from repro_torch.configs import get_arch
from repro_torch.core import kvcache
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import PackedW
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.runtime import guard
from repro_torch.runtime.serve_loop import (ServeConfig, load_serving_artifact,
                                            prepare_params_for_serving,
                                            save_serving_artifact, serve,
                                            serve_requests)

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

JCFG = jget_arch("qwen1.5-0.5b").reduced()
CFG = get_arch("qwen1.5-0.5b").reduced()
POLICIES = ("paper-iv", "sensitive-fallback")
STEP = "step_00000000"


def _jpolicy(name):
    return jget_policy(name, impl="packed", kv=JK.KV_HIF4)


def _tpolicy(name):
    return get_policy(name, impl="packed", kv=kvcache.KV_HIF4)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's raw weights and its artifact under each policy (the
    reference packs eagerly: ~12 s for paper-iv, once per file)."""
    params = JL.init_params(JCFG, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    dirs = {}
    for name in POLICIES:
        d = str(tmp_path_factory.mktemp(f"ref-{name}"))
        JS.save_serving_artifact(d, params, JCFG, _jpolicy(name))
        dirs[name] = d
    return {"np_params": np_params, "dirs": dirs}


@pytest.fixture(scope="module")
def port_dirs(ref, tmp_path_factory):
    dirs = {}
    for name in POLICIES:
        d = str(tmp_path_factory.mktemp(f"port-{name}"))
        save_serving_artifact(d, interop.params_from_jax(ref["np_params"], "cpu"),
                              CFG, _tpolicy(name), device="cpu")
        dirs[name] = d
    return dirs


def _read(directory, name):
    with open(os.path.join(directory, STEP, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("policy", POLICIES)
def test_artifact_equals_reference(ref, port_dirs, policy):
    want = json.loads(_read(ref["dirs"][policy], "manifest.json"))
    got = json.loads(_read(port_dirs[policy], "manifest.json"))
    assert got["n_leaves"] == want["n_leaves"] and got["step"] == want["step"] == 0
    assert got["arrays"] == want["arrays"]
    assert {a["dtype"] for a in got["arrays"]} >= {"uint8", "uint32", "bfloat16"}
    assert _read(port_dirs[policy], "extra.json") == _read(ref["dirs"][policy],
                                                           "extra.json")
    extra = json.loads(_read(port_dirs[policy], "extra.json"))
    assert extra["quant_policy"]["name"] == policy and extra["family"] == "dense"
    n_packed = len(extra["integrity"]["leaves"])
    assert n_packed == (7 if policy == "paper-iv" else 5)
    for fn in sorted(os.listdir(os.path.join(port_dirs[policy], STEP))):
        assert _read(port_dirs[policy], fn) == _read(ref["dirs"][policy], fn) \
            or fn == "manifest.json", fn


def _leaves_equal(jtree, ttree):
    jleaves = jax.tree_util.tree_flatten(jtree)[0]
    tleaves = tree_leaves(ttree)
    assert len(jleaves) == len(tleaves)
    for j, (path, t, is_meta) in zip(jleaves, tleaves):
        want = np.asarray(j)
        got = interop.to_numpy(t, uint32=is_meta)
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=str(path))


@pytest.mark.parametrize("policy", POLICIES)
def test_each_package_loads_the_others_artifact(ref, port_dirs, policy):
    tparams, tpol = load_serving_artifact(ref["dirs"][policy], CFG, device="cpu")
    jparams, jpol = JS.load_serving_artifact(port_dirs[policy], JCFG)
    assert tpol.to_json_dict() == jpol.to_json_dict()
    _leaves_equal(jparams, tparams)
    packed = [leaf for _, leaf in guard._packed_leaves(tparams)]
    assert packed and all(not p.kernel_layout for p in packed)


def test_leaf_order_and_names_are_the_references(ref):
    """tree_leaves walks the reference's pytree order (PackedW as codes then
    meta); the integrity names are jax.tree_util.keystr's."""
    jplan = JL.quant_plan(JCFG, _jpolicy("paper-iv"))
    jtarget = JL.realize_packed(JL.packed_overlay(JL.abstract_params(JCFG), jplan),
                                lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype))
    tplan = lm.quant_plan(CFG, _tpolicy("paper-iv"))
    ttarget = lm.realize_packed(lm.packed_overlay(lm.abstract_params(CFG), tplan),
                                lambda p: torch.empty(p.shape, dtype=p.dtype,
                                                      device="meta"))
    jleaves = jax.tree_util.tree_flatten(jtarget)[0]
    tleaves = tree_leaves(ttarget)
    assert [tuple(j.shape) for j in jleaves] == [tuple(t.shape) for _, t, _ in tleaves]
    jflat = jax.tree_util.tree_flatten_with_path(
        jtarget, is_leaf=lambda x: isinstance(x, JPackedW))[0]
    jnames = [jax.tree_util.keystr(p) for p, leaf in jflat
              if isinstance(leaf, JPackedW)]
    assert [n for n, _ in guard._packed_leaves(ttarget)] == jnames
    assert jnames[0] == "['blocks']['attn']['wk']"
    for (_, j), (_, t) in zip([x for x in jflat if isinstance(x[1], JPackedW)],
                              guard._packed_leaves(ttarget)):
        assert (j.shape2d, j.axes2d) == (t.shape2d, t.axes2d)


def test_integrity_record_equals_reference(ref):
    jparams = JS.prepare_params_for_serving(
        jax.tree_util.tree_map(jax.numpy.asarray, ref["np_params"]), JCFG,
        JL.quant_plan(JCFG, _jpolicy("sensitive-fallback")), kernel_layout=False)
    tparams = interop.params_from_jax(jparams, "cpu")
    assert guard.artifact_integrity(tparams) == JG.artifact_integrity(jparams)
    for name, leaf in guard._packed_leaves(tparams):
        assert guard.packed_invariants(name, leaf) == []


def _scaled(tree, f):
    if isinstance(tree, dict):
        return {k: _scaled(v, f) for k, v in tree.items()}
    return tree * f


def test_loaded_artifact_serves_the_in_memory_tokens(ref, tmp_path):
    """Weights at 5x the init's scale (tokens then vary): the artifact
    round trip changes no token, lockstep or paged."""
    raw = interop.params_from_jax(ref["np_params"], "cpu")
    raw = dict(raw, blocks=_scaled(raw["blocks"], 5), embed=raw["embed"] * 5)
    policy = _tpolicy("paper-iv")
    plan = lm.quant_plan(CFG, policy)
    ctx = ModelCtx(quant=plan.base, plan=plan, attn_q_chunk=2, attn_k_chunk=2)
    save_serving_artifact(str(tmp_path), raw, CFG, policy, device="cpu")
    loaded, lpol = load_serving_artifact(str(tmp_path), CFG, device="cpu")
    assert lpol.name == "paper-iv"
    mem = prepare_params_for_serving(raw, CFG, plan, device="cpu")
    g = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, CFG.vocab, (2, 8), generator=g)
    sc = ServeConfig(max_new_tokens=6, kv_format="hif4")
    toks = serve(CFG, loaded, {"tokens": prompts}, ctx, sc, device="cpu")
    assert torch.equal(toks, serve(CFG, mem, {"tokens": prompts}, ctx, sc,
                                   device="cpu"))
    assert len(set(toks[0].tolist())) > 1
    psc = ServeConfig(max_new_tokens=6, decode_chunk=2, kv_format="hif4",
                      kv_pages=8, kv_page_tokens=8)
    a = serve_requests(CFG, loaded, list(prompts), ctx, psc, slots=2, device="cpu")
    b = serve_requests(CFG, mem, list(prompts), ctx, psc, slots=2, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _flip_last_byte(directory, index):
    path = os.path.join(directory, STEP, f"arr_{index:05d}.npy")
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0x10                 # payload tail, clear of the .npy header
    open(path, "wb").write(bytes(blob))


def _failing_leaves(message):
    return sorted(set(re.findall(r"(\[[^\n]*?\]): (?:codes|meta)_sha256", message)))


@pytest.mark.parametrize("target", [("['blocks']['attn']['wq']", "codes"),
                                    ("['blocks']['mlp']['wo']", "meta")])
def test_flipped_byte_names_the_leaf_like_the_reference(ref, port_dirs, tmp_path,
                                                       target):
    """The same byte flipped in the same .npy of each package's artifact:
    both loads raise the integrity error naming the same leaf."""
    name, part = target
    tplan = lm.quant_plan(CFG, _tpolicy("paper-iv"))
    leaves = tree_leaves(lm.realize_packed(
        lm.packed_overlay(lm.abstract_params(CFG), tplan),
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta")))
    index = next(i for i, (path, _, is_meta) in enumerate(leaves)
                 if guard.keystr(path) == name and is_meta == (part == "meta"))
    messages = []
    for pkg, src in (("port", port_dirs["paper-iv"]),
                     ("ref", ref["dirs"]["paper-iv"])):
        d = tmp_path / pkg
        shutil.copytree(os.path.join(src, STEP), d / STEP)
        _flip_last_byte(str(d), index)
        if pkg == "port":
            with pytest.raises(guard.ArtifactIntegrityError) as e:
                load_serving_artifact(str(d), CFG, device="cpu")
        else:
            with pytest.raises(JG.ArtifactIntegrityError) as e:
                JS.load_serving_artifact(str(d), JCFG)
        messages.append(str(e.value))
    assert _failing_leaves(messages[0]) == _failing_leaves(messages[1]) == [name]
    assert f"{name}: {part}_sha256 mismatch" in messages[0]


def test_packed_tree_raises_layout_error(ref, tmp_path):
    raw = interop.params_from_jax(ref["np_params"], "cpu")
    policy = _tpolicy("paper-iv")
    packed = prepare_params_for_serving(raw, CFG, policy, device="cpu")
    with pytest.raises(guard.ArtifactLayoutError, match="already-packed"):
        save_serving_artifact(str(tmp_path / "art"), packed, CFG, policy,
                              device="cpu")
    # prepare keeps a packed tree's layout when asked for the artifact layout
    art = prepare_params_for_serving(raw, CFG, policy, kernel_layout=False,
                                     device="cpu")
    again = prepare_params_for_serving(art, CFG, policy, kernel_layout=False,
                                       device="cpu")
    assert again["blocks"]["attn"]["wq"].codes is art["blocks"]["attn"]["wq"].codes
    assert not again["blocks"]["attn"]["wq"].kernel_layout


def test_empty_directory_raises_not_found(tmp_path):
    with pytest.raises(guard.ArtifactNotFoundError, match="no serving artifact"):
        load_serving_artifact(str(tmp_path), CFG, device="cpu")
    with pytest.raises(guard.ArtifactNotFoundError):
        load_serving_artifact(str(tmp_path / "missing"), CFG, device="cpu")
    assert issubclass(guard.ArtifactNotFoundError, guard.ArtifactError)
    assert issubclass(guard.ArtifactError, guard.ServeError)


def test_checkpoint_verify_and_latest_step(tmp_path):
    """A generic tree: bf16, int32 and a PackedW; the reference loads the
    port's checkpoint; verify=True catches a changed array; latest_step
    ignores a directory without a manifest."""
    w = (torch.randn(128, 8, generator=torch.Generator().manual_seed(1)) * 0.3
         ).to(torch.bfloat16)
    tree = {"w": w, "n": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "p": PackedW.from_dense(w)}
    save_checkpoint(str(tmp_path), 3, tree, {"k": 1})
    os.makedirs(tmp_path / "step_00000009")           # incomplete: no manifest
    assert latest_step(str(tmp_path)) == 3
    got, extra = load_checkpoint(str(tmp_path), 3, tree, verify=True,
                                 device="cpu")
    assert extra == {"k": 1}
    for (_, a, _), (_, b, _) in zip(tree_leaves(tree), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jtree = {"w": jax.numpy.zeros((128, 8), jax.numpy.bfloat16),
             "n": jax.numpy.zeros((2, 3), jax.numpy.int32),
             "p": JPackedW(jax.numpy.zeros((8, 2, 32), jax.numpy.uint8),
                           jax.numpy.zeros((8, 2), jax.numpy.uint32), (128, 8))}
    jgot, _ = JC.load_checkpoint(str(tmp_path), 3, jtree, verify=True)
    np.testing.assert_array_equal(np.asarray(jgot["p"].meta),
                                  interop.to_numpy(tree["p"].meta, uint32=True))
    path = tmp_path / "step_00000003" / "arr_00000.npy"
    blob = bytearray(path.read_bytes())
    blob[-1] ^= 0x01
    path.write_bytes(bytes(blob))
    with pytest.raises(CheckpointCorruptError, match="sha256"):
        load_checkpoint(str(tmp_path), 3, tree, verify=True, device="cpu")
