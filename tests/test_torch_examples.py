"""The port's examples (``examples/torch_*.py``) on the CPU, against the
reference's (``examples/*.py``).

* One reference process (XLA's excess precision off, as in the other
  cross-package tests) runs ``examples/quickstart.py`` and
  ``examples/ptq_higptq.py`` as shipped, each in a thread of its own with
  its stdout captured, and saves the inputs they draw (``PRNGKey(0)`` and
  its ``fold_in`` 1-5; ``split(PRNGKey(0), 3)`` for the PTQ script) as
  ``.npy``. It starts with the module, beside the port-only tests, which
  come first.
* The port's :func:`tour` and :func:`ptq_rows` on those inputs print the
  reference's lines: the unit structure, the storage line and the dot line
  equal as strings; the MSE order equal; the MSE values and ratios, the
  matmul's relative error and the two PTQ errors within ``RTOL`` of the
  values the reference printed (plus half a unit of the last printed
  digit, the printed value's own rounding).
* ``torch_serve_quantized`` and ``torch_train_quantized_lm`` run their
  ``main`` with ``--device cpu`` at 2 steps: every row and both runs'
  lines print, bf16 reads 100.0%, and the B/value, KV bytes and packed
  sites equal the reference library's for the reduced config.
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-3
CPU = torch.device("cpu")

# run in the reference process: the two scripts as shipped, then the inputs
# they draw, saved beside their captured stdout
REFERENCE = r'''
import io, runpy, sys, threading
from pathlib import Path
import numpy as np
import jax, jax.numpy as jnp

out = Path(sys.argv[1])


class PerThread(io.TextIOBase):
    """sys.stdout for the threads: each writes into its own buffer."""
    def __init__(self, default):
        self.default, self.bufs = default, {}

    def write(self, s):
        return self.bufs.get(threading.get_ident(), self.default).write(s)


def run(name, proxy):
    buf = proxy.bufs[threading.get_ident()] = io.StringIO()
    runpy.run_path(f"examples/{name}.py", run_name="__main__")
    (out / f"{name}.txt").write_text(buf.getvalue())


sys.stdout = proxy = PerThread(sys.stdout)
threads = [threading.Thread(target=run, args=(n, proxy))
           for n in ("quickstart", "ptq_higptq")]
for t in threads:
    t.start()
for t in threads:
    t.join()
sys.stdout = proxy.default

key = jax.random.PRNGKey(0)
arrays = {"x": jax.random.normal(key, (4, 64), jnp.float32) * 0.02,
          "big": jax.random.normal(jax.random.fold_in(key, 1), (1024, 1024)) * 0.01,
          "a": jax.random.normal(jax.random.fold_in(key, 2), (64,)) * 0.1,
          "b": jax.random.normal(jax.random.fold_in(key, 3), (64,)) * 0.1,
          "m": jax.random.normal(jax.random.fold_in(key, 4), (32, 256)) * 0.1,
          "w": jax.random.normal(jax.random.fold_in(key, 5), (256, 32)) * 0.05}
K, N, S = 512, 128, 1024
kw, kx, km = jax.random.split(key, 3)
base = jax.random.normal(kx, (S, K // 8), jnp.float32)
arrays["ptq_w"] = jax.random.normal(kw, (K, N), jnp.float32) * 0.04
arrays["ptq_x"] = base @ (jax.random.normal(km, (K // 8, K)) * 0.4)
for name, v in arrays.items():
    np.save(out / f"{name}.npy", np.asarray(v))
assert all((out / f"{n}.txt").exists() for n in ("quickstart", "ptq_higptq"))
'''


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_REF: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _reference_process(tmp_path_factory):
    """Start the reference's examples as the module begins, so they overlap
    the port-only tests; :func:`reference` collects them."""
    out = tmp_path_factory.mktemp("reference_examples")
    env = dict(os.environ, XLA_FLAGS=" ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_allow_excess_precision=false"))),
        JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    _REF["dir"] = out
    _REF["proc"] = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(out)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield
    if _REF["proc"].poll() is None:
        _REF["proc"].kill()
        _REF["proc"].communicate()
    _REF.clear()


@pytest.fixture(scope="module")
def reference() -> dict:
    """{"quickstart": lines, "ptq_higptq": lines, "inputs": the quickstart's
    draws, "ptq_inputs": the PTQ script's}, f32 on the CPU."""
    if "out" not in _REF:
        _, err = _REF["proc"].communicate(timeout=600)
        assert _REF["proc"].returncode == 0, err[-4000:]
        d = _REF["dir"]

        def load(n):
            return torch.from_numpy(np.load(d / f"{n}.npy"))

        _REF["out"] = {
            "quickstart": (d / "quickstart.txt").read_text().splitlines(),
            "ptq_higptq": (d / "ptq_higptq.txt").read_text().splitlines(),
            "inputs": {n: load(n) for n in ("x", "big", "a", "b", "m", "w")},
            "ptq_inputs": {"w": load("ptq_w"), "x": load("ptq_x")}}
    return _REF["out"]


def _close(got: float, printed: str, rtol=RTOL):
    """``got`` within rtol of the printed value, plus half a unit of its
    last printed digit."""
    mantissa = printed.split("e")[0]
    decimals = len(mantissa.split(".")[1]) if "." in mantissa else 0
    exp = int(printed.split("e")[1]) if "e" in printed else 0
    want = float(printed)
    half_unit = 0.5 * 10.0 ** (exp - decimals)
    assert abs(got - want) <= rtol * abs(want) + half_unit, (got, printed)


# ---------------------------------------------------------------------------
# the port alone (these run while the reference process works)
# ---------------------------------------------------------------------------

SERVE_ROWS = ("bf16", "hif4", "nvfp4", "nvfp4_pts", "mxfp4",
              "hif4 (impl=packed)", "hif4 + hif4 kv cache",
              "policy: sens-fallback")


@pytest.fixture(scope="module")
def serve_output():
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _example("torch_serve_quantized").main(
            ["--device", "cpu", "--steps", "2", "--new-tokens", "2"])
    assert rc == 0
    return buf.getvalue().splitlines()


def test_serve_example_prints_every_row(serve_output):
    lines = serve_output
    assert lines[0] == "training reduced qwen1.5-0.5b for 2 steps ..."
    assert re.fullmatch(r"  loss \d+\.\d{3} -> \d+\.\d{3}", lines[1])
    assert "batched serving: 4 requests, 2 new tokens each" in lines
    rows = {}
    for line in lines:
        for mode in SERVE_ROWS:
            if line.startswith(f"{mode:22} "):
                rows[mode] = line
    assert list(rows) == list(SERVE_ROWS), lines
    assert rows["bf16"].split()[-1] == "100.0%"
    for mode, line in rows.items():
        pct = re.search(r"(\d+\.\d)%", line[22:])
        assert pct and 0.0 <= float(pct.group(1)) <= 100.0, (mode, line)


def test_serve_example_bytes_equal_the_reference_library(serve_output):
    from repro.configs import get_arch as ref_get_arch
    from repro.core import hif4 as ref_hif4
    from repro.core import kvcache as ref_kvcache
    from repro.core.policy import get_policy as ref_get_policy
    from repro.models import lm as ref_lm

    cfg = ref_get_arch("qwen1.5-0.5b").reduced()
    a = cfg.attn
    kv = {f: ref_kvcache.kv_bytes_per_token(a.n_kv_heads, a.d_head, f)
          * cfg.n_layers for f in ("hif4", "bf16")}
    plan = ref_lm.quant_plan(cfg, ref_get_policy("sensitive-fallback",
                                                 impl="packed"))
    bpv = f"{ref_hif4.BITS_PER_VALUE / 8:.4f}"
    text = "\n".join(serve_output)
    assert f"[{bpv} B/value resident]" in text
    assert (f"[kv {kv['hif4']} B/token vs bf16 {kv['bf16']} -> "
            f"{kv['bf16'] / kv['hif4']:.2f}x slots]") in text
    assert (f"[{len(plan.packed_paths)}/{len(plan.sites)} sites packed, "
            f"{bpv} B/value on packed sites]") in text


def test_train_example_prints_both_runs(tmp_path, capsys):
    mod = _example("torch_train_quantized_lm")
    ckpt = str(tmp_path / "ckpt")
    assert mod.main(["--device", "cpu", "--steps", "2",
                     "--ckpt-dir", ckpt]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2, lines
    for fmt, line in zip(("none", "hif4"), lines):
        assert re.fullmatch(
            rf"{fmt:6}: loss \d+\.\d{{3}} -> \d+\.\d{{3}} \(mean step \d+ms, "
            r"stragglers: \d+\)", line), line
        # the final checkpoint of each run, in the reference's layout
        assert (tmp_path / f"ckpt_{fmt}" / "step_00000002").is_dir()
    # a finished run resumes at its last step: nothing left to train
    assert mod.main(["--device", "cpu", "--steps", "2",
                     "--ckpt-dir", ckpt]) == 0
    again = capsys.readouterr().out.splitlines()
    assert again == [f"{fmt:6}: nothing to train, the checkpoint is at step 2"
                     for fmt in ("none", "hif4")]


def test_quickstart_main_runs_on_the_cpu(capsys):
    assert _example("torch_quickstart").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "equal: True" in out
    assert ("== HiF4 matmul: hif4_quantize, then bfp_decode_matmul (their "
            "plain PyTorch versions on the CPU) ==") in out


# ---------------------------------------------------------------------------
# against the reference's printed lines, on the reference's inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tour(reference):
    return _example("torch_quickstart").tour(reference["inputs"], CPU)


def test_quickstart_unit_structure_equals_the_reference(reference, tour):
    ref, (lines, _) = reference["quickstart"], tour
    assert ref[0] == lines[0] == "== HiF4 unit structure (first group) =="
    assert lines[1:7] == ref[1:7]     # the four fields, storage, blank line


def test_quickstart_mse_equals_the_reference(reference, tour):
    ref, (lines, values) = reference["quickstart"], tour
    pat = re.compile(r"  (\S+)\s+mse=(\S+)  \(x(\S+) vs hif4\)")
    ref_rows = [pat.fullmatch(x).groups() for x in ref if pat.fullmatch(x)]
    rows = [pat.fullmatch(x).groups() for x in lines if pat.fullmatch(x)]
    assert [r[0] for r in rows] == [r[0] for r in ref_rows]   # the order
    assert len(rows) == 4
    errs = values["mse"]
    for name, mse, ratio in ref_rows:
        _close(errs[name], mse)
        _close(errs[name] / errs["hif4"], ratio)


def test_quickstart_dot_line_equals_the_reference(reference, tour):
    ref, (lines, values) = reference["quickstart"], tour
    i = ref.index("== 64-length dot: integer flow vs dequantized floats ==")
    assert lines[i] == ref[i]
    assert lines[i + 1] == ref[i + 1]
    assert ref[i + 1].endswith("equal: True")
    assert values["fixed_point"] == values["dequant"]


def test_quickstart_matmul_error_matches_the_reference(reference, tour):
    ref, (lines, values) = reference["quickstart"], tour
    want = re.fullmatch(r"  output \(32, 32\), relative error vs f32 matmul: "
                        r"(\S+)%", ref[-1])
    assert want, ref[-1]
    assert lines[-1].startswith("  output (32, 32), relative error vs f32 matmul: ")
    _close(100 * values["rel"], want.group(1))
    assert tuple(values["y"].shape) == (32, 32)


def test_ptq_errors_match_the_reference(reference):
    ref = reference["ptq_higptq"]
    lines, values = _example("torch_ptq_higptq").ptq_rows(
        reference["ptq_inputs"], CPU)
    assert lines[0] == ref[0] == "layer output error ||X(W - Wq)|| / ||XW||"
    d = re.fullmatch(r"  HiF4 direct-cast : (\S+)", ref[1]).group(1)
    g = re.fullmatch(r"  HiF4 \+ HiGPTQ    : (\S+)  \(\S+% lower\)",
                     ref[2]).group(1)
    _close(values["direct"], d)
    _close(values["higptq"], g)
    assert lines[1] == ref[1]
    assert values["higptq"] < values["direct"]
