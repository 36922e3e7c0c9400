"""Ground rules of the PyTorch port.

* No file of ``src/repro_torch``, no example of the port
  (``examples/torch_*.py``) and not ``chip_smoke.py`` imports JAX or
  anything of the JAX package (an AST scan of every import).
* Entry points run on ``cuda`` unless the caller asks for the CPU: without a
  CUDA device they raise instead of running on the CPU.
* What the port carries (the NVFP4/MXFP4 formats, the journal, every
  architecture and family, the train mode, the dry run and its breakdown)
  resolves; what it does not is a typed error.
"""
import ast
import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import __main__ as front_door
from repro_torch import interop
from repro_torch.calibrate import calibrate
from repro_torch.configs import get_arch
from repro_torch.core.formats import get_format
from repro_torch.device import resolve_device
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.runtime.guard import RecoveryError
from repro_torch.runtime.scenario import Scenario, run_scenarios
from repro_torch.runtime.serve_loop import (
    ServeConfig,
    prepare_params_for_serving,
    serve,
    serve_requests,
)
from repro_torch.runtime.train_loop import TrainLoopConfig, train

# One intra-op thread: the suite runs several pytest-xdist workers at once,
# and torch's default pool (a thread per core in each) oversubscribes the CPU.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


EXAMPLES = ("torch_quickstart", "torch_ptq_higptq", "torch_serve_quantized",
            "torch_train_quantized_lm")


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return (files + sorted((REPO / "examples").glob("torch_*.py"))
            + [REPO / "chip_smoke.py"])


def _example_main(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


# the calibration slice's modules, named so the scans below cannot miss them
CALIBRATION_MODULES = ("core/tap.py", "core/higptq.py", "calibrate/__init__.py",
                       "calibrate/probe.py", "calibrate/search.py",
                       "calibrate/emit.py", "calibrate/run.py",
                       "launch/calibrate.py", "__main__.py")
# the training slice's modules
TRAINING_MODULES = ("core/qlinear.py", "models/attention.py", "models/common.py",
                    "models/lm.py", "models/moe.py", "data/__init__.py",
                    "data/synthetic.py", "optim/__init__.py", "optim/adamw.py",
                    "optim/grad_compress.py", "launch/steps.py",
                    "checkpoint/checkpoint.py", "runtime/train_loop.py",
                    "launch/train.py")
# the serve-cell harness's slice
SCENARIO_MODULES = ("runtime/scenario.py", "models/attention.py",
                    "launch/dryrun.py")
# the per-token KV append's slice
KV_APPEND_MODULES = ("kernels/kv_append.py", "core/kvcache.py",
                     "launch/profile.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    for rel in (CALIBRATION_MODULES + TRAINING_MODULES + SCENARIO_MODULES
                + KV_APPEND_MODULES):
        assert REPO / "src" / "repro_torch" / rel in files, rel
    for name in EXAMPLES:
        assert REPO / "examples" / f"{name}.py" in files, name
    bad = [(str(f.relative_to(REPO)), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_in_a_process_without_jax():
    """Importing every module of the port loads no JAX module."""
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "import repro_torch.checkpoint\n"
            "import repro_torch.runtime.guard, repro_torch.runtime.faults\n"
            "import repro_torch.runtime.journal\n"
            "import repro_torch.core.tap, repro_torch.core.higptq\n"
            "import repro_torch.calibrate, repro_torch.launch.calibrate\n"
            "import repro_torch.data, repro_torch.optim.adamw\n"
            "import repro_torch.optim.grad_compress, repro_torch.launch.steps\n"
            "import repro_torch.runtime.train_loop, repro_torch.launch.train\n"
            "import repro_torch.runtime.scenario\n"
            "import repro_torch.kernels.kv_append, repro_torch.launch.profile\n"
            "import repro_torch.__main__\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
            "assert not bad, bad\n"
            "assert 'jax' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


@pytest.mark.parametrize("entry", ["resolve_device", "init_params", "prepare",
                                   "serve", "interop", "launcher", "calibrate",
                                   "calibrate_launcher", "train",
                                   "train_launcher", "scenario", *EXAMPLES])
def test_entry_points_raise_without_cuda(no_cuda, entry):
    cfg = get_arch("qwen1.5-0.5b").reduced()
    calls = {
        "resolve_device": lambda: resolve_device(),
        "init_params": lambda: lm.init_params(cfg, 0),
        "prepare": lambda: prepare_params_for_serving(
            lm.init_params(cfg, 0, device="cpu"), cfg, lm.quant_plan(
                cfg, lm.QuantConfig(fmt="hif4", impl="packed"))),
        "serve": lambda: serve(cfg, lm.init_params(cfg, 0, device="cpu"),
                               {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                               ModelCtx(), ServeConfig(max_new_tokens=2)),
        "interop": lambda: interop.params_from_jax({"w": [1.0, 2.0]}),
        "launcher": lambda: launch_serve.main(["--arch", "qwen1.5-0.5b",
                                               "--reduced"]),
        "calibrate": lambda: calibrate("qwen1.5-0.5b", reduced=True),
        "calibrate_launcher": lambda: front_door.main([
            "calibrate", "--arch", "qwen1.5-0.5b", "--reduced"]),
        "train": lambda: train(cfg, ModelCtx(), TrainLoopConfig(steps=1)),
        "train_launcher": lambda: launch_train.main([
            "--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1"]),
        "scenario": lambda: run_scenarios(
            [Scenario("cell", "qwen1.5-0.5b", "packed", "hif4")], repeats=1,
            log=lambda *_: None),
        **{name: (lambda name=name: _example_main(name)([])) for name in EXAMPLES},
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_cpu_runs_only_when_asked():
    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert resolve_device("cpu").type == "cpu"


def test_not_yet_ported_parts_raise():
    assert get_format("nvfp4").name == "nvfp4"
    cfg = get_arch("qwen1.5-0.5b").reduced()
    # the journal is ported: resume without a journal_dir is a typed error
    with pytest.raises(RecoveryError, match="journal_dir"):
        serve_requests(cfg, lm.init_params(cfg, 0, device="cpu"),
                       [torch.zeros(8, dtype=torch.long)], ModelCtx(),
                       ServeConfig(max_new_tokens=2), device="cpu", resume=True)
    # every family, the train mode (the reference's train_loss and
    # repro.launch.train) and the dry-run tooling (costed on meta) are ported
    assert "enc_blocks" in lm.abstract_params(get_arch("whisper-tiny"))
    assert callable(lm.train_loss)
    assert importlib.import_module("repro_torch.launch.train") is launch_train
    assert "train" in front_door.COMMANDS
    for tool in ("dryrun", "breakdown"):
        assert front_door.COMMANDS[tool][0] == f"repro_torch.launch.{tool}"
        assert callable(importlib.import_module(
            f"repro_torch.launch.{tool}").main)
    with pytest.raises(ValueError):
        get_format("fp3")
