"""What runs on the card loads no JAX and no JAX package, and the reference
nothing of the program: by the top-level name of every import (the part
before the first dot, compared whole: ``repro_torch`` is not ``repro``),
in the sources and in a fresh interpreter."""
import ast
import os
import subprocess
import sys

from hifbench.harness.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_the_reference_none_of_the_program():
    files = sorted((ROOT / "hifbench").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path
        if "reference" in path.relative_to(ROOT / "hifbench").parts:
            assert "repro_torch" not in tops, path
            assert not any(n.startswith("hifbench.") and not n.startswith(
                "hifbench.reference") for n in _imports(path)), path


def test_fresh_interpreter_loads_neither():
    code = (
        "import sys\n"
        "import hifbench.reference.model, hifbench.reference.draw\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert not tops & {'repro_torch', 'jax', 'jaxlib', 'flax', 'repro'}, tops\n"
        "import hifbench.harness.main, hifbench.harness.program\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'repro_torch' in tops\n"
        "assert not tops & {'jax', 'jaxlib', 'flax', 'repro'}, tops\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
