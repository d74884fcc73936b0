"""The port stands alone: no module of `vosesam_tpu_torch/`, and not
`chip_smoke.py`, imports `jax` or the JAX package `vosesam_tpu` (not even
its modules that need no JAX), so the port runs where JAX is not installed.
Checked twice: by reading every import statement, and by importing every
module of the port in a fresh interpreter."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "vosesam_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "vosesam_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, (ast.Name, ast.Attribute))
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("__import__", "import_module")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_every_file_is_scanned():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "vosesam_tpu_torch/eval/runner.py" in names
    assert len(FILES) > 50


def test_the_profiling_bench_and_debug_plot_modules_are_scanned():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"vosesam_tpu_torch/bench.py", "vosesam_tpu_torch/utils/profiling.py",
            "vosesam_tpu_torch/viz/debug_plots.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [f"{path.name}:{line} imports {name}" for line, name in _imports(path)
           if _forbidden(name)]
    assert not bad, bad


def test_importing_the_whole_port_loads_neither():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in ('jax', 'jaxlib', 'vosesam_tpu'))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
