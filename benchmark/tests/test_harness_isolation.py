"""The isolation the benchmark promises: no file under `benchmark/` imports
JAX or the JAX package (whole top-level names: the port's name begins with
the JAX package's), the reference imports nothing of the port, and the
run's own check reads whole names."""

import ast
import os
import subprocess
import sys

import tiny
from harness import isolation


def _imports(path):
    tree = ast.parse(open(path).read())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module and n.level == 0:
            yield n.module


def _files(top):
    for d, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_jax_or_the_jax_package():
    bad = [(p, m) for p in _files(tiny.BENCH) for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "vosesam_tpu")]
    assert bad == []


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(tiny.BENCH, "reference")
    bad = [(p, m) for p in _files(ref) for m in _imports(p)
           if m.split(".")[0] not in ("plainref", "torch", "numpy", "math", "typing",
                                      "dataclasses", "functools", "__future__")]
    assert bad == []


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vosesam_tpu_torch_fake", sys)
    assert "vosesam_tpu" not in isolation.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vosesam_tpu.sub", sys)
    assert "vosesam_tpu" in isolation.forbidden_modules()


def test_a_fresh_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, tiny, torch; from harness import cli, system; "
            "b, wl, cfg, spec = tiny.cell('xmem.long_video'); "
            "system.build(cfg, 5, torch.device('cpu')); "
            "import harness.reference, harness.tracing; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'vosesam_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.HERE, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(tiny.BENCH, "run.py"), "--workload",
                          "xmem.long_video", "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                         cwd=tiny.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_a_module_loaded_during_the_check_stops_the_result(monkeypatch, capsys):
    """`main` looks again once the check's reference has run: a forbidden
    module loaded by then means no result line and a non-zero exit."""
    import torch
    from harness import cli

    def check_loads_jax(*a, **k):
        monkeypatch.setitem(sys.modules, "jax", sys)
        return {"correct": True}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(cli, "program_from_checkout", lambda root: True)
    monkeypatch.setattr(cli, "run_cell", check_loads_jax)
    n = torch.get_num_threads()
    try:
        rc = cli.main(["--workload", "xmem.long_video", "--seed", "3", "--seconds", "1"])
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err
