"""Nothing under portbench/ imports JAX or the JAX package, compared by
whole top-level module names (iyokan_tpu_torch begins with iyokan_tpu);
the reference imports nothing of the program; the command refuses to run
without a card or without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX = {"jax", "jaxlib", "flax", "iyokan_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_imports():
    found = {p: set(_imports(p)) & JAX for p in _sources()}
    assert not any(found.values()), found
    # the top-level comparison is whole: the port's name is not the JAX
    # package's
    assert "iyokan_tpu_torch".split(".")[0] not in JAX


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = set(_imports(os.path.join(ref, f)))
            assert not any(t.startswith("iyokan") for t in tops), (f, tops)


def test_run_names_loaded_jax_modules(monkeypatch):
    sys.path.insert(0, BENCH)
    try:
        import run
    finally:
        sys.path.remove(BENCH)
    monkeypatch.setitem(sys.modules, "iyokan_tpu_torch_probe",
                        types.ModuleType("iyokan_tpu_torch_probe"))
    assert run.jax_modules() == [m for m in run.jax_modules()
                                 if m.split(".")[0] in JAX]
    monkeypatch.setitem(sys.modules, "iyokan_tpu.probe",
                        types.ModuleType("iyokan_tpu.probe"))
    assert "iyokan_tpu.probe" in run.jax_modules()
    assert "iyokan_tpu_torch_probe" not in run.jax_modules()


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "memmac.long",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this run would measure")
    r = _run(ROOT)
    assert r.returncode != 0 and "no CUDA card" in r.stderr
    assert not r.stdout.strip()


def test_fails_alone(tmp_path):
    """BENCHMARK.json and portbench/ without the program: no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
