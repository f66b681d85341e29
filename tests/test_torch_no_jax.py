"""The torch port imports no JAX: every module of iyokan_tpu_torch (and
chip_smoke.py, which runs where no JAX is installed) imports in a fresh
interpreter whose import system refuses `jax` and `iyokan_tpu`."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "iyokan_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
import iyokan_tpu_torch
names = ["iyokan_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(iyokan_tpu_torch.__path__,
                                          "iyokan_tpu_torch.")]
for n in names:
    importlib.import_module(n)
for n in ("parallel", "parallel.mesh", "parallel.distributed",
          "tools.measure_error_rate"):
    assert "iyokan_tpu_torch." + n in names, n
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "iyokan_tpu")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _PROBE],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20      # every module was imported


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py copied into an otherwise empty directory exits
    non-zero and prints no result line."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       capture_output=True, text=True, cwd=tmp_path,
                       env=env, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
