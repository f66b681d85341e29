"""The work model's counts (metrics/workmodel.py): fixed by the circuit and
the parameter set, the same whatever route the program takes."""

import json
import os
import subprocess
import sys

import pytest

from portbench.metrics import workmodel
from portbench.reference.circuit import Circuit
from portbench.tests import gen_nandwide

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CGGI128 = {"n": 635, "N": 1024, "k": 1, "l": 3}
PEAKS = json.load(open(os.path.join(BENCH, "metrics", "peaks.json")))


def test_counts_at_cggi128():
    assert workmodel.multiplies_per_row(CGGI128) == 635 * 53_248
    assert workmodel.batch_bytes(CGGI128, 0) == 31_211_520     # the key
    assert workmodel.batch_bytes(CGGI128, 1) == 31_211_520 + (636 + 2048) * 4
    # a row's multiplies at 16.7e12/s, and the key's bytes at 3.35 TB/s
    one = workmodel.batch_bound_s(CGGI128, PEAKS, 1)
    assert one == pytest.approx(31_222_256 / 3.35e12)
    big = workmodel.batch_bound_s(CGGI128, PEAKS, 2048)
    assert big == pytest.approx(2048 * 635 * 53_248 / 16_727_040_000_000)


def test_cycle_batches():
    mac16 = Circuit(os.path.join(BENCH, "configs", "mac16", "mac16.toml"))
    rows = workmodel.cycle_batches(mac16, False)
    assert (len(rows), sum(rows), max(rows)) == (64, 1536, 256)
    assert rows == workmodel.cycle_batches(mac16, True)     # no RAM
    memmac = Circuit(os.path.join(BENCH, "configs", "memmac", "memmac.toml"))
    plain, refresh = (workmodel.cycle_batches(memmac, r)
                      for r in (False, True))
    assert plain[-2:] == [32, 16] and refresh[-2:] == [32, 4096]
    assert sum(plain[:-2]) == 96 and plain[:-2] == refresh[:-2]
    assert workmodel.cycle_bound_s(mac16, CGGI128, PEAKS, False) \
        == pytest.approx(3.12e-3, rel=1e-3)


@pytest.mark.parametrize("route", ["tkey", "v3", "pallas"])
def test_same_whatever_the_route(route):
    """The model reads nothing of the program: in a process that sets the
    program's route knob it gives the same bound to the last digit."""
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from portbench.metrics import workmodel\n"
        "from portbench.reference.circuit import Circuit\n"
        "c = Circuit(%r)\n"
        "p = {'n': 635, 'N': 1024, 'k': 1, 'l': 3}\n"
        "pk = json.load(open(%r))\n"
        "print(repr(workmodel.cycle_bound_s(c, p, pk, True)))\n"
        "assert not any(m.split('.')[0].startswith('iyokan') "
        "for m in sys.modules)\n"
    ) % (ROOT, os.path.join(BENCH, "configs", "memmac", "memmac.toml"),
         os.path.join(BENCH, "metrics", "peaks.json"))
    env = dict(os.environ, IYOKAN_BR_IMPL=route)
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, check=True).stdout.strip()
    memmac = Circuit(os.path.join(BENCH, "configs", "memmac", "memmac.toml"))
    assert float(out) == workmodel.cycle_bound_s(memmac, CGGI128, PEAKS, True)


@pytest.mark.parametrize("chips,rows", [(1, 2048), (4, 512)])
def test_card_rows_on_the_mesh(chips, rows, tmp_path):
    """nandwide's levels (gen_nandwide.py): card 0 runs 2,048 rows a level
    alone and 512 on four cards (the mesh's even shards), and its bound
    shrinks with them."""
    gen_nandwide.write(str(tmp_path), 2048)
    nw = Circuit(str(tmp_path / "nandwide.toml"))
    assert workmodel.cycle_batches(nw, False, chips) == [rows] * 8
    assert workmodel.cycle_bound_s(nw, CGGI128, PEAKS, False, chips) \
        == pytest.approx(8 * rows * 635 * 53_248 / 16_727_040_000_000)


def test_card_rows_follow_the_mesh_rule():
    # split where every card gets at least 8 rows and the rows divide
    assert workmodel.card_rows(32, 4) == 8
    assert workmodel.card_rows(31, 4) == 31          # does not divide
    assert workmodel.card_rows(24, 4) == 24          # 6 rows a card
    assert workmodel.card_rows(4096, 1) == 4096
