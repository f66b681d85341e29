"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of the benchmark."""

import json
import os
import re

import pytest

from portbench import cells

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
PATH = os.path.join(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(PATH) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_shape(bench):
    assert set(bench) == KEYS
    assert os.path.getsize(PATH) <= 64 * 1024
    assert bench["paths"] == ["portbench"]
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert cmd == ["python3", "portbench/run.py"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries(bench):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }
    for key, keys in allowed.items():
        names = [e["name"] for e in bench[key]]
        assert len(names) == len(set(names)), key
        for e in bench[key]:
            assert set(e) <= keys, (key, e)
            assert NAME.match(e["name"]), e["name"]
            if "why" in e:
                assert _line(e["why"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher"), e["name"]
    for c in bench["configs"]:
        assert _line(c["source"]) and c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) == {"wrong_bits", "max_phase_err"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in bench["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w]), m["name"]
        layers.setdefault(m["name"].split(".")[0], m["layer"])
    cfgs = {c["name"] for c in bench["configs"]}
    used = set()
    four = 0
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        four += w["chips"] == 4
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        reported = [m for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2 and "setup_s" in [m["name"]
                                                     for m in reported]
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])
    assert used == cfgs
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_files_are_found_by_name(bench):
    man = cells.Manifest(ROOT)
    for w in bench["workloads"]:
        cell = man.cell(w["name"])
        cfg = man.config(cell["config"])
        assert os.path.exists(os.path.join(cfg["_dir"], cfg["blueprint"]))
        assert man.traffic(cell["traffic"])["kind"] in ("long",
                                                        "closed_loop")
        for trace in (False, True):
            for m in man.metrics(w["name"], trace):
                assert callable(man.reader(m["name"]))
    for name in ("br1", "cbcmux"):
        table = man.layer(name)
        assert table["kernels"] and _line(table["layer"])
    layer_names = {m["layer"] for m in bench["per_layer"]}
    assert {man.layer(n)["layer"] for n in ("br1", "cbcmux")} <= layer_names
    assert man.control("tk_lb1")["env"]["IYOKAN_TK_LB"] == "1"


def test_file_names():
    for dirpath, dirnames, files in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert len(rel) <= 200
            assert all(NAME.match(part) for part in rel.split("/")), rel
