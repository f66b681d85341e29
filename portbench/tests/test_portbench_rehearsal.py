"""A rehearsal of whole runs on the CPU, at toy parameters on the port's
CPU twins: a toy configuration, toy traffic files and a toy per-layer
metric are dropped into a copy of the benchmark's layout and found by
name; each run goes from set-up to the judgement.  The control (the
program's lower-precision path) and faults planted in the timed path have
to come out not correct."""

import json
import os
import re
import shutil

import pytest
import torch

from portbench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
DATA = os.path.join(ROOT, "tests", "data")
TOY = {"n": 64, "N": 256, "k": 1, "l": 3, "Bgbit": 6, "N2": 512, "l2": 5}
SEED = 2**31 + 2**20 + 3
TOY_METRIC = '''"""toy_cycles.cycle: the window's cycles (dropped in)."""


def read(view):
    return len(view.window["cycle_s"]) or None
'''


def _config(name, blueprint, **extra):
    cfg = {"name": name, "source": "toy", "params": "toy",
           "param_values": TOY, "key_seed": 7, "blueprint": blueprint,
           "limits": {"wrong_bits": 0, "max_phase_err": 0.2},
           "assumed": [], "reduced": []}
    cfg.update(extra)
    return cfg


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("layout")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "iyokan_tpu_torch"),
               root / "iyokan_tpu_torch")
    pb = root / "portbench"
    (pb / "configs" / "toymac").mkdir()
    for f in ("mac2.toml", "mac2-yosys.json"):
        shutil.copy(os.path.join(DATA, f), pb / "configs" / "toymac")
    (pb / "configs" / "toyram").mkdir()
    shutil.copy(os.path.join(DATA, "tiny-ram.toml"), pb / "configs" / "toyram")
    (pb / "configs" / "toymac.json").write_text(json.dumps(
        _config("toymac", "toymac/mac2.toml")))
    (pb / "configs" / "toyram.json").write_text(json.dumps(_config(
        "toyram", "toyram/tiny-ram.toml", ram_refresh_period=2,
        inputs={"addr": "distinct_revisit", "wren": "first_and_odd"})))
    (pb / "traffic" / "toylong.json").write_text(json.dumps(
        {"kind": "long", "stream_entries": 4, "warmup_cycles": 1,
         "warmup_seconds": 0, "trace_cycles": 1}))
    (pb / "traffic" / "toywarm.json").write_text(json.dumps(
        {"kind": "long", "stream_entries": 4, "warmup_cycles": 1,
         "warmup_seconds": 6.0, "trace_cycles": 1}))
    (pb / "traffic" / "toyreq.json").write_text(json.dumps(
        {"kind": "closed_loop", "cycles": 2, "pool": 2, "stream_entries": 2,
         "warmup": 1, "trace_requests": 1}))
    (pb / "metrics" / "toy_cycles.cycle.py").write_text(TOY_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in ("toymac", "toyram"):
        bench["configs"].append({
            "name": name, "source": "toy", "reduced": [], "why": "toy",
            "file": f"portbench/configs/{name}.json"})
    bench["workloads"] += [
        {"name": "toymac.toylong", "config": "toymac", "traffic": "toylong",
         "chips": 1, "why": "toy"},
        {"name": "toyram.toyreq", "config": "toyram", "traffic": "toyreq",
         "chips": 1, "why": "toy"},
        {"name": "toyram.toywarm", "config": "toyram", "traffic": "toywarm",
         "chips": 1, "why": "toy"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for real, toy in (("mac16.long", "toymac.toylong"),
                          ("memmac.req8", "toyram.toyreq")):
            if real in m.get("workloads", []):
                m["workloads"].append(toy)
    bench["per_layer"].append({
        "name": "toy_cycles.cycle", "unit": "cycles", "better": "higher",
        "source": "host_clock", "layer": "Frontend", "moves": "s_per_cycle",
        "workloads": ["toymac.toylong"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(layout, workload, trace=False, seconds=0.3, **kw):
    return harness.run_cell(layout, workload, SEED, seconds, trace,
                            device="cpu", log=lambda msg: None, **kw)


def test_long_cell(layout):
    out = _run(layout, "toymac.toylong")
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "s_per_cycle"}
    assert out["compared"]["wrong_bits"] == {"value": 0, "limit": 0}
    assert list(out)[-1] == "compared"
    traced = _run(layout, "toymac.toylong", trace=True)
    assert traced["correct"] is True
    # the dropped-in metric is found by name; the device metrics find no
    # device trace on the CPU and are left out
    assert set(traced["metrics"]) == {"toy_cycles.cycle",
                                      "eager_launches_per_cycle.cycle"}
    assert traced["metrics"]["eager_launches_per_cycle.cycle"]["value"] == 0


def test_closed_loop_cell_with_a_ram(layout):
    out = _run(layout, "toyram.toyreq", trace=True, seconds=0.1)
    assert out["correct"] is True and out["attempted"] >= 3
    assert set(out["metrics"]) == {"request_overhead_s.request"}
    out = _run(layout, "toyram.toyreq", seconds=0.1)
    assert set(out["metrics"]) == {"setup_s", "s_per_request"}


def test_long_warmup_runs_its_seconds_in_the_refresh_phase(layout):
    """A long cell warms up for warmup_seconds at least, and its window
    starts at the same cycle of the refresh period as with none (toyram:
    period 2, three cycles through the first refresh)."""
    logs = []
    out = harness.run_cell(layout, "toyram.toywarm", SEED, 0.1, False,
                           device="cpu", log=logs.append)
    assert out["correct"] is True
    warm = [re.match(r"set-up: (\d+) warm-up cycles ([\d.]+) s", m)
            for m in logs]
    n, secs = next((int(w[1]), float(w[2])) for w in warm if w)
    assert secs >= 6.0 and n >= 3 and n % 2 == 3 % 2


def test_setup_leaves_out_the_reference(layout, monkeypatch):
    """The reference evaluator's circuit is the reference's work, not the
    program's: a second spent building it does not reach setup_s."""
    import time

    class SlowCircuit(harness.Circuit):
        def __init__(self, path):
            time.sleep(1.0)
            super().__init__(path)

    monkeypatch.setattr(harness, "Circuit", SlowCircuit)
    t0 = time.time()
    out = _run(layout, "toymac.toylong")
    assert out["correct"] is True
    assert out["metrics"]["setup_s"]["value"] <= time.time() - t0 - 1.0


def test_control_is_refused(layout):
    out = _run(layout, "toymac.toylong", control="tk_lb1")
    assert out["correct"] is False
    c = out["compared"]["max_phase_err"]
    assert c["value"] > 3 * 0.02 and c["value"] > c["limit"]


def _unchanged(monkeypatch):
    from iyokan_tpu_torch.engine import tfhe

    monkeypatch.setattr(tfhe.TFHEEngine, "settle",
                        lambda self, vals, rams, roms, **kw: (vals, rams))


def _half_batch(monkeypatch):
    from iyokan_tpu_torch.crypto import ops

    real = ops.blind_rotate

    def half(batch, *a, **kw):
        h = (batch.shape[0] + 1) // 2
        out = real(batch[:h], *a, **kw)
        return torch.cat([out, out[: batch.shape[0] - h]])

    monkeypatch.setattr(ops, "blind_rotate", half)


def _altered(monkeypatch):
    from iyokan_tpu_torch.crypto import ops

    real = ops.keyswitch_10

    def altered(*a, **kw):
        out = real(*a, **kw).clone()
        out[0] = -out[0]                          # one gate's bit flipped
        return out

    monkeypatch.setattr(ops, "keyswitch_10", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_faults_are_refused(layout, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(layout, "toymac.toylong")
    assert out["correct"] is False and out["failed"] > 0
    assert out["compared"]["wrong_bits"]["value"] > 0
