"""The readers of the program's spans (metrics/programspans.py and the four
metrics that use it) on hand-built traces: idle under nested spans goes to
the innermost, aten ops and the benchmark's own spans do not count, the
parts sum to the traced idle time, each reader's number, and None where a
trace or the program's spans are missing."""

import os
import types

import numpy as np
import pytest

from portbench import cells
from portbench.devtrace import Trace
from portbench.metrics import programspans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MS = 1_000_000                 # ns


def _trace(ops, host, end=100):
    return Trace([(n, s * MS, e * MS) for n, s, e in ops],
                 [(n, s * MS, e * MS) for n, s, e in host], 0, end * MS)


def _cycle_trace():
    """Busy 10-20 and 60-70 of 0-100; a cycle span 0-90 holding CB 20-50
    (with an aten op inside it) and a RAM write 50-58; the benchmark's own
    span over everything."""
    return _trace(
        [("tkey_loop_kernel", 10, 20), ("ep_cluster_kernel", 60, 70)],
        [("portbench.window", 0, 100), ("portbench.cycle", 0, 100),
         ("iyokan.cycle", 0, 90), ("iyokan.inputs", 0, 5),
         ("iyokan.mem.cb", 20, 50), ("aten::bitwise_and", 25, 45),
         ("cudaLaunchKernel", 46, 49), ("iyokan.ram_write", 50, 58)])


def _view(trace, **traced):
    return types.SimpleNamespace(trace=trace, traced=traced or None)


def _reader(name):
    return cells.Manifest(ROOT).reader(name)


def test_innermost_span_owns_the_idle():
    parts = programspans.idle_by_span(_cycle_trace())
    ms = {n: round(v * 1e3, 9) for n, v in parts.items()}
    # idle 0-10 (inputs 0-5, cycle 5-10), 20-60 (CB 20-50, RAM write
    # 50-58, cycle 58-60), 70-100 (cycle 70-90, outside 90-100)
    assert ms == {"iyokan.inputs": 5, "iyokan.cycle": 27,
                  "iyokan.mem.cb": 30, "iyokan.ram_write": 8,
                  programspans.OUTSIDE: 10}


@pytest.mark.parametrize("seed", range(6))
def test_parts_sum_to_the_idle_time(seed):
    """Random device operations under random nested spans, with aten and
    portbench.* events among them: the parts sum to window_s - busy_s."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(int(rng.integers(0, 40))):
        s = int(rng.integers(0, 1000))
        ops.append(("k", s, s + int(rng.integers(1, 60))))
    host = [("portbench.cycle", 0, 1000)]

    def nest(lo, hi, depth):
        t = lo
        while depth < 4 and t < hi - 2:
            s = int(rng.integers(t, hi - 1))
            e = int(rng.integers(s + 1, hi + 1))
            name = str(rng.choice(["iyokan.cycle", "iyokan.gates",
                                   "iyokan.mem.cb", "aten::add"]))
            host.append((name, s, e))
            nest(s, e, depth + 1)
            t = e + int(rng.integers(0, 50))

    nest(0, 1000, 0)
    host.append(("iyokan.cycle", 0, 1))         # at least one span
    tr = _trace([(n, s, min(e, 1000)) for n, s, e in ops], host, 1000)
    parts = programspans.idle_by_span(tr)
    assert not any(n.startswith(("aten::", "portbench.")) for n in parts)
    assert sum(parts.values()) == pytest.approx(tr.window_s - tr.busy_s,
                                                abs=1e-12)


def test_cycle_readers():
    view = _view(_cycle_trace(), cycles=[False, True])
    assert _reader("mem_idle_ms_per_cycle.cycle")(view) == pytest.approx(19)
    assert _reader("driver_idle_ms_per_cycle.cycle")(view) \
        == pytest.approx(16)


def test_request_readers():
    """Two traced requests: captures 10-30 (one nested in it, 15-20) and
    50-60, builds 0-8 and 40-44."""
    tr = _trace([("k", 30, 50)], [
        ("portbench.request", 0, 100), ("iyokan.frontend.build", 0, 8),
        ("iyokan.gates", 9, 31), ("iyokan.graph.capture", 10, 30),
        ("iyokan.graph.capture", 15, 20), ("iyokan.frontend.build", 40, 44),
        ("iyokan.graph.capture", 50, 60)])
    view = _view(tr, requests=2)
    assert _reader("graph_capture_s.request")(view) == pytest.approx(0.015)
    assert _reader("frontend_build_s.request")(view) == pytest.approx(0.006)


@pytest.mark.parametrize("name", [
    "mem_idle_ms_per_cycle.cycle", "driver_idle_ms_per_cycle.cycle",
    "graph_capture_s.request", "frontend_build_s.request"])
def test_none_without_trace_or_spans(name):
    read = _reader(name)
    traced = {"cycles": [False], "requests": 1}
    assert read(_view(None, **traced)) is None                 # a CPU run
    bare = _trace([("k", 10, 20)], [("portbench.cycle", 0, 100),
                                    ("aten::add", 30, 40)])
    assert read(_view(bare, **traced)) is None      # a program with no spans
    assert read(_view(_cycle_trace())) is None      # nothing traced
