"""A rehearsal on the CPU of a cell of several cards: two processes, one a
rank, on the program's gate-batch mesh over gloo, at toy parameters on a
64-lane nandwide (gen_nandwide.py) in a cell that the test adds to a copy
of the benchmark.  run.py is started as the command starts it (through a
small entry script that selects the CPU twins, shortens the crew's limits
and plants a fault in rank 1); each run goes from set-up to the
judgement.  A rank off the mesh, a rank whose answers differ from rank
0's, and a rank killed in the window never give a correct result, and no
run outlives its limits."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench.tests import gen_nandwide

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TOY = {"n": 64, "N": 256, "k": 1, "l": 3, "Bgbit": 6, "N2": 512, "l2": 5}
SEED = 2**32 + 2**20 + 11
CELL = "toywide.toylong8"
ENTRY = '''import os, signal, sys
os.environ.setdefault("OMP_NUM_THREADS", "2")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "portbench"))
from portbench import crew, program
crew.LIMITS.update(setup=240.0, window=30.0, judge=120.0, finish=30.0)
crew.GROUP_TIMEOUT_S = 120.0
fault = os.environ.get("REHEARSAL_FAULT", "")
rank = int(sys.argv[sys.argv.index("--rank") + 1]) if "--rank" in sys.argv else 0
if rank == 1 and fault == "off_mesh":
    def join_off_mesh(self):
        from iyokan_tpu_torch.parallel import distributed
        distributed.initialize()
        distributed.global_mesh()              # taken part in, not set
        return 1
    program.Program.join_mesh = join_off_mesh
if rank == 1 and fault == "packet":
    real = program.Program.result
    def altered(fe):
        res = real(fe)
        name = sorted(res["bits"])[0]
        res["bits"][name] = res["bits"][name].copy()
        res["bits"][name][0, 0] ^= 1
        return res
    program.Program.result = staticmethod(altered)
if rank == 1 and fault == "killed":
    real_stop = crew.Steer.stop
    calls = []
    def stop_then_die(self, flag):
        calls.append(1)
        if len(calls) == 5:              # 3 warm-up steps, then the window's
            os.kill(os.getpid(), signal.SIGKILL)      # second step
        return real_stop(self, flag)
    crew.Steer.stop = stop_then_die
import run
sys.exit(run.main(sys.argv[1:], device="cpu"))
'''


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "iyokan_tpu_torch"),
               root / "iyokan_tpu_torch")
    pb = root / "portbench"
    gen_nandwide.write(str(pb / "configs" / "toywide"), 64)
    cfg = {"name": "toywide", "source": "toy", "params": "toy",
           "param_values": TOY, "key_seed": 7,
           "blueprint": "toywide/nandwide.toml", "inputs": {"in": "uniform"},
           "limits": {"wrong_bits": 0, "max_phase_err": 0.2}}
    (pb / "configs" / "toywide.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "toylong8.json").write_text(json.dumps(
        {"kind": "long", "stream_entries": 2, "warmup_cycles": 1,
         "warmup_seconds": 0, "trace_cycles": 1}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toywide", "source": "toy",
                             "reduced": [], "why": "toy",
                             "file": "portbench/configs/toywide.json"})
    bench["workloads"].append({"name": CELL, "config": "toywide",
                               "traffic": "toylong8", "chips": 2,
                               "why": "toy"})
    # the metrics of the one-card gate-only cell
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mac16.long" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "rehearse.py").write_text(ENTRY)
    return str(root)


def _run(layout, fault="", trace=0, seconds=2.0):
    env = dict(os.environ, REHEARSAL_FAULT=fault)
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "rehearse.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=layout, env=env, capture_output=True, text=True, timeout=900)
    lines = r.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if lines else None
    return r, out, time.time() - t0


def test_two_ranks_are_correct(layout):
    r, out, _ = _run(layout, trace=0)
    assert r.returncode == 0, r.stderr[-3000:]
    assert out["correct"] is True and out["failed"] == 0, out
    assert out["attempted"] >= 2
    assert out["device"]["count"] == 2
    assert set(out["metrics"]) == {"setup_s", "s_per_cycle"}
    assert out["compared"]["ranks_differing"] == {"value": 0, "limit": 0}
    assert list(out)[-1] == "compared"
    assert "rank 1: set-up: keys and blueprint loaded" in r.stderr
    assert "control: " in r.stderr


def test_two_ranks_traced(layout):
    r, out, _ = _run(layout, trace=1)
    assert r.returncode == 0, r.stderr[-3000:]
    assert out["correct"] is True and out["device"]["count"] == 2
    # no device trace on the CPU: the device metrics are left out
    assert "eager_launches_per_cycle.cycle" in out["metrics"]
    assert "br1_device_ms_per_cycle.cycle" not in out["metrics"]


def test_rank_with_other_answers_is_not_correct(layout):
    r, out, _ = _run(layout, fault="packet")
    assert r.returncode == 0, r.stderr[-3000:]
    assert out["correct"] is False
    assert out["compared"]["ranks_differing"] == {"value": 1, "limit": 0}
    # rank 0's own answers are right: only the comparison fails them
    assert out["compared"]["wrong_bits"]["value"] == 0


@pytest.mark.parametrize("fault", ["off_mesh", "killed"])
def test_failed_rank_gives_no_result(layout, fault):
    r, out, seconds = _run(layout, fault=fault, seconds=20.0)
    assert r.returncode != 0 and out is None, r.stdout[-2000:]
    if fault == "off_mesh":
        assert "meshes hold [2, 1] shards" in r.stderr
    else:
        # ended at once by rank 0's watchdog or its own broken message,
        # not at the window's end or a limit
        assert ("crew: rank 1 ended with code -9" in r.stderr
                or "Connection reset by peer" in r.stderr
                or "Connection closed by peer" in r.stderr), r.stderr[-3000:]
        assert seconds < 20.0 + 60.0
    assert not _leftovers(layout)


def _leftovers(layout):
    """Processes of this layout's entry script still running."""
    out = subprocess.run(["ps", "-eo", "args"], capture_output=True,
                         text=True).stdout
    return [ln for ln in out.splitlines() if "rehearse.py" in ln
            and CELL in ln]
