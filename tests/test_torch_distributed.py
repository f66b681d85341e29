"""Two-process torch.distributed runs of the port's mesh (gloo, CPU).

The counterpart of tests/test_distributed.py: OS processes initialize
through parallel/distributed.py from the IYOKAN_COORDINATOR /
IYOKAN_NUM_PROCESSES / IYOKAN_PROCESS_ID variables, build the global
"gates" mesh over both processes' shards, and

* all-reduce a value spread over the processes (the JAX test's psum), and
  run shard_batch across them: each process computes only its shards'
  rows and the all-gather brings the batch back whole, also where the
  processes hold different numbers of shards;
* run one cycle of tiny-romram (gate levels, CB, ROM read, RAM read and
  write) on a mesh of one shard a process, every even batch split
  (IYOKAN_SHARD_MIN_ROWS=1): each process's result packet equals the
  one-process run's byte for byte.
Each worker runs on the CPU (IYOKAN_TORCH_DEVICE=cpu) on a port of its own;
a worker that hangs is killed at its test's timeout and fails that test.
A worker leaves through os._exit once its result is printed: gloo's
teardown at interpreter exit (TCPStore, work threads) can abort a process
whose work is done.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from .test_torch_parallel import romram_bp  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PSUM = r"""
import torch
import torch.distributed as dist

from iyokan_tpu_torch.parallel import distributed, mesh as mesh_mod

distributed.initialize()
pid = dist.get_rank()
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
mesh = distributed.global_mesh(local_shards=2)
assert mesh.size == 4 and mesh.counts == (2, 2), mesh
assert list(mesh.local) == [2 * pid, 2 * pid + 1]

local = torch.arange(2, dtype=torch.float32) + 2 * pid
total = local.sum()
dist.all_reduce(total)
assert float(total) == 0 + 1 + 2 + 3, float(total)

x = torch.arange(64 * 3, dtype=torch.int32).reshape(64, 3)
for counts in ((2, 2), (1, 3)):
    rows = []

    def fn(t):
        rows.append(int(t[0, 0]) // 3)
        return t * 2 + 1

    mesh_mod.set_mesh(mesh_mod.Mesh(counts, pid, dist.group.WORLD))
    out = mesh_mod.shard_batch(x, fn)
    assert torch.equal(out, x * 2 + 1), counts
    first = sum(counts[:pid])
    assert rows == [16 * (first + i) for i in range(counts[pid])], rows
mesh_mod.set_mesh(None)
dist.barrier()
print("WORKER_OK", pid, flush=True)
os._exit(0)   # leave the process group's teardown at exit to the OS
"""

_CYCLE = r"""
import torch
import torch.distributed as dist

from iyokan_tpu_torch import packet
from iyokan_tpu_torch.circuit.blueprint import Blueprint
from iyokan_tpu_torch.crypto import host
from iyokan_tpu_torch.engine.driver import Frontend
from iyokan_tpu_torch.parallel import distributed, mesh as mesh_mod

d = sys.argv[1]
distributed.initialize()
pid = dist.get_rank()
mesh = distributed.global_mesh()
assert mesh.size == 2 and mesh.group is not None
mesh_mod.set_mesh(mesh)
gathers = []
real = mesh_mod._all_gather
mesh_mod._all_gather = lambda *a: gathers.append(1) or real(*a)
ek = host.EvalKey.load(os.path.join(d, "ek"))
req = packet.TFHEPacket.load(os.path.join(d, "req.enc"))
fe = Frontend("tfhe", Blueprint(os.path.join(d, "tiny-romram.toml")), req,
              eval_key=ek, device="cpu")
fe.go(1)
fe.make_result_packet().save(os.path.join(d, f"res.{pid}"))
assert gathers, "no batch was sharded"
mesh_mod.set_mesh(None)
dist.barrier()
print("WORKER_OK", pid, flush=True)
os._exit(0)
"""

_HEAD = (f"import os, sys\nsys.path.insert(0, {ROOT!r})\n"
         "import torch\ntorch.set_num_threads(1)\n")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, body, args=(), timeout=60, env_extra=None):
    script = tmp_path / "worker.py"
    script.write_text(_HEAD + body)
    port = _free_port()
    procs = []
    for i in range(2):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(IYOKAN_TORCH_DEVICE="cpu",
                   IYOKAN_COORDINATOR=f"localhost:{port}",
                   IYOKAN_NUM_PROCESSES="2", IYOKAN_PROCESS_ID=str(i),
                   **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *args], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, text=True, cwd=tmp_path))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER_OK {i}" in out, out


def test_two_process_psum_and_shard_batch(tmp_path):
    _run_workers(tmp_path, _PSUM)


def test_two_process_romram_cycle_matches_one_process(tmp_path, toy_sk,
                                                      toy_ek, romram_bp,
                                                      monkeypatch):
    import shutil

    from iyokan_tpu_torch.circuit.blueprint import Blueprint
    from iyokan_tpu_torch.engine.driver import Frontend

    from .test_torch_parallel import _romram_request

    knobs = {"IYOKAN_SHARD_MIN_ROWS": "1", "IYOKAN_RAM_REFRESH_PERIOD": "1"}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    shutil.copy(romram_bp, tmp_path)
    shutil.copy(os.path.join(os.path.dirname(romram_bp),
                             "addr-4bit-yosys.json"), tmp_path)
    toy_ek.save(str(tmp_path / "ek"))
    req = _romram_request().encrypt(toy_sk, seed=7)
    req.save(str(tmp_path / "req.enc"))
    fe = Frontend("tfhe", Blueprint(str(tmp_path / "tiny-romram.toml")),
                  req, eval_key=toy_ek, device="cpu")
    fe.go(1)
    fe.make_result_packet().save(str(tmp_path / "res.one"))
    _run_workers(tmp_path, _CYCLE, (str(tmp_path),), env_extra=knobs)
    want = (tmp_path / "res.one").read_bytes()
    for pid in range(2):
        assert (tmp_path / f"res.{pid}").read_bytes() == want
    res = fe.make_result_packet().decrypt(toy_sk)
    assert list(res.bits["sum"]) == [0, 0, 0, 1]
    np.testing.assert_array_equal(res.ram["ramA"][8:12], [0, 0, 0, 1])


def test_mesh_run_tool_two_processes(monkeypatch, capsys):
    """tools/mesh_run.py (the multi-card run) in two gloo processes at
    toy parameters: the NAND batch and MAC-2 in every mode under the mesh
    equal each process's unsharded run."""
    import json

    from iyokan_tpu_torch.tools import mesh_run

    monkeypatch.setenv("IYOKAN_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = mesh_run.main(["--procs", "2", "--params", "toy", "--G", "32",
                        "--circuit", "mac2", "--cycles", "1",
                        "--timeout", "240"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["ok"], rec
    for w in rec["workers"]:
        assert w["backend"] == "gloo" and w["mesh_size"] == 2
        assert w["nands"]["shard_rows"] == [16] and w["nands"]["equal"]
        modes = w["circuit"]["modes"]
        assert [m["mode"] for m in modes] == ["1", "8", "all"]
        assert all(m["equal"] and m["no_mesh_equal"] for m in modes)
