"""The gate-batch mesh across processes, one a card (gloo on the CPU).

    python3 -m iyokan_tpu_torch.tools.mesh_run [--procs N] [--params P]
        [--G G] [--circuit NAME] [--cycles C] [--timeout S]

Starts N worker processes (default: one per card) on a free localhost port.
Each sets IYOKAN_COORDINATOR / IYOKAN_NUM_PROCESSES / IYOKAN_PROCESS_ID,
calls parallel.distributed.initialize() (NCCL on a card, gloo under
IYOKAN_TORCH_DEVICE=cpu) and takes the global mesh of one shard a process.
Every worker, from the same seeds (keys 0 / 1 at P, default cggi128):

  1. G NANDs (default 2048): the batch whole on its own device with no mesh
     set, then under the mesh (its G/N rows, then the all-gather): the
     two outputs byte for byte, 0 wrong, the route's kernel (K3 under the
     port's default rule, K1 under IYOKAN_BR_IMPL=tkey) launched once on
     G/N rows; ms a batch both ways (CUDA events after a barrier, 3 reps);
  2. tests/data/<circuit>.toml (default mac16) for C cycles (default 3) on
     random inputs: with no mesh at IYOKAN_FUSE_LEVELS=1 (the reference),
     then at 1, 8 and all (IYOKAN_SCAN_CHUNK=2) with no mesh and under
     the mesh: each result packet == the reference byte for byte, and the
     decrypted reference == the plain engine's; s/cycle of the last cycle
     or span of each run. A
     fused mode whose CUDA-graph capture of the collectives fails is
     recorded with the capture's error (the engine raises, naming the
     graph; nothing runs eagerly in its place).

Each worker prints one line "MESH_RESULT <json>"; this process prints the
workers' records and the card's name and power limit as one JSON line and
exits non-zero if a worker failed, disagreed or ran out of time.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODES = {"1": {"IYOKAN_FUSE_LEVELS": "1"},
         "8": {"IYOKAN_FUSE_LEVELS": "8"},
         "all": {"IYOKAN_FUSE_LEVELS": "all", "IYOKAN_SCAN_CHUNK": "2"}}


def _nands(args, p, sk, dk, mesh, device, rec):
    import numpy as np
    import torch
    import torch.distributed as dist

    from .. import gates
    from ..crypto import host, ops
    from ..ops import br3, tkey
    from ..parallel import mesh as mesh_mod
    from . import timing

    G = args.G
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2, G, dtype=np.uint8)
    b = rng.integers(0, 2, G, dtype=np.uint8)
    A = ops.u32_tensor(host.encrypt_bits(sk, a, rng), device)
    B = ops.u32_tensor(host.encrypt_bits(sk, b, rng), device)
    ca, cb, kk = (torch.full((G,), c, dtype=torch.int32, device=device)
                  for c in gates.GATE_LIN[gates.NAND])
    pre = ops.gate_linear(A, B, ca, cb, kk, p)

    def nand():
        lvl1 = ops.gate_bootstrap_tlwe1(pre, dk.bk_for(G), p)
        return ops.keyswitch_10(lvl1, dk.ksk_f64, p)

    def ms(fn, reps=3):
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()
        return timing.timed_ms(fn, reps, device)

    whole = nand()
    ms_whole = ms(nand)
    rows = []
    # the route's kernel wrapper: K1's (tkey) or K3's (the port's rule)
    mod, name = ((tkey, "blind_rotate_tkey") if dk.bk_for(G).dtype ==
                 torch.int8 else (br3, "blind_rotate_pallas3"))
    real = getattr(mod, name)

    def counted(t, *rest, **kw):
        rows.append(t.shape[0])
        return real(t, *rest, **kw)

    mesh_mod.set_mesh(mesh)
    setattr(mod, name, counted)
    try:
        launches = mod.LAUNCHES
        sharded = nand()
        launches = mod.LAUNCHES - launches
        shard_rows = list(rows)
        ms_mesh = ms(nand)
    finally:
        setattr(mod, name, real)
        mesh_mod.set_mesh(None)
    wrong = int((host.decrypt_bits(sk, ops.u32_numpy(sharded))
                 != 1 - (a & b)).sum())
    rec["nands"] = {
        "G": G, "equal": bool(torch.equal(sharded, whole)), "wrong": wrong,
        "shard_rows": shard_rows,
        "kernel_launches": launches if device.type == "cuda" else None,
        "ms_whole": ms_whole, "ms_mesh": ms_mesh,
        "rate_whole": G / (ms_whole / 1e3), "rate_mesh": G / (ms_mesh / 1e3)}
    return rec["nands"]["equal"] and not wrong and \
        shard_rows == [G // mesh.size]


def _circuit(args, sk, ek, mesh, device, rec):
    import numpy as np

    from .. import packet
    from ..circuit.blueprint import Blueprint
    from ..engine.driver import Frontend
    from ..parallel import mesh as mesh_mod
    from .timing import cycle_log

    bp = os.path.join(ROOT, "tests", "data", f"{args.circuit}.toml")
    W = int(args.circuit[3:]) if args.circuit.startswith("mac") else None
    rng = np.random.default_rng(11)
    plain = packet.PlainPacket(bits={
        "a": rng.integers(0, 2, W * args.cycles).astype(np.uint8),
        "b": rng.integers(0, 2, W * args.cycles).astype(np.uint8)})
    req = plain.encrypt(sk, seed=5)
    pf = Frontend("plain", Blueprint(bp), plain, device=device)
    pf.go(args.cycles)
    want_plain = pf.make_result_packet()

    def run(mode, with_mesh):
        saved = {k: os.environ.get(k) for k in
                 ("IYOKAN_FUSE_LEVELS", "IYOKAN_SCAN_CHUNK")}
        os.environ.pop("IYOKAN_SCAN_CHUNK", None)
        os.environ.update(MODES[mode])
        mesh_mod.set_mesh(mesh if with_mesh else None)
        try:
            with cycle_log() as lines:
                fe = Frontend("tfhe", Blueprint(bp), req, eval_key=ek,
                              device=device)
                fe.go(args.cycles)
            return fe.make_result_packet(), lines
        finally:
            mesh_mod.set_mesh(None)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def same(x, y):
        return all(np.array_equal(x.bits[k], y.bits[k]) for k in y.bits) \
            and sorted(x.bits) == sorted(y.bits)

    ref, _ = run("1", False)
    ok = same(ref.decrypt(sk), want_plain)
    rec["circuit"] = {"name": args.circuit, "cycles": args.cycles,
                      "decrypts_to_plain": ok, "modes": []}
    for mode in MODES:
        alone, lines = run(mode, False)
        n, us = lines[-1]
        row = {"mode": mode, "no_mesh_equal": same(alone, ref),
               "no_mesh_s_per_cycle": us / n / 1e6}
        ok = ok and row["no_mesh_equal"]
        try:
            got, lines = run(mode, True)
        except RuntimeError as e:
            if "CUDA graph capture" not in str(e):
                raise
            row["capture_error"] = str(e)[:400]
            rec["circuit"]["modes"].append(row)
            ok = False
            continue
        n, us = lines[-1]
        row.update(equal=same(got, ref), s_per_cycle=us / n / 1e6,
                   cycles_us=lines)
        ok = ok and row["equal"]
        rec["circuit"]["modes"].append(row)
    return ok


def worker(args) -> int:
    import torch
    import torch.distributed as dist

    from .. import params
    from ..crypto import host, ops
    from ..parallel import distributed

    distributed.initialize()
    mesh = distributed.global_mesh()
    device = ops.default_device()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    p = params.by_name(args.params)
    sk = host.keygen(p, seed=0)
    ek = host.genevalkey(sk, seed=1, with_cb=False)
    dk = ops.DeviceKeys.from_evalkey(ek, device, with_cb=False)
    rec = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend(), "device": str(device),
           "mesh_size": mesh.size}
    if device.type == "cuda":
        rec["card"] = torch.cuda.get_device_name(device)
    ok = _nands(args, p, sk, dk, mesh, device, rec)
    ok = _circuit(args, sk, ek, mesh, device, rec) and ok
    rec["ok"] = ok
    dist.barrier()
    print("MESH_RESULT " + json.dumps(rec), flush=True)
    # the record is out: leave without the process group's teardown at
    # interpreter exit, which can abort a finished gloo process
    os._exit(0 if ok else 1)


def launch(args) -> int:
    import torch

    procs_n = args.procs or torch.cuda.device_count()
    if procs_n < 1:
        raise SystemExit("no card: pass --procs with IYOKAN_TORCH_DEVICE=cpu")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "iyokan_tpu_torch.tools.mesh_run",
            "--worker", "--params", args.params, "--G", str(args.G),
            "--circuit", args.circuit, "--cycles", str(args.cycles)]
    procs = []
    t0 = time.time()
    for i in range(procs_n):
        env = dict(os.environ, IYOKAN_COORDINATOR=f"localhost:{port}",
                   IYOKAN_NUM_PROCESSES=str(procs_n),
                   IYOKAN_PROCESS_ID=str(i))
        procs.append(subprocess.Popen(argv, env=env, cwd=ROOT, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs, timed_out = [], False
    try:
        for pr in procs:
            outs.append(pr.communicate(
                timeout=max(1.0, args.timeout - (time.time() - t0)))[0])
    except subprocess.TimeoutExpired:
        timed_out = True
        for pr in procs:
            pr.kill()
        outs = [pr.communicate()[0] for pr in procs]
    recs = []
    for i, out in enumerate(outs):
        found = [ln[len("MESH_RESULT "):] for ln in out.splitlines()
                 if ln.startswith("MESH_RESULT ")]
        if not found:
            print(f"--- worker {i} (rc {procs[i].returncode}) ---\n"
                  + out[-4000:], flush=True)
        recs.append(json.loads(found[0]) if found else None)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except OSError:
        smi = []
    ok = (not timed_out and all(r and r["ok"] for r in recs)
          and all(pr.returncode == 0 for pr in procs))
    print(json.dumps({"ok": ok, "timed_out": timed_out, "procs": procs_n,
                      "cards": smi, "seconds": time.time() - t0,
                      "workers": recs}), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=0)
    ap.add_argument("--params", default="cggi128")
    ap.add_argument("--G", type=int, default=2048)
    ap.add_argument("--circuit", default="mac16")
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    return worker(args) if args.worker else launch(args)


if __name__ == "__main__":
    sys.exit(main())
