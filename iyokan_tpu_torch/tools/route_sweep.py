"""The two candidate routes of a gate rotation, K1 on the tkey slab and K3
at M = 3 on the unrolled key, timed as the cells run them, at each batch
size.

    python3 -m iyokan_tpu_torch.tools.route_sweep [--sizes 1,16,...]
        [--reps 20] [--params cggi128] [--out FILE]

Routes: "tkey" = K1 on the tkey slab (ops/tkey.py, in the form its batch
takes: persistent, mma.sync or wgmma), "v3-unrolled" = K3 at M = 3 on the
2-bit-unrolled NTT key (ops/br3.py).  Both keys are made by
DeviceKeys.from_evalkey (IYOKAN_BR_IMPL=tkey with the unrolled key on,
slab cache off) from keys of fixed seeds, without circuit-bootstrapping
material.  At each size G, G NANDs of random encrypted bits: on the card
each route's blind rotation (set-up included, as crypto/ops.py:
blind_rotate runs it) is captured once as a CUDA graph and replayed, the
mean over --reps replays timed with CUDA events, in the order tkey, K3,
K3, tkey, and each route's ms a rotation is the mean of its two turns; on
the CPU the plain twins run eagerly, timed by the host clock.  Each
route's last result is sample-extracted, key-switched and decrypted
against the plain NANDs (wrong gates, and the largest phase distance from
+-mu in sixteenths of the torus).  The crossover printed is the largest
size up to which K3 was faster at every size measured (the port's rule,
crypto/ops.py:DeviceKeys, gives K3 every batch because it was faster at
every size up to the engine's BOOT_CHUNK).  Writes one JSON record
(--out).  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch

from .. import gates, params as params_mod
from ..crypto import host, ops
from ..ops import br3, tkey
from .measure_error_rate import device_record
from .timing import timed_ms

SIZES = "1,2,4,8,12,16,24,32,48,64,96,128,192,256,384,512,1024,2048"
ROUTES = ("tkey", "v3-unrolled")


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def route_keys(ek, device) -> dict:
    """{route: key} of both routes, from one preparation."""
    with _env(IYOKAN_BR_IMPL="tkey", IYOKAN_UNROLL_MAX="1",
              IYOKAN_SLAB_CACHE="0"):
        dk = ops.DeviceKeys.from_evalkey(ek, device, with_cb=False)
    return dk, {"tkey": dk.bk_tk, "v3-unrolled": dk.bk_ntt_u}


def rotate(route: str, key, pre, testv, p):
    if route == "tkey":
        return tkey.blind_rotate_tkey(pre, key, testv, p)
    return br3.blind_rotate_pallas3(pre, key, testv, p)


def _timer(fn, reps: int, device):
    """(ms a call, last result): fn replayed as a CUDA graph on the card
    (captured after one eager warm-up), called eagerly on the CPU."""
    if device.type != "cuda":
        out = [None]

        def call():
            out[0] = fn()

        return timed_ms(call, reps, device), out[0]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize(device)
    ms = timed_ms(graph.replay, reps, device)
    del graph
    return ms, out


def check(p, sk, keys, acc, want) -> dict:
    """Wrong NANDs and the largest phase distance from +-mu (1/16ths)."""
    lvl0 = ops.u32_numpy(ops.keyswitch_10(ops.sample_extract(acc, 0),
                                          keys.ksk_f64, p))
    ideal = np.where(want == 1, p.mu, (1 << 32) - p.mu).astype(np.int64)
    ph = host.tlwe0_phase(sk, lvl0).astype(np.int64)
    err = np.abs(((ph - ideal + (1 << 31)) % (1 << 32)) - (1 << 31))
    return {"wrong": int((host.decrypt_bits(sk, lvl0) != want).sum()),
            "max_phase_err": float(err.max()) / (1 << 28)}


def crossover(rows: list):
    """The largest size up to which K3 was faster at every size measured
    (0 where it lost at the smallest)."""
    best = 0
    for r in sorted(rows, key=lambda r: r["G"]):
        if r["ms"]["v3-unrolled"] >= r["ms"]["tkey"]:
            break
        best = r["G"]
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default=SIZES)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--params", default="cggi128")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    p = params_mod.by_name(args.params)
    device = ops.default_device()
    sk = host.keygen(p, seed=0)
    ek = host.genevalkey(sk, seed=1, with_cb=False)
    keys, bks = route_keys(ek, device)
    testv = torch.full((p.N,), p.mu, dtype=torch.int32, device=device)
    rng = np.random.default_rng(7)
    rows = []
    for G in (int(s) for s in args.sizes.split(",")):
        a = rng.integers(0, 2, G, dtype=np.uint8)
        b = rng.integers(0, 2, G, dtype=np.uint8)
        A = ops.u32_tensor(host.encrypt_bits(sk, a, rng), device)
        B = ops.u32_tensor(host.encrypt_bits(sk, b, rng), device)
        ca, cb, kk = (torch.full((G,), c, dtype=torch.int32, device=device)
                      for c in gates.GATE_LIN[gates.NAND])
        pre = ops.gate_linear(A, B, ca, cb, kk, p)
        want = 1 - (a & b)
        turns = {r: [] for r in ROUTES}
        checks = {}
        for route in ROUTES + ROUTES[::-1]:
            ms, acc = _timer(lambda: rotate(route, bks[route], pre, testv, p),
                             args.reps, device)
            turns[route].append(ms)
            checks[route] = check(p, sk, keys, acc, want)
        row = {"G": G, "ms": {r: float(np.mean(t)) for r, t in turns.items()},
               "turns": turns, "check": checks,
               "tkey_form": tkey.route_form(
                   "fat", -(-G // tkey.BLOCK_G) * tkey.BLOCK_G)}
        rows.append(row)
        k1, k3 = checks["tkey"], checks["v3-unrolled"]
        print(f"G={G:5d}  tkey {row['ms']['tkey']:9.3f} ms "
              f"({row['tkey_form']})  K3 M=3 "
              f"{row['ms']['v3-unrolled']:9.3f} ms  wrong {k1['wrong']}/"
              f"{k3['wrong']}  phase {k1['max_phase_err']:.4f}/"
              f"{k3['max_phase_err']:.4f}", flush=True)
    rec = {"params": p.name, "reps": args.reps,
           "device": device_record(device),
           "timing": "CUDA graph replays" if device.type == "cuda"
           else "eager, host clock", "rows": rows,
           "crossover": crossover(rows)}
    print(f"K3 faster up to G = {rec['crossover']} at every size measured")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
