"""Check and time the NTT blind-rotation kernels on the card: K4
(ops/br.py:br_loop), K3 (ops/br3.py:br3, M = 1 and 3), K5 (br_steps /
br_step) and K6 (ops/extprod.py:extprod1, RR = 2l and 3*2l).

    python3 -m iyokan_tpu_torch.tools.br_profile [--params cggi128]
        [--check-only] [--sizes 1,64,256,2048]

Builds the three NTT libraries (nvcc in parallel) and prints each
kernel's ptxas line and each cluster kernel's shared memory and
cudaOccupancyMaxActiveClusters.  Then every kernel against its plain twin
on seeded random accumulators, amounts and prep1 keys (a few steps),
raising on any difference or on a launch that is not one cluster of four
CTAs a row.  Unless --check-only: K4, K3 (M = 1, 3) and K5 at the full
step count on random keys, and K6 at 2l and 3*2l rows, K = 2, timed by
CUDA events at each batch (each at both thread counts a CTA,
the plan's pick marked: the figures behind ops/br.py:threads_for),
beside the card's nvidia-smi name and power limit; the last line is a
JSON record.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .. import params
from ..crypto import polymul
from ..ops import br, br3, extprod, nvcc
from . import timing


def random_key(p, steps, rr, rng, device):
    """A prep1 key of random TRGSW rows [steps, rr, 2, P, N] with its
    kernel form."""
    rows = rng.integers(0, 1 << 32, (steps, rr, 2, p.N), dtype=np.uint32)
    key = polymul.prep1(torch.from_numpy(rows.view(np.int32)).to(device), p)
    return br.attach_kernel_key(key, p)


def random_acc(p, G, rng, device):
    a = rng.integers(0, 1 << 32, (G, 2, p.N), dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def amounts(p, shape, rng, device):
    return torch.from_numpy(
        rng.integers(0, 2 * p.N, shape, dtype=np.int32)).to(device)


def same(got, want, what):
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        d = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
        raise AssertionError(f"{what}: kernel != twin, max |diff| {int(d)}")


def check(p, rng, dev="cuda"):
    """Every kernel == its twin on random inputs; returns the cases run."""
    cases = 0
    for G in (1, 2, 5, 13):
        acc = random_acc(p, G, rng, dev)
        key = random_key(p, 3, 2 * p.l, rng, dev)
        rows = amounts(p, (3, G), rng, dev)
        same(br.br_loop(rows, acc, key, p),
             br.cmux_steps_ref(rows, acc, key, p), f"K4 G={G}")
        if br.last_launch()[:2] != (br.CLUSTER * G, br.CLUSTER):
            raise AssertionError(f"K4 launched {br.last_launch()}")
        for M in (1, 3):
            keym = random_key(p, 2, 2 * p.l * M, rng, dev)
            st = amounts(p, (2, M, G), rng, dev)
            same(br3.br3(st, acc, keym, p), br3.br3_ref(st, acc, keym, p),
                 f"K3 M={M} G={G}")
        same(br.br_step(acc, rows[1], key, 1, p),
             br.cmux_steps_ref(rows[1:2], acc, key[1:2], p), f"K5 G={G}")
        same(br.br_steps(rows, acc, key, p),
             br.cmux_steps_ref(rows, acc, key, p), f"K5 x3 G={G}")
        if br.last_launch()[:2] != (br.CLUSTER * G, br.CLUSTER):
            raise AssertionError(f"K5 launched {br.last_launch()}")
        for K in (1, 2):
            for rr in (2 * p.l, 6 * p.l):
                d = torch.from_numpy(rng.integers(
                    -32, 33, (G, rr, p.N), dtype=np.int32)).to(dev)
                keys = random_key(p, K, rr, rng, dev)
                idx = None if K == 1 else torch.from_numpy(
                    rng.integers(0, 2, G).astype(np.int32))
                same(extprod.extprod1(d, keys, idx, p),
                     extprod.extprod1_ref(d, keys, idx, p),
                     f"K6 K={K} RR={rr} G={G}")
                if extprod.last_launch()[:2] != (br.CLUSTER * G, br.CLUSTER):
                    raise AssertionError(f"K6 launched "
                                         f"{extprod.last_launch()}")
        cases += 9
    return cases


def sweep(p, sizes, rng, dev="cuda"):
    """ms of a blind rotation at full depth of K4, K3 (M = 1, 3) and K5
    (n launches), and of one K6 call (2l and 3*2l rows, K = 2), per
    batch."""
    nh = (p.n + 1) // 2
    plain = random_key(p, p.n, 2 * p.l, rng, dev)
    unrolled = random_key(p, nh, 6 * p.l, rng, dev)
    keys2 = {rr: random_key(p, 2, rr, rng, dev) for rr in (2 * p.l, 6 * p.l)}
    out = []
    for G in sizes:
        acc = random_acc(p, G, rng, dev)
        a = amounts(p, (p.n, G), rng, dev)
        st1 = br3.rotation_steps(a, plain, p)
        st3 = br3.rotation_steps(a, unrolled, p)
        d = {rr: torch.from_numpy(rng.integers(-32, 32, (G, rr, p.N),
                                               dtype=np.int32)).to(dev)
             for rr in keys2}
        idx = torch.from_numpy(rng.integers(0, 2, G).astype(np.int32))

        for name, fn in (
                ("br_ntt_loop", lambda: br.br_loop(a, acc, plain, p)),
                ("br3_ntt M=1", lambda: br3.br3(st1, acc, plain, p)),
                ("br3_ntt M=3", lambda: br3.br3(st3, acc, unrolled, p)),
                ("br_ntt_step", lambda: br.br_steps(a, acc, plain, p)),
                *((f"extprod1_ntt K=2 RR={rr}", lambda rr=rr: extprod.extprod1(
                    d[rr], keys2[rr], idx, p)) for rr in keys2)):
            reps = 20 if name.startswith("extprod") else 2 if G >= 1024 else 3
            for nt in (br.WIDE_THREADS, br.NARROW_THREADS):
                rec = {"kernel": name, "G": G}
                with forced_threads(nt):
                    fn()
                    rec["ms"] = timing.timed_ms(fn, reps, dev)
                launched = (br3 if name.startswith("br3") else extprod
                            if name.startswith("extprod") else br).last_launch()
                rec.update(threads=launched[2], picked=forced_threads.picked)
                out.append(rec)
                print(json.dumps(rec), flush=True)
    return out


class _Forced:
    """forced_threads(nt): K3-K6 launches at nt threads a CTA within the
    block (None: the plan's own); .picked tells whether the plan would
    have picked nt for the last launch."""

    def __init__(self):
        self.nt, self.picked = None, None

    def __call__(self, nt):
        self.nt = nt
        return self

    def __enter__(self):
        self.plan = br.threads_for

        def forced(G, cap):
            self.picked = self.plan(G, cap) == self.nt
            return self.nt or self.plan(G, cap)

        br.threads_for = forced

    def __exit__(self, *exc):
        br.threads_for = self.plan


forced_threads = _Forced()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="cggi128")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--sizes", default="1,64,256,2048")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("br_profile needs an NVIDIA card")
    p = params.by_name(args.params)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    nvcc.build(br.SOURCE, br3.SOURCE, extprod.SOURCE)
    for src in (br.SOURCE, br3.SOURCE, extprod.SOURCE):
        for ln in nvcc.LOGS.get(src, "").splitlines():
            if "Used" in ln or "spill" in ln:
                print(f"[ptxas {src}] {ln.strip()}", flush=True)
    for nt in (br.WIDE_THREADS, br.NARROW_THREADS):
        print(f"[plan] clusters of {br.CLUSTER} CTAs of {nt} threads, "
              f"(smem B a CTA, clusters the card holds): K4 "
              f"{br.cluster_plan(p, nt)}, K3 M=1 {br3.cluster_plan(p, 1, nt)}"
              f", K3 M=3 {br3.cluster_plan(p, 3, nt)}, K6 RR=2l "
              f"{extprod.cluster_plan(p, 2 * p.l, nt)}, K6 RR=3*2l "
              f"{extprod.cluster_plan(p, 6 * p.l, nt)}", flush=True)
    rng = np.random.default_rng(7)
    n = check(p, rng)
    print(f"[check] {n} kernel == twin cases at {p.name} on {smi}",
          flush=True)
    recs = [] if args.check_only else sweep(
        p, [int(x) for x in args.sizes.split(",")], rng)
    print(smi)
    print(json.dumps({"card": smi, "params": p.name, "checked": n,
                      "sweep": recs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
