"""Gate-failure rate and phase noise of the port's gate bootstrap.

    python3 -m iyokan_tpu_torch.tools.measure_error_rate

The port of tools/measure_error_rate.py, with its knobs, defaults, seeds
and statistics: ER_BATCHES batches (default 25) of ER_G (4096) mixed
2-input gates of the 8 kinds, fresh random inputs each, through
gate_linear -> the bk_for(ER_G) blind rotation -> keyswitch_10, counting
decryption errors and the phase noise of the outputs; then ER_CASCADE (8)
rounds in which each round's outputs are the next round's inputs.  Keys
from seeds 0 (secret) and 1 (evaluation, no circuit-bootstrapping keys),
inputs from numpy's default_rng(99), parameters ER_PARAMS (cggi128).  The
route is the one DeviceKeys.bk_for gives under the usual knobs
(IYOKAN_BR_IMPL unset: the tkey slab; v3, pallas, pallas2 ...).

The record goes to ER_OUT (default ERROR_RATE_H100.json at the repo root;
ERROR_RATE.json there is the JAX package's record from a TPU): gates,
wrong, the phase sigma against the budget of params.py and the margin of
the 1/16 threshold in sigmas, the cascade's counts, the route, the seconds
the gate calls took (synced, after one warm-up batch on trivial zeros),
the device (the card's name and nvidia-smi power limit) and the IYOKAN_*
knobs.  Exits 1 when a gate is wrong or sigma exceeds 1.5
times the budget.  Runs on the card unless IYOKAN_TORCH_DEVICE names
another device (cpu: the kernels' plain twins).  Imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import gates, params as params_mod
from ..crypto import host, ops

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PLAIN = {
    gates.AND: lambda a, b: a & b,
    gates.NAND: lambda a, b: 1 - (a & b),
    gates.ANDNOT: lambda a, b: a & (1 - b),
    gates.OR: lambda a, b: a | b,
    gates.NOR: lambda a, b: 1 - (a | b),
    gates.ORNOT: lambda a, b: a | (1 - b),
    gates.XOR: lambda a, b: a ^ b,
    gates.XNOR: lambda a, b: 1 - (a ^ b),
}
KINDS = list(PLAIN)


def device_record(device: torch.device) -> dict:
    """The device the gates ran on: the card's name and nvidia-smi's
    power limit, or the CPU."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = None
    return {"name": torch.cuda.get_device_name(device),
            "power_limit": smi.split(",")[-1].strip() if smi else None}


def main() -> dict:
    G = int(os.environ.get("ER_G", "4096"))
    batches = int(os.environ.get("ER_BATCHES", "25"))
    cascade = int(os.environ.get("ER_CASCADE", "8"))
    p = params_mod.by_name(os.environ.get("ER_PARAMS", "cggi128"))
    device = ops.default_device()
    sk = host.keygen(p, seed=0)
    ek = host.genevalkey(sk, seed=1, with_cb=False)
    keys = ops.DeviceKeys.from_evalkey(ek, device, with_cb=False)
    bk = keys.bk_for(G)
    rng = np.random.default_rng(99)
    gate_s = [0.0]

    def run(A, B, lin):
        t0 = time.time()
        ca, cb, kk = (torch.as_tensor(lin[:, i], device=device)
                      for i in range(3))
        pre = ops.gate_linear(A, B, ca, cb, kk, p)
        out = ops.keyswitch_10(ops.gate_bootstrap_tlwe1(pre, bk, p),
                               keys.ksk_f64, p)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        gate_s[0] += time.time() - t0
        return out

    def operands(kinds, a, b):
        lin = np.array([gates.GATE_LIN[KINDS[k]] for k in kinds], np.int32)
        want = np.array([PLAIN[KINDS[k]](int(x), int(y))
                         for k, x, y in zip(kinds, a, b)], np.uint8)
        return lin, want

    # the kernels' first-use set-up (loading, first launch) outside the
    # timed calls: one batch of NANDs on trivial zeros (no rng draws)
    zeros = torch.zeros((G, p.n + 1), dtype=torch.int32, device=device)
    run(zeros, zeros, np.array([gates.GATE_LIN[gates.NAND]] * G, np.int32))
    gate_s[0] = 0.0

    total = wrong = 0
    errs = []
    t0 = time.time()
    for it in range(batches):
        kinds = rng.integers(0, len(KINDS), G)
        a = rng.integers(0, 2, G, dtype=np.uint8)
        b = rng.integers(0, 2, G, dtype=np.uint8)
        A = ops.u32_tensor(host.encrypt_bits(sk, a, rng), device)
        B = ops.u32_tensor(host.encrypt_bits(sk, b, rng), device)
        lin, want = operands(kinds, a, b)
        out = ops.u32_numpy(run(A, B, lin))
        got = host.decrypt_bits(sk, out)
        wrong += int((got != want).sum())
        total += G
        phase = host.tlwe0_phase(sk, out).astype(np.int64)
        signed = np.where(phase > 1 << 31, phase - (1 << 32), phase)
        errs.append(np.where(want == 1, signed - p.mu, signed + p.mu))
        print(f"batch {it+1}/{batches}: cumulative errors {wrong}/{total}",
              flush=True)

    # cascade rounds: outputs feed the next round's inputs (the next gate's
    # linear combination sums two bootstrapped outputs' noise)
    c_wrong = c_total = 0
    if cascade:
        a = rng.integers(0, 2, G, dtype=np.uint8)
        b = rng.integers(0, 2, G, dtype=np.uint8)
        A = ops.u32_tensor(host.encrypt_bits(sk, a, rng), device)
        B = ops.u32_tensor(host.encrypt_bits(sk, b, rng), device)
        for r in range(cascade):
            kinds = rng.integers(0, len(KINDS), G)
            lin, want = operands(kinds, a, b)
            out = run(A, B, lin)
            got = host.decrypt_bits(sk, ops.u32_numpy(out))
            c_wrong += int((got != want).sum())
            c_total += G
            # outputs become one operand, a shuffled copy the other
            perm = rng.permutation(G)
            A, B = out, out[torch.as_tensor(perm, device=device)]
            a, b = want, want[perm]
            print(f"cascade {r+1}/{cascade}: cumulative errors "
                  f"{c_wrong}/{c_total}", flush=True)

    wall = time.time() - t0
    err = np.concatenate(errs)
    sigma = err.std() / 2.0 ** 32
    route = ops.gate_route(bk, p)
    print(f"\n{total} gates, {wrong} wrong (rate {wrong/total:.2e})")
    if cascade:
        print(f"cascade: {c_total} chained gates, {c_wrong} wrong "
              f"(rate {c_wrong/max(c_total,1):.2e})")
    print(f"phase sigma = 2^{math.log2(sigma):.2f} "
          f"(threshold 1/16 = 2^-4; margin {(1/16)/sigma:.1f} sigma)")
    print(f"route {route}; gates {gate_s[0]:.1f} s "
          f"({(total + c_total) / gate_s[0]:.1f} gates/s); wall {wall:.1f} s")

    out_path = os.environ.get("ER_OUT",
                              os.path.join(ROOT, "ERROR_RATE_H100.json"))
    budget_sigma = 2.0 ** -8.2
    rec = {
        "params": p.name,
        "gates": total,
        "wrong": wrong,
        "error_rate": wrong / total,
        "sigma": sigma,
        "sigma_log2": math.log2(sigma),
        "budget_sigma_log2": math.log2(budget_sigma),
        "threshold": 1 / 16,
        "margin_sigmas": (1 / 16) / sigma,
        "cascade_gates": c_total,
        "cascade_wrong": c_wrong,
        "route": route,
        "gate_s": gate_s[0],
        "wall_s": wall,
        "device": device_record(device),
        "env": {k: v for k, v in os.environ.items()
                if k.startswith("IYOKAN_")},
    }
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out_path}")
    if wrong or sigma > budget_sigma * 1.5:
        sys.exit(1)
    return rec


if __name__ == "__main__":
    main()
