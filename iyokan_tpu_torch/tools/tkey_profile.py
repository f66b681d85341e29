"""Where the port's blind rotation spends its time on the card.

    python3 -m iyokan_tpu_torch.tools.tkey_profile [--G 1,64,2048] [--steps 635]

For each gate batch G: the CUDA kernel's time per blind rotation (CUDA
events, after a warm-up) in the form the route picks (ops/tkey.py
route_form: the persistent form below LOOP_MAX_G) and in the other two
forms, and one torch.profiler trace of a blind rotation split by kernel
(tkey_loop_kernel, or digits_kernel and conv_kernel or conv_wgmma_kernel)
with the device's idle share over the traced window and the product's
time per step (for the persistent form: its one launch over the steps).
Beside it, as a yardstick of the product alone (not a blind rotation, and
never called by the port): torch._int_mm of one step's K-major product
[NB*Gp, RT] x [RT, 2L*128] on random int8 operands made beforehand, B
column-major (the slab's K-contiguous storage).  Uses a random int8 slab of
the cggi128 shape [steps, 5120, 768], stored K-contiguous by
ops/tkey.py:k_contiguous (the kernel's cost depends on shapes only).
Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import torch

from .. import params
from ..ops import tkey
from .timing import int_mm_ms, timed_ms


def step_product_ms(G: int, p, L: int, lb: int, gen) -> float:
    """Mean ms of torch._int_mm on one step's K-major product at batch G
    (padded to the kernel's 16-gate tile), operands built beforehand."""
    Gp = -(-G // tkey.BLOCK_G) * tkey.BLOCK_G
    RT, C = (p.l + lb) * p.N, 2 * L * 128
    a = torch.randint(-32, 33, (p.N // 128 * Gp, RT), dtype=torch.int8,
                      device="cuda", generator=gen)
    b = torch.randint(-128, 128, (C, RT), dtype=torch.int8, device="cuda",
                      generator=gen)
    return int_mm_ms(a, b.t())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--G", default="1,64,2048")
    ap.add_argument("--steps", type=int, default=635)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    p = dataclasses.replace(params.CGGI128, n=args.steps)
    L, lb = 3, 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    bk = tkey.k_contiguous(torch.randint(
        -128, 128, (p.n, (p.l + lb) * p.N, 2 * L * 128), dtype=torch.int8,
        device="cuda", generator=gen))
    testv = torch.full((p.N,), p.mu, dtype=torch.int32, device="cuda")
    out = {"card": card, "steps": p.n, "rows": []}
    for G in (int(g) for g in args.G.split(",")):
        tl = torch.randint(-2**31, 2**31, (G, p.n + 1), dtype=torch.int64,
                           device="cuda", generator=gen).to(torch.int32)
        def rotate():
            tkey.blind_rotate_tkey(tl, bk, testv, p)
        rotate()
        torch.cuda.synchronize()
        ms = timed_ms(rotate, 3, "cuda")
        form = tkey.route_form("fat", -(-G // 16) * 16)
        others = {}
        for other in tkey.FORM_LAUNCHES:
            if other == form:
                continue

            def rotate_other(other=other):
                tkey.blind_rotate_tkey(tl, bk, testv, p, form=other)
            rotate_other()
            others[f"{other}_ms_per_blind_rotation"] = timed_ms(
                rotate_other, 3, "cuda")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            window_us = timed_ms(rotate, 1, "cuda") * 1e3
        mm_ms = step_product_ms(G, p, L, lb, gen)
        kern = {}
        for ev in prof.key_averages():
            if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
                continue                        # host-side op records
            dev_us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0))
            kern[ev.key[:80]] = {"device_us": dev_us, "calls": ev.count}
        busy = sum(v["device_us"] for v in kern.values())
        conv = [v for k, v in kern.items()
                if "conv_" in k or "tkey_loop" in k]
        row = {"G": G, "form": form, "ms_per_blind_rotation": ms, **others,
               "us_per_step": ms * 1e3 / p.n,
               "conv_us_per_step": (sum(v["device_us"] for v in conv)
                                    / max(1, sum(v["calls"] for v in conv))
                                    / (p.n if form == "loop" else 1)),
               "int_mm_product_only_us": mm_ms * 1e3,
               "traced_window_us": window_us, "kernels": kern,
               "device_idle_share": (1 - busy / window_us
                                     if window_us else None)}
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
