"""int8 dot rate against output width and contraction length, on the card.

    python3 -m iyokan_tpu_torch.tools.tk_width_bench [BG] [STEPS] [reps] [case...]

The port of tools/tk_width_bench.py: the same argv, cases and lines.  A
case runs STEPS steps of ndots dots [BG, K] x [K, NO] inside one launch of
the looped int8 product (ops/micro.py width_loop, csrc/micro.cu); dot d
reads the LHS window [:, 128 d : 128 d + K] of a [BG, K + 128 ndots]
buffer, the first 128 output columns accumulate (wrapping int32) and feed
the LHS's first 128 columns, and the other columns go into a checksum, so
every product is computed.  The right-hand side (up to 36 MB at w6144) is
read from L2 each step.  Cases (all by default, else those named):

  w768 8x[BG,6144]x[6144,768]    w1536 4x[BG,6144]x[6144,1536]
  w3072 2x[BG,6144]x[6144,3072]  w6144 1x[BG,6144]x[6144,6144]
  k18432 8x[BG,18432]x[18432,768] k3072 16x[BG,3072]x[3072,768]

All-ones inputs, CUDA-event times after a warm-up launch.  A case that
fails raises (the JAX tool printed FAILED and went on).  Runs on the card,
or the twins under IYOKAN_TORCH_DEVICE=cpu.  Imports no JAX.
"""

from __future__ import annotations

import sys
import time

import torch

from ..crypto import ops
from ..ops import micro
from .timing import timed_ms

CASES = [
    ("w768", "8x[BG,6144]x[6144,768]", (6144, 768, 8)),
    ("w1536", "4x[BG,6144]x[6144,1536]", (6144, 1536, 4)),
    ("w3072", "2x[BG,6144]x[6144,3072]", (6144, 3072, 2)),
    ("w6144", "1x[BG,6144]x[6144,6144]", (6144, 6144, 1)),
    ("k18432", "8x[BG,18432]x[18432,768]", (18432, 768, 8)),
    ("k3072", "16x[BG,3072]x[3072,768]", (3072, 768, 16)),
]


def main(argv=None) -> list:
    """Runs the cases and prints one line each; returns [(case, us/step,
    TMAC/s)]."""
    argv = sys.argv[1:] if argv is None else list(argv)
    BG = int(argv[0]) if len(argv) > 0 else 512
    STEPS = int(argv[1]) if len(argv) > 1 else 100
    reps = int(argv[2]) if len(argv) > 2 else 3
    names = set(argv[3:])
    dev = ops.default_device()
    rows = []
    for short, desc, (K, NO, ndots) in CASES:
        if names and short not in names:
            continue
        x = torch.ones((BG, K + 128 * ndots), dtype=torch.int8, device=dev)
        rhs = torch.ones((K, NO), dtype=torch.int8, device=dev)
        t0 = time.time()
        micro.width_loop(x, rhs, STEPS, ndots)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        comp = time.time() - t0
        ms = timed_ms(lambda: micro.width_loop(x, rhs, STEPS, ndots), reps,
                      dev)
        dt = ms / 1e3 / STEPS
        macs = ndots * BG * K * NO
        print(f"{short:7s} {desc}: {dt * 1e6:8.1f} us/step  "
              f"{macs / dt / 1e12:7.1f} TMAC/s  [compile {comp:.0f}s]",
              flush=True)
        rows.append((short, dt * 1e6, macs / dt / 1e12))
    return rows


if __name__ == "__main__":
    main()
