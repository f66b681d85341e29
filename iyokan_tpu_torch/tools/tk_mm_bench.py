"""Dot-core benchmark of the tkey step, on the card.

    python3 -m iyokan_tpu_torch.tools.tk_mm_bench [BG] [STEPS] [reps] [case...]

The port of tools/tk_mm_bench.py: the same argv, cases and lines.  Each
case runs STEPS steps of the looped int8 product (ops/micro.py tk_loop,
csrc/micro.cu mm_step_kernel: one wgmma launch a step over 128-row tiles,
the right-hand side K-major, read from L2):

  fat    per step 8 dots [BG, 6144] x [6144, 768] (j folded into the
         contraction), w_K = (s[:, :128] + s[:, 128:256]) & 31 tiled 12x
         into the next LHS;
  thin   per step 8 blocks x 6 j-dots [BG, 1024] x [1024, 768] summed;
  pure   the 8 fat dots summed into a wrapping int32 accumulator, whose
         first 128 columns become the LHS's (the pure-dot ceiling);
  puret  pure with the RHS stored [768, 6144] (contraction contiguous).

Without case names it runs fat and thin.  Inputs are all ones, as in the
JAX tool.  Times come from CUDA events after a warm-up launch (the first
line's "compile" is that launch, nvcc build included); "TOPS" is MACs per
second / 1e12, as the JAX tool prints it.  Runs on the card, or on the CPU
(the twins) when IYOKAN_TORCH_DEVICE=cpu; never falls back.  Imports no
JAX.
"""

from __future__ import annotations

import sys
import time

import torch

from ..crypto import ops
from ..ops import micro
from .timing import timed_ms


def main(argv=None) -> list:
    """Runs the cases and prints one line each; returns [(case, us/step,
    TMAC/s)]."""
    argv = sys.argv[1:] if argv is None else list(argv)
    BG = int(argv[0]) if len(argv) > 0 else 512
    STEPS = int(argv[1]) if len(argv) > 1 else 100
    reps = int(argv[2]) if len(argv) > 2 else 3
    dev = ops.default_device()
    ones = {"x": torch.ones((BG, 12288), dtype=torch.int8, device=dev),
            "x3": torch.ones((BG, 6, 2048), dtype=torch.int8, device=dev),
            "fat": torch.ones((6144, 768), dtype=torch.int8, device=dev),
            "t": torch.ones((768, 6144), dtype=torch.int8, device=dev),
            "thin": torch.ones((1024, 768), dtype=torch.int8, device=dev)}
    cases = []
    if "puret" in argv:
        cases.append(("puret 8x[BG,6144]x[768,6144]T", "puret", ones["x"],
                      ones["t"], 8 * BG * 6144 * 768))
    if "pure" in argv:
        cases.append(("pure 8x[BG,6144]x[6144,768]", "pure", ones["x"],
                      ones["fat"], 8 * BG * 6144 * 768))
    if "fat" in argv or len(argv) < 4:
        cases.append(("fat  8x[BG,6144]x[6144,768]", "fat", ones["x"],
                      ones["fat"], 8 * BG * 6144 * 768))
    if "thin" in argv or len(argv) < 4:
        cases.append(("thin 48x[BG,1024]x[1024,768]", "thin", ones["x3"],
                      ones["thin"], 48 * BG * 1024 * 768))

    rows = []
    for name, mode, x, rhs, macs in cases:
        t0 = time.time()
        micro.tk_loop(x, rhs, STEPS, mode)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"# {name} compile {time.time() - t0:.0f}s", flush=True)
        ms = timed_ms(lambda: micro.tk_loop(x, rhs, STEPS, mode), reps, dev)
        dt = ms / 1e3 / STEPS
        print(f"{name}: {dt * 1e6:8.1f} us/step  "
              f"{macs / dt / 1e12:7.1f} TOPS  "
              f"(635 steps x {1024 // BG} blocks = "
              f"{dt * 635 * (1024 // BG) * 1e3:.1f} ms/1024 gates)",
              flush=True)
        rows.append((mode, dt * 1e6, macs / dt / 1e12))
    return rows


if __name__ == "__main__":
    main()
