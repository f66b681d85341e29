"""The benchmark of iyokan_tpu_torch on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1> [--control <name>]

runs one cell of BENCHMARK.json (harness.py) on the card it is started on
and prints one JSON line last on standard output: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or under --trace 1 its
per-layer ones), device, the traced run's breakdown, and the numbers the
judgement compared, each beside its limit (also the last lines of standard
error).  It exits non-zero, printing no result, without a card, with fewer
cards than the cell asks for, or where a JAX module is loaded once the
window has closed.  --control runs a control (controls/<name>.json: the
program at a lower precision), which the judgement has to refuse.
Caches: build/portbench/ (keys, the key slab) and build/kernels/ (the
program's nvcc libraries), inside the checkout.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = ("jax", "jaxlib", "flax", "iyokan_tpu")


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: iyokan_tpu_torch is not iyokan_tpu)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_NAMES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from portbench import cells

    cell = cells.Manifest(ROOT).cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        err("no CUDA card: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        err(f"{args.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    from portbench import harness

    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), control=args.control,
                           t_start=T_START, log=err)
    bad = jax_modules()
    if bad:
        err(f"JAX modules loaded in the measuring process: {bad}")
        return 3
    err(f"run: {time.time() - T_START:.1f} s in all")
    for name, c in out["compared"].items():
        err(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
