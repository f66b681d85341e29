"""The benchmark of iyokan_tpu_torch on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1> [--control <name>]

runs one cell of BENCHMARK.json (harness.py) on the cards of the machine it
is started on and prints one JSON line last on standard output: correct,
attempted,
failed, metrics (the cell's end-to-end metrics, or under --trace 1 its
per-layer ones), device, the traced run's breakdown, and the numbers the
judgement compared, each beside its limit (also the last lines of standard
error).  A cell of N > 1 chips runs as N processes on the program's mesh,
this one rank 0 on card 0: it starts ranks 1 .. N-1 (this script again,
with --rank, --coordinator and --parent; crew.py), which print no result.
It exits non-zero, printing no result, without a card, with fewer cards
than the cell asks for, where a JAX module is loaded in any rank once the
window has closed, or where a rank fails, ends or stalls (every rank is
then ended).  --control runs a control (controls/<name>.json: the
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
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = ("jax", "jaxlib", "flax", "iyokan_tpu")


def err(msg: str) -> None:
    # one write a line: the ranks of a cell share standard error
    sys.stderr.write(f"{msg}\n")
    sys.stderr.flush()


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: iyokan_tpu_torch is not iyokan_tpu)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_NAMES)


def _leave(code: int):
    """End a process of a cell of several cards without the process
    groups' teardown at interpreter exit, which can hang or abort once a
    peer has gone."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def worker(args, chips: int, device: str) -> int:
    """Rank args.rank of a cell of several cards: the same run, no result
    printed; rank 0 (the parent) reads what it sends."""
    from portbench import crew, harness

    crew.die_with_parent(args.parent)
    ranks = harness.Ranks(coordinator=args.coordinator, world=chips,
                          rank=args.rank)
    try:
        harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), device=device,
                         control=args.control, t_start=T_START,
                         log=lambda m: err(f"rank {args.rank}: {m}"),
                         ranks=ranks)
    except BaseException:
        traceback.print_exc()
        _leave(1)
    bad = jax_modules()
    if bad:
        err(f"rank {args.rank}: JAX modules loaded: {bad}")
        _leave(3)
    _leave(0)


def main(argv=None, device: str = "cuda") -> int:
    """device "cpu" runs the program's CPU twins (the CPU rehearsal's
    entry; the command never passes it)."""
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    for hidden in ("--rank", "--parent"):
        ap.add_argument(hidden, type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from portbench import cells

    cell = cells.Manifest(ROOT).cell(args.workload)
    chips = int(cell["chips"])
    import torch

    if device != "cpu":
        if not torch.cuda.is_available():
            err("no CUDA card: torch.cuda.is_available() is False")
            return 2
        if torch.cuda.device_count() < chips:
            err(f"{args.workload} needs {chips} cards, "
                f"{torch.cuda.device_count()} present")
            return 2
    if args.rank:
        return worker(args, chips, device)
    from portbench import crew, harness

    team = ranks = None
    if chips > 1:
        team = crew.Crew(os.path.abspath(sys.argv[0]), argv, chips, err)
        ranks = harness.Ranks(coordinator=team.coordinator, world=chips,
                              rank=0)
    try:
        out = harness.run_cell(
            ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
            device=device, control=args.control, t_start=T_START, log=err,
            ranks=ranks, progress=team.progress if team else None)
        if team:
            team.finish()
    except BaseException:
        if team is None:
            raise
        traceback.print_exc()
        team.kill()
        _leave(1)
    bad = jax_modules()
    if bad:
        err(f"JAX modules loaded in the measuring process: {bad}")
        return _leave(3) if team else 3
    err(f"run: {time.time() - T_START:.1f} s in all")
    for name, c in out["compared"].items():
        err(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    if team:
        _leave(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
