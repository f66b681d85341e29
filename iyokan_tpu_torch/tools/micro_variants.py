"""Time variants of the microbenchmark loops (csrc/micro.cu: alu_kernel,
roll_kernel, smallk_kernel) built from edited copies of the source, beside
the source as it is: the forms a kernel's design was chosen among.

    python3 -m iyokan_tpu_torch.tools.micro_variants VARIANTS [CASES]

VARIANTS is read as tools/br_variants.py reads it ([file under csrc/,
regular expression, replacement] edits), but every variant edits its own
copy of csrc/ (build/micro_variants/<name>/), and a variant with no edits
is the source as it is.  All build at once; each is then loaded in place
of the repo's library, held against the twins (1, 5 and 6 rounds on
seeded random inputs at the tools' shapes; a mismatch raises), and timed
on CASES (comma-separated, default all: the microbench bodies of
ops/micro.py:BODIES and smallk) by the difference method at 2000 rounds
after 0.2 s of warm-up, in turns: the variants in order, then in reverse.
Prints a JSON record a time and, last, {"variants", "us"}: each variant's
mean µs a round per case.  For measurement only: the port never runs an
edited kernel, and the repo's library is loaded again at the end.  Needs
a card.

tools/micro_forms.json holds the forms PERF.md compares (select's step,
the float round of barrett and conv, the rounds an unrolled iteration,
smallk's mma shape and tiles a warp):

    python3 -m iyokan_tpu_torch.tools.micro_variants \\
        iyokan_tpu_torch/tools/micro_forms.json
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import sys

import numpy as np
import torch

from ..ops import micro, nvcc
from . import br_variants, timing

OUT = os.path.join(os.path.dirname(nvcc.BUILD_DIR), "micro_variants")
CASES = tuple(micro.BODIES) + ("smallk",)
ROUNDS = 2000


def operands(rng, dev="cuda") -> dict:
    """case -> [inputs] at the tools' shapes (alu_operands; smallk: w [8,
    8], a [8, 3072, 128])."""
    ins = {b: micro.alu_operands(b, dev, rng) for b in micro.BODIES}
    ins["smallk"] = [torch.from_numpy(rng.integers(-128, 128, s,
                                                   dtype=np.int8)).to(dev)
                     for s in ((8, 8), (8, 3072, 128))]
    return ins


def runner(case: str, ins: list):
    """(n -> the kernel at n rounds, n -> its twin)."""
    if case == "smallk":
        return (lambda n: micro.smallk_loop(*ins, n),
                lambda n: micro.smallk_loop_ref(*ins, n))
    return (lambda n: micro.alu_loop(ins[0], case, n, *ins[1:]),
            lambda n: micro.alu_loop_ref(ins[0], case, n, *ins[1:]))


def run(variants: dict, cases=CASES) -> dict:
    """{variant: {case: mean µs a round over the two turns}}; raises if a
    variant's kernel differs from a twin."""
    dirs = br_variants.prepare(variants, OUT, cumulative=False)
    saved = nvcc.CSRC, nvcc.BUILD_DIR
    lib_dir = {d: saved[1] if d == saved[0] else os.path.join(d, "build")
               for _, d in dirs}
    with concurrent.futures.ThreadPoolExecutor(len(lib_dir)) as ex:
        list(ex.map(lambda d: nvcc.build(micro.SOURCE, csrc=d,
                                         build_dir=lib_dir[d]), lib_dir))
    ins = operands(np.random.default_rng(11))
    us = {name: {c: [] for c in cases} for name, _ in dirs}
    try:
        for turn in (dirs, dirs[::-1]):
            for name, d in turn:
                nvcc.CSRC, nvcc.BUILD_DIR = d, lib_dir[d]
                nvcc._libs.clear()
                for case in cases:
                    kern, twin = runner(case, ins[case])
                    if turn is dirs:
                        for n in (1, 5, 6):
                            got = kern(n)
                            torch.cuda.synchronize()
                            if not torch.equal(got, twin(n)):
                                raise AssertionError(
                                    f"{name}: {case} != twin at {n} rounds")
                    t = timing.marginal(kern, ROUNDS, "cuda", warm_s=0.2)
                    us[name][case].append(t * 1e6)
                    print(json.dumps({"variant": name, "case": case,
                                      "us": t * 1e6}), flush=True)
    finally:
        nvcc.CSRC, nvcc.BUILD_DIR = saved
        nvcc._libs.clear()
    return {name: {c: sum(v) / len(v) for c, v in per.items()}
            for name, per in us.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    variants = br_variants.load_spec(argv[0])
    cases = argv[1].split(",") if len(argv) > 1 else CASES
    print(json.dumps({"variants": list(variants),
                      "us": run(variants, cases)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
