"""Time variants of the K3/K4 cluster kernels built from edited copies of
the kernel sources: a removal sequence, for where a step's time goes.

    python3 -m iyokan_tpu_torch.tools.br_variants VARIANTS [SIZES]

VARIANTS (a JSON object, or the path of a file holding one) maps a
variant's name to its edits, each [file under csrc/, regular expression,
replacement] (an edit that matches nothing raises; a name with no edits
is the sources as they are).  Variants apply in the order given, each on
top of the ones before it: the first copies csrc/, each later one the
previous variant's sources, into build/br_variants/<name>/, edits them,
builds them by ops/nvcc.py into its own directory and loads them in place
of the repo's libraries (so a variant's time less the previous one's is
what its own edits cost, in that order); then K4 and
K3 (M = 3) run at the full step count on seeded random cggi128 keys at
each batch of SIZES (default 1,64,2048), timed by CUDA events, and a
variant named "base" is held against the twins first.  For measurement
experiments only: the port never runs an edited kernel.  Needs a card.
tools/br_ablation.json is the sequence behind PERF.md's K3/K4 breakdown
(cluster barriers, the forward transforms after the digit stages, the
inverse, the key reads, Garner's CRT):

    python3 -m iyokan_tpu_torch.tools.br_variants \
        iyokan_tpu_torch/tools/br_ablation.json 1,64,2048
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys

import numpy as np

from .. import params
from ..ops import br, br3, nvcc
from . import br_profile, timing

OUT = os.path.join(os.path.dirname(nvcc.BUILD_DIR), "br_variants")


def build_variant(name: str, edits: list, src: str) -> str:
    """Copy the sources in src to OUT/<name>, apply the edits, point
    ops/nvcc.py at the copy (the libraries load from there from now on)
    and return its directory."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    for fn, pat, rep in edits:
        path = os.path.join(d, fn)
        with open(path) as f:
            text, n = re.subn(pat, rep, f.read())
        if not n:
            raise ValueError(f"{name}: {pat!r} matches nothing in {fn}")
        with open(path, "w") as f:
            f.write(text)
    nvcc.CSRC, nvcc.BUILD_DIR = d, os.path.join(d, "build")
    nvcc._libs.clear()
    nvcc.build(br.SOURCE, br3.SOURCE)
    return d


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[0].lstrip().startswith("{"):
        variants = json.loads(argv[0])
    else:
        with open(argv[0]) as f:
            variants = json.load(f)
    sizes = [int(x) for x in (argv[1] if len(argv) > 1
                              else "1,64,2048").split(",")]
    p, dev = params.CGGI128, "cuda"
    rng = np.random.default_rng(3)
    plain = br_profile.random_key(p, p.n, 2 * p.l, rng, dev)
    unrolled = br_profile.random_key(p, (p.n + 1) // 2, 6 * p.l, rng, dev)
    out, src = [], nvcc.CSRC
    for name, edits in variants.items():
        src = build_variant(name, edits, src)
        if name == "base":
            br_profile.check(p, rng, dev)
        for G in sizes:
            acc = br_profile.random_acc(p, G, rng, dev)
            a = br_profile.amounts(p, (p.n, G), rng, dev)
            st = br3.rotation_steps(a, unrolled, p)
            for kernel, fn in (
                    ("br_ntt_loop", lambda: br.br_loop(a, acc, plain, p)),
                    ("br3_ntt M=3", lambda: br3.br3(st, acc, unrolled, p))):
                fn()
                rec = {"variant": name, "kernel": kernel, "G": G,
                       "ms": timing.timed_ms(fn, 2 if G >= 1024 else 3, dev)}
                out.append(rec)
                print(json.dumps(rec), flush=True)
    print(json.dumps({"variants": variants, "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
