"""Time variants of the cluster blind-rotation kernels (K3, K4, K5, K7)
built from edited copies of the kernel sources: a removal sequence, for
where a step's time goes, or one alternative form.

    python3 -m iyokan_tpu_torch.tools.br_variants VARIANTS [SIZES [KERNELS]]

VARIANTS (a JSON object, or the path of a file holding one) maps a
variant's name to its edits, each [file under csrc/, regular expression,
replacement] (an edit that matches nothing raises; a name with no edits
is the sources as they are).  Variants apply in the order given, each on
top of the ones before it: the first edits a copy of csrc/, each later one
a copy of the previous variant's sources, in build/br_variants/<name>/.
All variants build at once (ops/nvcc.py, one nvcc each, in parallel);
then each in turn is loaded in place of the repo's libraries (so a
variant's time less the previous one's is what its own edits cost, in
that order) and KERNELS run at the full step count on seeded random
cggi128 keys at each batch of SIZES (default 1,64,2048), timed by CUDA
events; a variant named "base" is held against the twins first.  KERNELS
(comma-separated, default br_ntt_loop,br3_ntt M=3): br_ntt_loop (K4, one
launch a rotation), br3_ntt M=3 (K3 on the unrolled key), br_ntt_step
(K5, n launches a rotation), br2_ntt M=3 and br2_ntt M=1 (K7, circuit
bootstrapping's lvl2 rotation on random unrolled and plain prep2 keys;
"base" holds each against its twin at the first batch), tkey_F S (K1 in
form F = loop, wgmma or mma on a random fat or unrolled slab S, e.g.
"tkey_loop fat"; the persistent form does not serve the unrolled slab;
"base" holds each against its twin).  For
measurement experiments only: the port
never runs an edited kernel, and `run` gives the repo's libraries back
when it ends.  Needs a card.

tools/br_ablation.json is the sequence behind PERF.md's K3/K4 breakdown
(cluster barriers, the forward transforms after the digit stages, the
inverse, the key reads, Garner's CRT):

    python3 -m iyokan_tpu_torch.tools.br_variants \\
        iyokan_tpu_torch/tools/br_ablation.json 1,64,2048

tools/k5_launch_ablation.json is K5's per-launch split (what a launch of
one step pays that K4's loop pays once; K5 with all of it removed, less
K4, is the launches' ramp and drain), and tools/k5_pdl.json compares
where a K5 step lets the next one launch (programmatic dependent launch:
after the second cluster barrier, as built, at entry, after the first
barrier, at exit, and without the attribute):

    python3 -m iyokan_tpu_torch.tools.br_variants \\
        iyokan_tpu_torch/tools/k5_launch_ablation.json 1,64,2048 \\
        br_ntt_step,br_ntt_loop
    python3 -m iyokan_tpu_torch.tools.br_variants \\
        iyokan_tpu_torch/tools/k5_pdl.json 1,8,64,256,2048 br_ntt_step

tools/k1_loop_ablation.json is K1's persistent form's removal sequence
(the grid barrier, the digits, the A gather, the cluster barriers, the
product, the reduction, the slab reads and their wait), and
tools/k1_loop_profile.json builds it with its clock profile on (each
launch prints each phase's cycles a step); chip_smoke.py's forms phase
runs both at G = 16 and 32:

    python3 -m iyokan_tpu_torch.tools.br_variants \\
        iyokan_tpu_torch/tools/k1_loop_ablation.json 16,32 "tkey_loop fat"

tools/k7_threads.json builds K7 at 512 threads a CTA beside its 1024,
tools/k7_rows.json at R_MAX = 1 (one row a cluster, on the same source),
and tools/k7_ablation.json is K7's removal sequence (cluster barriers,
the forward transforms after the digit stages, the inverse, the key
reads, Garner's CRT); chip_smoke.py's K7 phase runs all three (run_specs:
one parallel build) at G = 3, 24, 69.  tools/k7_forms.json holds K7's
two form choices against the source: the rotations as a loop, then one
digit region (and barrier 3) at every R:

    python3 -m iyokan_tpu_torch.tools.br_variants \\
        iyokan_tpu_torch/tools/k7_forms.json 3,31,69 \\
        "br2_ntt M=3,br2_ntt M=1"
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import sys

import numpy as np

import torch

from .. import params
from ..crypto import polymul
from ..crypto import ops as tops
from ..ops import br, br2, br3, nvcc, tkey
from . import br_profile, timing

OUT = os.path.join(os.path.dirname(nvcc.BUILD_DIR), "br_variants")
KERNELS = ("br_ntt_loop", "br3_ntt M=3")
SOURCE_OF = {"br_ntt_loop": br.SOURCE, "br_ntt_step": br.SOURCE,
             "br3_ntt M=3": br3.SOURCE, "br2_ntt M=3": br2.SOURCE,
             "br2_ntt M=1": br2.SOURCE,
             **{f"tkey_{f} {s}": tkey.SOURCE for f in tkey.FORM_LAUNCHES
                for s in ("fat", "unrolled")
                if (f, s) != ("loop", "unrolled")}}


def random_slab(p, unrolled, device):
    """A random K-contiguous tkey slab at the route's default limbs and
    lb: fat [n, RT, C], or the 2-bit-unrolled [ceil(n/2), 3RT, C]."""
    L, _, lb = tops.tkey_default_config(p)
    M = 3 if unrolled else 1
    steps = (p.n + 1) // 2 if unrolled else p.n
    return torch.randint(-128, 128, (steps, 2 * L * 128, M * (p.l + lb)
                                     * p.N), dtype=torch.int8,
                         device=device).movedim(1, -1)


def random_key2(p, M, rng, device):
    """A prep2 CB key of random lvl2 TRGSW rows, plain (M = 1, n steps) or
    2-bit-unrolled (M = 3, ceil(n/2) steps), with its K7 kernel form."""
    steps = p.n if M == 1 else (p.n + 1) // 2
    rows = rng.integers(0, 1 << 64, (steps, 2 * p.l2 * M, 2, p.N2),
                        dtype=np.uint64)
    key = polymul.prep2(torch.from_numpy(rows.view(np.int64)).to(device), p)
    return br2.attach_kernel_key2(key, p)


def load_spec(arg: str) -> dict:
    """VARIANTS from a JSON object or the path of a file holding one."""
    if arg.lstrip().startswith("{"):
        return json.loads(arg)
    with open(arg) as f:
        return json.load(f)


def prepare(variants: dict, root: str = OUT,
            cumulative: bool = True) -> list:
    """[(name, source directory)]: each variant's edits applied to a copy
    of the previous variant's sources (the first: of csrc/; with
    cumulative False, every one of csrc/), under root; a variant without
    edits keeps the previous directory (csrc/)."""
    out, src = [], nvcc.CSRC
    for name, edits in variants.items():
        if not cumulative:
            src = nvcc.CSRC
        if edits:
            d = os.path.join(root, name)
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(src, d, ignore=shutil.ignore_patterns("build"))
            for fn, pat, rep in edits:
                path = os.path.join(d, fn)
                with open(path) as f:
                    text, n = re.subn(pat, rep, f.read())
                if not n:
                    raise ValueError(f"{name}: {pat!r} matches nothing in "
                                     f"{fn}")
                with open(path, "w") as f:
                    f.write(text)
            src = d
        out.append((name, src))
    return out


def run(variants: dict, sizes, kernels=KERNELS, p=params.CGGI128,
        dev="cuda") -> list:
    """The timing records {spec, variant, kernel, G, ms} of every variant,
    kernel and batch; the repo's own libraries are loaded again at the
    end."""
    return run_specs({"": variants}, sizes, kernels, p, dev)


def run_specs(specs: dict, sizes, kernels=KERNELS, p=params.CGGI128,
              dev="cuda") -> list:
    """`run` for several specs {label: variants} at once: every variant of
    every spec built in one parallel round (spec `label`'s under
    OUT/label/), then each spec's variants timed in turn; the repo's
    sources ("base") are held against the twins once."""
    dirs = [(label, name, d) for label, variants in specs.items()
            for name, d in prepare(variants, os.path.join(OUT, label))]
    saved = nvcc.CSRC, nvcc.BUILD_DIR
    lib_dir = {d: saved[1] if d == saved[0] else os.path.join(d, "build")
               for _, _, d in dirs}
    srcs = sorted({SOURCE_OF[k] for k in kernels})
    with concurrent.futures.ThreadPoolExecutor(len(lib_dir)) as ex:
        list(ex.map(lambda d: nvcc.build(*srcs, csrc=d,
                                         build_dir=lib_dir[d]), lib_dir))
    rng = np.random.default_rng(3)
    plain = br_profile.random_key(p, p.n, 2 * p.l, rng, dev)
    unrolled = br_profile.random_key(p, (p.n + 1) // 2, 6 * p.l, rng, dev)
    keys2 = {int(k[-1]): random_key2(p, int(k[-1]), rng, dev)
             for k in kernels if k.startswith("br2_ntt")}
    slabs = {s: random_slab(p, s == "unrolled", dev)
             for s in {k.split()[1] for k in kernels if k.startswith("tkey")}}
    testv = torch.from_numpy(rng.integers(0, 1 << 32, p.N, dtype=np.uint32)
                             .view(np.int32)).to(dev)
    out, checked = [], False
    try:
        for label, name, d in dirs:
            nvcc.CSRC, nvcc.BUILD_DIR = d, lib_dir[d]
            nvcc._libs.clear()
            check = name == "base" and not checked
            if check:
                if {SOURCE_OF[k] for k in kernels} & {br.SOURCE, br3.SOURCE}:
                    br_profile.check(p, rng, dev)
                checked = True
            for G in sizes:
                acc = br_profile.random_acc(p, G, rng, dev)
                a = br_profile.amounts(p, (p.n, G), rng, dev)
                st = br3.rotation_steps(a, unrolled, p)
                acc2 = torch.from_numpy(rng.integers(
                    0, 1 << 64, (G, 2, p.N2), dtype=np.uint64).view(
                        np.int64)).to(dev)
                st2 = {M: br2.rotation_steps(torch.from_numpy(
                    rng.integers(0, 2 * p.N2, (p.n, G), dtype=np.int32)).to(
                        dev), k, p) for M, k in keys2.items()}
                tl = torch.from_numpy(rng.integers(
                    0, 1 << 32, (G, p.n + 1), dtype=np.uint32).view(
                        np.int32)).to(dev)
                fns = {"br_ntt_loop": lambda: br.br_loop(a, acc, plain, p),
                       "br_ntt_step": lambda: br.br_steps(a, acc, plain, p),
                       "br3_ntt M=3": lambda: br3.br3(st, acc, unrolled, p),
                       **{f"br2_ntt M={M}": (lambda M=M: br2.br2(
                           st2[M], acc2, keys2[M], p)) for M in keys2},
                       **{f"tkey_{f} {s}": (
                           lambda f=f, s=s: tkey.blind_rotate_tkey(
                               tl, slabs[s], testv, p, form=f))
                          for f in tkey.FORM_LAUNCHES for s in slabs}}
                if check and G == sizes[0]:
                    for M, k in keys2.items():
                        br_profile.same(
                            fns[f"br2_ntt M={M}"](),
                            br2.blind_rotate2_ref(st2[M], acc2, k, p),
                            f"K7 M={M} G={G}")
                    for k in kernels:
                        if k.startswith("tkey"):
                            br_profile.same(fns[k](),
                                            tkey.blind_rotate_tkey_ref(
                                                tl, slabs[k.split()[1]],
                                                testv, p), f"K1 {k} G={G}")
                for kernel in kernels:
                    fn = fns[kernel]
                    fn()
                    rec = {"spec": label, "variant": name, "kernel": kernel,
                           "G": G,
                           "ms": timing.timed_ms(fn, 2 if G >= 1024 else 3,
                                                 dev)}
                    out.append(rec)
                    print(json.dumps(rec), flush=True)
    finally:
        nvcc.CSRC, nvcc.BUILD_DIR = saved
        nvcc._libs.clear()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    variants = load_spec(argv[0])
    sizes = [int(x) for x in (argv[1] if len(argv) > 1
                              else "1,64,2048").split(",")]
    kernels = argv[2].split(",") if len(argv) > 2 else KERNELS
    out = run(variants, sizes, kernels)
    print(json.dumps({"variants": variants, "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
