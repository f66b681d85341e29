"""Write the nandwide circuit, a test fixture of the benchmark's:
nandwide-yosys.json and nandwide.toml.

    python3 portbench/tests/gen_nandwide.py [--lanes L] --out DIR

L lanes (default 2048, a power of two), exactly 8 levels of L 2-input
gates a cycle, each one bootstrapped row:

    level 1:        t1[i] = XOR(s[i], in[i])
    level j = 2..8: tj[i] = NAND(t(j-1)[i], t(j-1)[(i + 2^(j-2)) mod L])
    then            s <- t8

s is L DFFs ($_DFF_P_), 0 at power-on (no @reset: the DFFs start at 0 and
no reset settle runs), @in an L-bit input stream, @out all of s.  Each
level's rotation distance doubles, so after 8 levels every lane depends on
128 lanes of the level before the first.  Level 1 is an XOR, not a NAND:
from DFFs at 0, NAND(s, in) is 1 on every lane whatever the input, seven
NAND levels turn all-ones into all-zeros, and the state would stay 0 for
ever; s XOR in is a uniform bit every cycle.  The CPU tests write it at
64 lanes for the rehearsal of a cell of several cards, and at 2,048 to
check the levelizer and the work model on wide levels; no cell runs it.
"""

from __future__ import annotations

import argparse
import json
import os

LEVELS = 8


def netlist(lanes: int) -> dict:
    """Yosys write_json-style netlist of the nandwide module."""
    if lanes < 2 or lanes & (lanes - 1):
        raise ValueError(f"lanes must be a power of two, not {lanes}")
    nets = iter(range(2, 1 << 30))
    clock = next(nets)
    inp = [next(nets) for _ in range(lanes)]
    s = [next(nets) for _ in range(lanes)]
    cells = {}

    def gate(kind, a, b):
        y = next(nets)
        cells[f"${kind[2:-1].lower()}${len(cells)}"] = {
            "type": kind, "connections": {"A": [a], "B": [b], "Y": [y]}}
        return y

    t = [gate("$_XOR_", s[i], inp[i]) for i in range(lanes)]
    for j in range(2, LEVELS + 1):
        d = 1 << (j - 2)
        t = [gate("$_NAND_", t[i], t[(i + d) % lanes]) for i in range(lanes)]
    for i in range(lanes):
        cells[f"$dff${len(cells)}"] = {
            "type": "$_DFF_P_",
            "connections": {"C": [clock], "D": [t[i]], "Q": [s[i]]}}
    return {"creator": "portbench/tests/gen_nandwide.py",
            "modules": {"nandwide": {
                "ports": {"clock": {"direction": "input", "bits": [clock]},
                          "in": {"direction": "input", "bits": inp},
                          "out": {"direction": "output", "bits": s}},
                "cells": cells}}}


def blueprint(lanes: int) -> str:
    top = lanes - 1
    return (f"# nandwide: {lanes} lanes, {LEVELS} levels of {lanes} gates a "
            "cycle (gen_nandwide.py)\n"
            "[[file]]\n"
            'type = "yosys-json"\n'
            'path = "nandwide-yosys.json"\n'
            'name = "nw"\n\n'
            "[connect]\n"
            f'"nw/in[0:{top}]" = "@in[0:{top}]"\n'
            f'"@out[0:{top}]" = "nw/out[0:{top}]"\n')


def write(out_dir: str, lanes: int) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "nandwide-yosys.json"), "w") as f:
        json.dump(netlist(lanes), f, separators=(",", ":"))
    with open(os.path.join(out_dir, "nandwide.toml"), "w") as f:
        f.write(blueprint(lanes))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=2048)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    write(args.out, args.lanes)


if __name__ == "__main__":
    main()
