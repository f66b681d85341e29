"""Generate the MAC-W test circuits tests/data/mac{W}-yosys.json + .toml.

The circuit is a W x W -> 2W-bit multiply-accumulate,

    acc <- acc + a * b  (mod 2^(2W))

with @a / @b circular per-cycle input streams, @reset a synchronous reset
of the accumulator registers and @acc the updated accumulator (after c
cycles: sum_{k<c} a_k * b_k mod 2^(2W)).  It is gate-only: partial products
are $_AND_, sums $_XOR_, full-adder carries $_MUX_(a^b ? cin : a), half-adder
carries $_AND_, and the 2W registers are $_DFF_P_ whose D input is
$_ANDNOT_(next, reset) -- what `dfflegalize -cell $_DFF_P_ 01` makes of a
$_SDFF_PP0_ (the Yosys reader rejects $_SDFF_* cells, as the reference's
does).  The partial-product rows are added into the accumulator one after
another with ripple-carry adders.

    python tests/data/gen_mac.py            # writes W = 2, 4, 16
"""

from __future__ import annotations

import json
import os
import sys


def mac_netlist(W: int) -> dict:
    """Yosys write_json-style netlist of the MAC-W module."""
    nets = iter(range(2, 1 << 30))
    cells = {}

    def cell(kind, **conn):
        y = next(nets)
        out = "Q" if kind == "$_DFF_P_" else "Y"
        cells[f"${kind[2:-1].lower()}${len(cells)}"] = {
            "type": kind,
            "connections": {**{k: [v] for k, v in conn.items()}, out: [y]},
        }
        return y

    clock, reset = next(nets), next(nets)
    a = [next(nets) for _ in range(W)]
    b = [next(nets) for _ in range(W)]
    # registers first (their Q nets are the sweep's sources); D wired below
    q_cells = []
    cur = []
    for _ in range(2 * W):
        name = f"$dff${len(cells)}"
        q = next(nets)
        cells[name] = {"type": "$_DFF_P_",
                       "connections": {"C": [clock], "D": [None], "Q": [q]}}
        q_cells.append(name)
        cur.append(q)

    def add(x, y, cin, need_carry):
        """(sum, carry) of one adder column; cin/y may be None."""
        if y is None:
            y, cin = cin, None
        if cin is None:
            s = cell("$_XOR_", A=x, B=y)
            return s, cell("$_AND_", A=x, B=y) if need_carry else None
        t = cell("$_XOR_", A=x, B=y)
        s = cell("$_XOR_", A=t, B=cin)
        return s, cell("$_MUX_", A=x, B=cin, S=t) if need_carry else None

    for i in range(W):
        carry = None
        for pos in range(i, 2 * W):
            j = pos - i
            pp = cell("$_AND_", A=a[j], B=b[i]) if j < W else None
            if pp is None and carry is None:
                break
            cur[pos], carry = add(cur[pos], pp, carry, pos < 2 * W - 1)

    for name, nxt in zip(q_cells, cur):
        cells[name]["connections"]["D"] = [cell("$_ANDNOT_", A=nxt, B=reset)]

    ports = {
        "clock": {"direction": "input", "bits": [clock]},
        "reset": {"direction": "input", "bits": [reset]},
        "a": {"direction": "input", "bits": a},
        "b": {"direction": "input", "bits": b},
        "acc": {"direction": "output", "bits": cur},
    }
    return {"creator": "tests/data/gen_mac.py",
            "modules": {f"mac{W}": {"ports": ports, "cells": cells}}}


def blueprint(W: int) -> str:
    return (
        f"# MAC-{W}: acc <- acc + a*b mod 2^{2 * W} (tests/data/gen_mac.py)\n"
        "[[file]]\n"
        'type = "yosys-json"\n'
        f'path = "mac{W}-yosys.json"\n'
        'name = "mac"\n'
        "\n"
        "[connect]\n"
        '"mac/reset" = "@reset"\n'
        f'"mac/a[0:{W - 1}]" = "@a[0:{W - 1}]"\n'
        f'"mac/b[0:{W - 1}]" = "@b[0:{W - 1}]"\n'
        f'"@acc[0:{2 * W - 1}]" = "mac/acc[0:{2 * W - 1}]"\n'
    )


def expected(W: int, a_vals, b_vals, cycles: int) -> int:
    """@acc after `cycles` cycles fed the circular streams a_vals/b_vals."""
    acc = 0
    for c in range(cycles):
        acc += a_vals[c % len(a_vals)] * b_vals[c % len(b_vals)]
    return acc % (1 << (2 * W))


def main(argv) -> int:
    out_dir = os.path.dirname(os.path.abspath(__file__))
    for W in (int(w) for w in (argv or ["2", "4", "16"])):
        with open(os.path.join(out_dir, f"mac{W}-yosys.json"), "w") as f:
            json.dump(mac_netlist(W), f, separators=(",", ":"))
            f.write("\n")
        with open(os.path.join(out_dir, f"mac{W}.toml"), "w") as f:
            f.write(blueprint(W))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
