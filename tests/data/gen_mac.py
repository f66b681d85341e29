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

memmac.toml wires MAC-4 between CMUX memories at the size of a small
processor's: a 128 x 32-bit ROM (512 B, 4 TRLWEs at N = 1024) feeds
@a = rdata[0:3] and @b = rdata[4:7]; the accumulator is the write data of
ramA, and ramB is written from @wdataB; both RAMs are 256 x 8 bits.  Gate
levels and memory levels alternate within one cycle.  memmac_request and
memmac_expected give a request that writes on cycle 0 and reads it back
later, and the outputs and RAM images Python integers predict for it.

    python tests/data/gen_mac.py            # writes W = 2, 4, 16 + memmac
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


MEMMAC = {"rom_addr": 7, "rom_width": 32, "ram_addr": 8, "ram_width": 8}


def memmac_blueprint() -> str:
    m = MEMMAC
    ra, rw = m["ram_addr"] - 1, m["ram_width"] - 1
    rams = "".join(
        "\n[[builtin]]\n"
        'type = "ram"\n'
        f'name = "{nm}"\n'
        f'in_addr_width = {m["ram_addr"]}\n'
        f'in_wdata_width = {m["ram_width"]}\n'
        f'out_rdata_width = {m["ram_width"]}\n'
        for nm in ("ramA", "ramB"))
    return (
        "# memmac: MAC-4 between a CMUX ROM and two CMUX RAMs "
        "(tests/data/gen_mac.py)\n"
        "[[file]]\n"
        'type = "yosys-json"\n'
        'path = "mac4-yosys.json"\n'
        'name = "mac"\n'
        "\n[[builtin]]\n"
        'type = "rom"\n'
        'name = "rom"\n'
        f'in_addr_width = {m["rom_addr"]}\n'
        f'out_rdata_width = {m["rom_width"]}\n'
        + rams +
        "\n[connect]\n"
        '"mac/reset" = "@reset"\n'
        f'"rom/addr[0:{m["rom_addr"] - 1}]" = "@romaddr[0:{m["rom_addr"] - 1}]"\n'
        '"mac/a[0:3]" = "rom/rdata[0:3]"\n'
        '"mac/b[0:3]" = "rom/rdata[4:7]"\n'
        f'"ramA/addr[0:{ra}]" = "@addrA[0:{ra}]"\n'
        '"ramA/wren" = "@wrenA"\n'
        f'"ramA/wdata[0:{rw}]" = "mac/acc[0:7]"\n'
        f'"ramB/addr[0:{ra}]" = "@addrB[0:{ra}]"\n'
        '"ramB/wren" = "@wrenB"\n'
        f'"ramB/wdata[0:{rw}]" = "@wdataB[0:{rw}]"\n'
        f'"@rdataA[0:{rw}]" = "ramA/rdata[0:{rw}]"\n'
        f'"@rdataB[0:{rw}]" = "ramB/rdata[0:{rw}]"\n'
        '"@acc[0:7]" = "mac/acc[0:7]"\n'
    )


def _bits(vals, width):
    return [(int(v) >> k) & 1 for v in vals for k in range(width)]


def memmac_request(cycles: int, seed: int):
    """(rom bits, {ram: bits}, {@input: bits}) of a memmac request.

    Random ROM and RAM contents.  Cycle 0 writes both RAMs (ramA the
    accumulator, ramB a random byte); odd cycles write fresh addresses;
    even cycles > 0 read cycle 0's addresses back without writing."""
    import numpy as np

    m = MEMMAC
    rng = np.random.default_rng(seed)
    rom = rng.integers(0, 2, (1 << m["rom_addr"]) * m["rom_width"])
    rams = {nm: rng.integers(0, 2, (1 << m["ram_addr"]) * m["ram_width"])
            for nm in ("ramA", "ramB")}
    romaddr = rng.integers(0, 1 << m["rom_addr"], cycles)
    wdataB = rng.integers(0, 1 << m["ram_width"], cycles)
    streams = {"romaddr": _bits(romaddr, m["rom_addr"]),
               "wdataB": _bits(wdataB, m["ram_width"])}
    for x in ("A", "B"):
        fresh = rng.choice(1 << m["ram_addr"], cycles, replace=False)
        addr = [fresh[c] if c % 2 else fresh[0] for c in range(cycles)]
        streams[f"addr{x}"] = _bits(addr, m["ram_addr"])
        streams[f"wren{x}"] = [int(c == 0 or c % 2 == 1)
                               for c in range(cycles)]
    to8 = (lambda b: np.asarray(b, np.uint8))
    return (to8(rom), {k: to8(v) for k, v in rams.items()},
            {k: to8(v) for k, v in streams.items()})


def memmac_expected(rom, rams, streams, cycles: int):
    """Python-integer model of memmac after `cycles` cycles (after the
    @reset settle): ({"acc", "rdataA", "rdataB"} of the last cycle,
    {ram: final bits})."""
    m = MEMMAC

    def word(bits, i, w):
        return sum(int(bits[i * w + k]) << k for k in range(w))

    def field(name, c, w):
        return word(streams[name], c, w)

    mem = {nm: [word(b, i, m["ram_width"])
                for i in range(1 << m["ram_addr"])]
           for nm, b in rams.items()}
    acc, out = 0, {}
    for c in range(cycles):
        rdata = word(rom, field("romaddr", c, m["rom_addr"]), m["rom_width"])
        acc = (acc + (rdata & 15) * ((rdata >> 4) & 15)) % 256
        out["acc"] = acc
        for x, wdata in (("A", acc), ("B", field("wdataB", c, m["ram_width"]))):
            ram = mem[f"ram{x}"]
            addr = field(f"addr{x}", c, m["ram_addr"])
            out[f"rdata{x}"] = ram[addr]
            if streams[f"wren{x}"][c]:
                ram[addr] = wdata
    final = {nm: [(v >> k) & 1 for v in words for k in range(m["ram_width"])]
             for nm, words in mem.items()}
    return out, final


def main(argv) -> int:
    out_dir = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(out_dir, "memmac.toml"), "w") as f:
        f.write(memmac_blueprint())
    for W in (int(w) for w in (argv or ["2", "4", "16"])):
        with open(os.path.join(out_dir, f"mac{W}-yosys.json"), "w") as f:
            json.dump(mac_netlist(W), f, separators=(",", ":"))
            f.write("\n")
        with open(os.path.join(out_dir, f"mac{W}.toml"), "w") as f:
            f.write(blueprint(W))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
