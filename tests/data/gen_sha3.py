"""Generate the SHA3-256 circuit, portbench/configs/sha3/sha3-yosys.json and
sha3.toml.

The circuit is the sponge of SHA3-256 as NIST FIPS 202 defines it: rate
1088, capacity 512, on Keccak-f[1600] = Keccak-p[1600, 24].  Its 1,600-bit
state S lives in $_DFF_P_ cells with no reset logic, so it starts at
FIPS 202's all-zero state (a TFHE Frontend starts every DFF as a trivial
0).  Each cycle absorbs one 1088-bit block and permutes:

  * absorb: A = S xor (block || 0^512), 1,088 XORs on lanes 0 .. 16;
  * 24 rounds, Rnd = iota o chi o pi o rho o theta (FIPS 202 Sec. 3.3):
      theta  C[x] = (A[x,0] ^ A[x,1]) ^ (A[x,2] ^ A[x,3]) ^ A[x,4],
             D[x,z] = C[x-1,z] ^ C[x+1,z-1], A ^ D;
      rho, pi  wiring;
      chi    B[x] ^ $_ANDNOT_(B[x+2], B[x+1]), i.e. B[x] ^ (~B[x+1] & B[x+2]);
      iota   folded in: where the round constant's bit is 1, lane (0,0)'s
             chi XOR is an XNOR;
  * @digest is bits 0 .. 255 of the new state, which the DFFs latch.

So the circuit has only $_XOR_, $_XNOR_ and $_ANDNOT_ gates and the DFFs:
no NOT gate and no constant.

Bit order (FIPS 202 Sec. 3.1.2 and B.1).  State bit w(5y + x) + z is
A[x, y, z]; bit 8i + j of @block and @digest is bit j of byte i of the
block or digest.  A client pads its message with SHA3's suffix 01 and
pad10*1 (bytes 0x06 .. 0x80) into 136-byte blocks and sends one a cycle;
after the last, @digest is SHA3-256 of the message.

keccak_netlist(w, rounds, rate, out_bits) builds the sponge on any
Keccak-p[25w, rounds] (Sec. 3.4: the last `rounds` of the 12 + 2l rounds
of Keccak-f[25w], round constants from Sec. 3.2.5's LFSR), so the CPU
tests can run small permutations.

    python tests/data/gen_sha3.py       # writes the configuration's copy
"""

from __future__ import annotations

import json
import os
import sys

import gen_aes
from gen_aes import Netlist, netlist_text

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "portbench", "configs", "sha3")
NETLIST = "sha3-yosys.json"


def rc_bit(t: int) -> int:
    """rc(t), FIPS 202 Algorithm 5: the LFSR x^8 + x^6 + x^5 + x^4 + 1."""
    if t % 255 == 0:
        return 1
    r = [1, 0, 0, 0, 0, 0, 0, 0]
    for _ in range(t % 255):
        r = [0] + r
        for k in (0, 4, 5, 6):
            r[k] ^= r[8]
        r = r[:8]
    return r[0]


def round_constant(ir: int, w: int) -> int:
    """RC of round ir as a w-bit lane (Algorithm 6): bit 2^j - 1 is
    rc(j + 7 ir) for j = 0 .. log2 w."""
    out = 0
    for j in range(w.bit_length()):
        out |= rc_bit(j + 7 * ir) << ((1 << j) - 1)
    return out


def rho_offsets(w: int) -> list:
    """offsets[x][y] of rho (Algorithm 2), mod w."""
    off = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        off[x][y] = (t + 1) * (t + 2) // 2 % w
        x, y = y, (2 * x + 3 * y) % 5
    return off


def keccak_round(nl: Netlist, a: list, ir: int, w: int) -> list:
    """One round of Keccak-p on the state's nets a[x][y][z]."""
    c = [[nl.xor(nl.xor(nl.xor(a[x][0][z], a[x][1][z]),
                        nl.xor(a[x][2][z], a[x][3][z])), a[x][4][z])
          for z in range(w)] for x in range(5)]
    d = [[nl.xor(c[(x - 1) % 5][z], c[(x + 1) % 5][(z - 1) % w])
          for z in range(w)] for x in range(5)]
    a = [[[nl.xor(a[x][y][z], d[x][z]) for z in range(w)]
          for y in range(5)] for x in range(5)]
    off = rho_offsets(w)
    a = [[[a[x][y][(z - off[x][y]) % w] for z in range(w)]
          for y in range(5)] for x in range(5)]                    # rho
    b = [[a[(x + 3 * y) % 5][x] for y in range(5)] for x in range(5)]  # pi
    rc = round_constant(ir, w)
    out = [[[None] * w for _ in range(5)] for _ in range(5)]
    for y in range(5):
        for x in range(5):
            for z in range(w):
                t = nl.gate("$_ANDNOT_", b[(x + 2) % 5][y][z],
                            b[(x + 1) % 5][y][z])
                iota = x == 0 and y == 0 and rc >> z & 1
                out[x][y][z] = nl.gate("$_XNOR_" if iota else "$_XOR_",
                                       b[x][y][z], t)
    return out


def keccak_netlist(w: int = 64, rounds: int = 24, rate: int = 1088,
                   out_bits: int = 256) -> dict:
    """Yosys write_json-style netlist of the sponge on Keccak-p[25w,
    rounds]: a `rate`-bit @block absorbed a cycle, the first `out_bits`
    bits of the permuted state out as @digest.  The defaults are SHA3-256
    on Keccak-f[1600]."""
    if w not in (1, 2, 4, 8, 16, 32, 64):
        raise ValueError(f"lane width must be a power of 2 up to 64, not {w}")
    b, nr = 25 * w, 12 + 2 * (w.bit_length() - 1)
    if not 1 <= rounds <= nr:
        raise ValueError(f"rounds must be 1 .. {nr}, not {rounds}")
    if not 0 < rate < b or not 0 < out_bits <= b:
        raise ValueError(f"rate {rate} and out_bits {out_bits} must lie "
                         f"in 1 .. {b}")
    nl = Netlist()
    clock = nl.net()
    block = [nl.net() for _ in range(rate)]
    q = [nl.net() for _ in range(b)]                     # the DFFs' Q
    s = [nl.xor(q[i], block[i]) if i < rate else q[i] for i in range(b)]
    a = [[[s[w * (5 * y + x) + z] for z in range(w)] for y in range(5)]
         for x in range(5)]
    for ir in range(nr - rounds, nr):
        a = keccak_round(nl, a, ir, w)
    new = [a[i // w % 5][i // w // 5][i % w] for i in range(b)]
    for i in range(b):
        nl.cells[f"$dff${i}"] = {"type": "$_DFF_P_", "connections": {
            "C": [clock], "D": [new[i]], "Q": [q[i]]}}
    ports = {
        "clock": {"direction": "input", "bits": [clock]},
        "block": {"direction": "input", "bits": block},
        "digest": {"direction": "output", "bits": new[:out_bits]},
    }
    return {"creator": "tests/data/gen_sha3.py",
            "modules": {"sha3": {"ports": ports, "cells": nl.cells}}}


def blueprint(netlist: str = NETLIST, rate: int = 1088,
              out_bits: int = 256) -> str:
    return (
        "# SHA3-256's sponge, FIPS 202: a 1088-bit block absorbed and "
        "Keccak-f[1600] a cycle (tests/data/gen_sha3.py)\n"
        "[[file]]\n"
        'type = "yosys-json"\n'
        f'path = "{netlist}"\n'
        'name = "sha3"\n'
        "\n"
        "[connect]\n"
        f'"sha3/block[0:{rate - 1}]" = "@block[0:{rate - 1}]"\n'
        f'"@digest[0:{out_bits - 1}]" = "sha3/digest[0:{out_bits - 1}]"\n'
    )


def census(netlist: dict) -> dict:
    """From the netlist alone: gen_aes.census of its gates, with the DFF
    outputs at level 0 as the input ports are, the DFFs among the cells
    and their number."""
    module = next(iter(netlist["modules"].values()))
    dffs = [c for c in module["cells"].values() if c["type"] == "$_DFF_P_"]
    gates = {k: c for k, c in module["cells"].items()
             if c["type"] != "$_DFF_P_"}
    ports = dict(module["ports"], state={
        "direction": "input",
        "bits": [c["connections"]["Q"][0] for c in dffs]})
    out = gen_aes.census({"modules": {"gates": {"ports": ports,
                                                "cells": gates}}})
    out["cells"] = dict(sorted({**out["cells"],
                                "$_DFF_P_": len(dffs)}.items()))
    out["dffs"] = len(dffs)
    return out


def main(argv) -> int:
    os.makedirs(OUT_DIR, exist_ok=True)
    net = keccak_netlist()
    with open(os.path.join(OUT_DIR, NETLIST), "w") as f:
        f.write(netlist_text(net))
    with open(os.path.join(OUT_DIR, "sha3.toml"), "w") as f:
        f.write(blueprint())
    print(json.dumps(census(net)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
