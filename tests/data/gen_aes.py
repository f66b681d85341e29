"""Generate the AES-128 circuit, portbench/configs/aes128/aes128-yosys.json
and aes128.toml.

The circuit is AES-128 encryption as NIST FIPS-197 defines it, with the key
expansion inside the circuit: one 128-bit key and one 128-bit plaintext in,
their ciphertext out, one block a cycle, combinational, with no register
(the function of the Bristol Fashion `aes_128` circuit).  It is built here
from the standard, gate by gate, as a Yosys write_json-style module:

  * SubBytes and the key expansion's SubWord: Boyar and Peralta's S-box
    circuit (IACR ePrint 2009/191; also "A new combinational logic
    minimization technique with applications to cryptology", SEA 2010),
    gate for gate: a linear top of 23 XORs, a nonlinear middle of 32 ANDs
    and 30 XORs, a linear bottom of 26 XORs and 4 XNORs, in which the
    affine map's constant 0x63 is folded.  Its input x0 .. x7 is the byte's
    b7 .. b0 (x0 the most significant bit), its output s0 .. s7 likewise;
  * ShiftRows: wiring;
  * MixColumns in the xtime form: for a column a0 .. a3,
    b_r = xtime(a_r ^ a_(r+1 mod 4)) ^ a_r ^ t with t = a0 ^ a1 ^ a2 ^ a3,
    xtime(u) = u << 1, reduced by x^8 + x^4 + x^3 + x + 1 (three XORs);
    the round key is added to the t side, (xtime(..) ^ a_r) ^ (t ^ k_r),
    so that the key joins before the data arrives;
  * AddRoundKey: XORs;
  * KeyExpansion (FIPS-197 Sec. 5.2): w[i] = w[i-4] ^ temp word by word,
    temp = SubWord(RotWord(w[i-1])) ^ Rcon[i/4] every fourth word; where
    Rcon has a 1 bit the XOR is an XNOR.

So the circuit has only $_AND_, $_XOR_ and $_XNOR_ cells: every constant
is absorbed by an XNOR, and no NOT gate is left.

Bit order.  FIPS-197 writes a block or a key as the bytes in_0 .. in_15
(Sec. 3.4: state s[r, c] = in[r + 4c]) and a byte as {b7 b6 ... b0}, b_j
the coefficient of x^j (Sec. 3.2).  Bit 8i + j of @key, @pt and @ct is
bit b_j of byte i, so each port read as a little-endian word is
int.from_bytes(block, "little").

rounds < 10 gives the reduced-round ciphers of the CPU tests: the key
expanded to round key `rounds`, rounds 1 .. rounds-1 full rounds and round
`rounds` the final one (no MixColumns), as portbench/reference/aes128.py's
encrypt(key, block, rounds) computes.

    python tests/data/gen_aes.py       # writes the configuration's copy
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "portbench", "configs", "aes128")
NETLIST = "aes128-yosys.json"

# Boyar-Peralta's S-box, ePrint 2009/191: "d = a + b" XOR, "d = a x b"
# AND, "d = a # b" XNOR; inputs x0 .. x7, outputs s0 .. s7.
SBOX_TOP = """
y14 = x3 + x5
y13 = x0 + x6
y9 = x0 + x3
y8 = x0 + x5
t0 = x1 + x2
y1 = t0 + x7
y4 = y1 + x3
y12 = y13 + y14
y2 = y1 + x0
y5 = y1 + x6
y3 = y5 + y8
t1 = x4 + y12
y15 = t1 + x5
y20 = t1 + x1
y6 = y15 + x7
y10 = y15 + t0
y11 = y20 + y9
y7 = x7 + y11
y17 = y10 + y11
y19 = y10 + y8
y16 = t0 + y11
y21 = y13 + y16
y18 = x0 + y16
"""
SBOX_MIDDLE = """
t2 = y12 x y15
t3 = y3 x y6
t4 = t3 + t2
t5 = y4 x x7
t6 = t5 + t2
t7 = y13 x y16
t8 = y5 x y1
t9 = t8 + t7
t10 = y2 x y7
t11 = t10 + t7
t12 = y9 x y11
t13 = y14 x y17
t14 = t13 + t12
t15 = y8 x y10
t16 = t15 + t12
t17 = t4 + t14
t18 = t6 + t16
t19 = t9 + t14
t20 = t11 + t16
t21 = t17 + y20
t22 = t18 + y19
t23 = t19 + y21
t24 = t20 + y18
t25 = t21 + t22
t26 = t21 x t23
t27 = t24 + t26
t28 = t25 x t27
t29 = t28 + t22
t30 = t23 + t24
t31 = t22 + t26
t32 = t31 x t30
t33 = t32 + t24
t34 = t23 + t33
t35 = t27 + t33
t36 = t24 x t35
t37 = t36 + t34
t38 = t27 + t36
t39 = t29 x t38
t40 = t25 + t39
t41 = t40 + t37
t42 = t29 + t33
t43 = t29 + t40
t44 = t33 + t37
t45 = t42 + t41
z0 = t44 x y15
z1 = t37 x y6
z2 = t33 x x7
z3 = t43 x y16
z4 = t40 x y1
z5 = t29 x y7
z6 = t42 x y11
z7 = t45 x y17
z8 = t41 x y10
z9 = t44 x y12
z10 = t37 x y3
z11 = t33 x y4
z12 = t43 x y13
z13 = t40 x y5
z14 = t29 x y2
z15 = t42 x y9
z16 = t45 x y14
z17 = t41 x y8
"""
SBOX_BOTTOM = """
t46 = z15 + z16
t47 = z10 + z11
t48 = z5 + z13
t49 = z9 + z10
t50 = z2 + z12
t51 = z2 + z5
t52 = z7 + z8
t53 = z0 + z3
t54 = z6 + z7
t55 = z16 + z17
t56 = z12 + t48
t57 = t50 + t53
t58 = z4 + t46
t59 = z3 + t54
t60 = t46 + t57
t61 = z14 + t57
t62 = t52 + t58
t63 = t49 + t58
t64 = z4 + t59
t65 = t61 + t62
t66 = z1 + t63
s0 = t59 + t63
s6 = t56 # t62
s7 = t48 # t60
t67 = t64 + t65
s3 = t53 + t66
s4 = t51 + t66
s5 = t47 + t65
s1 = t64 # s3
s2 = t55 # t67
"""
SBOX_PROGRAM = [tuple(line.split()) for part in
                (SBOX_TOP, SBOX_MIDDLE, SBOX_BOTTOM)
                for line in part.strip().splitlines()]
_OPS = {"+": "$_XOR_", "x": "$_AND_", "#": "$_XNOR_"}

RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


class Netlist:
    """Cells of one module, nets numbered from 2 as Yosys numbers them."""

    def __init__(self):
        self._next = 2
        self.cells = {}

    def net(self) -> int:
        n = self._next
        self._next += 1
        return n

    def gate(self, kind: str, a: int, b: int) -> int:
        y = self.net()
        self.cells[f"${kind[2:-1].lower()}${len(self.cells)}"] = {
            "type": kind, "connections": {"A": [a], "B": [b], "Y": [y]}}
        return y

    def xor(self, a, b):
        return self.gate("$_XOR_", a, b)

    def xors(self, xs, ys):
        return [self.xor(a, b) for a, b in zip(xs, ys)]


def sbox(nl: Netlist, byte: list) -> list:
    """The S-box of a byte's nets (byte[j] = b_j), Boyar-Peralta's circuit
    gate for gate; returns the output byte's nets, b_0 first."""
    v = {f"x{i}": byte[7 - i] for i in range(8)}
    for dst, _, a, op, b in SBOX_PROGRAM:
        v[dst] = nl.gate(_OPS[op], v[a], v[b])
    return [v[f"s{7 - j}"] for j in range(8)]


def xtime(nl: Netlist, u: list) -> list:
    """u * x in GF(2^8) mod x^8 + x^4 + x^3 + x + 1 (0x1b): three XORs."""
    return [u[7], nl.xor(u[0], u[7]), u[1], nl.xor(u[2], u[7]),
            nl.xor(u[3], u[7]), u[4], u[5], u[6]]


def key_expansion(nl: Netlist, key: list, rounds: int) -> list:
    """Round keys 0 .. rounds, each a list of 16 bytes of nets."""
    w = [[key[32 * i + 8 * k: 32 * i + 8 * k + 8] for k in range(4)]
         for i in range(4)]
    for i in range(4, 4 * (rounds + 1)):
        prev = w[i - 1]
        if i % 4 == 0:
            sub = [sbox(nl, b) for b in prev[1:] + prev[:1]]   # RotWord
            rc = RCON[i // 4 - 1]
            word = []
            for k in range(4):
                word.append([nl.gate("$_XNOR_" if k == 0 and rc >> j & 1
                                     else "$_XOR_", w[i - 4][k][j],
                                     sub[k][j]) for j in range(8)])
        else:
            word = [nl.xors(w[i - 4][k], prev[k]) for k in range(4)]
        w.append(word)
    return [[b for i in range(4 * r, 4 * r + 4) for b in w[i]]
            for r in range(rounds + 1)]


def aes_netlist(rounds: int = 10) -> dict:
    """Yosys write_json-style netlist of AES-128 encryption with `rounds`
    rounds (10: FIPS-197's AES-128)."""
    if not 1 <= rounds <= 10:
        raise ValueError(f"rounds must be 1 .. 10, not {rounds}")
    nl = Netlist()
    key = [nl.net() for _ in range(128)]
    pt = [nl.net() for _ in range(128)]
    rk = key_expansion(nl, key, rounds)

    def byte(bits, i):
        return bits[8 * i: 8 * i + 8]

    state = [nl.xors(byte(pt, i), rk[0][i]) for i in range(16)]
    for r in range(1, rounds + 1):
        sub = [sbox(nl, b) for b in state]
        # ShiftRows: s'[r, c] = s[r, c + r mod 4], byte r + 4c
        shifted = [sub[row + 4 * ((c + row) % 4)]
                   for c in range(4) for row in range(4)]
        if r == rounds:
            state = [nl.xors(shifted[i], rk[r][i]) for i in range(16)]
            continue
        state = []
        for c in range(4):
            a = shifted[4 * c: 4 * c + 4]
            u = [nl.xors(a[row], a[(row + 1) % 4]) for row in range(4)]
            t = nl.xors(u[0], u[2])
            for row in range(4):
                p = nl.xors(xtime(nl, u[row]), a[row])
                q = nl.xors(t, rk[r][4 * c + row])
                state.append(nl.xors(p, q))
    ct = [b for s in state for b in s]
    ports = {
        "key": {"direction": "input", "bits": key},
        "pt": {"direction": "input", "bits": pt},
        "ct": {"direction": "output", "bits": ct},
    }
    name = "aes128" if rounds == 10 else f"aes128r{rounds}"
    return {"creator": "tests/data/gen_aes.py",
            "modules": {name: {"ports": ports, "cells": nl.cells}}}


def sbox_netlist() -> dict:
    """One S-box alone, @x[0:7] in and @y[0:7] out (bit j = b_j), for the
    test of all 256 inputs."""
    nl = Netlist()
    x = [nl.net() for _ in range(8)]
    y = sbox(nl, x)
    ports = {"x": {"direction": "input", "bits": x},
             "y": {"direction": "output", "bits": y}}
    return {"creator": "tests/data/gen_aes.py",
            "modules": {"sbox": {"ports": ports, "cells": nl.cells}}}


def blueprint(netlist: str = NETLIST) -> str:
    return (
        "# AES-128 encryption, FIPS-197, key expansion in circuit "
        "(tests/data/gen_aes.py)\n"
        "[[file]]\n"
        'type = "yosys-json"\n'
        f'path = "{netlist}"\n'
        'name = "aes"\n'
        "\n"
        "[connect]\n"
        '"aes/key[0:127]" = "@key[0:127]"\n'
        '"aes/pt[0:127]" = "@pt[0:127]"\n'
        '"@ct[0:127]" = "aes/ct[0:127]"\n'
    )


def netlist_text(netlist: dict) -> str:
    return json.dumps(netlist, separators=(",", ":")) + "\n"


def census(netlist: dict) -> dict:
    """From the netlist alone: cells by type, and the gate levels (every
    cell one level deeper than its deepest input, the ports at level 0):
    levels, rows a cycle (one a cell) and the rows a level's min, median,
    90th percentile (nearest rank) and max."""
    module = next(iter(netlist["modules"].values()))
    depth = {b: 0 for p in module["ports"].values()
             if p["direction"] == "input" for b in p["bits"]}
    types, width = {}, {}
    for cell in module["cells"].values():      # written in order of use
        conn = cell["connections"]
        d = 1 + max(depth[conn["A"][0]], depth[conn["B"][0]])
        depth[conn["Y"][0]] = d
        types[cell["type"]] = types.get(cell["type"], 0) + 1
        width[d] = width.get(d, 0) + 1
    rows = sorted(width.values())

    def rank(q):
        return rows[max(0, -(-q * len(rows) // 100) - 1)]

    return {"cells": dict(sorted(types.items())), "levels": len(width),
            "rows_per_cycle": sum(rows),
            "rows_per_level": {"min": rows[0], "median": rank(50),
                               "p90": rank(90), "max": rows[-1]}}


def main(argv) -> int:
    os.makedirs(OUT_DIR, exist_ok=True)
    net = aes_netlist(10)
    with open(os.path.join(OUT_DIR, NETLIST), "w") as f:
        f.write(netlist_text(net))
    with open(os.path.join(OUT_DIR, "aes128.toml"), "w") as f:
        f.write(blueprint())
    print(json.dumps(census(net)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
