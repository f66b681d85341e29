"""Plain bit-level evaluator of a blueprint and its Yosys netlists.

The benchmark's own reading of a circuit, written apart from the program
under test: it imports nothing of it.  It follows the iyokan request
protocol that the program documents for its Frontend:

  * a reset settle with @reset = 1 (not a cycle);
  * per cycle: every DFF latches its D input, @reset falls on the first
    cycle after that latch, the request's RAM images are loaded on cycle 0,
    the circular @input streams feed bit (width * cycle + bit) mod length,
    then the combinational network settles;
  * built-in memories ("rom", "ram"): combinational reads of the word at
    the address wires, and a RAM write at the end of the settle, after the
    read (read before write), of wdata where wren is 1.

Nodes follow the reference netlist's granularity: every instance port bit
is a wire node and every node is one level deeper than its deepest input,
so the levels are the batches a levelized engine runs (the work model in
metrics/workmodel.py counts them).
"""

from __future__ import annotations

import json
import os
import re
import tomllib

import numpy as np

# 2-input cells: Yosys type -> function of bits a, b
GATES2 = {
    "$_AND_": lambda a, b: a & b,
    "$_NAND_": lambda a, b: 1 - (a & b),
    "$_ANDNOT_": lambda a, b: a & (1 - b),
    "$_OR_": lambda a, b: a | b,
    "$_NOR_": lambda a, b: 1 - (a | b),
    "$_ORNOT_": lambda a, b: a | (1 - b),
    "$_XOR_": lambda a, b: a ^ b,
    "$_XNOR_": lambda a, b: 1 - (a ^ b),
}

_PORT_RE = re.compile(r"^@?(?:([^/]+)/)?([^[]+)(?:\[([0-9]+):([0-9]+)\])?$")


def _ports(text):
    """'inst/port[lo:hi]' or '@port[lo:hi]' -> [(inst, port, bit)]."""
    m = _PORT_RE.match(text)
    if not m:
        raise ValueError(f"invalid port string: {text}")
    lo = hi = 0
    if m.group(3) is not None:
        lo, hi = int(m.group(3)), int(m.group(4))
    return [(m.group(1) or "", m.group(2), b) for b in range(lo, hi + 1)]


class Circuit:
    """A blueprint with its netlists, as nodes: kind[i] in "wire", "dff",
    "const", a Yosys 2-input cell type, "$_NOT_", "$_MUX_", "romread",
    "ramread"; ins[i] the driving nodes (MUX: A, B, S)."""

    def __init__(self, blueprint_path: str):
        self.kind, self.ins, self.const = [], [], {}
        self.named = {}                      # (inst, dir, port, bit) -> node
        self.roms, self.rams = {}, {}
        self.read_of = {}                    # read node -> (memory, bit)
        with open(blueprint_path, "rb") as f:
            bp = tomllib.load(f)
        here = os.path.dirname(os.path.abspath(blueprint_path))
        for file in bp.get("file", []):
            if file["type"] != "yosys-json":
                raise ValueError(f"unsupported netlist type {file['type']}")
            self._read_yosys(file["name"], os.path.join(here, file["path"]))
        for b in bp.get("builtin", []):
            if b["type"] == "rom":
                self._add_memory("rom", b["name"], int(b["in_addr_width"]),
                                 int(b["out_rdata_width"]))
            elif b["type"] == "ram":
                if int(b["in_wdata_width"]) != int(b["out_rdata_width"]):
                    raise ValueError("RAM wdata and rdata widths differ")
                self._add_memory("ram", b["name"], int(b["in_addr_width"]),
                                 int(b["out_rdata_width"]))
            else:
                raise ValueError(f"unsupported builtin {b['type']}")
        self.inputs, self.outputs = {}, {}  # @name -> {bit: node}
        for dst, src in bp.get("connect", {}).items():
            if dst == "TOGND":
                continue
            d, s = _ports(dst), _ports(src)
            if len(d) != len(s):
                raise ValueError(f"width mismatch: {dst} = {src}")
            for (di, dp, db), (si, sp, sb) in zip(d, s):
                if dst.startswith("@"):
                    self.outputs.setdefault(dp, {}).setdefault(
                        db, self.named[(si, "out", sp, sb)])
                elif src.startswith("@"):
                    self.inputs.setdefault(sp, {}).setdefault(
                        sb, self.named[(di, "in", dp, db)])
                else:
                    self._drive(self.named[(di, "in", dp, db)],
                                self.named[(si, "out", sp, sb)])
        self._levelize()

    # ---------------------------------------------------------------- #
    def _new(self, kind, ins=()):
        self.kind.append(kind)
        self.ins.append(list(ins))
        return len(self.kind) - 1

    def _drive(self, wire, src):
        if self.ins[wire]:
            raise ValueError(f"wire {wire} driven twice")
        self.ins[wire].append(src)

    def _read_yosys(self, inst, path):
        with open(path) as f:
            modules = json.load(f)["modules"]
        if len(modules) != 1:
            raise ValueError(f"{path}: expected one module")
        module = next(iter(modules.values()))
        net = {}
        outs = []
        for name, port in module["ports"].items():
            if name == "clock" or (name == "reset" and not port["bits"]):
                continue
            for bit, b in enumerate(port["bits"]):
                if port["direction"] == "input":
                    node = net[b] = self._new("wire")
                    self.named[(inst, "in", name, bit)] = node
                else:
                    node = self._new("wire")
                    self.named[(inst, "out", name, bit)] = node
                    if isinstance(b, str):
                        c = self._new("const")
                        self.const[c] = int(b == "1")
                        self._drive(node, c)
                    else:
                        outs.append((node, b))
        pending = []
        for cell in module["cells"].values():
            t, conn = cell["type"], cell["connections"]
            if t in GATES2:
                pins, out = ("A", "B"), "Y"
            elif t == "$_NOT_":
                pins, out = ("A",), "Y"
            elif t == "$_MUX_":
                pins, out = ("A", "B", "S"), "Y"
            elif t == "$_DFF_P_":
                pins, out = ("D",), "Q"
                t = "dff"
            else:
                raise ValueError(f"unsupported cell {t}")
            node = net[conn[out][0]] = self._new(t)
            pending += [(node, conn[p][0]) for p in pins]
        for node, b in pending:
            self.ins[node].append(net[b])
        for node, b in outs:
            self._drive(node, net[b])

    def _add_memory(self, kind, name, addr_width, width):
        addr = [self._new("wire") for _ in range(addr_width)]
        for i, a in enumerate(addr):
            self.named[(name, "in", "addr", i)] = a
        reads = []
        for b in range(width):
            r = self._new(kind + "read", addr)
            self.read_of[r] = (name, b)
            reads.append(r)
            self.named[(name, "out", "rdata", b)] = self._new("wire", [r])
        mem = {"addr": addr, "reads": reads, "width": width,
               "words": 1 << addr_width}
        if kind == "ram":
            mem["wren"] = self._new("wire")
            self.named[(name, "in", "wren", 0)] = mem["wren"]
            mem["wdata"] = [self._new("wire") for _ in range(width)]
            for i, w in enumerate(mem["wdata"]):
                self.named[(name, "in", "wdata", i)] = w
            self.rams[name] = mem
        else:
            self.roms[name] = mem

    def _levelize(self):
        n = len(self.kind)
        level = [-1] * n

        def comb_ins(i):
            return [] if self.kind[i] in ("dff", "const") else self.ins[i]

        for start in range(n):
            stack = [start]
            while stack:
                i = stack[-1]
                if level[i] >= 0:
                    stack.pop()
                    continue
                todo = [j for j in comb_ins(i) if level[j] < 0]
                if todo:
                    if len(stack) > n:
                        raise ValueError("combinational loop")
                    stack.extend(todo)
                    continue
                level[i] = 1 + max((level[j] for j in comb_ins(i)),
                                   default=-1)
                stack.pop()
        self.level = level
        self.order = sorted((i for i in range(n) if level[i] > 0),
                            key=level.__getitem__)
        self.dffs = [i for i in range(n) if self.kind[i] == "dff"]

    # ---------------------------------------------------------------- #
    def level_rows(self):
        """Rotated rows of each level with gates, in level order: a
        2-input gate one row, a MUX two (NOT and wires are free)."""
        rows = {}
        for i in self.order:
            k = self.kind[i]
            if k in GATES2 or k == "$_MUX_":
                rows[self.level[i]] = (rows.get(self.level[i], 0)
                                       + (2 if k == "$_MUX_" else 1))
        return [rows[lv] for lv in sorted(rows)]

    def input_widths(self):
        return {name: max(bits) + 1 for name, bits in self.inputs.items()}


def _word(bits, nodes):
    """Little-endian word of the bits at `nodes`."""
    return sum(int(bits[n]) << k for k, n in enumerate(nodes))


class Run:
    """One request through the circuit: rom {name: bits}, ram {name: bits}
    (bit addr * width + b), streams {@input: bits}."""

    def __init__(self, circ: Circuit, rom, ram, streams):
        self.c = circ
        self.rom = {k: np.asarray(v, np.uint8) for k, v in rom.items()}
        self.ram = {k: np.zeros(m["words"] * m["width"], np.uint8)
                    for k, m in circ.rams.items()}
        self.ram_init = {k: np.asarray(v, np.uint8) for k, v in ram.items()}
        self.streams = {k: np.asarray(v, np.uint8)
                        for k, v in streams.items()}
        self.widths = circ.input_widths()
        self.v = np.zeros(len(circ.kind), np.uint8)
        for node, val in circ.const.items():
            self.v[node] = val
        self.cycle = 0
        reset = circ.inputs.get("reset", {}).get(0)
        self.reset = reset
        if reset is not None:
            self.v[reset] = 1
            self._settle()

    def _settle(self):
        c, v = self.c, self.v
        for i in c.order:
            k, ins = c.kind[i], c.ins[i]
            if k == "wire":
                if ins:
                    v[i] = v[ins[0]]
            elif k in GATES2:
                v[i] = GATES2[k](int(v[ins[0]]), int(v[ins[1]]))
            elif k == "$_MUX_":
                v[i] = v[ins[1]] if v[ins[2]] else v[ins[0]]
            elif k == "$_NOT_":
                v[i] = 1 - v[ins[0]]
            else:                                   # romread / ramread
                name, b = c.read_of[i]
                m = (c.roms if k == "romread" else c.rams)[name]
                store = (self.rom.get(name) if k == "romread"
                         else self.ram[name])
                a = _word(v, m["addr"]) * m["width"]
                v[i] = 0 if store is None else store[a + b]
        for name, m in c.rams.items():
            if v[m["wren"]]:
                a = _word(v, m["addr"]) * m["width"]
                self.ram[name][a: a + m["width"]] = v[m["wdata"]]

    def step(self):
        """One cycle; returns {@output: bits} after its settle."""
        c, v = self.c, self.v
        d = [c.ins[i][0] for i in c.dffs]
        v[c.dffs] = v[d]
        if self.cycle == 0:
            if self.reset is not None:
                v[self.reset] = 0
            for name, bits in self.ram_init.items():
                self.ram[name] = bits.copy()
        for name, bits in c.inputs.items():
            if name == "reset" or name not in self.streams:
                continue
            s, w = self.streams[name], self.widths[name]
            for b, node in bits.items():
                v[node] = s[(w * self.cycle + b) % len(s)]
        self._settle()
        self.cycle += 1
        return self.outputs()

    def outputs(self):
        """{@output: bits}; a bit the blueprint leaves unconnected reads 0."""
        return {name: np.array([self.v[bits[b]] if b in bits else 0
                                for b in range(max(bits) + 1)], np.uint8)
                for name, bits in self.c.outputs.items()}
