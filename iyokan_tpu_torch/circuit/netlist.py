"""Circuit IR: a flat node store with a construction API.

Every logic value in the evaluated system -- gate outputs, DFF state,
INPUT/OUTPUT buffers, ROM cells, builtin-memory read ports -- is one *node*
with exactly one output bit.  The construction API (AND()/NAND()/.../DFF()/
INPUT()/OUTPUT()/ROM()/RAM()/connect()) intentionally mirrors the reference's
NetworkBuilder (reference src/iyokan.hpp:1100-1300) so the netlist readers
stay close to the reference's observable semantics, but there is no task
graph here: nodes are rows of arrays, and the compiler (compile.py) levelizes
them for batched execution.

A single :class:`Design` holds *all* instantiated circuits (files + builtin
ROM/RAMs), namespaced by instance name, matching the frontend composition step
of the reference (reference src/iyokan_plain.cpp:299-446).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .. import gates as G

# named-task key: (instance, kind, portName, portBit)
NamedKey = Tuple[str, str, str, int]


@dataclasses.dataclass
class RomInst:
    """Built-in CMUX-memory ROM (reference makeTFHEppROMNetwork semantics)."""

    name: str
    addr_width: int
    data_width: int
    addr_nodes: List[int]
    read_nodes: List[int]   # ROMREAD node per data bit


@dataclasses.dataclass
class RamInst:
    """Built-in CMUX-memory RAM (read port + end-of-cycle write)."""

    name: str
    addr_width: int
    data_width: int
    addr_nodes: List[int]
    wren_node: int
    wdata_nodes: List[int]
    read_nodes: List[int]   # RAMREAD node per data bit
    rdata_out_nodes: List[int]  # OUTPUT wires fed by read_nodes


class Design:
    def __init__(self) -> None:
        self.kinds: List[int] = []
        self.ins: List[List[int]] = []
        self.named: Dict[NamedKey, int] = {}
        self.sdff_init: Dict[int, int] = {}
        self.rom_insts: Dict[str, RomInst] = {}
        self.ram_insts: Dict[str, RamInst] = {}
        self._instance: str = ""

    # ------------------------------------------------------------------ #
    @property
    def num_nodes(self) -> int:
        return len(self.kinds)

    def _new(self, kind: int) -> int:
        self.kinds.append(kind)
        self.ins.append([])
        return len(self.kinds) - 1

    def connect(self, frm: int, to: int) -> None:
        self.ins[to].append(frm)

    def register(self, kind: str, port: str, bit: int, node: int) -> None:
        key = (self._instance, kind, port, bit)
        assert key not in self.named, f"duplicate named task {key}"
        self.named[key] = node

    def get(self, instance: str, kind: str, port: str, bit: int) -> int:
        return self.named[(instance, kind, port, bit)]

    def maybe_get(self, instance: str, kind: str, port: str,
                  bit: int) -> Optional[int]:
        return self.named.get((instance, kind, port, bit))

    # ------------------------ construction API ------------------------ #
    def INPUT(self, port: str, bit: int) -> int:
        n = self._new(G.WIRE)
        self.register("input", port, bit, n)
        return n

    def OUTPUT(self, port: str, bit: int) -> int:
        n = self._new(G.WIRE)
        self.register("output", port, bit, n)
        return n

    def ROM(self, port: str, bit: int) -> int:
        """Input-less wire cell holding one ROM data bit (MUX-ROM leaves),
        registered under ("rom", port, bit) like the reference's network
        construction (reference src/iyokan.hpp:1232-1236)."""
        n = self._new(G.WIRE)
        self.register("rom", port, bit, n)
        return n

    def DFF(self) -> int:
        return self._new(G.DFF)

    def SDFF(self, init: int) -> int:
        n = self._new(G.SDFF1 if init else G.SDFF0)
        self.sdff_init[n] = init
        return n

    def NOT(self) -> int:
        return self._new(G.NOT)

    def MUX(self) -> int:
        return self._new(G.MUX)

    def CONSTONE(self) -> int:
        return self._new(G.CONSTONE)

    def CONSTZERO(self) -> int:
        return self._new(G.CONSTZERO)

    def AND(self) -> int:
        return self._new(G.AND)

    def NAND(self) -> int:
        return self._new(G.NAND)

    def ANDNOT(self) -> int:
        return self._new(G.ANDNOT)

    def OR(self) -> int:
        return self._new(G.OR)

    def NOR(self) -> int:
        return self._new(G.NOR)

    def ORNOT(self) -> int:
        return self._new(G.ORNOT)

    def XOR(self) -> int:
        return self._new(G.XOR)

    def XNOR(self) -> int:
        return self._new(G.XNOR)

    # ------------------------- builtin memories ------------------------ #
    def add_cmux_rom(self, name: str, addr_width: int, data_width: int) -> None:
        """Built-in ROM with encrypted-domain CMUX-tree read
        (the reference 'rom' builtin, src/iyokan_plain.cpp:339-365)."""
        prev = self._instance
        self._instance = name
        addr = [self.INPUT("addr", i) for i in range(addr_width)]
        reads, outs = [], []
        for b in range(data_width):
            r = self._new(G.ROMREAD)
            self.ins[r] = list(addr)
            o = self.OUTPUT("rdata", b)
            self.connect(r, o)
            reads.append(r)
            outs.append(o)
        self.rom_insts[name] = RomInst(name, addr_width, data_width, addr, reads)
        self._instance = prev

    def add_cmux_ram(self, name: str, addr_width: int, data_width: int) -> None:
        """Built-in RAM: combinational read, end-of-cycle write with
        read-before-write ordering (the reference 'ram' builtin,
        src/iyokan_plain.hpp:216-342)."""
        prev = self._instance
        self._instance = name
        addr = [self.INPUT("addr", i) for i in range(addr_width)]
        wren = self.INPUT("wren", 0)
        wdata = [self.INPUT("wdata", i) for i in range(data_width)]
        reads, outs = [], []
        for b in range(data_width):
            r = self._new(G.RAMREAD)
            self.ins[r] = list(addr)
            o = self.OUTPUT("rdata", b)
            self.connect(r, o)
            reads.append(r)
            outs.append(o)
        self.ram_insts[name] = RamInst(
            name, addr_width, data_width, addr, wren, wdata, reads, outs
        )
        self._instance = prev

    # ------------------------------------------------------------------ #
    def instance(self, name: str):
        """Context manager scoping named registrations to an instance."""
        design = self

        class _Ctx:
            def __enter__(self):
                self._prev = design._instance
                design._instance = name

            def __exit__(self, *exc):
                design._instance = self._prev

        return _Ctx()

    # ------------------------------------------------------------------ #
    def check_valid(self) -> None:
        """Arity checks, the analogue of TaskNetwork::checkValid
        (reference src/iyokan.hpp:1002-1015)."""
        arity = {
            G.AND: 2, G.NAND: 2, G.ANDNOT: 2, G.OR: 2, G.NOR: 2, G.ORNOT: 2,
            G.XOR: 2, G.XNOR: 2, G.MUX: 3, G.NOT: 1, G.CONSTONE: 0,
            G.CONSTZERO: 0, G.DFF: 1, G.SDFF0: 1, G.SDFF1: 1,
        }
        errors = []
        for n, kind in enumerate(self.kinds):
            if kind in arity and len(self.ins[n]) != arity[kind]:
                errors.append(
                    f"node {n} ({G.NAMES[kind]}): got {len(self.ins[n])} "
                    f"inputs, want {arity[kind]}"
                )
            if kind == G.WIRE and len(self.ins[n]) > 1:
                errors.append(f"node {n} (WIRE): more than one input")
        if errors:
            raise ValueError("invalid network:\n" + "\n".join(errors[:20]))
