"""Iyokan-L1 JSON netlist reader (deprecated upstream, kept for parity).

Format (reference src/iyokan.hpp:2354-2482):
  { "cells": [ {type, id, input: {A,B,S,D}, output: ...} ],
    "ports": [ {type: input|output, id, portName, portBit, bits: [...]} ] }

Cell types: AND NAND ANDNOT OR NOR ORNOT XOR XNOR NOT MUX DFFP and --
when the target supports it (MUX-RAM synthesis) -- RAM with ramAddress /
ramBit, which becomes a named DFF registered ("ram","ramdata",addr*w+bit)
(reference RAMNetworkBuilder, src/iyokan.hpp:1285-1300).
"""

from __future__ import annotations

import json
from typing import IO, Optional

from .netlist import Design

_SIMPLE = {
    "AND": "AND", "NAND": "NAND", "ANDNOT": "ANDNOT", "OR": "OR",
    "NOR": "NOR", "ORNOT": "ORNOT", "XOR": "XOR", "XNOR": "XNOR",
}


def read(design: Design, f: IO, ram_width: Optional[int] = None) -> None:
    root = json.load(f)
    cells = root["cells"]
    ports = root["ports"]
    id2node = {}

    if ram_width is None:
        # Infer the RAM data width from the cells themselves so
        # reference-style pre-minimized RAM netlists (mux-ram-*.min.json,
        # reference src/iyokan.hpp:2595-2628) load as plain [[file]] entries:
        # ramBit indexes the data word, so width = max(ramBit) + 1.
        ram_bits = []
        for c in cells:
            if c["type"] != "RAM":
                continue
            bit = c.get("ramBit")
            if bit is None:
                raise ValueError(
                    f"RAM cell id={c.get('id')} has no 'ramBit' field; "
                    "cannot infer the RAM data width -- pass ram_width "
                    "explicitly or fix the netlist")
            ram_bits.append(int(bit))
        if ram_bits:
            ram_width = max(ram_bits) + 1

    for port in ports:
        ptype, pid = port["type"], int(port["id"])
        name, bit = port["portName"], int(port["portBit"])
        if ptype == "input":
            id2node[pid] = design.INPUT(name, bit)
        elif ptype == "output":
            id2node[pid] = design.OUTPUT(name, bit)

    for cell in cells:
        ctype, cid = cell["type"], int(cell["id"])
        if ctype in _SIMPLE:
            id2node[cid] = getattr(design, _SIMPLE[ctype])()
        elif ctype == "NOT":
            id2node[cid] = design.NOT()
        elif ctype == "MUX":
            id2node[cid] = design.MUX()
        elif ctype == "DFFP":
            id2node[cid] = design.DFF()
        elif ctype == "RAM":
            if ram_width is None:
                raise ValueError("RAM cell in a non-RAM netlist")
            addr, bit = int(cell["ramAddress"]), int(cell["ramBit"])
            node = design.DFF()
            design.register("ram", "ramdata", addr * ram_width + bit, node)
            id2node[cid] = node
        else:
            raise ValueError(f"invalid cell type: {ctype}")

    for port in ports:
        if port["type"] == "output":
            for b in port["bits"]:
                design.connect(id2node[int(b)], id2node[int(port["id"])])

    for cell in cells:
        ctype, cid = cell["type"], int(cell["id"])
        inp = cell["input"]
        if ctype in _SIMPLE:
            design.connect(id2node[int(inp["A"])], id2node[cid])
            design.connect(id2node[int(inp["B"])], id2node[cid])
        elif ctype in ("DFFP", "RAM"):
            design.connect(id2node[int(inp["D"])], id2node[cid])
        elif ctype == "NOT":
            design.connect(id2node[int(inp["A"])], id2node[cid])
        elif ctype == "MUX":
            design.connect(id2node[int(inp["A"])], id2node[cid])
            design.connect(id2node[int(inp["B"])], id2node[cid])
            design.connect(id2node[int(inp["S"])], id2node[cid])
