"""Yosys ``write_json`` netlist reader.

Implements the same format subset and conventions as the reference's
YosysJSONReader (reference src/iyokan.hpp:2064-2352):

  * exactly one module; its ``ports`` and ``cells`` objects are used;
  * port named ``clock`` skipped; port ``reset`` skipped when it has no bits;
  * output port bits given as string "0"/"1" are wired to CONSTZERO/CONSTONE
    (constant-driver netlist bits); constant-driven *inputs* are rejected;
  * cell map: $_NOT_ $_AND_ $_ANDNOT_ $_NAND_ $_OR_ $_XOR_ $_XNOR_ $_NOR_
    $_ORNOT_ $_DFF_P_ $_MUX_; $_SDFF_PP0_/$_SDFF_PP1_ are rejected with the
    same guidance (use dfflegalize) as the reference (src/iyokan.hpp:2279);
  * connections: A/B inputs for 2-input gates, A for NOT, D/Q for DFF,
    A/B/S/Y for MUX.
"""

from __future__ import annotations

import json
from typing import IO

from .netlist import Design

_CELLS2 = {
    "$_AND_": "AND", "$_NAND_": "NAND", "$_ANDNOT_": "ANDNOT", "$_OR_": "OR",
    "$_NOR_": "NOR", "$_ORNOT_": "ORNOT", "$_XOR_": "XOR", "$_XNOR_": "XNOR",
}


def _conn_bit(conn: dict, key: str):
    bits = conn[key]
    if len(bits) != 1:
        raise ValueError(f"invalid JSON: wrong conn size for {key}: {len(bits)}")
    if isinstance(bits[0], str):
        raise ValueError(
            "connection of cells to a constant driver is not implemented"
        )
    return bits[0]


def read(design: Design, f: IO) -> None:
    root = json.load(f)
    modules = root["modules"]
    if len(modules) != 1:
        raise ValueError(".modules should be an object of size 1")
    module = next(iter(modules.values()))
    ports = module["ports"]
    cells = module["cells"]

    bit2node = {}
    pending_outputs = []  # (net bit, OUTPUT node)

    for name, val in ports.items():
        direction = val["direction"]
        bits = val["bits"]
        if name == "clock":
            continue
        if name == "reset" and len(bits) == 0:
            continue
        if direction not in ("input", "output"):
            raise ValueError(f"invalid direction token: {direction}")
        is_input = direction == "input"
        for port_bit, bit in enumerate(bits):
            if isinstance(bit, str):
                if is_input:
                    raise ValueError(
                        "INPUT connected to a constant driver is not "
                        "implemented"
                    )
                cnst = bit == "1"
                out = design.OUTPUT(name, port_bit)
                src = design.CONSTONE() if cnst else design.CONSTZERO()
                design.connect(src, out)
            else:
                if is_input:
                    node = design.INPUT(name, port_bit)
                    bit2node[bit] = node
                else:
                    node = design.OUTPUT(name, port_bit)
                    pending_outputs.append((bit, node))

    pending_conns = []  # (src net bit, dst node)
    for _, val in cells.items():
        ctype = val["type"]
        conn = val["connections"]
        if ctype in _CELLS2:
            node = getattr(design, _CELLS2[ctype])()
            pending_conns.append((_conn_bit(conn, "A"), node))
            pending_conns.append((_conn_bit(conn, "B"), node))
            bit2node[_conn_bit(conn, "Y")] = node
        elif ctype == "$_NOT_":
            node = design.NOT()
            pending_conns.append((_conn_bit(conn, "A"), node))
            bit2node[_conn_bit(conn, "Y")] = node
        elif ctype == "$_MUX_":
            node = design.MUX()
            pending_conns.append((_conn_bit(conn, "A"), node))
            pending_conns.append((_conn_bit(conn, "B"), node))
            pending_conns.append((_conn_bit(conn, "S"), node))
            bit2node[_conn_bit(conn, "Y")] = node
        elif ctype == "$_DFF_P_":
            node = design.DFF()
            pending_conns.append((_conn_bit(conn, "D"), node))
            bit2node[_conn_bit(conn, "Q")] = node
        elif ctype in ("$_SDFF_PP0_", "$_SDFF_PP1_"):
            raise ValueError(
                f"{ctype} is not supported (its 'R' input cannot be handled); "
                "use $_DFF_P_ instead: `dfflegalize -cell $_DFF_P_ 01` in Yosys"
            )
        else:
            raise ValueError(f"unknown cell type: {ctype}")

    for bit, node in pending_outputs:
        design.connect(bit2node[bit], node)
    for bit, node in pending_conns:
        design.connect(bit2node[bit], node)
