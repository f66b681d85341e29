"""Programmatic MUX-tree ROM / RAM synthesis.

Functionally identical to the reference generators
(reference src/iyokan.hpp:2517-2762): the memories become ordinary gate
circuits -- ROM cells are input-less wires, RAM cells are named DFFs -- so
the TFHE engine evaluates them with plain gate bootstraps (one TLWE per cell)
instead of the CMUX/TRLWE machinery.  The reference additionally embeds
pre-minimized netlists for 8x8/8x16/9x16 RAMs (reference src/iyokan.hpp:2604-
2628); the generated networks here have the same interface and semantics, a
few percent more gates, and are produced on the fly.
"""

from __future__ import annotations

from .netlist import Design


def make_mux_rom(design: Design, name: str, in_addr_width: int,
                 out_rdata_width: int) -> None:
    """Binary MUX tree per data bit over 2^a ROM cells
    (reference make1bitROMWithMUX, src/iyokan.hpp:2538-2593)."""
    with design.instance(name):
        addr = [design.INPUT("addr", i) for i in range(in_addr_width)]
        for b in range(out_rdata_width):
            work = []
            for i in range(1 << in_addr_width):
                work.append(design.ROM("romdata", b + i * out_rdata_width))
            for lvl in range(in_addr_width):
                nxt = []
                for j in range(0, len(work), 2):
                    m = design.MUX()
                    design.connect(work[j], m)
                    design.connect(work[j + 1], m)
                    design.connect(addr[lvl], m)
                    nxt.append(m)
                work = nxt
            out = design.OUTPUT("rdata", b)
            design.connect(work[0], out)


def make_mux_ram(design: Design, name: str, in_addr_width: int,
                 data_width: int) -> None:
    """DMUX write decoder + per-address write-back MUX loop into RAM DFFs +
    read MUX tree (reference make1bitRAMWithMUX, src/iyokan.hpp:2646-2762)."""
    with design.instance(name):
        addr = [design.INPUT("addr", i) for i in range(in_addr_width)]
        wren = design.INPUT("wren", 0)
        for b in range(data_width):
            wdata = design.INPUT("wdata", b)

            # DMUX tree: wren routed to the selected address
            #   dst0 = andnot(src, addr_i); dst1 = and(src, addr_i)
            # (iterated from the high address bit, reference :2700-2719)
            work = [wren]
            for a in reversed(addr):
                nxt = []
                for src in work:
                    d0 = design.ANDNOT()
                    d1 = design.AND()
                    design.connect(src, d0)
                    design.connect(a, d0)
                    design.connect(src, d1)
                    design.connect(a, d1)
                    nxt.extend([d0, d1])
                work = nxt
            assert len(work) == (1 << in_addr_width)

            # per-address write-back loop: ram = DFF, D = MUX(ram, wdata, sel)
            cells = []
            for address in range(1 << in_addr_width):
                sel = work[address]
                ram = design.DFF()
                design.register("ram", "ramdata", address * data_width + b, ram)
                m = design.MUX()
                design.connect(ram, m)
                design.connect(wdata, m)
                design.connect(sel, m)
                design.connect(m, ram)
                cells.append(ram)

            # read MUX tree over the RAM cells
            work = cells
            for lvl in range(in_addr_width):
                nxt = []
                for j in range(0, len(work), 2):
                    m = design.MUX()
                    design.connect(work[j], m)
                    design.connect(work[j + 1], m)
                    design.connect(addr[lvl], m)
                    nxt.append(m)
                work = nxt
            out = design.OUTPUT("rdata", b)
            design.connect(work[0], out)
