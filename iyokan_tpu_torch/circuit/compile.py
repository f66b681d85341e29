"""Levelizing compiler: Design -> static per-level execution plans.

This is where the reference's runtime machinery collapses into ahead-of-time
structure: the priority ready-queue + worker polling loop
(reference src/iyokan.hpp:774-883, :1982-2062) and the topo/ranku priority
assignment (reference src/iyokan.cpp:4-161) all existed to discover, at run
time, which gates are ready.  On TPU the circuit is static, so we compute the
topological *level* of every node once; at run time each level is a handful
of batched gathers + one fused bootstrap batch + a scatter.

Combinational sources (level 0): DFF/SDFF outputs (latched at tick), wires
without a driver (INPUTs, MUX-ROM cells), constants.  DFF D-edges do not
count as combinational dependencies -- they form the tick plan.  Built-in
CMUX memory reads depend on their address wires; built-in RAM writes run
after the level sweep (read-before-write, the levelized equivalent of the
reference's rdata ordering edge, src/iyokan_plain.hpp:308-313).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List

import numpy as np

from .. import gates as G
from .netlist import Design

_GATE2 = set(G.BINARY_KINDS)


@dataclasses.dataclass
class LevelPlan:
    # 2-input gates (one bootstrap row each)
    bin_kind: np.ndarray
    bin_a: np.ndarray
    bin_b: np.ndarray
    bin_out: np.ndarray
    # MUX gates (two bootstrap rows each)
    mux_a: np.ndarray
    mux_b: np.ndarray
    mux_s: np.ndarray
    mux_out: np.ndarray
    # NOT gates (free: torus negation)
    not_src: np.ndarray
    not_out: np.ndarray
    # copies (driven WIREs: OUTPUTs, connected INPUTs, buffers)
    copy_src: np.ndarray
    copy_out: np.ndarray
    # names of builtin memories whose read port resolves at this level
    rom_reads: List[str]
    ram_reads: List[str]

    @property
    def n_bootstraps(self) -> int:
        return len(self.bin_kind) + 2 * len(self.mux_out)

    @property
    def n_gates(self) -> int:
        """Nodes evaluated at this level (for progress reporting)."""
        return (len(self.bin_out) + len(self.mux_out) + len(self.not_out)
                + len(self.copy_out))


@dataclasses.dataclass
class Compiled:
    design: Design
    num_nodes: int
    levels: List[LevelPlan]
    node_level: np.ndarray
    # tick: simultaneous vals[tick_dst] = vals[tick_src]
    tick_dst: np.ndarray
    tick_src: np.ndarray
    # SDFF initial-value override (cycle 0 after tick)
    sdff_nodes: np.ndarray
    sdff_vals: np.ndarray
    # constants
    const_nodes: np.ndarray
    const_vals: np.ndarray

    def gate_census(self) -> Dict[str, int]:
        """Per-kind census (reference GateCountVisitor role)."""
        out: Dict[str, int] = {}
        for k in self.design.kinds:
            out[G.NAMES[k]] = out.get(G.NAMES[k], 0) + 1
        return out


def compile_design(design: Design) -> Compiled:
    design.check_valid()
    n = design.num_nodes
    kinds = design.kinds

    # combinational dependency edges
    comb_ins: List[List[int]] = [[] for _ in range(n)]
    for node in range(n):
        k = kinds[node]
        if k in (G.DFF, G.SDFF0, G.SDFF1, G.CONSTONE, G.CONSTZERO):
            continue
        comb_ins[node] = design.ins[node]

    src_list, dst_list = [], []
    for node in range(n):
        for s in comb_ins[node]:
            src_list.append(s)
            dst_list.append(node)

    from .. import native

    level = native.levelize(
        n, np.asarray(src_list, np.int32), np.asarray(dst_list, np.int32)
    )
    if level is None:
        # pure-Python fallback (no compiler available)
        succs: List[List[int]] = [[] for _ in range(n)]
        indeg = np.zeros(n, np.int64)
        for s, d in zip(src_list, dst_list):
            succs[s].append(d)
            indeg[d] += 1
        level = np.zeros(n, np.int64)
        queue = deque(i for i in range(n) if indeg[i] == 0)
        seen = 0
        while queue:
            u = queue.popleft()
            seen += 1
            for v in succs[u]:
                level[v] = max(level[v], level[u] + 1)
                indeg[v] -= 1
                if indeg[v] == 0:
                    queue.append(v)
        if seen != n:
            bad = [i for i in range(n) if indeg[i] > 0][:10]
            raise ValueError(f"combinational cycle through nodes {bad}")

    max_level = int(level.max()) if n else 0

    # memory instance read levels
    rom_level = {
        name: int(level[inst.read_nodes[0]])
        for name, inst in design.rom_insts.items()
    }
    ram_level = {
        name: int(level[inst.read_nodes[0]])
        for name, inst in design.ram_insts.items()
    }

    levels: List[LevelPlan] = []
    for lv in range(1, max_level + 1):
        nodes = [i for i in range(n) if level[i] == lv]
        bk, ba, bb, bo = [], [], [], []
        ma, mb, ms, mo = [], [], [], []
        ns, no = [], []
        cs, co = [], []
        for node in nodes:
            k = kinds[node]
            ins = design.ins[node]
            if k in _GATE2:
                bk.append(k); ba.append(ins[0]); bb.append(ins[1])
                bo.append(node)
            elif k == G.MUX:
                ma.append(ins[0]); mb.append(ins[1]); ms.append(ins[2])
                mo.append(node)
            elif k == G.NOT:
                ns.append(ins[0]); no.append(node)
            elif k == G.WIRE:
                if ins:
                    cs.append(ins[0]); co.append(node)
            elif k in (G.ROMREAD, G.RAMREAD):
                pass  # handled per-instance below
            else:
                raise AssertionError(f"unexpected kind at level {lv}: {k}")
        plan = LevelPlan(
            np.array(bk, np.int32), np.array(ba, np.int32),
            np.array(bb, np.int32), np.array(bo, np.int32),
            np.array(ma, np.int32), np.array(mb, np.int32),
            np.array(ms, np.int32), np.array(mo, np.int32),
            np.array(ns, np.int32), np.array(no, np.int32),
            np.array(cs, np.int32), np.array(co, np.int32),
            [nm for nm, l in rom_level.items() if l == lv],
            [nm for nm, l in ram_level.items() if l == lv],
        )
        levels.append(plan)

    tick_dst, tick_src = [], []
    sdff_nodes, sdff_vals = [], []
    const_nodes, const_vals = [], []
    for node in range(n):
        k = kinds[node]
        if k in (G.DFF, G.SDFF0, G.SDFF1):
            if design.ins[node]:
                tick_dst.append(node)
                tick_src.append(design.ins[node][0])
            if k != G.DFF:
                sdff_nodes.append(node)
                sdff_vals.append(1 if k == G.SDFF1 else 0)
        elif k == G.CONSTONE:
            const_nodes.append(node); const_vals.append(1)
        elif k == G.CONSTZERO:
            const_nodes.append(node); const_vals.append(0)

    return Compiled(
        design, n, levels, level,
        np.array(tick_dst, np.int32), np.array(tick_src, np.int32),
        np.array(sdff_nodes, np.int32), np.array(sdff_vals, np.int32),
        np.array(const_nodes, np.int32), np.array(const_vals, np.int32),
    )
