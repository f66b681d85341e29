"""Progress / profiling dumps.

The reference's ProgressGraphMaker (src/iyokan.hpp:128-278) records per-task
start/end wall-clock and notification edges, dumped per cycle as a time CSV,
graph JSON and DOT (src/iyokan_plain.cpp:520-537).  In the levelized engine
the unit of execution is a *level batch*, not a task, so the equivalents are:

  time CSV   -- one row per level per cycle with the batch composition and,
                when per-level timing is enabled, the measured wall-clock of
                that level's kernels (plus a per-cycle total row);
  graph JSON -- the static levelized structure: nodes with kind/level, plus
                per-level batch statistics;
  graph DOT  -- level-collapsed DAG (one box per level, edges by data flow).

Per-gate timestamps fundamentally do not exist here: all gates of a level
run inside one fused kernel.  That is the point of the design.
"""

from __future__ import annotations

import json
from typing import IO

from .. import gates as G
from ..circuit.compile import Compiled


def dump_graph_json(c: Compiled, f: IO) -> None:
    nodes = [
        {"id": i, "kind": G.NAMES[k], "level": int(c.node_level[i])}
        for i, k in enumerate(c.design.kinds)
    ]
    levels = [
        {
            "level": lv + 1,
            "bootstraps": int(plan.n_bootstraps),
            "binary_gates": len(plan.bin_out),
            "mux_gates": len(plan.mux_out),
            "not_gates": len(plan.not_out),
            "copies": len(plan.copy_out),
            "rom_reads": plan.rom_reads,
            "ram_reads": plan.ram_reads,
        }
        for lv, plan in enumerate(c.levels)
    ]
    json.dump({"nodes": nodes, "levels": levels}, f, indent=1)


def dump_graph_dot(c: Compiled, f: IO) -> None:
    f.write("digraph levels {\n  rankdir=LR;\n")
    for lv, plan in enumerate(c.levels):
        label = (
            f"L{lv + 1}\\n{len(plan.bin_out)} bin, {len(plan.mux_out)} mux"
            f"\\n{plan.n_bootstraps} bootstraps"
        )
        extras = plan.rom_reads + plan.ram_reads
        if extras:
            label += "\\nmem: " + ",".join(extras)
        f.write(f'  l{lv + 1} [shape=box, label="{label}"];\n')
        if lv:
            f.write(f"  l{lv} -> l{lv + 1};\n")
    f.write("}\n")


def dump_time_csv(c: Compiled, cycle: int, level_times, total: float,
                  f: IO) -> None:
    """level_times: list of seconds per level (or None when not profiled)."""
    f.write("cycle,level,bootstraps,seconds\n")
    for lv, plan in enumerate(c.levels):
        t = "" if level_times is None else f"{level_times[lv]:.6f}"
        f.write(f"{cycle},{lv + 1},{plan.n_bootstraps},{t}\n")
    f.write(f"{cycle},total,,{total:.6f}\n")
