"""gateglue_device_ms_per_cycle.cycle: device milliseconds per traced cycle
of every device operation outside the lvl1 blind rotation's and circuit
bootstrapping's kernel tables (layers/br1.json, layers/cbcmux.json).  In a
gate-only circuit that is the gate levels' work around the rotation:
gather, gate_linear, sample extract, the key switch's digits and float64
GEMM, scatter and NOT."""

import re


def read(view):
    cycles = (view.traced or {}).get("cycles")
    if view.trace is None or not cycles:
        return None
    rx = [re.compile(p) for name in ("br1", "cbcmux")
          for p in view.layer(name)["kernels"]]
    s = sum(e - b for n, b, e in view.trace.ops
            if not any(r.search(n) for r in rx)) / 1e9
    return s * 1e3 / len(cycles) if s else None
