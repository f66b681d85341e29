"""br1_roofline.cycle: the traced cycles' lvl1 blind-rotation bound
(workmodel.py: the work the circuit needs, whatever kernel runs it; on a
mesh card 0's share of it) over card 0's device time of the lvl1 blind
rotation's kernels, in %."""

from portbench.metrics import workmodel


def read(view):
    cycles = (view.traced or {}).get("cycles")
    if view.trace is None or not cycles:
        return None
    s = view.trace.device_s(view.layer("br1")["kernels"])
    if not s:
        return None
    bound = sum(workmodel.cycle_bound_s(view.circuit, view.params,
                                        view.peaks, refresh, view.chips)
                for refresh in cycles)
    return 100.0 * bound / s
