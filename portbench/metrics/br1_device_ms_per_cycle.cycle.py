"""br1_device_ms_per_cycle.cycle: device milliseconds of the lvl1 blind
rotation's kernels (layers/br1.json) per traced cycle."""


def read(view):
    cycles = (view.traced or {}).get("cycles")
    if view.trace is None or not cycles:
        return None
    s = view.trace.device_s(view.layer("br1")["kernels"])
    return s * 1e3 / len(cycles) if s else None
