"""cbcmux_device_ms_per_cycle.cycle: device milliseconds of circuit
bootstrapping's lvl2 rotation (K7) and the lvl1 CMUX external products
(K6) per traced cycle (layers/cbcmux.json)."""


def read(view):
    cycles = (view.traced or {}).get("cycles")
    if view.trace is None or not cycles:
        return None
    s = view.trace.device_s(view.layer("cbcmux")["kernels"])
    return s * 1e3 / len(cycles) if s else None
