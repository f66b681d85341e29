"""driver_idle_ms_per_cycle.cycle: device idle milliseconds a traced cycle
whose innermost program span is the Frontend's own (iyokan.cycle,
iyokan.scan, iyokan.inputs: its tick, input scatter and the glue between
the engine's stages); programspans.py splits the idle time."""

from portbench.metrics import programspans

DRIVER = ("iyokan.cycle", "iyokan.scan", "iyokan.inputs")


def read(view):
    return programspans.idle_ms_per_cycle(view, lambda n: n in DRIVER)
