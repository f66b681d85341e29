"""mem_idle_ms_per_cycle.cycle: device idle milliseconds a traced cycle
whose innermost program span is a memory level's stage (iyokan.mem.cb,
.rom_read, .ram_read) or the RAM write (iyokan.ram_write); programspans.py
splits the idle time."""

from portbench.metrics import programspans


def read(view):
    return programspans.idle_ms_per_cycle(
        view, lambda n: n.startswith("iyokan.mem.") or n == "iyokan.ram_write")
