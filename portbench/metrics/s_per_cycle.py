"""s_per_cycle: the whole window over the cycles it completed (host
clock; every cycle ends in the Frontend's device synchronisation)."""


def read(view):
    w = view.window
    if not w["cycle_s"]:
        return None
    return (w["end"] - w["start"]) / len(w["cycle_s"])
