"""eager_launches_per_cycle.cycle: hand-kernel launches the kernel
wrappers counted outside CUDA-graph replays (the change in the program's
launch_counts() over the window), per window cycle."""


def read(view):
    w = view.window
    if not w["cycle_s"] or w["launches"] is None:
        return None
    return w["launches"] / len(w["cycle_s"])
