"""device_idle_share.cycle: the share of the traced cycles' span in which
no device operation runs, in %."""


def read(view):
    if view.trace is None or not (view.traced or {}).get("cycles"):
        return None
    t = view.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
