"""device_idle_share.request: the share of the traced requests' span in
which no device operation runs, in %."""


def read(view):
    if view.trace is None or not (view.traced or {}).get("requests"):
        return None
    t = view.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
