"""cycle_p95_s: the 95th percentile of the window's cycle times
(statistics.quantiles, 20 parts); None under 20 cycles."""

import statistics


def read(view):
    c = view.window["cycle_s"]
    if len(c) < 20:
        return None
    return statistics.quantiles(c, n=20)[18]
