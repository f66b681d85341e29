"""request_overhead_s.request: the mean over the window's requests of the
time from a request's start to the end of its first cycle (Frontend
build, state upload, reset settle, the first cycle with its graph
captures) plus the time of make_result_packet; the benchmark's own spans
around the calls."""


def read(view):
    reqs = view.window["requests"]
    if not reqs:
        return None
    return sum((r["first_cycle_end"] - r["start"]) + (r["end"] - r["go_end"])
               for r in reqs) / len(reqs)
