"""graph_capture_s.request: seconds of the program's iyokan.graph.capture
spans (a CUDA graph's warm-up, capture and instantiation; the outermost
where they nest) a traced request."""

from portbench.metrics import programspans


def read(view):
    return programspans.seconds_per_request(view, "iyokan.graph.capture")
