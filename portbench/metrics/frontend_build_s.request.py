"""frontend_build_s.request: seconds of the program's iyokan.frontend.build
span (Frontend.__init__: design, compile, engine with device keys and
plans, initial state) a traced request."""

from portbench.metrics import programspans


def read(view):
    return programspans.seconds_per_request(view, "iyokan.frontend.build")
