"""setup_s: seconds from process start to the window's first step: key
load, device keys, request encryption, Frontend build and warm-up."""


def read(view):
    return view.setup_s
