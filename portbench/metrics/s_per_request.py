"""s_per_request: the whole window over the requests it completed, each
from request packet to result packet, back to back."""


def read(view):
    w = view.window
    if not w["requests"]:
        return None
    return (w["end"] - w["start"]) / len(w["requests"])
