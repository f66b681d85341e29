"""Reduction of a torch.profiler trace to what the per-layer readers need.

The traced span is one record_function("portbench.window") on the host.
Device operations (kernels, memsets, copies: the events on the CUDA side)
are clipped to it; their union is the busy time, its complement inside the
span the idle gaps.  Each gap is named by the innermost host event open at
its middle (an aten op, a CUDA runtime call or one of the benchmark's own
spans "portbench.*"), which says what the host was doing while the card
waited.
"""

from __future__ import annotations

import re

SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    return f() if f is not None else getattr(ev, f"{what}_us")() * 1000


class Trace:
    """ops: [(name, start, end)] of the device inside the span, in ns;
    host: [(name, start, end)] of host events; start, end: the span."""

    def __init__(self, ops, host, start, end):
        self.ops, self.host, self.start, self.end = ops, host, start, end

    @staticmethod
    def from_profiler(prof) -> "Trace":
        dev, host, span = [], [], None
        for ev in prof.profiler.kineto_results.events():
            s = _ns(ev, "start")
            e = s + _ns(ev, "duration")
            kind = str(ev.device_type())
            if kind.endswith("CUDA"):
                # record_function ranges are mirrored onto the device's
                # timeline as annotations: they are no device work
                ann = getattr(ev, "is_user_annotation", None)
                if not ((ann is not None and ann())
                        or ev.name().startswith(SPAN_PREFIX)):
                    dev.append((ev.name(), s, e))
            else:
                if ev.name() == WINDOW:
                    span = (s, e)
                host.append((ev.name(), s, e))
        if span is None:
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        lo, hi = span
        ops = [(n, max(s, lo), min(e, hi)) for n, s, e in dev
               if e > lo and s < hi]
        return Trace(ops, host, lo, hi)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self):
        out = []
        for _, s, e in sorted(self.ops, key=lambda t: t[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_s(self, patterns) -> float:
        """Seconds of the device operations whose name matches one of the
        regular expressions, summed."""
        rx = [re.compile(p) for p in patterns]
        return sum(e - s for n, s, e in self.ops
                   if any(r.search(n) for r in rx)) / 1e9

    def by_name(self):
        tot = {}
        for n, s, e in self.ops:
            tot[n] = tot.get(n, 0) + (e - s)
        return sorted(((n, t / 1e9) for n, t in tot.items()),
                      key=lambda x: -x[1])

    def idle_gaps(self):
        """[(host activity, seconds)] of the idle time inside the span,
        summed by the innermost host event open at each gap's middle."""
        gaps, t = [], self.start
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        # host events nest: sweep them by start with a stack of the open
        # ones; at each gap's middle the top of the stack is the innermost
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        tot, stack, i = {}, [], 0
        for s, e in gaps:
            mid = (s + e) // 2
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            name = stack[-1][0] if stack else "(no host event)"
            tot[name] = tot.get(name, 0) + (e - s)
        return sorted(((n, v / 1e9) for n, v in tot.items()),
                      key=lambda x: -x[1])
