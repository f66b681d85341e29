"""The program's own spans in a traced run: the ranges "iyokan.<stage>"
that iyokan_tpu_torch/engine/spans.py opens while a profiler records, on
the profiler's clock beside the device's operations.

idle_by_span splits the device's idle time inside the traced span (the
complement of the union of its operations: devtrace.Trace.busy_intervals)
exactly, by overlap, among the innermost program span open over each part.
Aten ops, runtime calls and the benchmark's own portbench.* spans do not
count; idle under no program span is OUTSIDE (the benchmark's own work
between the program's calls, such as its per-cycle output read).  A trace
with no program span (a program without them) gives None, so its readers
report nothing.
"""

from __future__ import annotations

PREFIX = "iyokan."
OUTSIDE = "(outside)"


def program_spans(trace) -> list:
    """[(name, start, end)] in ns of the program spans, clipped to the
    traced span."""
    return [(n, max(s, trace.start), min(e, trace.end))
            for n, s, e in trace.host
            if n.startswith(PREFIX) and e > trace.start and s < trace.end]


def _owners(trace, spans) -> list:
    """[(start, end, name)]: the traced span cut at every span's ends, each
    piece named by the innermost span open over it (of those open, the one
    started last) or OUTSIDE."""
    spans = sorted(spans, key=lambda x: (x[1], -x[2]))
    cuts = sorted({trace.start, trace.end}
                  | {t for _, s, e in spans for t in (s, e)})
    out, stack, i = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(spans) and spans[i][1] <= a:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] <= a:
            stack.pop()
        out.append((a, b, stack[-1][0] if stack else OUTSIDE))
    return out


def idle_intervals(trace) -> list:
    """[(start, end)] in ns of the traced span's idle gaps."""
    gaps, t = [], trace.start
    for s, e in trace.busy_intervals():
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if trace.end > t:
        gaps.append((t, trace.end))
    return gaps


def idle_by_span(trace):
    """{innermost program span, or OUTSIDE: idle seconds}, summing to the
    traced span's idle time; None without a trace or program spans."""
    if trace is None:
        return None
    spans = program_spans(trace)
    if not spans:
        return None
    pieces, tot, j = _owners(trace, spans), {}, 0
    for s, e in idle_intervals(trace):
        while pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, name = pieces[k]
            tot[name] = tot.get(name, 0) + min(b, e) - max(a, s)
            k += 1
    return {n: v / 1e9 for n, v in tot.items()}


def outermost_s(trace, name: str) -> float:
    """Seconds of the union of the spans of this name (the outermost ones
    where they nest)."""
    total, end = 0, None
    for _, s, e in sorted((x for x in program_spans(trace) if x[0] == name),
                          key=lambda x: x[1]):
        if end is not None and s < end:
            if e > end:
                total += e - end
                end = e
            continue
        total += e - s
        end = e
    return total / 1e9


def idle_ms_per_cycle(view, owns) -> float:
    """Idle ms a traced cycle under the program spans `owns` accepts (a
    predicate on the name); None without cycles, a trace or spans."""
    cycles = (view.traced or {}).get("cycles")
    parts = idle_by_span(view.trace)
    if parts is None or not cycles:
        return None
    return 1e3 * sum(v for n, v in parts.items() if owns(n)) / len(cycles)


def seconds_per_request(view, name: str) -> float:
    """Seconds of the outermost spans of this name a traced request; None
    without requests, a trace or spans."""
    n = (view.traced or {}).get("requests")
    if view.trace is None or not n or not program_spans(view.trace):
        return None
    return outermost_s(view.trace, name) / n
