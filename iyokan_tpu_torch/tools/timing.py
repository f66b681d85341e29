"""Timers shared by the port's tools and chip_smoke.py.

  timed_ms(fn, reps, device)   mean ms of fn() over reps calls: CUDA events
                               on the card, the host clock on the CPU;
  marginal(run, n, device)     seconds per unit of run(n) by the difference
                               method, (t(run(4n)) - t(run(n))) / 3n (after
                               warm_s seconds of run(n));
  int_mm_ms(a, b, reps)        mean ms of torch._int_mm(a, b) after a
                               warm-up (raises what torch._int_mm raises);
  cycle_log()                  us of each cycle the Frontend logs while
                               the block runs.

Imports no JAX.
"""

from __future__ import annotations

import contextlib
import logging
import re
import time

import torch


def timed_ms(fn, reps: int, device) -> float:
    """Mean ms of fn() over reps calls: CUDA events on the card, the host
    clock on the CPU."""
    if torch.device(device).type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def marginal(run, n: int, device, warm_s: float = 0.0) -> float:
    """Seconds per unit: (t(run(4n)) - t(run(n))) / 3n, each the minimum of
    3 runs after a warm-up of both, and first of warm_s seconds of run(n):
    a card that idled (while a twin ran on the host) climbs back to its
    clock during the first runs, which inflates t(n) and shrinks the
    difference."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        run(n)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    run(n)
    run(4 * n)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t1 = min(timed_ms(lambda: run(n), 1, device) for _ in range(3))
    t4 = min(timed_ms(lambda: run(4 * n), 1, device) for _ in range(3))
    return (t4 - t1) / 1e3 / (3 * n)


def int_mm_ms(a: torch.Tensor, b: torch.Tensor, reps: int = 20) -> float:
    """Mean ms of torch._int_mm(a, b) on operands built beforehand, after
    one warm-up call."""
    torch._int_mm(a, b)
    return timed_ms(lambda: torch._int_mm(a, b), reps, a.device)


@contextlib.contextmanager
def cycle_log():
    """Yields a list that collects the us of each cycle the Frontend logs
    at INFO while the block runs, from its "done. (N us)" line."""
    cycles = []

    class Cycles(logging.Handler):
        def emit(self, record):
            m = re.match(r"\s*done\. \((\d+) us\)", record.getMessage())
            if m:
                cycles.append(int(m.group(1)))

    lg = logging.getLogger("iyokan")
    lg.setLevel(logging.INFO)
    handler = Cycles()
    lg.addHandler(handler)
    try:
        yield cycles
    finally:
        lg.removeHandler(handler)
