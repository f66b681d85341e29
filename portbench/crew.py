"""A cell of several cards: one process a card on the program's gate-batch
mesh, rank 0 the process the command started.

  Crew     rank 0's side: starts ranks 1 .. N-1 as processes of the same
           entry script (rank r takes card r: parallel/distributed.py),
           and watches them from a thread.  A rank that ends with another
           code than 0, or a run that makes no progress within its phase's
           limit (LIMITS), ends every rank: the workers are killed and
           waited for, and rank 0 leaves with EXIT_CREW, printing no
           result.  A worker dies with rank 0 (PR_SET_PDEATHSIG).
  Steer    every rank's side: a host-side gloo group beside the program's
           own, on which rank 0 broadcasts each decision (stop here or go
           on) as one small message a step, so that no rank runs a cycle
           the others do not; barrier() and gather() on the same group.
           A decision is acted on one step after rank 0 sent it (rank 0
           runs the step after its stop too), and every other rank posts
           its receive of the next decision a step ahead, so that the
           message is in its hands before it is read; rank 0 waits for its
           sends to complete only at the next barrier or gather.  No rank
           waits on a message in the window.  A world of one process sends
           nothing: stop() returns its flag at once.
  digest   a hash of a rank's answers, which rank 0 compares with its own.
"""

from __future__ import annotations

import ctypes
import datetime
import hashlib
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

# seconds a phase may pass without progress before every rank is ended:
# set-up steps (the first run of a checkout makes the eval key and builds
# the kernels), one cycle or request of the window or the traced span,
# the judgement, and the workers' exit once rank 0 is done
LIMITS = {"setup": 600.0, "window": 120.0, "judge": 600.0, "finish": 120.0}
# the gloo group's timeout: no rank waits longer on a message
GROUP_TIMEOUT_S = 900.0
EXIT_CREW = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Crew:
    def __init__(self, entry: str, argv: list, world: int, log):
        self.coordinator = f"localhost:{free_port()}"
        self.log = log
        self.phase, self.t = "setup", time.monotonic()
        self.done = False
        self.procs = [subprocess.Popen(
            [sys.executable, entry, *argv, "--rank", str(r),
             "--coordinator", self.coordinator, "--parent", str(os.getpid())],
            stdin=subprocess.DEVNULL, stdout=sys.stderr.fileno())
            for r in range(1, world)]
        threading.Thread(target=self._watch, daemon=True).start()

    def progress(self, phase: str = None) -> None:
        """Rank 0 made progress (and entered `phase`)."""
        if phase:
            self.phase = phase
        self.t = time.monotonic()

    def _watch(self):
        while not self.done:
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc not in (None, 0):
                    self._abort(f"rank {r} ended with code {rc}")
            idle = time.monotonic() - self.t
            if idle > LIMITS[self.phase]:
                self._abort(f"no progress in {self.phase} for {idle:.0f} s")
            time.sleep(0.2)

    def _abort(self, why: str):
        if self.done:
            return
        self.log(f"crew: {why}: every rank ended, no result")
        self.kill()
        sys.stderr.flush()
        os._exit(EXIT_CREW)

    def kill(self) -> None:
        """Kill every worker still running and wait until each has
        ended."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def finish(self) -> None:
        """Wait until every worker has ended; each has to end with 0."""
        self.progress("finish")
        for r, p in enumerate(self.procs, 1):
            rc = p.wait()
            if rc != 0:
                self._abort(f"rank {r} ended with code {rc}")
        self.done = True


def die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its parent (rank 0) ends."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, int(signal.SIGKILL))          # PR_SET_PDEATHSIG
    if os.getppid() != parent:                  # it ended before the call
        os._exit(EXIT_CREW)


class Steer:
    def __init__(self, world: int = 1, rank: int = 0):
        self.world, self.rank = world, rank
        self.group = None
        self.pending, self.posted = [], None
        self.started = self.sent = False
        self.reset()
        if world > 1:
            import torch.distributed as dist

            self.dist = dist
            self.group = dist.new_group(
                backend="gloo",
                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))

    def reset(self) -> None:
        """Record the messages from now: stamps [(start, end)] of each
        stop() call, perf_counter seconds (CLOCK_MONOTONIC, one clock
        for every process of the host)."""
        self.stamps = []

    def stop(self, flag) -> bool:
        """Whether every rank leaves its loop at this step: rank 0's flag
        (the others' own is not read); on several cards the flag rank 0
        gave at the loop's step before (False at its first step)."""
        if self.group is None:
            return bool(flag)
        import torch

        t0 = time.perf_counter()
        prev = False
        if self.rank == 0:
            prev = self.started and self.sent
            if not prev:
                t = torch.tensor([int(bool(flag))], dtype=torch.int32)
                self.pending.append((t, self._bcast(t)))
                self.sent = bool(flag)
        else:
            if self.started:
                t, work = self.posted
                work.wait()
                prev = bool(t.item())
            if not prev:                    # the next decision's receive
                t = torch.zeros(1, dtype=torch.int32)
                self.posted = (t, self._bcast(t))
        self.started = not prev
        self.stamps.append((t0, time.perf_counter()))
        return prev

    def _bcast(self, t):
        return self.dist.broadcast(t, src=0, group=self.group, async_op=True)

    def _flush(self):
        for _, work in self.pending:
            work.wait()
        self.pending = []

    def barrier(self) -> None:
        if self.group is not None:
            self._flush()
            self.dist.barrier(group=self.group)

    def gather(self, obj) -> list:
        """Every rank's obj, in rank order, on rank 0 (None elsewhere)."""
        if self.group is None:
            return [obj]
        self._flush()
        out = [None] * self.world if self.rank == 0 else None
        self.dist.gather_object(obj, out, dst=0, group=self.group)
        return out


def message_cost(stamps: list) -> dict:
    """What the control messages cost a step, from every rank's stop()
    stamps (rank order, one list a rank, step k the k-th entry of each):
    the host time of the slowest rank's call at each step, which delays
    the next step's first all-gather by as much, and rank 0's own; medians
    and the largest, in seconds."""
    n = min(len(s) for s in stamps)
    slowest = [max(s[k][1] - s[k][0] for s in stamps) for k in range(n)]
    root = [e - b for b, e in stamps[0][:n]]
    return {"steps": n,
            "median_s": float(np.median(slowest)) if n else 0.0,
            "max_s": max(slowest, default=0.0),
            "root_median_s": float(np.median(root)) if n else 0.0}


def digest(obj) -> str:
    """sha256 of the arrays in obj (dicts by sorted key, lists in order),
    with their dtypes and shapes."""
    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(repr(k).encode())
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(b"[%d]" % len(x))
            for y in x:
                feed(y)
        else:
            a = np.ascontiguousarray(np.asarray(x))
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())

    feed(obj)
    return h.hexdigest()
