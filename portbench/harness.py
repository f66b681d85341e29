"""One run of one cell: set-up, the measured window, the traced span, the
judgement, and the result line (run.py prints it).

  long          one request from the seed; warm-up cycles (through the
                first RAM refresh cycle where the circuit has RAM, else
                the traffic's warmup_cycles, and on until warmup_seconds
                have passed and the refresh period is at the same cycle),
                then cycles until --seconds have passed, the window
                closing at the end of the cycle in flight;
  closed_loop   a pool of requests made in set-up, `warmup` requests run,
                then one client sending the pool's requests in turn, each
                a new Frontend over the loaded eval key, until --seconds
                have passed.

Under --trace 1 the same window runs, then a profiled span after it:
trace_cycles cycles (whole refresh periods where there is RAM, starting
at a period's first cycle) or trace_requests requests.  Every answer of
the run, warm-up and traced span included, is judged once the window has
closed and the program's state is freed.

A cell of N > 1 chips runs as N processes, one a card (crew.py; run.py
starts them), each with the same keys, request, Frontend and cycles, on
the program's gate-batch mesh (Program.join_mesh).  Rank 0 decides when
the warm-up ends and the window closes and sends each decision to the
others (crew.Steer); every rank profiles the same traced span; every rank
sends rank 0 its peak memory, its trace's busy and span seconds, its
steps' stamps and a digest of its result packet.  Rank 0 alone reads
each cycle's outputs, times, reads the per-layer metrics (card 0's trace)
and judges; a rank whose result packet differs from rank 0's makes the
run not correct (ranks_differing, limit 0).  A cell of one chip starts no
process and sets no mesh.
"""

from __future__ import annotations

import contextlib
import glob
import math
import os
import re
import time
import types

import numpy as np

from portbench import cells, crew, generator, judge
from portbench.devtrace import SPAN_PREFIX, WINDOW, Trace
from portbench.reference import tfhe as ref_tfhe
from portbench.reference.circuit import Circuit


@contextlib.contextmanager
def program_env(settings: dict):
    """os.environ without any IYOKAN_* variable, plus `settings`;
    restored afterwards."""
    saved = dict(os.environ)
    for k in list(os.environ):
        if k.startswith("IYOKAN_"):
            del os.environ[k]
    os.environ.update(settings)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def ensure_keys(prog, root: str, config: dict, log) -> tuple:
    """(secret key, secret key file, eval key file, seconds of the
    reference's own work) of the configuration's fixed key seed, made once
    per checkout under build/portbench/keys: the secret key drawn here
    (reference/tfhe.py) or read back from its file, the eval key by the
    client tool."""
    p = config["param_values"]
    d = os.path.join(root, "build", "portbench", "keys",
                     f"{config['params']}-{config['key_seed']}")
    os.makedirs(d, exist_ok=True)
    sk_path, ek_path = os.path.join(d, "sk.npz"), os.path.join(d, "ek.npz")
    t0 = time.time()
    if os.path.exists(sk_path):
        with np.load(sk_path) as f:
            s = {k: f[k] for k in ("s0", "s1", "s2")}
    else:
        s = ref_tfhe.secret_key(p, config["key_seed"])
        tmp = f"{sk_path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, kind="secret-key", params=config["params"],
                                **s)
        os.replace(tmp, sk_path)
    ref_s = time.time() - t0
    if not os.path.exists(ek_path):
        t0 = time.time()
        prog.make_eval_key(sk_path, ek_path, config["key_seed"] + 1)
        log(f"keys: eval key made in {time.time() - t0:.1f} s "
            f"({os.path.getsize(ek_path) / 2**20:.0f} MiB)")
    return s, sk_path, ek_path, ref_s


def _sync(prog):
    if prog.device != "cpu":
        prog.torch.cuda.synchronize()


@contextlib.contextmanager
def _profiled(prog, holder, steer):
    torch = prog.torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if prog.device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(prog)
    with torch.profiler.profile(activities=acts) as prof:
        # every rank's profiler has started before the first traced step
        steer.barrier()
        with torch.profiler.record_function(WINDOW):
            yield
            _sync(prog)
    holder.append(prof)


def _span(prog, name):
    return prog.torch.profiler.record_function(SPAN_PREFIX + name)


class Ranks(types.SimpleNamespace):
    """This process's place in a cell of several cards: rank `rank` of
    `world` processes, meeting at `coordinator` ("host:port")."""


def run_long(prog, ctx):
    cfg, trf, circ = ctx.config, ctx.traffic, ctx.circuit
    request = generator.make_request(circ, cfg, trf, ctx.seed, 0)
    enc = prog.encrypt(*request, generator.encryption_seed(ctx.seed, 0))
    ctx.mark("request encrypted")
    fe = prog.frontend(enc)
    ctx.mark("Frontend built (device keys)")
    nodes = prog.output_nodes(fe)
    outs, stamps = [], []
    # rank 0 reads each cycle's outputs for the judgement; the other ranks
    # of a cell of several cards only stamp their cycles (their result
    # packet is compared with rank 0's)
    reading = ctx.steer.rank == 0

    def on_cycle(f):
        stamps.append(time.perf_counter())
        if reading:
            outs.append(prog.read_outputs(f, nodes))

    def cycle():
        with _span(prog, "cycle"):
            fe.go(1, on_cycle=on_cycle)
        ctx.progress()

    # warm-up: the first cycles capture the graphs (through the first
    # refresh cycle where there is RAM); then cycles until the card has run
    # warmup_seconds, since it comes out of idle slower for some seconds;
    # the window starts at the same cycle of the refresh period every run
    period = int(cfg["ram_refresh_period"]) if circ.rams else 0
    first = period + 1 if period else int(trf["warmup_cycles"])
    # (rank 0 decides each step for every rank: crew.Steer)
    steer = ctx.steer
    t_warm = time.perf_counter()
    while not steer.stop(not (
            fe.current_cycle < first
            or time.perf_counter() - t_warm < float(trf["warmup_seconds"])
            or (period and fe.current_cycle % period != first % period))):
        cycle()
    ctx.mark(f"{fe.current_cycle} warm-up cycles")
    launches0, graphs0 = prog.launches(), prog.graphs(fe)
    ctx.setup_s = time.time() - ctx.t_start - ctx.ref_s
    ctx.progress("window")
    t0 = time.perf_counter()
    n0 = len(stamps)
    steer.reset()
    end = None        # the cycles run when the window closed
    while True:
        cycle()
        if end is None and stamps[-1] - t0 >= ctx.seconds:
            end = len(stamps), prog.launches()
        if steer.stop(end is not None):
            break
    end, launches1 = end or (len(stamps), prog.launches())
    w = [t0] + stamps[n0:end]
    ctx.window = {"start": t0, "end": w[-1], "cycle_s": list(np.diff(w)),
                  "requests": [], "launches": launches1 - launches0}
    q = np.quantile(ctx.window["cycle_s"], [0, 0.25, 0.5, 0.75, 0.95, 1])
    ctx.log("window: cycle s min/q1/median/q3/p95/max "
            + "/".join(f"{x:.4f}" for x in q))
    if prog.graphs(fe) != graphs0:
        ctx.log(f"warning: {prog.graphs(fe) - graphs0} graphs captured "
                "inside the window")
    ctx.read_memory()
    if ctx.trace:
        while period and fe.current_cycle % period:
            cycle()
        n = int(trf["trace_cycles"])
        if period:
            n = math.ceil(n / period) * period
        first = fe.current_cycle
        nodes_before = prog.replayed_kernel_nodes(fe)
        with _profiled(prog, ctx.profiles, ctx.steer):
            for _ in range(n):
                cycle()
        ctx.expected_ops = prog.replayed_kernel_nodes(fe) - nodes_before
        ctx.traced = {"cycles": [bool(period) and (c + 1) % period == 0
                                 for c in range(first, first + n)]}
    result = prog.result(fe)
    ctx.footprint = prog.footprint(fe)
    if steer.world > 1:
        ctx.digest = crew.digest(result)
    del fe
    ctx.free()
    return lambda: judge.judge_long(circ, ctx.sk, request, outs, result)


def run_closed_loop(prog, ctx):
    cfg, trf, circ = ctx.config, ctx.traffic, ctx.circuit
    pool = [generator.make_request(circ, cfg, trf, ctx.seed, i)
            for i in range(int(trf["pool"]))]
    enc = [prog.encrypt(*r, generator.encryption_seed(ctx.seed, i))
           for i, r in enumerate(pool)]
    ctx.mark(f"{len(enc)} requests encrypted")
    cycles = int(trf["cycles"])
    results, spans = [], []

    def request(k):
        i = k % len(pool)
        with _span(prog, "request"):
            t_a = time.perf_counter()
            first = []
            with _span(prog, "frontend"):
                fe = prog.frontend(enc[i])
            with _span(prog, "go"):
                fe.go(cycles, on_cycle=lambda f: first.append(
                    time.perf_counter()) if not first else None)
            t_b = time.perf_counter()
            with _span(prog, "result"):
                res = prog.result(fe)
            t_c = time.perf_counter()
        if ctx.footprint is None:
            ctx.footprint = prog.footprint(fe)
        del fe
        results.append((i, res))
        spans.append({"start": t_a, "first_cycle_end": first[0],
                      "go_end": t_b, "end": t_c})
        ctx.progress()

    for k in range(int(trf["warmup"])):
        request(k)
    ctx.mark(f"{trf['warmup']} warm-up requests")
    ctx.setup_s = time.time() - ctx.t_start - ctx.ref_s
    ctx.progress("window")
    t0 = time.perf_counter()
    n0 = len(spans)
    k = 0
    steer = ctx.steer
    steer.reset()
    end = None        # the requests run when the window closed
    while True:
        request(k)
        k += 1
        if end is None and spans[-1]["end"] - t0 >= ctx.seconds:
            end = len(spans)
        if steer.stop(end is not None):
            break
    end = end or len(spans)
    ctx.window = {"start": t0, "end": spans[end - 1]["end"], "cycle_s": [],
                  "requests": spans[n0:end], "launches": None}
    ctx.log("window: requests (s: to the first cycle's end, rest of go, "
            "result) " + " ".join(
                f"{r['first_cycle_end'] - r['start']:.3f}/"
                f"{r['go_end'] - r['first_cycle_end']:.3f}/"
                f"{r['end'] - r['go_end']:.3f}" for r in spans[n0:end]))
    ctx.read_memory()
    if ctx.trace:
        n = int(trf["trace_requests"])
        with _profiled(prog, ctx.profiles, ctx.steer):
            for _ in range(n):
                request(k)
                k += 1
        ctx.traced = {"requests": n}
    if steer.world > 1:
        ctx.digest = crew.digest(results)
    ctx.free()
    return lambda: judge.judge_requests(circ, ctx.sk, pool, cycles, results)


KINDS = {"long": run_long, "closed_loop": run_closed_loop}


class Context(types.SimpleNamespace):
    def mark(self, what):
        """Log the set-up step that ended now, with its seconds."""
        now = time.time()
        self.log(f"set-up: {what} {now - self.t_mark:.2f} s")
        self.t_mark = now
        self.progress()

    def read_memory(self):
        if self.device == "cpu":
            self.memory_peak = 0
        else:
            self.memory_peak = int(self.prog.torch.cuda.max_memory_reserved())

    def free(self):
        if self.device != "cpu":
            self.prog.torch.cuda.synchronize()
            self.prog.torch.cuda.empty_cache()


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", control: str = None,
             t_start: float = None, log=print, ranks: Ranks = None,
             progress=None) -> dict:
    """The result of one run (run.py prints it as the last line); None on
    a rank other than 0 of a cell of several cards (`ranks`).  progress(
    [phase]) is called at each set-up step, cycle and request."""
    t_start = time.time() if t_start is None else t_start
    man = cells.Manifest(root)
    cell = man.cell(workload)
    config, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    chips = int(cell["chips"])
    settings = {"IYOKAN_SLAB_CACHE": os.path.join(root, "build", "portbench",
                                                  "slab")}
    if control:
        settings.update(man.control(control)["env"])
    if chips > 1:
        if ranks is None or ranks.world != chips:
            raise SystemExit(f"{workload} runs as {chips} processes, one a "
                             "card (run.py starts them)")
        settings.update({"IYOKAN_COORDINATOR": ranks.coordinator,
                         "IYOKAN_NUM_PROCESSES": str(chips),
                         "IYOKAN_PROCESS_ID": str(ranks.rank)})
        if device == "cpu":
            settings["IYOKAN_TORCH_DEVICE"] = "cpu"
    progress = progress or (lambda phase=None: None)
    # the reference's own work (its evaluator's circuit, the secret key)
    # is left out of setup_s
    t0 = time.time()
    circ = Circuit(os.path.join(config["_dir"], config["blueprint"]))
    ref_s = time.time() - t0
    with program_env(settings):
        from portbench.program import Program

        prog = Program(root, device)
        steer = crew.Steer()
        if chips > 1:
            # one process a card: at most the card's share of the host's
            # cores each
            prog.torch.set_num_threads(max(1, min(
                prog.torch.get_num_threads(), (os.cpu_count() or 1) // chips)))
            shards = prog.join_mesh()
            steer = crew.Steer(chips, ranks.rank)
            sizes = steer.gather(shards)
            if ranks.rank == 0 and sizes != [chips] * chips:
                raise RuntimeError(f"the ranks' meshes hold {sizes} shards, "
                                   f"not {chips} each")
        t_import = time.time()
        log(f"set-up: program imported {t_import - t_start:.2f} s")
        progress()
        # one rank makes the keys of a new checkout; the others load them
        if steer.rank == 0:
            keys = ensure_keys(prog, root, config, log)
        steer.barrier()
        if steer.rank != 0:
            keys = ensure_keys(prog, root, config, log)
        sk, sk_path, ek_path, key_ref_s = keys
        ref_s += key_ref_s
        prog.load(sk_path, ek_path,
                  os.path.join(config["_dir"], config["blueprint"]))
        got = prog.params()
        want = {k: config["param_values"][k] for k in got if k != "name"}
        if got["name"] != config["params"] or any(
                got[k] != v for k, v in want.items()):
            raise SystemExit(f"the program's parameter set {got} is not the "
                             f"configuration's {config['params']} {want}")
        ctx = Context(config=config, traffic=traffic, circuit=circ,
                      seed=seed, seconds=seconds, trace=trace,
                      device=device, prog=prog, t_start=t_start,
                      ref_s=ref_s, sk=sk, setup_s=None, window=None,
                      traced=None, profiles=[], footprint=None, memory_peak=0,
                      expected_ops=None, t_judge=None, log=log,
                      t_mark=t_import, steer=steer, progress=progress,
                      digest=None)
        ctx.mark("keys and blueprint loaded")
        judge_run = KINDS[traffic["kind"]](prog, ctx)
    progress("judge")
    trace_obj = None
    if ctx.profiles and device != "cpu":
        trace_obj = Trace.from_profiler(ctx.profiles[0])
        ctx.profiles.clear()
    # every rank's readings, in rank order, on rank 0
    ranks_read = steer.gather({
        "memory_peak": ctx.memory_peak, "digest": ctx.digest,
        "busy_s": trace_obj.busy_s if trace_obj else None,
        "window_s": trace_obj.window_s if trace_obj else None,
        "steer": steer.stamps})
    if steer.rank != 0:
        return None
    if chips > 1:
        c = crew.message_cost([r["steer"] for r in ranks_read])
        step = (ctx.window["end"] - ctx.window["start"]) / max(1, c["steps"])
        log(f"control: {c['steps']} steps; the slowest rank's host time in "
            f"the step's message {c['median_s'] * 1e3:.4f} ms (median; "
            f"largest {c['max_s'] * 1e3:.4f}; rank 0's "
            f"{c['root_median_s'] * 1e3:.4f}): "
            f"{100 * c['median_s'] / step:.4f} % of the window's mean step")
    ctx.t_judge = time.time()
    tally = judge_run()
    t_end = time.time()
    log(f"timing: setup {ctx.setup_s:.1f} s (the reference's {ref_s:.2f} s "
        f"left out), window and traced span "
        f"{ctx.t_judge - t_start - ref_s - ctx.setup_s:.1f} s, judgement "
        f"{t_end - ctx.t_judge:.1f} s")
    log("footprint on the device (bytes): " + " ".join(
        f"{k}={v}" for k, v in (ctx.footprint or {}).items())
        + f" peak_reserved={ctx.memory_peak}")

    view = types.SimpleNamespace(
        config=config, traffic=traffic, circuit=circ,
        params=config["param_values"], peaks=man.peaks(),
        layer=man.layer, setup_s=ctx.setup_s, chips=chips,
        window=ctx.window, traced=ctx.traced, trace=trace_obj)
    metrics = {}
    for m in man.metrics(workload, trace):
        value = man.reader(m["name"])(view)
        if value is None and not trace:
            raise RuntimeError(f"{workload}: no reading of {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    # the fullest card's peak; busy and span seconds averaged over the
    # cards
    device_rec = {"platform": "gpu" if device != "cpu" else "cpu",
                  "kind": (prog.torch.cuda.get_device_name(0)
                           if device != "cpu" else "cpu"),
                  "count": chips,
                  "memory_peak_bytes": max(r["memory_peak"]
                                           for r in ranks_read)}
    out = {"correct": None, "attempted": tally.attempted,
           "failed": tally.failed, "metrics": metrics, "device": device_rec}
    if trace_obj is not None:
        device_rec["busy_s"] = sum(r["busy_s"] for r in ranks_read) / chips
        device_rec["window_s"] = sum(r["window_s"]
                                     for r in ranks_read) / chips
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           trace_obj.by_name()[:10]],
                            "idle_gaps": [list(x) for x in
                                          trace_obj.idle_gaps()[:10]]}
        report_layers(man, trace_obj, ctx, log)
    numbers = tally.numbers()
    limits = dict(config["limits"])
    if chips > 1:
        numbers["ranks_differing"] = sum(r["digest"] != ranks_read[0]["digest"]
                                         for r in ranks_read[1:])
        limits["ranks_differing"] = 0
    out["correct"] = all(numbers[k] <= limits[k] for k in limits)
    out["compared"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in limits}
    return out


def report_layers(man, tr, ctx, log):
    """Device seconds by layer table and what no table claims ("other"),
    with the largest unclaimed operations, so a renamed kernel shows."""
    names = sorted(os.path.splitext(os.path.basename(p))[0] for p in
                   glob.glob(os.path.join(man.bench, "metrics", "layers",
                                          "*.json")))
    claimed, parts = [], []
    for name in names:
        pats = man.layer(name)["kernels"]
        claimed += pats
        parts.append(f"{name} {tr.device_s(pats):.6f}")
    rx = [re.compile(p) for p in claimed]
    other = [(n, s) for n, s in tr.by_name()
             if not any(r.search(n) for r in rx)]
    log(f"trace: {len(tr.ops)} device operations in {tr.window_s:.6f} s "
        f"(graph kernel nodes replayed: {ctx.expected_ops}); device s by "
        f"layer: {', '.join(parts)}, other {sum(s for _, s in other):.6f}")
    log("trace: largest other operations: " + "; ".join(
        f"{n[:80]} {s:.6f}" for n, s in other[:8]))
