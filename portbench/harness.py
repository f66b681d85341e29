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

from portbench import cells, generator, judge
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
def _profiled(prog, holder):
    torch = prog.torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if prog.device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(prog)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            _sync(prog)
    holder.append(prof)


def _span(prog, name):
    return prog.torch.profiler.record_function(SPAN_PREFIX + name)


def run_long(prog, ctx):
    cfg, trf, circ = ctx.config, ctx.traffic, ctx.circuit
    request = generator.make_request(circ, cfg, trf, ctx.seed, 0)
    enc = prog.encrypt(*request, generator.encryption_seed(ctx.seed, 0))
    ctx.mark("request encrypted")
    fe = prog.frontend(enc)
    ctx.mark("Frontend built (device keys)")
    nodes = prog.output_nodes(fe)
    outs, stamps = [], []

    def on_cycle(f):
        stamps.append(time.perf_counter())
        outs.append(prog.read_outputs(f, nodes))

    def cycle():
        with _span(prog, "cycle"):
            fe.go(1, on_cycle=on_cycle)

    # warm-up: the first cycles capture the graphs (through the first
    # refresh cycle where there is RAM); then cycles until the card has run
    # warmup_seconds, since it comes out of idle slower for some seconds;
    # the window starts at the same cycle of the refresh period every run
    period = int(cfg["ram_refresh_period"]) if circ.rams else 0
    first = period + 1 if period else int(trf["warmup_cycles"])
    t_warm = time.perf_counter()
    while (fe.current_cycle < first
           or time.perf_counter() - t_warm < float(trf["warmup_seconds"])
           or (period and fe.current_cycle % period != first % period)):
        cycle()
    ctx.mark(f"{fe.current_cycle} warm-up cycles")
    launches0, graphs0 = prog.launches(), prog.graphs(fe)
    ctx.setup_s = time.time() - ctx.t_start - ctx.ref_s
    t0 = time.perf_counter()
    n0 = len(stamps)
    while True:
        cycle()
        if stamps[-1] - t0 >= ctx.seconds:
            break
    w = [t0] + stamps[n0:]
    ctx.window = {"start": t0, "end": stamps[-1],
                  "cycle_s": list(np.diff(w)),
                  "requests": [], "launches": prog.launches() - launches0}
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
        with _profiled(prog, ctx.profiles):
            for _ in range(n):
                cycle()
        ctx.expected_ops = prog.replayed_kernel_nodes(fe) - nodes_before
        ctx.traced = {"cycles": [bool(period) and (c + 1) % period == 0
                                 for c in range(first, first + n)]}
    result = prog.result(fe)
    ctx.footprint = prog.footprint(fe)
    del fe
    ctx.free()
    ctx.t_judge = time.time()
    return judge.judge_long(circ, ctx.sk, request, outs, result)


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

    for k in range(int(trf["warmup"])):
        request(k)
    ctx.mark(f"{trf['warmup']} warm-up requests")
    ctx.setup_s = time.time() - ctx.t_start - ctx.ref_s
    t0 = time.perf_counter()
    n0 = len(spans)
    k = 0
    while True:
        request(k)
        k += 1
        if spans[-1]["end"] - t0 >= ctx.seconds:
            break
    ctx.window = {"start": t0, "end": spans[-1]["end"], "cycle_s": [],
                  "requests": spans[n0:], "launches": None}
    ctx.log("window: requests (s: to the first cycle's end, rest of go, "
            "result) " + " ".join(
                f"{r['first_cycle_end'] - r['start']:.3f}/"
                f"{r['go_end'] - r['first_cycle_end']:.3f}/"
                f"{r['end'] - r['go_end']:.3f}" for r in spans[n0:]))
    ctx.read_memory()
    if ctx.trace:
        n = int(trf["trace_requests"])
        with _profiled(prog, ctx.profiles):
            for _ in range(n):
                request(k)
                k += 1
        ctx.traced = {"requests": n}
    ctx.free()
    ctx.t_judge = time.time()
    return judge.judge_requests(circ, ctx.sk, pool, cycles, results)


KINDS = {"long": run_long, "closed_loop": run_closed_loop}


class Context(types.SimpleNamespace):
    def mark(self, what):
        """Log the set-up step that ended now, with its seconds."""
        now = time.time()
        self.log(f"set-up: {what} {now - self.t_mark:.2f} s")
        self.t_mark = now

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
             t_start: float = None, log=print) -> dict:
    """The result of one run (run.py prints it as the last line)."""
    t_start = time.time() if t_start is None else t_start
    man = cells.Manifest(root)
    cell = man.cell(workload)
    config, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    settings = {"IYOKAN_SLAB_CACHE": os.path.join(root, "build", "portbench",
                                                  "slab")}
    if control:
        settings.update(man.control(control)["env"])
    # the reference's own work (its evaluator's circuit, the secret key)
    # is left out of setup_s
    t0 = time.time()
    circ = Circuit(os.path.join(config["_dir"], config["blueprint"]))
    ref_s = time.time() - t0
    with program_env(settings):
        from portbench.program import Program

        prog = Program(root, device)
        t_import = time.time()
        log(f"set-up: program imported {t_import - t_start:.2f} s")
        sk, sk_path, ek_path, key_ref_s = ensure_keys(prog, root, config,
                                                      log)
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
                      t_mark=t_import)
        ctx.mark("keys and blueprint loaded")
        tally = KINDS[traffic["kind"]](prog, ctx)
    t_end = time.time()
    log(f"timing: setup {ctx.setup_s:.1f} s (the reference's {ref_s:.2f} s "
        f"left out), window and traced span "
        f"{ctx.t_judge - t_start - ref_s - ctx.setup_s:.1f} s, judgement "
        f"{t_end - ctx.t_judge:.1f} s")
    log("footprint on the device (bytes): " + " ".join(
        f"{k}={v}" for k, v in (ctx.footprint or {}).items())
        + f" peak_reserved={ctx.memory_peak}")

    trace_obj = None
    if ctx.profiles and device != "cpu":
        trace_obj = Trace.from_profiler(ctx.profiles[0])
        ctx.profiles.clear()
    view = types.SimpleNamespace(
        config=config, traffic=traffic, circuit=circ,
        params=config["param_values"], peaks=man.peaks(),
        layer=man.layer, setup_s=ctx.setup_s,
        window=ctx.window, traced=ctx.traced, trace=trace_obj)
    metrics = {}
    for m in man.metrics(workload, trace):
        value = man.reader(m["name"])(view)
        if value is None and not trace:
            raise RuntimeError(f"{workload}: no reading of {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_rec = {"platform": "gpu" if device != "cpu" else "cpu",
                  "kind": (prog.torch.cuda.get_device_name(0)
                           if device != "cpu" else "cpu"),
                  "count": 1, "memory_peak_bytes": ctx.memory_peak}
    out = {"correct": None, "attempted": tally.attempted,
           "failed": tally.failed, "metrics": metrics, "device": device_rec}
    if trace_obj is not None:
        device_rec["busy_s"] = trace_obj.busy_s
        device_rec["window_s"] = trace_obj.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           trace_obj.by_name()[:10]],
                            "idle_gaps": [list(x) for x in
                                          trace_obj.idle_gaps()[:10]]}
        report_layers(man, trace_obj, ctx, log)
    numbers = tally.numbers()
    limits = config["limits"]
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
