"""The port's stage spans (iyokan_tpu_torch/engine/spans.py) on the CPU.

* With no profiler recording, a Frontend's build, run and result packet
  enter no torch.profiler.record_function of their own (counted by a
  patched one, which counts the spans of a profiled run; the test's
  on_cycle opens one of its own either way).
* Under torch.profiler (CPU activity), tests/data/tiny-ram.toml (a CMUX
  RAM, no @reset) records the build, each cycle and its inputs, the memory
  stages, the RAM write and the result packet; every memory stage and RAM
  write lies inside a cycle span, and every cycle span ends before that
  cycle's on_cycle starts.  tests/data/mac4.toml (gates, @reset) records
  the reset settle and the gate groups.
* Profiled or not, the result packets are byte for byte the same.
* On the card (cuda-marked): one graph.capture span per captured graph.
"""

import os

import numpy as np
import pytest
import torch

from iyokan_tpu_torch import packet, params
from iyokan_tpu_torch.circuit.blueprint import Blueprint
from iyokan_tpu_torch.crypto import host
from iyokan_tpu_torch.engine.driver import Frontend

DATA = os.path.join(os.path.dirname(__file__), "data")
ON_CYCLE = "test.on_cycle"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tiny_ram_request():
    """Cycle 0 writes 0b1011 to address 2, cycle 1 reads it back."""
    return packet.PlainPacket(bits={
        "addr": np.array([0, 1, 0, 1], np.uint8),
        "wren": np.array([1, 0], np.uint8),
        "wdata": np.array([1, 1, 0, 1, 0, 0, 0, 0], np.uint8)})


def _mac4_request():
    rng = np.random.default_rng(61)
    return packet.PlainPacket(bits={
        "a": rng.integers(0, 2, 8).astype(np.uint8),
        "b": rng.integers(0, 2, 8).astype(np.uint8)})


# name -> (blueprint, request, cycles)
CASES = {"tiny-ram": ("tiny-ram.toml", _tiny_ram_request, 2),
         "mac4": ("mac4.toml", _mac4_request, 2)}


def _run(name, sk, ek, device="cpu"):
    """Build a Frontend, run it, make its result packet; on_cycle opens a
    range of its own, so its start is on the profiler's clock too."""
    bp, request, cycles = CASES[name]
    fe = Frontend("tfhe", Blueprint(os.path.join(DATA, bp)),
                  request().encrypt(sk, seed=7), eval_key=ek, device=device)

    def on_cycle(f):
        with torch.profiler.record_function(ON_CYCLE):
            pass

    fe.go(cycles, on_cycle=on_cycle)
    return fe, fe.make_result_packet()


def _events(prof):
    """[(name, start ns, end ns)] of the spans and on_cycle ranges."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(("iyokan.", ON_CYCLE)):
            out.append((ev.name(), ev.start_ns(),
                        ev.start_ns() + ev.duration_ns()))
    return sorted(out, key=lambda e: e[1])


@pytest.fixture(scope="module")
def runs():
    """Per case: the packet and record_function calls of a run with no
    profiler, then the packet, calls and spans of a profiled run (the
    program's knobs at their defaults, no slab file)."""
    sk = host.keygen(params.TOY, seed=42)
    ek = host.genevalkey(sk, seed=43)
    calls = []
    real = torch.profiler.record_function

    def counting(*args, **kw):
        calls.append(args[0])
        return real(*args, **kw)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k in ("IYOKAN_FUSE_LEVELS", "IYOKAN_PROFILE",
                  "IYOKAN_RAM_REFRESH_PERIOD", "IYOKAN_BR_IMPL"):
            mp.delenv(k, raising=False)
        mp.setenv("IYOKAN_SLAB_CACHE", "0")
        mp.setattr(torch.profiler, "record_function", counting)
        for name in CASES:
            del calls[:]
            _, plain = _run(name, sk, ek)
            quiet = list(calls)
            del calls[:]
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                _, traced = _run(name, sk, ek)
            out[name] = {"plain": plain, "quiet_calls": quiet,
                         "traced": traced, "traced_calls": list(calls),
                         "events": _events(prof)}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_no_record_function_without_profiler(runs, name):
    assert set(runs[name]["quiet_calls"]) == {ON_CYCLE}
    # the patched function is the one the spans call
    assert "iyokan.cycle" in runs[name]["traced_calls"]


@pytest.mark.parametrize("name", list(CASES))
def test_packets_identical_under_profiler(runs, name):
    a, b = runs[name]["plain"], runs[name]["traced"]
    assert (a.params, a.num_cycles) == (b.params, b.num_cycles)
    for field in packet.TFHEPacket._FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        assert sorted(x) == sorted(y), field
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert x[k].tobytes() == y[k].tobytes(), (field, k)


def test_tiny_ram_spans(runs):
    ev = runs["tiny-ram"]["events"]
    names = {n for n, _, _ in ev}
    assert {"iyokan.frontend.build", "iyokan.cycle", "iyokan.inputs",
            "iyokan.mem.cb", "iyokan.mem.ram_read", "iyokan.ram_write",
            "iyokan.result_packet"} <= names
    assert "iyokan.reset" not in names
    cycles = [(s, e) for n, s, e in ev if n == "iyokan.cycle"]
    hooks = [s for n, s, _ in ev if n == ON_CYCLE]
    assert len(cycles) == len(hooks) == CASES["tiny-ram"][2]
    for (s, e), hook in zip(cycles, hooks):
        assert s < e <= hook
    inner = [(n, s, e) for n, s, e in ev
             if n.startswith("iyokan.mem.") or n == "iyokan.ram_write"]
    assert len(inner) >= 3 * len(cycles)
    for n, s, e in inner:
        assert any(cs <= s and e <= ce for cs, ce in cycles), n


def test_mac4_spans(runs):
    ev = runs["mac4"]["events"]
    names = [n for n, _, _ in ev]
    assert {"iyokan.frontend.build", "iyokan.reset", "iyokan.gates",
            "iyokan.cycle", "iyokan.result_packet"} <= set(names)
    assert not any(n.startswith("iyokan.mem.") for n in names)
    # the reset settle comes before the first cycle and holds gate groups
    (rs, re_), = [(s, e) for n, s, e in ev if n == "iyokan.reset"]
    first = min(s for n, s, _ in ev if n == "iyokan.cycle")
    assert re_ <= first
    assert any(n == "iyokan.gates" and rs <= s and e <= re_
               for n, s, e in ev)


@pytest.mark.cuda
def test_graph_capture_spans_on_card():
    """One graph.capture span per graph the engine captured (FUSE=8: the
    level groups of the reset settle and the cycles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs, CUDA kernels)")
    sk = host.keygen(params.TOY, seed=42)
    ek = host.genevalkey(sk, seed=43)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("IYOKAN_FUSE_LEVELS", raising=False)
        mp.setenv("IYOKAN_SLAB_CACHE", "0")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fe, _ = _run("mac4", sk, ek, device="cuda")
    captures = [n for n, _, _ in _events(prof)
                if n == "iyokan.graph.capture"]
    assert captures and len(captures) == len(fe.engine.graph_stats())
