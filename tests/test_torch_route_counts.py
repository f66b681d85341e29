"""The port's gate-rotation counter, engine/tfhe.py:route_counts.

* On the CPU, at toy parameters: for MAC-2 (tests/data/mac2.toml) and
  tiny-ram (tests/data/tiny-ram.toml, with and without the full refresh),
  the counter's rows per stage add up to the cycle's level rows
  (nb + 2 nm a level), RAM-write rows (2W) and refresh rows (every RAM bit,
  or the W written ones); its routes are the ones gate_route gives the key
  bk_for picks for each row's JAX chunk; and it equals the rows and
  blind_rotate calls one eager sweep and RAM write make, route by route.
  Cases: the port's rule (every rotation on K3) and IYOKAN_BR_IMPL=tkey
  (the JAX package's table: every rotation on K1).
* On the card (cuda-marked): a default MAC-16 cycle's group graphs hold
  br_cluster_kernel nodes (K3) and none of K1's (tkey_loop_kernel,
  conv_kernel, conv_wgmma_kernel), read from a profiled replay.
"""

import os

import numpy as np
import pytest
import torch

from iyokan_tpu_torch import packet as tpacket
from iyokan_tpu_torch.circuit.blueprint import Blueprint
from iyokan_tpu_torch.crypto import ops
from iyokan_tpu_torch.engine import tfhe
from iyokan_tpu_torch.engine.driver import Frontend

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _frontend(name, sk, ek, device="cpu"):
    """A Frontend on the blueprint, every input 0."""
    req = tpacket.PlainPacket(bits={}).encrypt(sk, seed=5)
    return Frontend("tfhe", Blueprint(os.path.join(DATA, f"{name}.toml")),
                    req, eval_key=ek, device=device)


def _recorder(monkeypatch):
    """ops.blind_rotate wrapped to tally each call's route, rows and
    calls."""
    tally = {}
    real = ops.blind_rotate

    def rec(tlwe0, bk, testv, p):
        c = tally.setdefault(ops.gate_route(bk, p),
                             {"rows": 0, "rotations": 0})
        c["rows"] += tlwe0.shape[0]
        c["rotations"] += 1
        return real(tlwe0, bk, testv, p)

    monkeypatch.setattr(ops, "blind_rotate", rec)
    return tally


def _by_route(counts):
    out = {}
    for stage in counts.values():
        for route, c in stage.items():
            o = out.setdefault(route, {"rows": 0, "rotations": 0})
            o["rows"] += c["rows"]
            o["rotations"] += c["rotations"]
    return out


def _expected(engine, refresh):
    """{stage: {route: rows}} from the compiled levels and RAMs: each row
    on the route of the key bk_for gives its JAX chunk."""
    keys, p = engine.keys, engine.p
    cap = int(os.environ.get("IYOKAN_BOOT_CHUNK", "2048"))
    out = {}

    def add(stage, route, rows):
        st = out.setdefault(stage, {})
        st[route] = st.get(route, 0) + rows

    for plan in engine.c.levels:
        nb, nm = len(plan.bin_out), len(plan.mux_out)
        for s in tfhe.jax_chunk_sizes(nb, nm, cap):
            add("levels", ops.gate_route(keys.bk_for(int(s)), p), 1)
    rams = engine.d.ram_insts.values()
    if rams:
        W = sum(r.data_width for r in rams)
        n = sum((1 << r.addr_width) * r.data_width for r in rams) \
            if refresh else W
        add("ram_write", ops.gate_route(keys.bk_for(2 * W), p), 2 * W)
        add("refresh", ops.gate_route(keys.bk_for(n), p), n)
    return out


CASES = [("mac2", None, True), ("tiny-ram", None, True),
         ("tiny-ram", None, False), ("mac2", "tkey", True),
         ("tiny-ram", "tkey", False)]


@pytest.mark.parametrize("name,rule,refresh", CASES,
                         ids=[f"{n}-{r}-refresh{int(f)}" for n, r, f in CASES])
def test_route_counts_match_a_cycle(toy_sk, toy_ek, monkeypatch, name, rule,
                                    refresh):
    """rule: None = the port's rule, "tkey" = IYOKAN_BR_IMPL=tkey."""
    for k in ops.PREP_KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", "0")
    monkeypatch.setenv("IYOKAN_FUSE_LEVELS", "1")
    monkeypatch.delenv("IYOKAN_BOOT_CHUNK", raising=False)
    if rule == "tkey":
        monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    ops.clear_device_key_cache()
    try:
        fe = _frontend(name, toy_sk, toy_ek)
    finally:
        ops.clear_device_key_cache()
    eng = fe.engine
    counts = tfhe.route_counts(eng, refresh=refresh)

    # rows per stage and route == the compiled circuit's, routed by bk_for
    want = _expected(eng, refresh)
    assert {s: {r: c["rows"] for r, c in st.items()}
            for s, st in counts.items()} == want
    rows = sum(len(pl.bin_out) + 2 * len(pl.mux_out) for pl in eng.c.levels)
    assert sum(want.get("levels", {}).values()) == rows
    if name == "tiny-ram":     # one 4 x 4-bit RAM; its levels only copy
        assert rows == 0 and set(counts) == {"ram_write", "refresh"}
        assert sum(want["ram_write"].values()) == 2 * 4
        assert sum(want["refresh"].values()) == (4 * 4 if refresh else 4)
    else:
        assert rows > 0 and set(counts) == {"levels"}
    routes = set(_by_route(counts))
    if rule is None:
        assert routes == {"v3-unrolled"} and eng.keys.bk_tk is None
    else:
        assert routes == {"tkey"}

    # == the calls one eager sweep and RAM write make
    tally = _recorder(monkeypatch)
    eng.settle(fe.vals, fe.rams, fe.roms, ram_refresh=refresh)
    assert tally == _by_route(counts)


@pytest.mark.cuda
def test_default_mac16_cycle_graph_runs_k3(toy_sk, toy_ek, monkeypatch):
    """A default MAC-16 cycle's graphs (its level groups at FUSE=8) on the
    card: their replays launch br_cluster_kernel and none of K1's
    kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs, CUDA kernels)")
    for k in ops.PREP_KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("IYOKAN_FUSE_LEVELS", raising=False)
    fe = _frontend("mac16", toy_sk, toy_ek, device="cuda")
    assert fe.engine.keys.port_routing and fe.engine.keys.bk_tk is None
    fe.go(2)                            # captures the group graphs
    groups = [g for g in fe.engine.graph_stats()
              if g["name"].startswith("level group")]
    assert groups and sum(g["kernels"].get("br3.LAUNCHES", 0)
                          for g in groups) > 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fe.go(1)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert any("br_cluster_kernel" in n for n in names), sorted(names)
    for k1 in ("tkey_loop_kernel", "conv_kernel", "conv_wgmma_kernel",
               "digits_kernel"):
        assert not any(k1 in n for n in names), (k1, sorted(names))


def test_route_sweep_crossover():
    """The largest size up to which K3 was faster at every size measured,
    whatever order the rows come in; 0 where K1 wins at the smallest."""
    from iyokan_tpu_torch.tools import route_sweep

    def rows(*cases):
        return [{"G": g, "ms": {"tkey": t, "v3-unrolled": k}}
                for g, t, k in cases]

    assert route_sweep.crossover(rows((64, 5, 4), (1, 2, 1), (256, 3, 4),
                                      (2048, 9, 1))) == 64
    assert route_sweep.crossover(rows((1, 2, 1), (2048, 9, 1))) == 2048
    assert route_sweep.crossover(rows((1, 1, 2), (16, 9, 1))) == 0


def test_route_sweep_runs_on_cpu(monkeypatch, tmp_path):
    """tools/route_sweep.py at toy parameters on the CPU (the twins, host
    clock): both routes at each size, 0 wrong NANDs, the record written."""
    import json

    from iyokan_tpu_torch.tools import route_sweep

    monkeypatch.setenv("IYOKAN_TORCH_DEVICE", "cpu")
    out = tmp_path / "sweep.json"
    rec = route_sweep.main(["--sizes", "1,3", "--reps", "1", "--params",
                            "toy", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert [r["G"] for r in rec["rows"]] == [1, 3]
    assert rec["timing"] == "eager, host clock"
    for r in rec["rows"]:
        assert set(r["ms"]) == set(route_sweep.ROUTES)
        assert all(len(t) == 2 for t in r["turns"].values())
        assert all(c["wrong"] == 0 for c in r["check"].values())
    assert rec["crossover"] == route_sweep.crossover(rec["rows"])
