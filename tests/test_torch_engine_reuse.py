"""TFHE engines kept across Frontends (engine/tfhe.py: lease_engine).

* Three requests through successive Frontends, each deleted before the
  next, share one engine and give the result packets of fresh engines
  bit for bit (clear_engine_cache() before each fresh one), which decrypt
  to the plain Frontend's: MAC-2 (gates, @reset) and a toy memmac (MAC-2
  between a CMUX ROM and a CMUX RAM at refresh period 2: the reset, ROM
  and RAM reads, the RAM write and a refresh cycle), each request with
  its own ROM, RAM image and input streams.  The Frontend logs the counts.
* Two Frontends alive at once get distinct engines and the right packets;
  released, both wait idle, and the next Frontend takes the one released
  last.
* The cache misses on another eval key, circuit, IYOKAN_* setting or mesh
  and hits on the same ones; engine_reuse_counts() counts each build and
  take-over; at most IDLE_ENGINES wait, the least recently released
  evicted first; an engine whose capture or replay failed is not kept.
* On the card (cuda-marked): after the first request has captured every
  graph, requests 2 and 3 capture none (no graph.capture span, the same
  graphs, their replays rising) and equal fresh engines.
"""

import logging
import os

import numpy as np
import pytest
import torch

from iyokan_tpu_torch import packet, params
from iyokan_tpu_torch.circuit.blueprint import Blueprint
from iyokan_tpu_torch.crypto import host, ops
from iyokan_tpu_torch.engine import tfhe
from iyokan_tpu_torch.engine.driver import Frontend
from iyokan_tpu_torch.parallel import mesh

DATA = os.path.join(os.path.dirname(__file__), "data")

# memmac's shape at toy size: MAC-2 reads its operands from a CMUX ROM,
# and its accumulator is written to a CMUX RAM
TOY_MEMMAC = f"""
[[file]]
type = "yosys-json"
path = "{os.path.join(DATA, 'mac2-yosys.json')}"
name = "mac"

[[builtin]]
type = "rom"
name = "rom"
in_addr_width = 2
out_rdata_width = 4

[[builtin]]
type = "ram"
name = "ramA"
in_addr_width = 2
in_wdata_width = 4
out_rdata_width = 4

[connect]
"mac/reset" = "@reset"
"rom/addr[0:1]" = "@romaddr[0:1]"
"mac/a[0:1]" = "rom/rdata[0:1]"
"mac/b[0:1]" = "rom/rdata[2:3]"
"ramA/addr[0:1]" = "@addr[0:1]"
"ramA/wren" = "@wren"
"ramA/wdata[0:3]" = "mac/acc[0:3]"
"@rdata[0:3]" = "ramA/rdata[0:3]"
"@acc[0:3]" = "mac/acc[0:3]"
"""
CYCLES = 3          # at refresh period 2, cycle 1 refreshes the whole RAM
REQUESTS = 3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    """The tkey route (the quickest twin on the CPU), no slab file, RAM
    refresh period 2; the cache emptied before and after."""
    for k in (*ops.PREP_KNOBS, "IYOKAN_FUSE_LEVELS", "IYOKAN_BOOT_CHUNK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", "0")
    monkeypatch.setenv("IYOKAN_RAM_REFRESH_PERIOD", "2")
    tfhe.clear_engine_cache()
    yield
    tfhe.clear_engine_cache()


@pytest.fixture(scope="module")
def sk():
    return host.keygen(params.TOY, seed=42)


@pytest.fixture(scope="module")
def ek(sk):
    return host.genevalkey(sk, seed=43)


@pytest.fixture(scope="module")
def blueprints(tmp_path_factory):
    path = tmp_path_factory.mktemp("bp") / "toy-memmac.toml"
    path.write_text(TOY_MEMMAC)
    return {"mac2": os.path.join(DATA, "mac2.toml"), "memmac": str(path)}


def _plain_request(name, i):
    """Request i of a circuit: its own operands, and for memmac its own
    ROM, RAM image and addresses (cycle 0 writes, cycle 2 reads cycle 1's
    address back)."""
    rng = np.random.default_rng(100 + i)
    bits = lambda n: rng.integers(0, 2, n).astype(np.uint8)  # noqa: E731
    if name == "mac2":
        return packet.PlainPacket(bits={"a": bits(2 * CYCLES),
                                        "b": bits(2 * CYCLES)})
    addr = rng.permutation(4)[:2]
    return packet.PlainPacket(
        rom={"rom": bits(16)}, ram={"ramA": bits(16)},
        bits={"romaddr": bits(2 * CYCLES),
              "addr": np.array([(addr[c % 2] >> b) & 1 for c in (0, 1, 1)
                                for b in range(2)], np.uint8),
              "wren": np.array([1, 1, 0], np.uint8)})


def _frontend(bp, req, ek, device="cpu"):
    return Frontend("tfhe", Blueprint(bp), req, eval_key=ek, device=device)


def _request(bp, req, ek, device="cpu"):
    """One request: a Frontend, CYCLES cycles, its result packet; returns
    (packet, id of the engine), the Frontend gone."""
    fe = _frontend(bp, req, ek, device)
    fe.go(CYCLES)
    res, eid = fe.make_result_packet(), id(fe.engine)
    del fe
    return res, eid


def _assert_same_packet(a, b):
    assert set(a.bits) == set(b.bits) and set(a.ram) == set(b.ram)
    for k in a.bits:
        np.testing.assert_array_equal(a.bits[k], b.bits[k])
    for k in a.ram:
        np.testing.assert_array_equal(a.ram[k], b.ram[k])


_FRESH = {}


def _fresh(name, i, bp, sk, ek):
    """Request i's packet from a fresh engine (computed once a module)."""
    if (name, i) not in _FRESH:
        tfhe.clear_engine_cache()
        _FRESH[name, i] = _request(bp, _plain_request(name, i).encrypt(
            sk, seed=i), ek)[0]
        tfhe.clear_engine_cache()
    return _FRESH[name, i]


@pytest.mark.parametrize("name", ["mac2", "memmac"])
def test_successive_requests_share_one_engine_bit_for_bit(
        sk, ek, blueprints, caplog, name):
    bp = blueprints[name]
    before = tfhe.engine_reuse_counts()
    got, engines = [], set()
    with caplog.at_level(logging.INFO, logger="iyokan"):
        for i in range(REQUESTS):
            res, eid = _request(bp, _plain_request(name, i).encrypt(
                sk, seed=i), ek)
            got.append(res)
            engines.add(eid)
    after = tfhe.engine_reuse_counts()
    assert len(engines) == 1
    assert after["built"] - before["built"] == 1
    assert after["reused"] - before["reused"] == REQUESTS - 1
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("TFHE engines in this process")]
    assert len(lines) == REQUESTS and lines[-1] == (
        f"TFHE engines in this process: {after['built']} built, "
        f"{after['reused']} taken over from an earlier Frontend")
    for i, res in enumerate(got):
        _assert_same_packet(res, _fresh(name, i, bp, sk, ek))
        plain_fe = Frontend("plain", Blueprint(bp), _plain_request(name, i),
                            device="cpu")
        plain_fe.go(CYCLES)
        plain = plain_fe.make_result_packet()
        dec = res.decrypt(sk)
        for k in plain.bits:
            np.testing.assert_array_equal(dec.bits[k], plain.bits[k])
        for k in plain.ram:
            np.testing.assert_array_equal(dec.ram[k], plain.ram[k])


def test_live_frontends_get_distinct_engines(sk, ek, blueprints):
    bp = blueprints["mac2"]
    fes = [_frontend(bp, _plain_request("mac2", i).encrypt(sk, seed=i), ek)
           for i in range(2)]
    assert fes[0].engine is not fes[1].engine
    for fe in fes:
        fe.go(CYCLES)
    for i, fe in enumerate(fes):
        _assert_same_packet(fe.make_result_packet(),
                            _fresh("mac2", i, bp, sk, ek))
    del fe
    fes.pop(1)
    last = fes.pop(0).engine
    assert len(tfhe._IDLE) == 2
    again = _frontend(bp, _plain_request("mac2", 0).encrypt(sk, seed=0), ek)
    assert again.engine is last


def _other_key(sk):
    return host.genevalkey(sk, seed=44, with_cb=False)


# what changes between the released engine's Frontend and the next one
CHANGES = {
    "same": None,
    "eval_key": "key",
    "circuit": "circuit",
    "IYOKAN_FUSE_LEVELS": ("IYOKAN_FUSE_LEVELS", "1"),
    "IYOKAN_BOOT_CHUNK": ("IYOKAN_BOOT_CHUNK", "16"),
    "mesh": "mesh",
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_cache_hits_only_the_same_circuit_key_settings_and_mesh(
        sk, ek, blueprints, monkeypatch, change):
    what = CHANGES[change]
    bp, req = blueprints["mac2"], _plain_request("mac2", 0).encrypt(sk,
                                                                     seed=0)
    fe = _frontend(bp, req, ek)
    first = fe.engine
    del fe
    assert list(tfhe._IDLE) == [first]
    before = tfhe.engine_reuse_counts()
    key = ek
    if what == "key":
        key = _other_key(sk)
    elif what == "circuit":
        bp = os.path.join(DATA, "mac4.toml")
    elif isinstance(what, tuple):
        monkeypatch.setenv(*what)
    elif what == "mesh":
        mesh.set_mesh(mesh.make_mesh(2))
    try:
        fe = _frontend(bp, req, key)
    finally:
        mesh.set_mesh(None)
    after = tfhe.engine_reuse_counts()
    if what is None:
        assert fe.engine is first and not tfhe._IDLE
        assert (after["built"], after["reused"]) == (
            before["built"], before["reused"] + 1)
    else:
        assert fe.engine is not first and list(tfhe._IDLE) == [
            first]
        assert (after["built"], after["reused"]) == (
            before["built"] + 1, before["reused"])


def test_idle_engines_bounded_least_recently_released_first(sk, ek,
                                                            blueprints,
                                                            monkeypatch):
    """Three engines of three IYOKAN_BOOT_CHUNK values released in turn:
    the first is evicted, the other two are taken over; an engine marked
    failed is not kept."""
    bp, req = blueprints["mac2"], _plain_request("mac2", 0).encrypt(sk,
                                                                     seed=0)
    chunks = ["16", "32", "64"]
    released = []
    for c in chunks:
        monkeypatch.setenv("IYOKAN_BOOT_CHUNK", c)
        fe = _frontend(bp, req, ek)
        released.append(fe.engine)
        del fe
    assert tfhe.IDLE_ENGINES == 2
    assert list(tfhe._IDLE) == released[1:]
    fes = []
    for c in reversed(chunks):
        monkeypatch.setenv("IYOKAN_BOOT_CHUNK", c)
        fes.append(_frontend(bp, req, ek))
    assert fes[0].engine is released[2] and fes[1].engine is released[1]
    assert fes[2].engine not in released and not tfhe._IDLE
    fes[0].engine._failed = True
    fes.clear()
    assert len(tfhe._IDLE) == 2 and released[2] not in tfhe._IDLE


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mac2", "memmac"])
def test_later_requests_capture_no_graph_on_card(sk, ek, blueprints,
                                                 monkeypatch, name):
    """At the port's defaults (no PREP_KNOBS, FUSE=8): request 1 captures
    every graph (at refresh period 2 its cycles use both RAM writes
    twice); requests 2 and 3 replay them on the same engine with no
    graph.capture span, and each packet equals a fresh engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs, CUDA kernels)")
    monkeypatch.delenv("IYOKAN_BR_IMPL")
    bp = blueprints[name]
    reqs = [_plain_request(name, i).encrypt(sk, seed=i)
            for i in range(REQUESTS)]
    want = []
    for req in reqs:
        tfhe.clear_engine_cache()
        want.append(_request(bp, req, ek, "cuda")[0])
    tfhe.clear_engine_cache()
    fe = _frontend(bp, reqs[0], ek, "cuda")
    fe.go(CYCLES)
    _assert_same_packet(fe.make_result_packet(), want[0])
    eng = fe.engine
    del fe
    stats = eng.graph_stats()
    assert stats
    for i in (1, 2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fe = _frontend(bp, reqs[i], ek, "cuda")
            fe.go(CYCLES)
            res = fe.make_result_packet()
        assert fe.engine is eng
        del fe
        names = {ev.name() for ev in prof.profiler.kineto_results.events()}
        assert "iyokan.gates" in names and "iyokan.graph.capture" not in names
        now = eng.graph_stats()
        assert [g["name"] for g in now] == [g["name"] for g in stats]
        assert all(b["replays"] > a["replays"] for a, b in zip(stats, now))
        stats = now
        _assert_same_packet(res, want[i])
