"""The port's gate-batch mesh (iyokan_tpu_torch/parallel) against the JAX
package's on the CPU, case by case after tests/test_parallel.py.

The port's make_mesh(8) gives 8 shards of the one CPU device, where the JAX
tests use 8 virtual CPU devices (tests/conftest.py).  Results never depend
on the placement, so every run is held byte for byte against the JAX
package under its 8-device mesh and against the port with no mesh:

* placement: the port's batch_sharding decision equals JAX's for the
  shapes the JAX tests place (a big batch, a small one, a ragged one, a
  key-like array, tiny-2ram's 64-row refresh), at IYOKAN_SHARD_MIN_ROWS 8
  and 1; shard_batch runs fn once per shard on equal slices and nothing
  extra in a world of one shard;
* a level's gate bootstrap and key switch come back whole, and the tkey
  route's rotation runs one kernel call per shard, both equal to the
  unsharded run and to JAX's sharded blind_rotate (Pallas in interpret
  mode);
* the Frontend under make_mesh(8) at IYOKAN_FUSE_LEVELS = 1, 8 and all
  (scan chunk 2) on mac4 (the F1 adder's place: the integer model),
  tiny-ram, tiny-2ram (its 64-row refresh, exactly at the threshold,
  split 8 ways) and tiny-romram (its adder netlist made here: the
  blueprint names a reference fixture this repository lacks), also at
  IYOKAN_SHARD_MIN_ROWS=1, where the gate levels split too;
* __graft_entry__.dryrun_multichip's scenario on tiny-romram: one cycle,
  then whole-cycle fusion with a scan of chunk 2 over 3 cycles.
On the card (cuda-marked): the same runs under make_mesh(4) equal the
card's run with no mesh, and the tkey route launches K1 once per shard.
"""

import contextlib
import json
import os
import re

import numpy as np
import pytest
import torch

from iyokan_tpu import packet as jpacket
from iyokan_tpu.circuit.blueprint import Blueprint as JBlueprint
from iyokan_tpu.engine.driver import Frontend as JFrontend
from iyokan_tpu_torch.circuit.blueprint import Blueprint as TBlueprint
from iyokan_tpu_torch.engine.driver import Frontend as TFrontend
from iyokan_tpu_torch.ops import tkey as ttkey
from iyokan_tpu_torch.parallel import mesh as tmesh

from .test_torch_fusion import (_assert_same_packet, _env, _mac4_request,
                                _tiny_ram_request)

DATA = os.path.join(os.path.dirname(__file__), "data")

# the JAX engine as the port's tests run it: tkey slab, Pallas in
# interpret mode, no slab file
JAX_ENV = {"IYOKAN_BR_IMPL": "tkey", "IYOKAN_PALLAS_INTERPRET": "1",
           "IYOKAN_SLAB_CACHE": "0"}
MODES = {"fuse1": {"IYOKAN_FUSE_LEVELS": "1"},
         "fuse8": {"IYOKAN_FUSE_LEVELS": "8"},
         "all-chunk2": {"IYOKAN_FUSE_LEVELS": "all",
                        "IYOKAN_SCAN_CHUNK": "2"},
         "fuse1-minrows1": {"IYOKAN_FUSE_LEVELS": "1",
                            "IYOKAN_SHARD_MIN_ROWS": "1"}}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _port_mesh(n):
    tmesh.set_mesh(None if n is None else tmesh.make_mesh(n))
    try:
        yield
    finally:
        tmesh.set_mesh(None)


@contextlib.contextmanager
def _jax_mesh(n):
    from iyokan_tpu.parallel import mesh as jmesh

    jmesh.set_mesh(jmesh.make_mesh(n))
    try:
        yield
    finally:
        jmesh.set_mesh(None)


@pytest.fixture()
def splits(monkeypatch):
    """The row counts of every batch shard_batch split (the split path
    ends in _all_gather, the identity in a world of one process)."""
    seen = []
    real = tmesh._all_gather

    def rec(mesh, local, axis):
        seen.append(local.shape[axis])
        return real(mesh, local, axis)

    monkeypatch.setattr(tmesh, "_all_gather", rec)
    return seen


@pytest.fixture()
def tkey_calls(monkeypatch):
    """The row count of every call of the tkey rotation (one kernel
    launch each on the card)."""
    seen = []
    real = ttkey.blind_rotate_tkey

    def rec(t, *a, **k):
        seen.append(t.shape[0])
        return real(t, *a, **k)

    monkeypatch.setattr(ttkey, "blind_rotate_tkey", rec)
    return seen


# --------------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------------- #

SHAPES = {"big": (128, 636), "small": (16, 636), "ragged": (129, 636),
          "key-like": (64, 6, 2, 4, 32), "refresh-64": (64, 257)}


@pytest.mark.parametrize("min_rows", ["8", "1"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_batch_sharding_matches_jax(shape, min_rows):
    """The port's placement decision == JAX's batch_sharding, shape by
    shape (the same min-rows and even-divide rules)."""
    with _env(IYOKAN_SHARD_MIN_ROWS=min_rows):
        with _jax_mesh(8):
            from iyokan_tpu.parallel import mesh as jmesh

            want = tuple(jmesh.batch_sharding(SHAPES[shape]).spec)
        with _port_mesh(8):
            got = tmesh.batch_sharding(SHAPES[shape])
    assert got.spec == want
    assert got.mesh.size == 8 and got.mesh.axis == "gates"


def test_shard_batch_runs_each_shard(splits):
    """fn runs on 8 equal slices of a sharded batch and once on a
    replicated one; the result is fn of the whole either way; nested
    batches stay whole; no mesh and a one-shard mesh add nothing."""
    x = torch.arange(128 * 3, dtype=torch.int32).reshape(128, 3)
    rows = []

    def fn(t):
        rows.append(t.shape[0])
        assert tmesh.shard_batch(t, lambda u: u) is t     # nested: whole
        return t * 2 + 1

    with _port_mesh(8):
        assert torch.equal(tmesh.shard_batch(x, fn), x * 2 + 1)
        assert rows == [16] * 8 and splits == [128]
        rows.clear()
        assert torch.equal(tmesh.shard_batch(x[:120], fn),
                           x[:120] * 2 + 1)               # 120 = 8 x 15
        assert rows == [15] * 8
        rows.clear()
        for small in (x[:16], x[:127]):                   # too few, ragged
            assert torch.equal(tmesh.shard_batch(small, fn), small * 2 + 1)
        assert rows == [16, 127]
        k = torch.zeros((64, 6, 2, 4, 32), dtype=torch.int32)
        assert tmesh.replicated(k) is k
    out = torch.ones(3)
    for n in (None, 1):
        splits.clear()
        with _port_mesh(n):
            assert tmesh.shard_batch(x, lambda t: out) is out
        assert len(splits) == (0 if n is None else 1)


# --------------------------------------------------------------------------- #
# a level, and the tkey route, against JAX's sharded kernels
# --------------------------------------------------------------------------- #


def _jcall(fn, *args):
    import jax

    return np.asarray(jax.jit(fn)(*args))


def _toy_batch(toy_sk, G, seed):
    from iyokan_tpu.crypto import host as jhost

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, G, dtype=np.uint8)
    return jhost.encrypt_bits(toy_sk, bits, rng), bits


def test_level_output_comes_back_whole(toy_sk, toy_ek, tkey_calls):
    """One level's bootstrap + key switch under the mesh: 8 kernel calls
    of 8 rows, the whole [G, n+1] batch back, == the unsharded run ==
    JAX's level under its mesh."""
    import jax.numpy as jnp

    from iyokan_tpu.crypto import ops as jops
    from iyokan_tpu.parallel import mesh as jmesh
    from iyokan_tpu_torch.crypto import ops as tops

    p, G = toy_ek.params, 64
    pre, _ = _toy_batch(toy_sk, G, 5)
    with _env(**JAX_ENV):
        keys = tops.DeviceKeys.from_evalkey(toy_ek, "cpu", with_cb=False)

        def level(t):
            t1 = tops.gate_bootstrap_tlwe1(t, keys.bk_for(G), p)
            return tops.keyswitch_10(t1, keys.ksk_f64, p)

        want = tops.u32_numpy(level(tops.u32_tensor(pre, "cpu")))
        assert tkey_calls == [G]
        tkey_calls.clear()
        with _port_mesh(8):
            got = tops.u32_numpy(level(tops.u32_tensor(pre, "cpu")))
        assert tkey_calls == [8] * 8
        jkeys = jops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)

        def jlevel(keys, pre):
            batch = jmesh.shard_batch(pre)
            t1 = jops.gate_bootstrap_tlwe1(batch, keys.bk_for(G), p,
                                           keys.backend)
            return jmesh.replicated(jops.keyswitch_10(t1, keys.ksk_mat, p))

        with _jax_mesh(8):
            jgot = _jcall(jlevel, jkeys, jnp.asarray(pre))
    assert got.shape == (G, p.n + 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jgot)


def test_tkey_route_sharded_matches_jax(toy_sk, toy_ek, tkey_calls):
    """ops.blind_rotate on the tkey slab under the mesh: each shard's rows
    through the kernel against the one slab (64 rows = 8 a shard, the
    threshold), == unsharded == JAX's shard_map of its tkey kernel."""
    import jax.numpy as jnp

    from iyokan_tpu.crypto import ops as jops
    from iyokan_tpu.parallel import mesh as jmesh
    from iyokan_tpu_torch.crypto import ops as tops

    p, G = toy_ek.params, 64
    ct, _ = _toy_batch(toy_sk, G, 6)
    testv = np.full(p.N, p.mu, np.uint32)
    with _env(**JAX_ENV):
        dk = tops.DeviceKeys.from_evalkey(toy_ek, "cpu", with_cb=False)
        t_ct, t_tv = tops.u32_tensor(ct, "cpu"), tops.u32_tensor(testv, "cpu")
        want = tops.u32_numpy(tops.blind_rotate(t_ct, dk.bk_tk, t_tv, p))
        with _port_mesh(8):
            got = tops.u32_numpy(tops.blind_rotate(t_ct, dk.bk_tk, t_tv, p))
            assert tkey_calls == [G] + [8] * 8
            # 63 rows do not divide over 8 shards: one call
            tops.blind_rotate(t_ct[:63], dk.bk_tk, t_tv, p)
            assert tkey_calls[-1] == 63
        jkeys = jops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
        assert jkeys.bkntt.dtype == jnp.int8

        def rot(ct, bk, tv):
            return jops.blind_rotate(jmesh.shard_batch(ct), bk, tv, p)

        with _jax_mesh(8):
            jgot = _jcall(rot, jnp.asarray(ct), jkeys.bkntt,
                          jnp.asarray(testv))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jgot)


# --------------------------------------------------------------------------- #
# the Frontend under the mesh
# --------------------------------------------------------------------------- #


def _adder_netlist(width=4) -> dict:
    """A ripple-carry adder io_out = io_inA + io_inB mod 2^width in Yosys
    write_json form (the module tiny-romram.toml wires as "addr")."""
    nets = iter(range(2, 1 << 20))
    a = [next(nets) for _ in range(width)]
    b = [next(nets) for _ in range(width)]
    cells, out, carry = {}, [], None

    def cell(kind, **conn):
        y = next(nets)
        cells[f"${kind[2:-1].lower()}${len(cells)}"] = {
            "type": kind,
            "connections": {**{k: [v] for k, v in conn.items()}, "Y": [y]}}
        return y

    for i in range(width):
        t = cell("$_XOR_", A=a[i], B=b[i])
        if carry is None:
            out.append(t)
            carry = cell("$_AND_", A=a[i], B=b[i])
        else:
            out.append(cell("$_XOR_", A=t, B=carry))
            if i < width - 1:
                carry = cell("$_MUX_", A=a[i], B=carry, S=t)
    ports = {"io_inA": {"direction": "input", "bits": a},
             "io_inB": {"direction": "input", "bits": b},
             "io_out": {"direction": "output", "bits": out}}
    return {"creator": "tests/test_torch_parallel.py",
            "modules": {"addr": {"ports": ports, "cells": cells}}}


@pytest.fixture(scope="module")
def romram_bp(tmp_path_factory):
    """tests/data/tiny-romram.toml with its adder netlist made here."""
    d = tmp_path_factory.mktemp("romram")
    (d / "addr-4bit-yosys.json").write_text(json.dumps(_adder_netlist()))
    with open(os.path.join(DATA, "tiny-romram.toml")) as f:
        text, n = re.subn(r'path = "[^"]*/addr-4bit-yosys.json"',
                          'path = "addr-4bit-yosys.json"', f.read())
    assert n == 1
    (d / "tiny-romram.toml").write_text(text)
    return str(d / "tiny-romram.toml")


ROMBITS = (np.arange(64) % 3 == 1).astype(np.uint8)


def _romram_request():
    """__graft_entry__.dryrun_multichip's request: 3 + 5, ROM word 2, RAM
    word 2 written with the sum."""
    return jpacket.PlainPacket(
        ram={"ramA": np.zeros(16, np.uint8)}, rom={"rom": ROMBITS},
        bits={"A": np.array([1, 1, 0, 0], np.uint8),
              "B": np.array([1, 0, 1, 0], np.uint8),
              "romaddr": np.array([0, 1, 0], np.uint8),
              "addr": np.array([0, 1], np.uint8),
              "wren": np.array([1], np.uint8)})


def _tiny_2ram_request():
    """test_parallel.py's fused two-RAM write: 0b1011 to word 2 of both."""
    return jpacket.PlainPacket(
        ram={"ramA": np.zeros(32, np.uint8), "ramB": np.zeros(32, np.uint8)},
        bits={"addr": np.array([0, 1, 0], np.uint8),
              "wren": np.array([1], np.uint8),
              "wdata": np.array([1, 0, 1, 1], np.uint8),
              "addrB": np.array([0, 1, 0], np.uint8),
              "wrenB": np.array([1], np.uint8),
              "wdataB": np.array([1, 0, 1, 1], np.uint8)})


# name -> (blueprint, request, cycles, extra knobs)
CASES = {
    "mac4": ("mac4.toml", _mac4_request, 3, {}),
    "tiny-ram": ("tiny-ram.toml", _tiny_ram_request, 3,
                 {"IYOKAN_RAM_REFRESH_PERIOD": "2"}),
    # refreshes all 2 x 8 x 4 = 64 words
    "tiny-2ram": ("tiny-2ram.toml", _tiny_2ram_request, 1,
                  {"IYOKAN_RAM_REFRESH_PERIOD": "1"}),
    "tiny-romram": (None, _romram_request, 3, {}),
}
_REFS = {}


def _bp_path(name, romram_bp):
    bp = CASES[name][0]
    return romram_bp if bp is None else os.path.join(DATA, bp)


def _run(frontend, blueprint, name, sk, ek, romram_bp, env, cycles=None,
         **kw):
    """The result packet after each of `cycles` (default: the case's
    count), one Frontend going on from one to the next."""
    bp, req, n, extra = CASES[name]
    out, done = [], 0
    with _env(**JAX_ENV, **extra, **env):
        fe = frontend("tfhe", blueprint(_bp_path(name, romram_bp)),
                      req().encrypt(sk, seed=7), eval_key=ek, **kw)
        for c in cycles or (n,):
            fe.go(c - done)
            done = c
            out.append(fe.make_result_packet())
    return out


def _refs(name, sk, ek, romram_bp):
    """{cycles: (the JAX Frontend's packet under its 8-device mesh, the
    port's with no mesh)} after 1 cycle and after the case's count, both
    level by level, computed once per module."""
    if name not in _REFS:
        cycles = sorted({1, CASES[name][2]})
        with _jax_mesh(8):
            jax_refs = _run(JFrontend, JBlueprint, name, sk, ek, romram_bp,
                            MODES["fuse1"], cycles)
        port_refs = _run(TFrontend, TBlueprint, name, sk, ek, romram_bp,
                         MODES["fuse1"], cycles, device="cpu")
        _REFS[name] = dict(zip(cycles, zip(jax_refs, port_refs)))
    return _REFS[name]


def _word(bits):
    return sum(int(b) << k for k, b in enumerate(bits))


def _check_plain(name, dec):
    """The decrypted results the circuits' semantics give."""
    if name == "mac4":
        import sys

        sys.path.insert(0, DATA)
        import gen_mac

        req = _mac4_request()
        a = [_word(req.bits["a"][4 * c: 4 * c + 4]) for c in range(3)]
        b = [_word(req.bits["b"][4 * c: 4 * c + 4]) for c in range(3)]
        assert _word(dec.bits["acc"]) == gen_mac.expected(4, a, b, 3)
    elif name == "tiny-ram":
        np.testing.assert_array_equal(dec.ram["ramA"][8:12], [1, 1, 0, 1])
        np.testing.assert_array_equal(dec.ram["ramA"][4:8], [0, 1, 1, 0])
        np.testing.assert_array_equal(dec.bits["rdata"], [0, 1, 1, 0])
    elif name == "tiny-2ram":
        for ram in ("ramA", "ramB"):
            np.testing.assert_array_equal(dec.ram[ram][8:12], [1, 0, 1, 1])
    else:
        assert list(dec.bits["sum"]) == [0, 0, 0, 1]
        assert list(dec.ram["ramA"][8:12]) == [0, 0, 0, 1]
        assert list(dec.bits["romdata"]) == list(ROMBITS[16:24])


# batches each case must split under the mesh at the default min rows
MUST_SPLIT = {"tiny-2ram": 64}


def check_frontend_under_mesh(name, mode, sk, ek, romram_bp, splits):
    """The port's Frontend under make_mesh(8) == the JAX Frontend under its
    8-device mesh == the port with no mesh, byte for byte; decrypted ==
    the circuit's semantics; the batches that must split did."""
    jax_ref, port_ref = _refs(name, sk, ek, romram_bp)[CASES[name][2]]
    _assert_same_packet(port_ref, jax_ref)
    splits.clear()
    with _port_mesh(8):
        got, = _run(TFrontend, TBlueprint, name, sk, ek, romram_bp,
                    MODES[mode], device="cpu")
    _assert_same_packet(got, jax_ref)
    _check_plain(name, got.decrypt(sk))
    if name in MUST_SPLIT:
        assert MUST_SPLIT[name] in splits, splits
    if mode == "fuse1-minrows1":
        assert splits, "no batch was sharded"


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["mac4", "tiny-ram"])
def test_frontend_under_mesh_matches_jax(name, mode, toy_sk, toy_ek,
                                         romram_bp, splits):
    """mac4 (in the F1 adder's place: decrypted == the integer model) and
    tiny-ram (a write, then a read of it inside a scanned span of mixed
    refresh flags) under the mesh."""
    check_frontend_under_mesh(name, mode, toy_sk, toy_ek, romram_bp, splits)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels, CUDA graphs)")


@pytest.mark.cuda
def test_tkey_route_one_launch_per_shard_on_card(toy_sk, toy_ek):
    """On the card the tkey route under make_mesh(4) launches K1 once per
    shard and equals the unsharded launch and the CPU's twin."""
    _card()
    from iyokan_tpu_torch.crypto import ops as tops

    p, G = toy_ek.params, 64
    ct, _ = _toy_batch(toy_sk, G, 8)
    testv = np.full(p.N, p.mu, np.uint32)
    with _env(**JAX_ENV):
        outs = []
        for dev in ("cpu", "cuda"):
            dk = tops.DeviceKeys.from_evalkey(toy_ek, dev, with_cb=False)
            args = (tops.u32_tensor(ct, dev), dk.bk_tk,
                    tops.u32_tensor(testv, dev), p)
            outs.append(tops.u32_numpy(tops.blind_rotate(*args)))
        before = ttkey.LAUNCHES
        with _port_mesh(4):
            got = tops.u32_numpy(tops.blind_rotate(*args))
        assert ttkey.LAUNCHES - before == 4
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(got, outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fuse1", "fuse8", "all-chunk2"])
@pytest.mark.parametrize("name", ["mac4", "tiny-2ram"])
def test_frontend_under_mesh_on_card(name, mode, toy_sk, toy_ek, romram_bp):
    """make_mesh(4) on the card, in each execution mode (the shards are
    captured like any other launches) == the card with no mesh == the
    CPU."""
    _card()
    want, = _run(TFrontend, TBlueprint, name, toy_sk, toy_ek, romram_bp,
                 MODES["fuse1"], device="cuda")
    cpu, = _run(TFrontend, TBlueprint, name, toy_sk, toy_ek, romram_bp,
                MODES["fuse1"], device="cpu")
    _assert_same_packet(want, cpu)
    with _port_mesh(4):
        got, = _run(TFrontend, TBlueprint, name, toy_sk, toy_ek, romram_bp,
                    MODES[mode], device="cuda")
    _assert_same_packet(got, want)
