"""The torch port's CMUX memories against the JAX package, bit for bit.

* Circuit bootstrapping at toy parameters: blind_rotate2 (plain and 2-bit
  unrolled keys), privks and circuit_bootstrap on the same numpy inputs
  give the JAX package's u64 / u32 words exactly.
* The engine on tests/data/tiny-rom.toml, tiny-ram.toml and tiny-2ram.toml
  in tfhe mode: the port's Frontend and the JAX Frontend (tkey slab,
  Pallas in interpret mode, one dispatch per level) give identical result
  ciphertexts and RAM stores, at refresh periods 1 and 3 too, and they
  decrypt to the plain engine's values.
* Snapshot/resume of a RAM design through the port's CLI equals a
  straight run, ciphertexts and RAM stores included.
* tests/data/memmac.toml (MAC-4 between a 128 x 32 ROM and two 256 x 8
  RAMs) in the port's plain mode equals the Python-integer model; its
  encrypted run (4096-row write trees) is chip_smoke.py's memory phase.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iyokan_tpu import packet as jpacket
from iyokan_tpu import params as jparams
from iyokan_tpu.circuit.blueprint import Blueprint as JBlueprint
from iyokan_tpu.crypto import host as jhost
from iyokan_tpu.crypto import ops as jops
from iyokan_tpu.crypto import polymul as jpm
from iyokan_tpu.engine.driver import Frontend as JFrontend
from iyokan_tpu_torch import packet as tpacket
from iyokan_tpu_torch import params as tparams
from iyokan_tpu_torch.circuit.blueprint import Blueprint as TBlueprint
from iyokan_tpu_torch.cli import iyokan_cli as t_iyokan_cli
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.crypto import polymul as tpm
from iyokan_tpu_torch.engine.driver import Frontend as TFrontend

DATA = os.path.join(os.path.dirname(__file__), "data")
sys.path.insert(0, DATA)
import gen_mac  # noqa: E402

TP = tparams.TOY
JP = jparams.TOY
CRT64 = jpm.CRT64Backend()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def jax_tkey_env(monkeypatch):
    """The JAX engine on its TPU default route (tkey slab) in interpret
    mode, one dispatch per level."""
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    monkeypatch.setenv("IYOKAN_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("IYOKAN_FUSE_LEVELS", "1")
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", "0")


def _t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def _u64(t):
    return t.numpy().view(np.uint64)


def _u32(t):
    return t.numpy().view(np.uint32)


def jcall(fn, *args):
    """fn(*args) of the JAX package, jitted whole (far quicker to compile
    on the CPU than op by op), as numpy."""
    return np.asarray(jax.jit(fn)(*args))


# --------------------------------------------------------------------------- #
# circuit bootstrapping
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("unrolled", [False, True], ids=["bk2", "bk2u"])
def test_blind_rotate2_matches_jax(toy_sk, toy_ek, unrolled):
    rng = np.random.default_rng(5)
    ct = jhost.encrypt_bits(toy_sk, rng.integers(0, 2, 3, dtype=np.uint8),
                            rng)
    if unrolled:
        rows = toy_ek.bk2u.reshape(toy_ek.bk2u.shape[0], 6 * JP.l2, 2, JP.N2)
    else:
        rows = toy_ek.bk2
    testv = rng.integers(0, 1 << 64, (3, JP.N2), dtype=np.uint64)
    want = jcall(
        lambda t, r, tv: jops.blind_rotate2(t, CRT64.prep2(r, JP), tv, JP,
                                            CRT64),
        jnp.asarray(ct), jnp.asarray(rows, jnp.uint64),
        jnp.asarray(testv, jnp.uint64))
    got = tops.blind_rotate2(_t32(ct), tpm.prep2(_t64(rows), TP),
                             _t64(testv), TP)
    assert want.dtype == np.uint64
    np.testing.assert_array_equal(_u64(got), want)


def test_privks_matches_jax(toy_ek):
    rng = np.random.default_rng(6)
    tl2 = rng.integers(0, 1 << 64, (4, JP.N2 + 1), dtype=np.uint64)
    for part in (0, 1):
        mat = toy_ek.pksk[part].reshape(JP.N2 * JP.pks_t, 2 * JP.N)
        want = jcall(lambda t, m: jops.privks(t, m, part, JP),
                     jnp.asarray(tl2, jnp.uint64), jnp.asarray(mat))
        for key in (_t32(mat), _t32(mat).to(torch.float64)):
            got = tops.privks(_t64(tl2), key, part, TP)
            np.testing.assert_array_equal(_u32(got), want)


def test_circuit_bootstrap_matches_jax(toy_sk, toy_ek, toy_dk):
    rng = np.random.default_rng(7)
    bits = np.array([0, 1, 1, 0, 1], np.uint8)
    ct = jhost.encrypt_bits(toy_sk, bits, rng)
    want = jcall(lambda t, bk2, pk: jops.circuit_bootstrap(
        t, bk2, pk, JP, toy_dk.backend), jnp.asarray(ct), toy_dk.bk2_for(),
        toy_dk.pksk_mats)
    dk = tops.DeviceKeys.from_evalkey(toy_ek, "cpu")
    assert dk.bk2.shape[1] == 6 * TP.l2          # the unrolled key
    got = tops.circuit_bootstrap(_t32(ct), dk.bk2, dk.pksk_f64, TP)
    np.testing.assert_array_equal(_u32(got), want)
    # the TRGSW rows encrypt m * gadget: the b-part rows' phases decode
    ph = jhost.trlwe1_phase(toy_sk, _u32(got)[:, TP.l:])   # [G, l, N]
    g1 = 1 << (32 - TP.Bgbit)
    dec = ((ph[:, 0, 0].astype(np.int64) + g1 // 2) // g1) & 1
    np.testing.assert_array_equal(dec, bits)


# --------------------------------------------------------------------------- #
# the engine against the JAX engine
# --------------------------------------------------------------------------- #


def _run_both(bp_name, req_plain, cycles, sk, ek):
    req = req_plain.encrypt(sk, seed=7)
    bp = os.path.join(DATA, bp_name)
    tfe = TFrontend("tfhe", TBlueprint(bp), req, eval_key=ek, device="cpu")
    tfe.go(cycles)
    jfe = JFrontend("tfhe", JBlueprint(bp), req, eval_key=ek)
    jfe.go(cycles)
    got, want = tfe.make_result_packet(), jfe.make_result_packet()
    assert sorted(got.bits) == sorted(want.bits)
    assert sorted(got.ram) == sorted(want.ram)
    for name in want.bits:
        np.testing.assert_array_equal(got.bits[name], want.bits[name])
    for name in want.ram:
        assert got.ram[name].dtype == np.uint32
        np.testing.assert_array_equal(got.ram[name], want.ram[name])
    plain = TFrontend("plain", TBlueprint(bp), req_plain, device="cpu")
    plain.go(cycles)
    dec = got.decrypt(sk)
    ref = plain.make_result_packet()
    for name in ref.bits:
        np.testing.assert_array_equal(dec.bits[name], ref.bits[name])
    for name in ref.ram:
        np.testing.assert_array_equal(dec.ram[name], ref.ram[name])
    return dec


def _ram_request(addr, wren, wdata, init=None, **extra):
    bits = {"addr": np.array(addr, np.uint8), "wren": np.array(wren, np.uint8),
            "wdata": np.array(wdata, np.uint8), **extra}
    return jpacket.PlainPacket(ram={} if init is None else {"ramA": init},
                               bits=bits)


def test_tiny_rom_matches_jax(toy_sk, toy_ek, jax_tkey_env):
    rom_bits = np.random.default_rng(3).integers(0, 2, 64, dtype=np.uint8)
    req = jpacket.PlainPacket(rom={"rom": rom_bits},
                              bits={"addr": np.array([1, 0, 1], np.uint8)})
    dec = _run_both("tiny-rom.toml", req, 1, toy_sk, toy_ek)
    np.testing.assert_array_equal(dec.bits["rdata"], rom_bits[40:48])


def test_tiny_ram_matches_jax(toy_sk, toy_ek, jax_tkey_env):
    """Write 0b1011 to address 2 on cycle 0, read address 3 (preloaded
    0xf) on cycle 1."""
    init = np.zeros(16, np.uint8)
    init[12:16] = 1
    req = _ram_request([0, 1, 1, 1], [1, 0], [1, 1, 0, 1, 0, 0, 0, 0], init)
    dec = _run_both("tiny-ram.toml", req, 2, toy_sk, toy_ek)
    np.testing.assert_array_equal(dec.bits["rdata"], [1, 1, 1, 1])
    np.testing.assert_array_equal(dec.ram["ramA"][8:12], [1, 1, 0, 1])


def test_tiny_2ram_matches_jax(toy_sk, toy_ek, jax_tkey_env):
    """Two RAMs share one write path (one MUXwoSE batch, one refresh)."""
    req = jpacket.PlainPacket(bits={
        "addr": np.array([1, 0, 1, 1, 0, 1], np.uint8),     # 5, 5
        "wren": np.array([1, 0], np.uint8),
        "wdata": np.array([0, 1, 1, 1, 0, 0, 0, 0], np.uint8),
        "addrB": np.array([0, 1, 0, 1, 1, 1], np.uint8),    # 2, 7
        "wrenB": np.array([1, 1], np.uint8),
        "wdataB": np.array([1, 0, 0, 1, 1, 1, 1, 0], np.uint8),
    })
    dec = _run_both("tiny-2ram.toml", req, 2, toy_sk, toy_ek)
    np.testing.assert_array_equal(dec.bits["rdataA"], [0, 1, 1, 1])
    np.testing.assert_array_equal(dec.ram["ramB"][28:32], [1, 1, 1, 0])


@pytest.mark.parametrize("period", ["1", "3"])
def test_ram_refresh_period_matches_jax(toy_sk, toy_ek, jax_tkey_env,
                                        monkeypatch, period):
    """4 cycles at period 3 run skip, skip, refresh, skip: the port and the
    JAX engine give the same ciphertexts and stores at either period."""
    monkeypatch.setenv("IYOKAN_RAM_REFRESH_PERIOD", period)
    init = np.zeros(16, np.uint8)
    init[12:16] = 1
    req = _ram_request([0, 1, 1, 1, 0, 1, 1, 0], [1, 0, 0, 1],
                       [1, 1, 0, 1] + [0] * 8 + [0, 1, 1, 0], init)
    dec = _run_both("tiny-ram.toml", req, 4, toy_sk, toy_ek)
    np.testing.assert_array_equal(dec.ram["ramA"][4:8], [0, 1, 1, 0])


def test_ram_snapshot_resume_cli(toy_sk, toy_ek, tmp_path, monkeypatch):
    """tfhe --snapshot after 2 cycles + --resume for 1 == 3 straight
    cycles: outputs and RAM stores bit for bit (period 2: cycle 1
    refreshes the whole store, cycles 0 and 2 only the written rows)."""
    monkeypatch.setenv("IYOKAN_RAM_REFRESH_PERIOD", "2")
    monkeypatch.setenv("IYOKAN_TORCH_DEVICE", "cpu")
    p = {k: str(tmp_path / k) for k in ("ek", "req", "r3", "r2", "r3b",
                                        "snap")}
    toy_ek.save(p["ek"])
    _ram_request([0, 1, 1, 1, 0, 1], [1, 1, 0],
                 [1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0]).encrypt(
        toy_sk, seed=3).save(p["req"])
    bp = os.path.join(DATA, "tiny-ram.toml")
    run = t_iyokan_cli.main
    common = ["--blueprint", bp, "--evalkey", p["ek"], "--quiet"]
    assert run(["tfhe", *common, "-i", p["req"], "-o", p["r3"],
                "-c", "3"]) == 0
    assert run(["tfhe", *common, "-i", p["req"], "-o", p["r2"], "-c", "2",
                "--snapshot", p["snap"]]) == 0
    assert run(["tfhe", "--resume", p["snap"], "--evalkey", p["ek"],
                "-o", p["r3b"], "-c", "1", "--quiet"]) == 0
    a = tpacket.TFHEPacket.load(p["r3"])
    b = tpacket.TFHEPacket.load(p["r3b"])
    np.testing.assert_array_equal(a.bits["rdata"], b.bits["rdata"])
    np.testing.assert_array_equal(a.ram["ramA"], b.ram["ramA"])
    dec = a.decrypt(toy_sk)
    np.testing.assert_array_equal(dec.bits["rdata"], [1, 1, 0, 1])
    np.testing.assert_array_equal(dec.ram["ramA"][12:16], [0, 1, 1, 1])


# --------------------------------------------------------------------------- #
# the memmac circuit
# --------------------------------------------------------------------------- #


def test_memmac_file_is_generated():
    with open(os.path.join(DATA, "memmac.toml")) as f:
        assert f.read() == gen_mac.memmac_blueprint()


@pytest.mark.parametrize("cycles,seed", [(3, 0), (5, 1)])
def test_memmac_plain_matches_integers(cycles, seed):
    rom, rams, streams = gen_mac.memmac_request(cycles, seed)
    fe = TFrontend("plain", TBlueprint(os.path.join(DATA, "memmac.toml")),
                   tpacket.PlainPacket(rom={"rom": rom}, ram=rams,
                                       bits=streams), device="cpu")
    fe.go(cycles)
    res = fe.make_result_packet()
    out, final = gen_mac.memmac_expected(rom, rams, streams, cycles)
    for name, want in out.items():
        assert sum(int(b) << k for k, b in enumerate(res.bits[name])) == want
    for name, bits in final.items():
        np.testing.assert_array_equal(res.ram[name], bits)
    # cycle 0's writes are read back on the last even cycle
    assert out["rdataA"] == gen_mac.memmac_expected(rom, rams, streams,
                                                    1)[0]["acc"]
