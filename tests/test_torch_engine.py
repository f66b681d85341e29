"""The torch port's encrypted gate path as a whole, against the JAX package.

* MAC-4 (tests/data/mac4.toml) at toy parameters for 2 cycles: the JAX
  Frontend (tkey slab, Pallas in interpret mode, one dispatch per level) and
  the port's Frontend give bit-identical result ciphertexts that decrypt to
  the integer arithmetic.
* The CLIs interchange: the JAX packet tool encrypts, the port's iyokan
  tfhe runs, the JAX packet tool decrypts; plain modes agree.
* Snapshot/resume (plain and tfhe) and per-cycle decrypted dumps work
  through the port's CLI.
* The entry points run on the card unless asked for the CPU: with no card,
  Frontend without a device and the CLI without IYOKAN_TORCH_DEVICE raise;
  IYOKAN_TORCH_DEVICE=cpu runs the CLI on the CPU (the CLI tests set it).
(CMUX ROM/RAM designs: tests/test_torch_memory.py.)
"""

import os
import sys

import numpy as np
import pytest
import torch

from iyokan_tpu import packet as jpacket
from iyokan_tpu.circuit.blueprint import Blueprint as JBlueprint
from iyokan_tpu.cli import iyokan_cli as j_iyokan_cli
from iyokan_tpu.cli import packet_cli as j_packet_cli
from iyokan_tpu.engine.driver import Frontend as JFrontend
from iyokan_tpu_torch import packet as tpacket
from iyokan_tpu_torch.circuit.blueprint import Blueprint as TBlueprint
from iyokan_tpu_torch.cli import iyokan_cli as t_iyokan_cli
from iyokan_tpu_torch.cli import packet_cli as t_packet_cli
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.engine.driver import Frontend as TFrontend

DATA = os.path.join(os.path.dirname(__file__), "data")
sys.path.insert(0, DATA)
import gen_mac  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mac_request(W, cycles, seed):
    rng = np.random.default_rng(seed)
    av = [int(x) for x in rng.integers(0, 1 << W, cycles)]
    bv = [int(x) for x in rng.integers(0, 1 << W, cycles)]

    def bits(vals):
        return np.array([(v >> k) & 1 for v in vals for k in range(W)],
                        np.uint8)

    return av, bv, {"a": bits(av), "b": bits(bv)}


def _acc(bits):
    return sum(int(x) << k for k, x in enumerate(bits))


def test_mac4_slice_matches_jax(toy_sk, toy_ek, monkeypatch):
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    monkeypatch.setenv("IYOKAN_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("IYOKAN_FUSE_LEVELS", "1")
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", "0")
    W, cycles = 4, 2
    av, bv, streams = _mac_request(W, cycles, 41)
    req = jpacket.PlainPacket(bits=streams).encrypt(toy_sk, seed=7)
    bp = os.path.join(DATA, f"mac{W}.toml")

    tfe = TFrontend("tfhe", TBlueprint(bp), req, eval_key=toy_ek,
                    device="cpu")
    tfe.go(cycles)
    got = tfe.make_result_packet()
    jfe = JFrontend("tfhe", JBlueprint(bp), req, eval_key=toy_ek)
    jfe.go(cycles)
    want = jfe.make_result_packet()

    assert got.params == want.params and got.num_cycles == want.num_cycles
    assert got.bits["acc"].dtype == np.uint32
    np.testing.assert_array_equal(got.bits["acc"], want.bits["acc"])
    dec = got.decrypt(toy_sk).bits["acc"]
    assert _acc(dec) == gen_mac.expected(W, av, bv, cycles)


def test_cli_interchange(toy_sk, toy_ek, tmp_path, monkeypatch):
    """JAX packet tool -> port iyokan tfhe -> JAX packet tool, then plain."""
    monkeypatch.setenv(tops.DEVICE_ENV, "cpu")
    W, cycles = 2, 3
    av, bv, streams = _mac_request(W, cycles, 5)
    p = {k: str(tmp_path / k) for k in (
        "sk", "ek", "req.plain", "req.enc", "res.enc", "res.dec",
        "res.tplain", "res.jplain")}
    toy_sk.save(p["sk"])
    toy_ek.save(p["ek"])
    jpacket.PlainPacket(bits=streams).save(p["req.plain"])
    bp = os.path.join(DATA, f"mac{W}.toml")
    assert j_packet_cli.main(["enc", "--key", p["sk"], "--in",
                              p["req.plain"], "--out", p["req.enc"]]) == 0
    assert t_iyokan_cli.main(["tfhe", "--blueprint", bp, "-i", p["req.enc"],
                              "-o", p["res.enc"], "--evalkey", p["ek"],
                              "-c", str(cycles), "--quiet"]) == 0
    assert j_packet_cli.main(["dec", "--key", p["sk"], "--in", p["res.enc"],
                              "--out", p["res.dec"]]) == 0
    dec = jpacket.PlainPacket.load(p["res.dec"])
    assert dec.num_cycles == cycles
    assert _acc(dec.bits["acc"]) == gen_mac.expected(W, av, bv, cycles)

    for cli, out in ((t_iyokan_cli, "res.tplain"), (j_iyokan_cli,
                                                    "res.jplain")):
        assert cli.main(["plain", "--blueprint", bp, "-i", p["req.plain"],
                         "-o", p[out], "-c", str(cycles), "--quiet"]) == 0
    tres = tpacket.PlainPacket.load(p["res.tplain"])
    jres = jpacket.PlainPacket.load(p["res.jplain"])
    assert tres.to_toml() == jres.to_toml()
    assert tres.to_toml() == dec.to_toml()


@pytest.mark.parametrize("enc_cli,dec_cli", [
    (j_packet_cli, t_packet_cli), (t_packet_cli, j_packet_cli)],
    ids=["jax-enc-port-dec", "port-enc-jax-dec"])
def test_packet_cli_interchange(enc_cli, dec_cli, tmp_path):
    """Both packet tools write the same key file from one seed, and a
    packet encrypted by one decrypts with the other."""
    p = {k: str(tmp_path / k) for k in ("sk.j", "sk.t", "req", "enc",
                                         "dec")}
    for cli, out in ((j_packet_cli, "sk.j"), (t_packet_cli, "sk.t")):
        assert cli.main(["genkey", "--params", "toy", "--seed", "17",
                         "--out", p[out]]) == 0
    with open(p["sk.j"], "rb") as fj, open(p["sk.t"], "rb") as ft:
        assert fj.read() == ft.read()
    _, _, streams = _mac_request(4, 3, 21)
    jpacket.PlainPacket(bits=streams).save(p["req"])
    assert enc_cli.main(["enc", "--key", p["sk.j"], "--in", p["req"],
                         "--out", p["enc"]]) == 0
    assert dec_cli.main(["dec", "--key", p["sk.t"], "--in", p["enc"],
                         "--out", p["dec"]]) == 0
    got = tpacket.PlainPacket.load(p["dec"])
    for name, bits in streams.items():
        np.testing.assert_array_equal(got.bits[name], bits)


@pytest.mark.parametrize("W", [4, 16])
def test_port_plain_matches_integers(W):
    cycles = 3
    av, bv, streams = _mac_request(W, cycles, W)
    fe = TFrontend("plain", TBlueprint(os.path.join(DATA, f"mac{W}.toml")),
                   tpacket.PlainPacket(bits=streams), device="cpu")
    fe.go(cycles)
    res = fe.make_result_packet()
    assert _acc(res.bits["acc"]) == gen_mac.expected(W, av, bv, cycles)


def test_port_plain_snapshot_resume(tmp_path, monkeypatch):
    """--snapshot after 2 cycles, --resume for 1 more == 3 straight cycles."""
    monkeypatch.setenv(tops.DEVICE_ENV, "cpu")
    W = 4
    av, bv, streams = _mac_request(W, 3, 9)
    bp = os.path.join(DATA, f"mac{W}.toml")
    req = str(tmp_path / "req")
    tpacket.PlainPacket(bits=streams).save(req)
    run = t_iyokan_cli.main
    assert run(["plain", "--blueprint", bp, "-i", req, "-o",
                str(tmp_path / "r3"), "-c", "3", "--quiet"]) == 0
    assert run(["plain", "--blueprint", bp, "-i", req, "-o",
                str(tmp_path / "r2"), "-c", "2", "--quiet",
                "--snapshot", str(tmp_path / "snap")]) == 0
    assert run(["plain", "--resume", str(tmp_path / "snap"), "-o",
                str(tmp_path / "r3b"), "-c", "1", "--quiet"]) == 0
    a = tpacket.PlainPacket.load(str(tmp_path / "r3"))
    b = tpacket.PlainPacket.load(str(tmp_path / "r3b"))
    assert _acc(a.bits["acc"]) == gen_mac.expected(W, av, bv, 3)
    np.testing.assert_array_equal(a.bits["acc"], b.bits["acc"])


def test_port_tfhe_snapshot_resume_and_dump(toy_sk, toy_ek, tmp_path,
                                            monkeypatch):
    """tfhe --snapshot after 2 cycles + --resume for 1 == 3 straight cycles,
    bit for bit; --dump-prefix with --secret-key writes each cycle's
    decrypted state (the accumulator before that cycle)."""
    W = 2
    av, bv, streams = _mac_request(W, 3, 13)
    bp = os.path.join(DATA, f"mac{W}.toml")
    p = {k: str(tmp_path / k) for k in ("sk", "ek", "req", "r3", "r2",
                                        "r3b", "snap")}
    toy_sk.save(p["sk"])
    toy_ek.save(p["ek"])
    jpacket.PlainPacket(bits=streams).encrypt(toy_sk, seed=3).save(p["req"])
    monkeypatch.setenv(tops.DEVICE_ENV, "cpu")
    run = t_iyokan_cli.main
    common = ["--blueprint", bp, "--evalkey", p["ek"], "--quiet"]
    assert run(["tfhe", *common, "-i", p["req"], "-o", p["r3"],
                "-c", "3"]) == 0
    assert run(["tfhe", *common, "-i", p["req"], "-o", p["r2"], "-c", "2",
                "--snapshot", p["snap"], "--secret-key", p["sk"],
                "--dump-prefix", str(tmp_path / "dump")]) == 0
    assert run(["tfhe", "--resume", p["snap"], "--evalkey", p["ek"],
                "-o", p["r3b"], "-c", "1", "--quiet"]) == 0
    a = tpacket.TFHEPacket.load(p["r3"])
    b = tpacket.TFHEPacket.load(p["r3b"])
    np.testing.assert_array_equal(a.bits["acc"], b.bits["acc"])
    assert _acc(a.decrypt(toy_sk).bits["acc"]) == \
        gen_mac.expected(W, av, bv, 3)
    dump1 = tpacket.PlainPacket.load(str(tmp_path / "dump-1"))
    assert _acc(dump1.bits["acc"]) == gen_mac.expected(W, av, bv, 1)


def _plain_cli_args(tmp_path, W=4, cycles=2):
    av, bv, streams = _mac_request(W, cycles, 31)
    req = str(tmp_path / "req")
    tpacket.PlainPacket(bits=streams).save(req)
    out = str(tmp_path / "res")
    args = ["plain", "--blueprint", os.path.join(DATA, f"mac{W}.toml"),
            "-i", req, "-o", out, "-c", str(cycles), "--quiet"]
    return args, out, gen_mac.expected(W, av, bv, cycles)


def test_no_card_and_no_cpu_variable_raises(tmp_path, monkeypatch):
    """No silent CPU fallback: with no card, Frontend without a device and
    the CLI without IYOKAN_TORCH_DEVICE raise, naming the variable, and
    IYOKAN_TORCH_DEVICE=cuda raises too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    monkeypatch.delenv(tops.DEVICE_ENV, raising=False)
    args, out, _ = _plain_cli_args(tmp_path)
    with pytest.raises(RuntimeError, match=tops.DEVICE_ENV):
        TFrontend("plain", TBlueprint(args[2]),
                  tpacket.PlainPacket.load(args[4]))
    with pytest.raises(RuntimeError, match=tops.DEVICE_ENV):
        t_iyokan_cli.main(args)
    assert not os.path.exists(out)
    monkeypatch.setenv(tops.DEVICE_ENV, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tops.default_device()


def test_cpu_variable_runs_the_cli(tmp_path, monkeypatch):
    """IYOKAN_TORCH_DEVICE=cpu: the default device is the CPU and the CLI
    runs there."""
    monkeypatch.setenv(tops.DEVICE_ENV, "cpu")
    assert tops.default_device() == torch.device("cpu")
    args, out, want = _plain_cli_args(tmp_path)
    assert t_iyokan_cli.main(args) == 0
    assert _acc(tpacket.PlainPacket.load(out).bits["acc"]) == want


@pytest.mark.cuda
def test_port_tfhe_on_card_equals_cpu(toy_sk, toy_ek):
    """The port's Frontend on the card (CUDA kernel: K3, the default route
    of every gate rotation) gives the same result ciphertexts as on the CPU
    (plain twin), bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    from iyokan_tpu_torch.ops import br3

    W, cycles = 4, 2
    av, bv, streams = _mac_request(W, cycles, 23)
    req = jpacket.PlainPacket(bits=streams).encrypt(toy_sk, seed=5)
    bp = os.path.join(DATA, f"mac{W}.toml")
    res = {}
    for dev in ("cpu", "cuda"):
        before = br3.LAUNCHES
        fe = TFrontend("tfhe", TBlueprint(bp), req, eval_key=toy_ek,
                       device=dev)
        fe.go(cycles)
        res[dev] = fe.make_result_packet()
        assert (br3.LAUNCHES > before) == (dev == "cuda")
    np.testing.assert_array_equal(res["cuda"].bits["acc"],
                                  res["cpu"].bits["acc"])
    assert _acc(res["cuda"].decrypt(toy_sk).bits["acc"]) == \
        gen_mac.expected(W, av, bv, cycles)

