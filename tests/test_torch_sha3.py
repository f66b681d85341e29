"""SHA3-256 (tests/data/gen_sha3.py, the benchmark's sha3 configuration)
against the plain FIPS 202 reference of the benchmark
(portbench/reference/sha3.py) and against hashlib.

The reference gives hashlib's digests; the frozen netlist is the
generator's output and its configuration records its census and levels;
the benchmark's own evaluator (portbench/reference/circuit.py) runs the
reference's sponge on the frozen netlist, and on a request that the
benchmark's generator draws; the frozen netlist through the port's normal
path (Frontend over the blueprint) hashes a padded message to hashlib's
digest in plain mode, and a Keccak-p[200, 1] sponge under the TFHE engine
at toy parameters gives the reference's states.  The cggi128 run of the
frozen netlist needs the card.  No JAX here.
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")
CONFIG = os.path.join(ROOT, "portbench", "configs")
BLUEPRINT = os.path.join(CONFIG, "sha3", "sha3.toml")
for p in (ROOT, DATA):
    if p not in sys.path:
        sys.path.insert(0, p)

import gen_sha3  # noqa: E402
from iyokan_tpu_torch import packet as tpacket  # noqa: E402
from iyokan_tpu_torch import params as tparams  # noqa: E402
from iyokan_tpu_torch.circuit.blueprint import Blueprint  # noqa: E402
from iyokan_tpu_torch.circuit.compile import compile_design  # noqa: E402
from iyokan_tpu_torch.crypto import host  # noqa: E402
from iyokan_tpu_torch.engine.driver import Frontend, build_design  # noqa: E402
from portbench import generator  # noqa: E402
from portbench.reference import sha3  # noqa: E402
from portbench.reference.circuit import Circuit, Run  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def circuit():
    return Circuit(BLUEPRINT)


def _message(n, seed=25):
    return bytes(np.random.default_rng(seed).integers(0, 256, n).tolist())


def _digest_nodes(fe, width=256):
    ports = {b: p for (name, b), p in fe.bp.at_ports.items()
             if name == "digest"}
    return [fe.design.get(ports[b].node_name, ports[b].kind,
                          ports[b].port_name, ports[b].port_bit)
            for b in range(width)]


def _write(tmp_path, netlist, rate, out_bits):
    (tmp_path / "k-yosys.json").write_text(gen_sha3.netlist_text(netlist))
    path = tmp_path / "k.toml"
    path.write_text(gen_sha3.blueprint("k-yosys.json", rate, out_bits))
    return str(path)


@pytest.mark.parametrize("n", [0, 1, 135, 136, 137, 300])
def test_reference_is_hashlib(n):
    msg = _message(n, n)
    assert len(sha3.pad(msg)) == n // 136 + 1
    assert sha3.sha3_256(msg) == hashlib.sha3_256(msg).digest()


def test_reference_round_constants():
    """FIPS 202's rc LFSR gives Keccak-f[1600]'s published RC[0], RC[1]
    and RC[23] (lane bits 2^j - 1 of rc(j + 7 ir))."""
    def lane(ir):
        return sum(sha3.rc(j + 7 * ir) << ((1 << j) - 1) for j in range(7))
    assert (lane(0), lane(1), lane(23)) == (
        0x1, 0x8082, 0x8000000080008008)
    assert [gen_sha3.round_constant(ir, 64) for ir in (0, 1, 23)] == [
        lane(0), lane(1), lane(23)]


def test_frozen_netlist_is_generated():
    with open(os.path.join(CONFIG, "sha3", gen_sha3.NETLIST)) as f:
        text = f.read()
    assert text == gen_sha3.netlist_text(gen_sha3.keccak_netlist())
    with open(BLUEPRINT) as f:
        assert f.read() == gen_sha3.blueprint()


def test_configuration_records_the_netlist(circuit):
    """The configuration's census is the frozen file's, and the
    benchmark's evaluator levelizes it the same way."""
    with open(os.path.join(CONFIG, "sha3.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(CONFIG, "sha3", gen_sha3.NETLIST)) as f:
        census = gen_sha3.census(json.load(f))
    rec = cfg["circuit"]
    assert {k: rec[k] for k in census} == census
    assert rec["cells"]["$_ANDNOT_"] == 24 * 1600 and rec["dffs"] == 1600
    assert cfg["reduced"] == [] and cfg["inputs"] == {"block": "uniform"}
    rows = circuit.level_rows()
    assert (len(rows), sum(rows), max(rows)) == (
        rec["levels"], rec["rows_per_cycle"], rec["rows_per_level"]["max"])
    assert rec["levels_by_rows"] == {str(r): rows.count(r)
                                     for r in set(rows)}
    assert len(circuit.dffs) == 1600


def test_levels_match_the_program(circuit):
    """The port's levelizer makes the batches that the benchmark's work
    model counts: rows a level as the benchmark's evaluator levelizes."""
    comp = compile_design(build_design(Blueprint(BLUEPRINT)))
    rows = [lv.n_bootstraps for lv in comp.levels if lv.n_bootstraps]
    assert rows == circuit.level_rows()
    assert sum(rows) == 154_688 and len(rows) == 169
    assert sorted(set(rows)) == [320, 640, 1088, 1600]


def test_evaluator_runs_the_reference_sponge(circuit):
    """Three uniform blocks through the frozen netlist under the
    benchmark's evaluator: each cycle's @digest is the first 256 bits of
    the reference's state after that block, the state carried in the
    DFFs."""
    rng = np.random.default_rng(2026)
    blocks = torch.tensor(rng.integers(0, 2, (3, 1088)), dtype=torch.uint8)
    run = Run(circuit, {}, {}, {"block": blocks.reshape(-1).numpy()})
    want = sha3.sponge(blocks)
    for c in range(3):
        assert torch.equal(torch.as_tensor(run.step()["digest"]),
                           want[c, :256]), c


@pytest.mark.parametrize("w,rounds,rate", [(8, 1, 136), (16, 3, 200),
                                           (64, 2, 1088)])
def test_small_permutations(tmp_path, w, rounds, rate):
    """The generator's sponge on Keccak-p[25w, rounds], under the
    benchmark's evaluator, equals the reference's states block after
    block."""
    b = 25 * w
    net = gen_sha3.keccak_netlist(w, rounds, rate, b)
    path = _write(tmp_path, net, rate, b)
    blocks = torch.tensor(np.random.default_rng(w).integers(
        0, 2, (3, rate)), dtype=torch.uint8)
    run = Run(Circuit(path), {}, {}, {"block": blocks.reshape(-1).numpy()})
    got = torch.stack([torch.as_tensor(run.step()["digest"])
                       for _ in range(3)])
    assert torch.equal(got, sha3.sponge(blocks, b, rounds))


def test_port_plain_frontend():
    """A 300-byte message padded to three blocks through the port's
    Frontend (plain engine) on the frozen netlist: the last cycle's
    @digest is hashlib's SHA3-256."""
    msg = _message(300)
    blocks = sha3.bits(sha3.pad(msg))
    fe = Frontend("plain", Blueprint(BLUEPRINT),
                  tpacket.PlainPacket(bits={"block":
                                            blocks.reshape(-1).numpy()}),
                  device="cpu")
    nodes, got = _digest_nodes(fe), []
    fe.go(len(blocks), on_cycle=lambda f: got.append(
        f.engine.read_nodes(f.vals, nodes)))
    digest = sha3.to_bytes(torch.as_tensor(np.array(got[-1:])))[0]
    assert digest == hashlib.sha3_256(msg).digest()
    census = fe.compiled.gate_census()
    assert (census["XOR"], census["ANDNOT"], census["XNOR"],
            census["DFF"]) == (116_202, 38_400, 86, 1600)
    assert "NOT" not in census


def test_benchmark_evaluator_on_a_generated_request(circuit):
    """portbench's generator draws the sha3 cell's request (uniform
    1088-bit blocks); the evaluator's @digest follows the reference's
    sponge over the circular stream, past its wrap."""
    with open(os.path.join(CONFIG, "sha3.json")) as f:
        cfg = json.load(f)
    rom, ram, streams = generator.make_request(
        circuit, cfg, {"stream_entries": 3}, 2**31 + 2**20 + 25, 0)
    assert (rom, ram) == ({}, {}) and set(streams) == {"block"}
    blocks = torch.as_tensor(streams["block"]).reshape(3, 1088)
    want = sha3.sponge(torch.cat([blocks, blocks[:1]]))
    run = Run(circuit, rom, ram, streams)
    for c in range(4):
        assert torch.equal(torch.as_tensor(run.step()["digest"]),
                           want[c, :256]), c


def test_port_tfhe_keccak_p200_toy(tmp_path):
    """A Keccak-p[200, 1] sponge of rate 136 through the port's Frontend
    under the TFHE engine at toy parameters on the CPU (the plain twins of
    the card's kernels), two blocks: each cycle's decrypted state is the
    reference's, the first carried to the second in the DFFs."""
    net = gen_sha3.keccak_netlist(8, 1, 136, 200)
    blocks = torch.tensor(np.random.default_rng(200).integers(
        0, 2, (2, 136)), dtype=torch.uint8)
    sk = host.keygen(tparams.TOY, seed=42)
    ek = host.genevalkey(sk, seed=43, with_cb=False)
    req = tpacket.PlainPacket(bits={"block": blocks.reshape(-1).numpy()}
                              ).encrypt(sk, seed=7)
    fe = Frontend("tfhe", Blueprint(_write(tmp_path, net, 136, 200)), req,
                  eval_key=ek, device="cpu")
    nodes, got = _digest_nodes(fe, 200), []
    fe.go(2, on_cycle=lambda f: got.append(
        f.engine.read_nodes(f.vals, nodes)))
    states = [tpacket.TFHEPacket(params="toy", bits={"digest": g})
              .decrypt(sk).bits["digest"] for g in got]
    assert torch.equal(torch.as_tensor(np.array(states)),
                       sha3.sponge(blocks, 200, 1))


@pytest.mark.cuda
def test_card_cggi128_two_blocks():
    """A 200-byte message padded to two blocks through the frozen netlist
    at cggi128 on the card: cycle 1's decrypted @digest is the reference's
    state after the first block, cycle 2's is hashlib's SHA3-256."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    msg = _message(200)
    blocks = sha3.bits(sha3.pad(msg))
    assert len(blocks) == 2
    sk = host.keygen(tparams.CGGI128, seed=2026101901)
    ek = host.genevalkey(sk, seed=2026101902, with_cb=False)
    req = tpacket.PlainPacket(bits={"block": blocks.reshape(-1).numpy()}
                              ).encrypt(sk, seed=11)
    fe = Frontend("tfhe", Blueprint(BLUEPRINT), req, eval_key=ek,
                  device="cuda")
    nodes, got = _digest_nodes(fe), []
    fe.go(2, on_cycle=lambda f: got.append(
        f.engine.read_nodes(f.vals, nodes)))
    bits = torch.as_tensor(np.array([
        tpacket.TFHEPacket(params="cggi128", bits={"digest": g})
        .decrypt(sk).bits["digest"] for g in got]))
    assert torch.equal(bits[0], sha3.sponge(blocks[:1])[0, :256])
    assert sha3.to_bytes(bits[1:])[0] == hashlib.sha3_256(msg).digest()
