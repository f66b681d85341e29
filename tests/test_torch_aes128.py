"""AES-128 (tests/data/gen_aes.py, the benchmark's aes128 configuration)
against the plain FIPS-197 reference of the benchmark
(portbench/reference/aes128.py).

The reference reproduces FIPS-197's vectors; the generator's S-box circuit
equals the reference's table on every byte; the frozen netlist is the
generator's output and its configuration records its census; the frozen
netlist through the port's normal path (Frontend over the blueprint) gives
the reference's ciphertexts: in plain mode at 10 rounds, and under the TFHE
engine at toy parameters on a 1-round circuit; the benchmark's own
evaluator (portbench/reference/circuit.py) agrees on a request that the
benchmark's generator draws.  The cggi128 run of the 10-round netlist needs
the card.  No JAX here.
"""

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
BLUEPRINT = os.path.join(CONFIG, "aes128", "aes128.toml")
for p in (ROOT, DATA):
    if p not in sys.path:
        sys.path.insert(0, p)

import gen_aes  # noqa: E402
from iyokan_tpu_torch import packet as tpacket  # noqa: E402
from iyokan_tpu_torch import params as tparams  # noqa: E402
from iyokan_tpu_torch.circuit.blueprint import Blueprint  # noqa: E402
from iyokan_tpu_torch.circuit.compile import compile_design  # noqa: E402
from iyokan_tpu_torch.crypto import host  # noqa: E402
from iyokan_tpu_torch.engine.driver import Frontend, build_design  # noqa: E402
from portbench import generator  # noqa: E402
from portbench.reference import aes128  # noqa: E402
from portbench.reference.circuit import Circuit, Run  # noqa: E402

# FIPS-197 Appendix B (the cipher example) and C.1 (AES-128): key,
# plaintext, ciphertext
APPENDIX_B = ("2b7e151628aed2a6abf7158809cf4f3c",
              "3243f6a8885a308d313198a2e0370734",
              "3925841d02dc09fbdc118597196a0b32")
APPENDIX_C1 = ("000102030405060708090a0b0c0d0e0f",
               "00112233445566778899aabbccddeeff",
               "69c4e0d86a7b0430d8cdb78070b4c55a")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _blocks(*hexes):
    return torch.tensor([list(bytes.fromhex(h)) for h in hexes])


def _request(n, seed):
    """(keys, plaintexts) uint8 [n + 2, 16]: FIPS-197 B and C.1, then n
    seeded random blocks under random keys."""
    rng = np.random.default_rng(seed)
    keys = torch.cat([_blocks(APPENDIX_B[0], APPENDIX_C1[0]),
                      torch.tensor(rng.integers(0, 256, (n, 16)))])
    pts = torch.cat([_blocks(APPENDIX_B[1], APPENDIX_C1[1]),
                     torch.tensor(rng.integers(0, 256, (n, 16)))])
    return keys, pts


def _streams(keys, pts):
    return {"key": aes128.bits(keys).reshape(-1).numpy(),
            "pt": aes128.bits(pts).reshape(-1).numpy()}


def _ct_nodes(fe):
    ports = {b: p for (name, b), p in fe.bp.at_ports.items() if name == "ct"}
    return [fe.design.get(ports[b].node_name, ports[b].kind,
                          ports[b].port_name, ports[b].port_bit)
            for b in range(128)]


def _write(tmp_path, netlist, text=None):
    (tmp_path / "aes-yosys.json").write_text(gen_aes.netlist_text(netlist))
    path = tmp_path / "aes.toml"
    path.write_text(text or gen_aes.blueprint("aes-yosys.json"))
    return str(path)


@pytest.mark.parametrize("vector", [APPENDIX_B, APPENDIX_C1],
                         ids=["appendix_b", "appendix_c1"])
def test_reference_fips197_vectors(vector):
    key, pt, ct = (bytes.fromhex(h) for h in vector)
    assert aes128.encrypt(key, pt) == ct
    blocks = aes128.block(aes128.bits(_blocks(vector[2])))
    assert bytes(blocks[0].tolist()) == ct


def test_reference_sbox_from_its_definition():
    s = aes128.sbox()
    # FIPS-197 Sec. 5.1.1's example and Figure 7's corners
    assert (s[0x53], s[0x00], s[0x01], s[0xFF]) == (0xED, 0x63, 0x7C, 0x16)
    assert sorted(s) == list(range(256))
    assert all(aes128.gf_mul(a, aes128.gf_inv(a)) == 1 for a in range(1, 256))


def test_sbox_circuit_on_all_inputs(tmp_path):
    """Boyar-Peralta's circuit, read back by the benchmark's evaluator,
    equals the reference's table on all 256 bytes; 32 ANDs, 83
    XOR/XNORs."""
    net = gen_aes.sbox_netlist()
    census = gen_aes.census(net)["cells"]
    assert census == {"$_AND_": 32, "$_XNOR_": 4, "$_XOR_": 79}
    path = _write(tmp_path, net, (
        '[[file]]\ntype = "yosys-json"\npath = "aes-yosys.json"\n'
        'name = "s"\n\n[connect]\n"s/x[0:7]" = "@x[0:7]"\n'
        '"@y[0:7]" = "s/y[0:7]"\n'))
    xs = np.array([(v >> j) & 1 for v in range(256) for j in range(8)],
                  np.uint8)
    run = Run(Circuit(path), {}, {}, {"x": xs})
    table = aes128.sbox()
    for v in range(256):
        y = run.step()["y"]
        assert sum(int(b) << j for j, b in enumerate(y)) == table[v], v


def test_frozen_netlist_is_generated():
    with open(os.path.join(CONFIG, "aes128", gen_aes.NETLIST)) as f:
        assert f.read() == gen_aes.netlist_text(gen_aes.aes_netlist(10))
    with open(BLUEPRINT) as f:
        assert f.read() == gen_aes.blueprint()


def test_configuration_records_the_netlist():
    """The configuration's census is the frozen file's, and the
    benchmark's evaluator levelizes it the same way."""
    with open(os.path.join(CONFIG, "aes128.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(CONFIG, "aes128", gen_aes.NETLIST)) as f:
        census = gen_aes.census(json.load(f))
    rec = cfg["circuit"]
    assert {k: rec[k] for k in census} == census
    assert rec["cells"]["$_AND_"] == 32 * rec["s_boxes"] == 6400
    assert cfg["reduced"] == [] and set(cfg["inputs"]) == {"key", "pt"}
    rows = Circuit(BLUEPRINT).level_rows()
    assert (len(rows), sum(rows), max(rows)) == (
        rec["levels"], rec["rows_per_cycle"], rec["rows_per_level"]["max"])


def test_levels_match_the_program():
    """The port's levelizer makes the batches that the benchmark's work
    model counts: rows a level as the benchmark's evaluator levelizes."""
    comp = compile_design(build_design(Blueprint(BLUEPRINT)))
    rows = [lv.n_bootstraps for lv in comp.levels if lv.n_bootstraps]
    assert rows == Circuit(BLUEPRINT).level_rows()
    assert sum(rows) == 29_864 and len(rows) == 312


@pytest.mark.parametrize("rounds", [1, 2, 9, 10])
def test_reduced_round_circuits(tmp_path, rounds):
    """The generator's circuit of `rounds` rounds, under the benchmark's
    evaluator, equals the reference's cipher of as many rounds."""
    keys, pts = _request(6, rounds)
    path = (BLUEPRINT if rounds == 10
            else _write(tmp_path, gen_aes.aes_netlist(rounds)))
    run = Run(Circuit(path), {}, {}, _streams(keys, pts))
    got = torch.stack([torch.as_tensor(run.step()["ct"])
                       for _ in range(len(keys))])
    want = aes128.encrypt_blocks(keys, pts, rounds)
    assert torch.equal(aes128.block(got), want)


def test_port_plain_frontend():
    """The frozen netlist through the port's Frontend (plain engine), one
    block a cycle: FIPS-197 B, C.1 and 64 seeded random blocks."""
    keys, pts = _request(64, 2026)
    fe = Frontend("plain", Blueprint(BLUEPRINT),
                  tpacket.PlainPacket(bits=_streams(keys, pts)),
                  device="cpu")
    nodes, got = _ct_nodes(fe), []
    fe.go(len(keys), on_cycle=lambda f: got.append(
        f.engine.read_nodes(f.vals, nodes)))
    ct = aes128.block(torch.as_tensor(np.array(got)))
    assert torch.equal(ct, aes128.encrypt_blocks(keys, pts))
    assert bytes(ct[1].tolist()).hex() == APPENDIX_C1[2]
    census = fe.compiled.gate_census()
    assert (census["AND"], census["XOR"], census["XNOR"]) == (6400, 22648,
                                                              816)
    assert "NOT" not in census and "DFF" not in census


def test_benchmark_evaluator_on_a_generated_request():
    """portbench's generator draws the aes128 cell's request (uniform
    128-bit keys and plaintexts); its evaluator's @ct equals the
    reference's ciphertexts of the streams' words."""
    with open(os.path.join(CONFIG, "aes128.json")) as f:
        cfg = json.load(f)
    circ = Circuit(BLUEPRINT)
    rom, ram, streams = generator.make_request(
        circ, cfg, {"stream_entries": 5}, 2**31 + 2**20 + 21, 0)
    assert (rom, ram) == ({}, {})
    keys = aes128.block(torch.as_tensor(streams["key"]).reshape(5, 128))
    pts = aes128.block(torch.as_tensor(streams["pt"]).reshape(5, 128))
    want = aes128.encrypt_blocks(keys, pts)
    run = Run(circ, rom, ram, streams)
    for c in range(7):                         # past the streams' wrap
        got = aes128.block(torch.as_tensor(run.step()["ct"])[None])
        assert torch.equal(got[0], want[c % 5]), c


def test_port_tfhe_one_round_toy(tmp_path):
    """A 1-round circuit through the port's Frontend under the TFHE engine
    at toy parameters on the CPU (the plain twins of the card's kernels):
    the decrypted @ct is the reference's 1-round cipher."""
    keys, pts = _request(0, 1)
    keys, pts = keys[1:], pts[1:]              # FIPS-197 C.1's key and block
    sk = host.keygen(tparams.TOY, seed=42)
    ek = host.genevalkey(sk, seed=43, with_cb=False)
    req = tpacket.PlainPacket(bits=_streams(keys, pts)).encrypt(sk, seed=7)
    fe = Frontend("tfhe", Blueprint(_write(tmp_path, gen_aes.aes_netlist(1))),
                  req, eval_key=ek, device="cpu")
    fe.go(1)
    got = fe.make_result_packet().decrypt(sk).bits["ct"]
    assert torch.equal(aes128.block(torch.as_tensor(got)[None]),
                       aes128.encrypt_blocks(keys, pts, 1))


@pytest.mark.cuda
def test_card_cggi128_two_cycles():
    """Two cycles of the frozen 10-round netlist at cggi128 on the card,
    FIPS-197 C.1 the first: the decrypted @ct of each is the reference's
    ciphertext."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    keys, pts = _request(1, 3)
    keys, pts = keys[1:], pts[1:]
    sk = host.keygen(tparams.CGGI128, seed=2026101801)
    ek = host.genevalkey(sk, seed=2026101802, with_cb=False)
    req = tpacket.PlainPacket(bits=_streams(keys, pts)).encrypt(sk, seed=9)
    fe = Frontend("tfhe", Blueprint(BLUEPRINT), req, eval_key=ek,
                  device="cuda")
    nodes, got = _ct_nodes(fe), []
    fe.go(2, on_cycle=lambda f: got.append(
        f.engine.read_nodes(f.vals, nodes)))
    bits = [tpacket.TFHEPacket(params="cggi128", bits={"ct": g})
            .decrypt(sk).bits["ct"] for g in got]
    ct = aes128.block(torch.as_tensor(np.array(bits)))
    assert bytes(ct[0].tolist()).hex() == APPENDIX_C1[2]
    assert torch.equal(ct, aes128.encrypt_blocks(keys, pts))
