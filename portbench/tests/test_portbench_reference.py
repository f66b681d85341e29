"""The benchmark's plain reference: the bit-level evaluator against the
circuits' integer models, and the decryption against the program's
encryption at toy parameters."""

import os

import numpy as np
import pytest

from portbench import generator
from portbench.reference import tfhe
from portbench.reference.circuit import Circuit, Run
from portbench.tests import oracle

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
MEMMAC_INPUTS = {"addrA": "distinct_revisit", "addrB": "distinct_revisit",
                 "wrenA": "first_and_odd", "wrenB": "first_and_odd"}


def _word(bits):
    return sum(int(b) << k for k, b in enumerate(bits))


def _stream_words(bits, width):
    return [_word(bits[i: i + width]) for i in range(0, len(bits), width)]


@pytest.mark.parametrize("W,blueprint", [
    (2, os.path.join(ROOT, "tests", "data", "mac2.toml")),
    (4, os.path.join(ROOT, "tests", "data", "mac4.toml")),
    (16, os.path.join(BENCH, "configs", "mac16", "mac16.toml")),
])
def test_mac_against_integers(W, blueprint):
    circ = Circuit(blueprint)
    rom, ram, streams = generator.make_request(
        circ, {}, {"stream_entries": 5}, 2**31 + 7, 0)
    a = _stream_words(streams["a"], W)
    b = _stream_words(streams["b"], W)
    run = Run(circ, rom, ram, streams)
    for c in range(1, 13):
        out = run.step()
        assert _word(out["acc"]) == oracle.mac_expected(W, a, b, c), c


def test_memmac_against_integers():
    circ = Circuit(os.path.join(BENCH, "configs", "memmac", "memmac.toml"))
    rom, ram, streams = generator.make_request(
        circ, {"inputs": MEMMAC_INPUTS}, {"stream_entries": 16}, 99, 3)
    run = Run(circ, rom, ram, streams)
    for c in range(1, 41):
        out = run.step()
        want, want_ram = oracle.memmac_expected(rom["rom"], ram, streams, c)
        assert {k: _word(v) for k, v in out.items()} == want, c
        for name, bits in want_ram.items():
            assert np.array_equal(run.ram[name], np.array(bits)), (c, name)


def test_circuit_levels_match_the_program():
    """The evaluator's levels are the batches the program's compiler makes
    (its rows per gate level), so the work model counts what a levelized
    engine runs."""
    from iyokan_tpu_torch.circuit import compile as compile_mod
    from iyokan_tpu_torch.circuit.blueprint import Blueprint
    from iyokan_tpu_torch.engine.driver import build_design

    for bp in (os.path.join(BENCH, "configs", "mac16", "mac16.toml"),
               os.path.join(BENCH, "configs", "memmac", "memmac.toml")):
        comp = compile_mod.compile_design(build_design(Blueprint(bp)))
        theirs = [lv.n_bootstraps for lv in comp.levels if lv.n_bootstraps]
        assert Circuit(bp).level_rows() == theirs


def test_decryption_on_a_toy_key():
    from iyokan_tpu_torch.crypto import host
    from iyokan_tpu_torch.params import TOY

    p = {"n": TOY.n, "N": TOY.N, "N2": TOY.N2}
    s = tfhe.secret_key(p, 11)
    want = host.keygen(TOY, seed=11)
    for k in ("s0", "s1", "s2"):                 # the same draw as keygen
        assert np.array_equal(s[k], getattr(want, k))
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 200).astype(np.uint8)
    ct = host.encrypt_bits(want, bits, rng)
    got, err = tfhe.bits_and_errors(tfhe.tlwe_phase(ct, s["s0"]), bits)
    assert np.array_equal(got, bits) and err.max() < 0.01
    ram = host.encrypt_ram(want, bits[:40], rng)
    ph = tfhe.trlwe_phase0(ram, s["s1"])
    assert np.array_equal(ph, host.trlwe1_phase(want, ram)[:, 0])
    got, err = tfhe.bits_and_errors(ph, bits[:40])
    assert np.array_equal(got, bits[:40]) and err.max() < 0.01
    # a flipped bit reads wrong and 2 sixteenths or more away
    got, err = tfhe.bits_and_errors(tfhe.tlwe_phase(ct, s["s0"]), 1 - bits)
    assert not np.any(got == 1 - bits) and err.min() >= 1.9


def test_generator_is_the_seed_s():
    circ = Circuit(os.path.join(BENCH, "configs", "memmac", "memmac.toml"))
    cfg, trf = {"inputs": MEMMAC_INPUTS}, {"stream_entries": 128}
    a = generator.make_request(circ, cfg, trf, 2**33 + 1, 0)
    b = generator.make_request(circ, cfg, trf, 2**33 + 1, 0)
    c = generator.make_request(circ, cfg, trf, 2**33 + 2, 0)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(a[0]["rom"], c[0]["rom"])
    # every seed the same sizes
    assert all({k: v.shape for k, v in x.items()}
               == {k: v.shape for k, v in z.items()} for x, z in zip(a, c))
