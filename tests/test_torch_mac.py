"""The MAC-W test circuits (tests/data/gen_mac.py) against the reference.

The checked-in netlists are what the generator writes, and the JAX
package's plain engine on them computes acc <- acc + a*b mod 2^(2W) --
which ties the port's slice circuit to the JAX reference.
"""

import json
import os
import sys

import numpy as np
import pytest

from iyokan_tpu import packet as jpacket
from iyokan_tpu.circuit.blueprint import Blueprint
from iyokan_tpu.engine.driver import Frontend

DATA = os.path.join(os.path.dirname(__file__), "data")
sys.path.insert(0, DATA)
import gen_mac  # noqa: E402


@pytest.mark.parametrize("W", [2, 4, 16])
def test_checked_in_netlist_is_generated(W):
    with open(os.path.join(DATA, f"mac{W}-yosys.json")) as f:
        assert json.load(f) == json.loads(json.dumps(gen_mac.mac_netlist(W)))
    with open(os.path.join(DATA, f"mac{W}.toml")) as f:
        assert f.read() == gen_mac.blueprint(W)


@pytest.mark.parametrize("W,cycles,seed", [(4, 5, 0), (16, 3, 1)])
def test_jax_plain_engine_computes_mac(W, cycles, seed):
    rng = np.random.default_rng(seed)
    av = [int(x) for x in rng.integers(0, 1 << W, cycles)]
    bv = [int(x) for x in rng.integers(0, 1 << W, cycles)]
    av[0] = bv[0] = (1 << W) - 1            # carries through every column
    bits = {name: np.array([(v >> k) & 1 for v in vals for k in range(W)],
                           np.uint8)
            for name, vals in (("a", av), ("b", bv))}
    fe = Frontend("plain", Blueprint(os.path.join(DATA, f"mac{W}.toml")),
                  jpacket.PlainPacket(bits=bits))
    fe.go(cycles)
    acc = fe.make_result_packet().bits["acc"]
    assert len(acc) == 2 * W
    assert sum(int(x) << k for k, x in enumerate(acc)) == \
        gen_mac.expected(W, av, bv, cycles)
    census = fe.compiled.gate_census()
    assert census["DFF"] == 2 * W and census["ANDNOT"] == 2 * W
    assert set(census) <= {"WIRE", "DFF", "AND", "XOR", "MUX", "ANDNOT"}
