"""The port's gate-batch mesh on the CMUX-memory circuits, against the JAX
package under its 8-device mesh (the cases and helpers of
tests/test_torch_parallel.py, in a file of their own so that the two run
side by side):

* tiny-2ram: the fused two-RAM write, whose 2 x 8 x 4 = 64-row refresh
  sits exactly at the threshold of 8 shards and splits 8 ways;
* tiny-romram (a 4-bit adder between a CMUX ROM and a CMUX RAM, its
  netlist made by the fixture): gate levels, circuit bootstrapping, the
  ROM read and the RAM read and write under the mesh;
* __graft_entry__.dryrun_multichip's scenario: one sharded cycle of
  tiny-romram in the default mode (its 3 cycles under all are the all
  case above);
each at IYOKAN_FUSE_LEVELS = 1, 8 and all (groups of any size), and at
IYOKAN_SHARD_MIN_ROWS=1, byte for byte against the JAX Frontend and the
port with no mesh.
"""

import pytest

from .test_torch_parallel import (  # noqa: F401 (fixtures)
    MODES, TBlueprint, TFrontend, _assert_same_packet, _check_plain,
    _port_mesh, _refs, _run, _threads, check_frontend_under_mesh, romram_bp,
    splits)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["tiny-2ram", "tiny-romram"])
def test_memory_frontend_under_mesh_matches_jax(name, mode, toy_sk, toy_ek,
                                                romram_bp, splits):
    check_frontend_under_mesh(name, mode, toy_sk, toy_ek, romram_bp, splits)


def test_dryrun_multichip_scenario(toy_sk, toy_ek, romram_bp):
    """One cycle of tiny-romram under make_mesh(8) in the default mode ==
    the JAX Frontend's first cycle under its mesh; 3 + 5 = 8 is written to
    RAM word 2 and ROM word 2 is read."""
    jax_one, _ = _refs("tiny-romram", toy_sk, toy_ek, romram_bp)[1]
    with _port_mesh(8):
        one, = _run(TFrontend, TBlueprint, "tiny-romram", toy_sk, toy_ek,
                    romram_bp, {}, cycles=(1,), device="cpu")
    _assert_same_packet(one, jax_one)
    _check_plain("tiny-romram", one.decrypt(toy_sk))
