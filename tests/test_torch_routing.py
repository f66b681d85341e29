"""Gate-key routing of the torch port against the JAX package.

* For every row of the table in iyokan_tpu_torch.crypto.ops.DeviceKeys
  that follows the JAX package (IYOKAN_BR_IMPL x IYOKAN_EP, with
  IYOKAN_UNROLL_MAX and IYOKAN_NO_UNROLL): the key kind (plain or 2-bit
  unrolled) each batch size gets from bk_for, and the route blind_rotate
  takes on it, equal the JAX package's on the TPU.  The JAX DeviceKeys are
  built with the MXU backend, as on the TPU; the route JAX takes is read by
  stopping it at the first kernel or product it calls.  Each of PREP_KNOBS
  set alone restores that table.
* The port's rule (no PREP_KNOBS set): the unrolled key and K3 at M = 3
  at every batch size, and no slab.
* The tkey slab's knobs (IYOKAN_TKEY_LIMBS, IYOKAN_TK_LB, IYOKAN_TK_LAYOUT,
  IYOKAN_TK_UNROLL, IYOKAN_TK_SMALL, IYOKAN_TK_SMALL_MAX, with
  IYOKAN_UNROLL_MAX): the key bk_for gives each batch size is the JAX
  DeviceKeys' (IYOKAN_BR_IMPL=tkey), the slab byte for byte; IYOKAN_TK_LB=0
  raises in both packages.
* jax_chunk_sizes, the row-to-chunk map of a level batch, on hand-made
  (nb, nm) cases around the bucket and chunk boundaries.
* MAC-2 (tests/data/mac2.toml) through the JAX and the port Frontends,
  ciphertexts identical after each cycle: (a) IYOKAN_EP=pallas
  IYOKAN_BR_IMPL=ntt with the unrolled key on and IYOKAN_UNROLL_MAX=16, so
  that one level's rows take both keys, and the same with
  IYOKAN_BOOT_CHUNK=16, which the port reads as the JAX engine does; (b)
  IYOKAN_BR_IMPL=v3, the JAX side on the MXU backend with its Pallas kernel
  in interpret mode; (c) IYOKAN_TK_SMALL=1 with IYOKAN_TK_SMALL_MAX=16, so
  that a level's 16-row chunks take the unrolled slab and its 32-row chunk
  the main one, the JAX kernels in interpret mode; (d) the port at its
  defaults (the port's rule: K3 at M = 3 on every level) against JAX under
  IYOKAN_BR_IMPL=v3.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iyokan_tpu import packet as jpacket
from iyokan_tpu.circuit.blueprint import Blueprint as JBlueprint
from iyokan_tpu.crypto import ops as jops
from iyokan_tpu.crypto import polymul as jpm
from iyokan_tpu.engine.driver import Frontend as JFrontend
from iyokan_tpu.ops import pallas_br, pallas_br2, pallas_br3, pallas_ep
from iyokan_tpu.ops import pallas_tk
from iyokan_tpu_torch import params as tparams
from iyokan_tpu_torch.circuit.blueprint import Blueprint as TBlueprint
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.engine import tfhe as ttfhe
from iyokan_tpu_torch.engine.driver import Frontend as TFrontend

DATA = os.path.join(os.path.dirname(__file__), "data")
sys.path.insert(0, DATA)
import gen_mac  # noqa: E402

TP = tparams.TOY
KNOBS = ("IYOKAN_BR_IMPL", "IYOKAN_EP", "IYOKAN_UNROLL_MAX",
         "IYOKAN_NO_UNROLL")
SIZES = (1, 16, 17, 256, 257, 2048)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _Taken(Exception):
    """Raised by the stand-ins of the JAX kernels: the route JAX took."""


def _stop(route):
    def stand_in(tlwe0, bk, *args, **kwargs):
        if route == "v3" and bk.shape[1] != 2 * TP.l:
            raise _Taken("v3-unrolled")
        raise _Taken(route)

    return stand_in


class _StopBackend:
    """A polymul backend whose lvl1 product names the XLA route."""

    def extprod1(self, d, g, p):
        raise _Taken("ntt-unrolled" if d.shape[-2] == 6 * p.l
                     else "ntt-step")


def _jax_route(monkeypatch, bk, p):
    for mod, name, route in (
            (pallas_tk, "blind_rotate_tkey", "tkey"),
            (pallas_br, "blind_rotate_pallas", "pallas"),
            (pallas_br2, "blind_rotate_pallas2", "pallas2"),
            (pallas_br3, "blind_rotate_pallas3", "v3"),
            (pallas_ep, "extprod1_fused", "ntt-step")):
        monkeypatch.setattr(mod, name, _stop(route))
    tlwe0 = jnp.zeros((2, p.n + 1), jnp.uint32)
    with pytest.raises(_Taken) as taken:
        jops.blind_rotate(tlwe0, bk, jnp.zeros(p.N, jnp.uint32), p,
                          _StopBackend())
    return taken.value.args[0]


# (IYOKAN_BR_IMPL, IYOKAN_EP, IYOKAN_UNROLL_MAX, IYOKAN_NO_UNROLL) ->
# the port's routes for (plain key, unrolled key): the DeviceKeys table
ROWS = [
    (("tkey", None, None, None), ("tkey", None)),
    (("tkey", "pallas", "16", None), ("tkey", "ntt-unrolled")),
    (("pallas", None, None, None), ("pallas", "ntt-unrolled")),
    (("pallas2", None, None, None), ("pallas2", "ntt-unrolled")),
    (("v3", None, None, None), ("v3", "v3-unrolled")),
    (("v3", None, "16", None), ("v3", "v3-unrolled")),
    (("v3", "pallas", None, None), ("ntt-step", "v3-unrolled")),
    (("pallas2", "pallas", None, None), ("ntt-step", "ntt-unrolled")),
    (("ntt", None, None, None), ("ntt-step", "ntt-unrolled")),
    (("ntt", None, None, "1"), ("ntt-step", None)),
]


def _set_knobs(monkeypatch, env):
    """env set (a value None: unset), every other one of PREP_KNOBS unset."""
    for k in tops.PREP_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        if v is not None:
            monkeypatch.setenv(k, v)
    monkeypatch.setenv("IYOKAN_MM_DTYPE", "int8")
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", "0")


def _jax_keys(toy_ek):
    """The JAX DeviceKeys on the MXU backend, as on the TPU."""
    jpm._mm_dtypes.cache_clear()
    jpm._use_full_fwd.cache_clear()
    try:
        return jops.DeviceKeys.from_evalkey(toy_ek, with_cb=False,
                                            backend=jpm.MXUBackend())
    finally:
        jpm._mm_dtypes.cache_clear()
        jpm._use_full_fwd.cache_clear()


def _both_keys(toy_ek, monkeypatch, env):
    """The JAX DeviceKeys and the port's under env (_set_knobs)."""
    _set_knobs(monkeypatch, env)
    return (_jax_keys(toy_ek),
            tops.DeviceKeys.from_evalkey(toy_ek, "cpu", with_cb=False))


@pytest.mark.parametrize("knobs,routes", ROWS,
                         ids=["-".join(str(v) for v in k) for k, _ in ROWS])
def test_routing_table_matches_jax(toy_ek, monkeypatch, knobs, routes):
    jdk, tdk = _both_keys(toy_ek, monkeypatch, dict(zip(KNOBS, knobs)))
    assert not tdk.port_routing
    assert (tdk.bk_ntt_u is None) == (jdk.bkuntt is None) == (
        routes[1] is None)
    thr = int(knobs[2] or ("0" if routes[0] == "tkey" else "256"))
    for batch in SIZES:
        jbk, tbk = jdk.bk_for(batch), tdk.bk_for(batch)
        unrolled = routes[1] is not None and batch <= thr
        assert (jbk is jdk.bkuntt) == (tbk is tdk.bk_ntt_u) == unrolled
        route = tops.gate_route(tbk, TP)
        assert route == routes[unrolled], batch
        assert _jax_route(monkeypatch, jbk, jdk.params) == route, batch


# each of PREP_KNOBS set alone, to a value the JAX package reads
ALONE = {"IYOKAN_BR_IMPL": "tkey", "IYOKAN_TK_LAYOUT": "fat",
         "IYOKAN_TKEY_LIMBS": "3", "IYOKAN_NO_UNROLL": "1",
         "IYOKAN_TK_UNROLL": "0", "IYOKAN_EP": "pallas", "IYOKAN_TK_LB": "2",
         "IYOKAN_TK_SMALL": "0", "IYOKAN_UNROLL_MAX": "16",
         "IYOKAN_KS_I8": "1"}


def test_alone_covers_prep_knobs():
    assert set(ALONE) == set(tops.PREP_KNOBS)


@pytest.mark.parametrize("knob", sorted(ALONE))
def test_any_prep_knob_restores_jax_table(toy_ek, monkeypatch, knob):
    """Any of PREP_KNOBS set, even to its JAX default, gives JAX's keys and
    routes at every batch size: the tkey slab, and the unrolled key (on
    ntt-unrolled) only under a positive IYOKAN_UNROLL_MAX."""
    jdk, tdk = _both_keys(toy_ek, monkeypatch, {knob: ALONE[knob]})
    assert not tdk.port_routing and tdk.bk_tk is not None
    assert (tdk.bk_ntt_u is None) == (jdk.bkuntt is None)
    for batch in SIZES + (48,):
        jbk, tbk = jdk.bk_for(batch), tdk.bk_for(batch)
        assert (jbk is jdk.bkuntt) == (tbk is tdk.bk_ntt_u), batch
        route = tops.gate_route(tbk, TP)
        assert route == ("ntt-unrolled" if tbk is tdk.bk_ntt_u else "tkey")
        assert _jax_route(monkeypatch, jbk, jdk.params) == route, batch


def test_port_rule(toy_ek, monkeypatch):
    """No PREP_KNOBS set: the unrolled key, routed to K3 at M = 3 (JAX's
    v3-unrolled route), at every batch size, and no slab."""
    _set_knobs(monkeypatch, {})
    tops.clear_device_key_cache()
    try:
        tdk = tops.DeviceKeys.from_evalkey(toy_ek, "cpu", with_cb=False)
    finally:
        tops.clear_device_key_cache()
    assert tdk.port_routing and tdk.bk_ntt_u is not None
    assert tdk.bk_ntt is None and tdk.bk_tk is None
    routes = {b: tops.gate_route(tdk.bk_for(b), TP)
              for b in SIZES + (48, 2048)}
    monkeypatch.setenv("IYOKAN_BR_IMPL", "v3")      # JAX's K3 route
    jdk = _jax_keys(toy_ek)
    for batch, route in routes.items():
        assert tdk.bk_for(batch) is tdk.bk_ntt_u, batch
        assert route == "v3-unrolled", batch
    assert _jax_route(monkeypatch, jdk.bkuntt, jdk.params) == "v3-unrolled"


def test_port_rule_needs_bku(toy_ek, monkeypatch):
    """A key without bku keeps JAX's default routing: the slab everywhere."""
    import dataclasses

    for k in tops.PREP_KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", "0")
    tdk = tops.DeviceKeys.from_evalkey(dataclasses.replace(toy_ek, bku=None),
                                       "cpu", with_cb=False)
    assert not tdk.port_routing and tdk.bk_ntt_u is None
    assert {tops.gate_route(tdk.bk_for(b), TP) for b in SIZES} == {"tkey"}


TK_KNOBS = ("IYOKAN_TKEY_LIMBS", "IYOKAN_TK_LB", "IYOKAN_TK_LAYOUT",
            "IYOKAN_TK_UNROLL", "IYOKAN_TK_SMALL", "IYOKAN_TK_SMALL_MAX",
            "IYOKAN_UNROLL_MAX")
# settings of TK_KNOBS (the others unset) -> the layout of the main slab and
# whether a small-batch unrolled slab is built
TK_ROWS = [
    ({}, "fat", False),
    ({"IYOKAN_TKEY_LIMBS": "4"}, "fat", False),
    ({"IYOKAN_TK_LB": "1"}, "fat", False),
    ({"IYOKAN_TK_LB": "3", "IYOKAN_TKEY_LIMBS": "4"}, "fat", False),
    ({"IYOKAN_TK_LAYOUT": "thin"}, "thin", False),
    ({"IYOKAN_TK_LAYOUT": "fat2"}, "fat2", False),
    ({"IYOKAN_TK_UNROLL": "1"}, "unrolled", False),
    ({"IYOKAN_TK_UNROLL": "1", "IYOKAN_TK_LB": "3"}, "unrolled", False),
    ({"IYOKAN_TK_UNROLL": "1", "IYOKAN_TK_LAYOUT": "fat2"}, "fat2", False),
    ({"IYOKAN_TK_SMALL": "1"}, "fat", True),
    ({"IYOKAN_TK_SMALL": "1", "IYOKAN_TK_SMALL_MAX": "16"}, "fat", True),
    ({"IYOKAN_TK_SMALL": "1", "IYOKAN_UNROLL_MAX": "16"}, "fat", True),
    ({"IYOKAN_TK_SMALL": "1", "IYOKAN_TK_UNROLL": "1"}, "unrolled", False),
    ({"IYOKAN_TK_SMALL": "1", "IYOKAN_TK_LAYOUT": "thin"}, "thin", False),
    ({"IYOKAN_TK_SMALL": "1", "IYOKAN_TKEY_LIMBS": "4",
      "IYOKAN_TK_LB": "3"}, "fat", True),
]


def _tk_knobs(monkeypatch, env):
    for k in TK_KNOBS + ("IYOKAN_NO_UNROLL", "IYOKAN_EP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", "0")


@pytest.mark.parametrize("env,layout,small", TK_ROWS,
                         ids=["-".join(f"{k[7:]}={v}" for k, v in e.items())
                              or "defaults" for e, _, _ in TK_ROWS])
def test_tkey_knobs_match_jax(toy_ek, monkeypatch, env, layout, small):
    """The key bk_for gives at each of SIZES: the JAX DeviceKeys' (a slab
    of the same shape and bytes, or the unrolled NTT key on both sides),
    and the port's tkey route reads the slab's layout."""
    from iyokan_tpu_torch.ops import tkey

    _tk_knobs(monkeypatch, env)
    jdk = jops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
    tdk = tops.DeviceKeys.from_evalkey(toy_ek, "cpu", with_cb=False)
    assert (tdk.bk_tk_small is not None) == (jdk.bk_tk_small is not None) \
        == small
    assert tkey.slab_config(tdk.bk_tk, TP)[0] == layout
    seen = set()
    for batch in SIZES:
        jbk, tbk = jdk.bk_for(batch), tdk.bk_for(batch)
        if tbk is tdk.bk_ntt_u:
            assert jbk is jdk.bkuntt and jbk is not None, batch
            continue
        assert tbk.dtype == torch.int8 and jbk.dtype == jnp.int8, batch
        assert tuple(tbk.shape) == tuple(jbk.shape), batch
        assert (tbk is tdk.bk_tk_small) == (jbk is jdk.bk_tk_small), batch
        assert tops.gate_route(tbk, TP) == "tkey"
        if id(tbk) not in seen:
            seen.add(id(tbk))
            np.testing.assert_array_equal(tbk.numpy(), np.asarray(jbk))


def test_tk_lb_zero_raises_in_both(toy_ek, monkeypatch):
    _tk_knobs(monkeypatch, {"IYOKAN_TK_LB": "0"})
    with pytest.raises(ValueError, match="IYOKAN_TK_LB"):
        jops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
    with pytest.raises(ValueError, match="IYOKAN_TK_LB"):
        tops.DeviceKeys.from_evalkey(toy_ek, "cpu", with_cb=False)


@pytest.mark.parametrize("nb,nm,cap,want", [
    # one batch of at most 16 rows goes whole (bucket 16)
    (5, 0, 2048, [16] * 5),
    # 16 + 2 * 16 = 48 bucketed rows: a 32-row chunk, then a 16-row one
    (3, 2, 2048, [32] * 3 + [32] * 2 + [16] * 2),
    (16, 16, 2048, [32] * 16 + [32] * 16 + [16] * 16),
    # 17 gates bucket to 32, 9 MUXes to 16 + 16: 64 rows, one chunk
    (17, 9, 2048, [64] * 35),
    # no gates: 2 * 16 MUX half rows
    (0, 3, 2048, [32] * 6),
    # 300 gates bucket to 512, 130 MUXes to 2 * 256: 1024 rows; cap 256
    (300, 130, 256, [256] * 300 + [256] * 130 + [256] * 130),
    # 2100 + 2 * 16 = 4096 + 32 rows: two 2048 chunks, then 32
    (2100, 16, 2048, [2048] * 2100 + [32] * 16 + [32] * 16),
    # cap <= 0: one chunk of the whole bucketed batch
    (20, 1, 0, [64] * 22),
])
def test_jax_chunk_sizes(nb, nm, cap, want):
    np.testing.assert_array_equal(ttfhe.jax_chunk_sizes(nb, nm, cap), want)


def test_jax_chunk_sizes_straddle():
    """Level sizes around the 256-row unrolled-key threshold: a 384-row
    level is a 256-row chunk (unrolled key) and a 128-row one; a
    2048 + 2 * 256-row level a 2048-row chunk and a 512-row one (plain)."""
    s = ttfhe.jax_chunk_sizes(200, 40, 2048)     # 256 + 2 * 64 = 384 rows
    np.testing.assert_array_equal(np.unique(s), [128, 256])
    assert (s[:200] == 256).all() and (s[200:] == 128).all()
    s = ttfhe.jax_chunk_sizes(2048, 130, 2048)   # 2048 + 2 * 256 rows
    assert (s[:2048] == 2048).all() and (s[2048:] == 512).all()
    s = ttfhe.jax_chunk_sizes(250, 3, 2048)      # 256 + 2 * 16 = 288 rows
    assert (s[:250] == 256).all() and (s[250:] == 32).all()


# --------------------------------------------------------------------------- #
# MAC-2 through both engines
# --------------------------------------------------------------------------- #


def _mac2_cycles(toy_sk, toy_ek, cycles, monkeypatch=None, jax_env=()):
    """MAC-2 on the port's and the JAX Frontend, one cycle at a time: the
    result ciphertexts are identical after each cycle and decrypt to the
    integers.  jax_env: (knob, value) pairs set through monkeypatch for the
    JAX Frontend's calls alone, unset for the port's.  Returns the port's
    Frontend."""

    def jax_side(on):
        for k, v in jax_env:
            if on:
                monkeypatch.setenv(k, v)
            else:
                monkeypatch.delenv(k, raising=False)

    W = 2
    av, bv = [3, 2][:cycles], [1, 3][:cycles]
    bits = {n: np.array([(v >> k) & 1 for v in vals for k in range(W)],
                        np.uint8) for n, vals in (("a", av), ("b", bv))}
    req = jpacket.PlainPacket(bits=bits).encrypt(toy_sk, seed=5)
    bp = os.path.join(DATA, f"mac{W}.toml")
    tfe = TFrontend("tfhe", TBlueprint(bp), req, eval_key=toy_ek,
                    device="cpu")
    jax_side(True)
    jfe = JFrontend("tfhe", JBlueprint(bp), req, eval_key=toy_ek)
    for c in range(cycles):
        jax_side(False)
        tfe.go(1)
        got = tfe.make_result_packet()
        jax_side(True)
        jfe.go(1)
        want = jfe.make_result_packet()
        np.testing.assert_array_equal(got.bits["acc"], want.bits["acc"])
        acc = got.decrypt(toy_sk).bits["acc"]
        assert sum(int(x) << k for k, x in enumerate(acc)) == \
            gen_mac.expected(W, av[: c + 1], bv[: c + 1], c + 1)
    jax_side(False)
    return tfe


def _ntt_unrolled_16(monkeypatch):
    """The NTT route with the unrolled key on, IYOKAN_UNROLL_MAX=16."""
    for k, v in (("IYOKAN_EP", "pallas"), ("IYOKAN_BR_IMPL", "ntt"),
                 ("IYOKAN_UNROLL_MAX", "16"), ("IYOKAN_FUSE_LEVELS", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("IYOKAN_NO_UNROLL", raising=False)


def _routes_taken(tfe, cap):
    keys = tfe.engine.keys
    assert keys.bk_ntt is not None and keys.bk_ntt_u is not None
    return {tops.gate_route(keys.bk_for(int(s)), TP)
            for pl_ in tfe.engine.c.levels
            for s in ttfhe.jax_chunk_sizes(len(pl_.bin_out),
                                           len(pl_.mux_out), cap)}


def test_mac2_unrolled_threshold_matches_jax(toy_sk, toy_ek, monkeypatch):
    """(a) the NTT route with the unrolled key at IYOKAN_UNROLL_MAX=16:
    MAC-2's levels bucket to 16 or 48 rows, and a 48-row level is a 32-row
    chunk on the plain key and a 16-row chunk on the unrolled one."""
    _ntt_unrolled_16(monkeypatch)
    monkeypatch.delenv("IYOKAN_BOOT_CHUNK", raising=False)
    tfe = _mac2_cycles(toy_sk, toy_ek, 2)
    assert _routes_taken(tfe, 2048) == {"ntt-step", "ntt-unrolled"}


def test_mac2_boot_chunk_matches_jax(toy_sk, toy_ek, monkeypatch):
    """(a) with IYOKAN_BOOT_CHUNK=16 on both engines: the JAX engine splits
    a 48-row level into three 16-row chunks, so every row takes the
    unrolled key, the rows of (a)'s 32-row chunk too."""
    _ntt_unrolled_16(monkeypatch)
    monkeypatch.setenv("IYOKAN_BOOT_CHUNK", "16")
    tfe = _mac2_cycles(toy_sk, toy_ek, 1)
    assert _routes_taken(tfe, 16) == {"ntt-unrolled"}


def test_mac2_v3_matches_jax(toy_sk, toy_ek, monkeypatch):
    """(b) IYOKAN_BR_IMPL=v3: K3 at M = 3 on every level (all are at most
    256 rows); the JAX side runs blind_rotate_pallas3 in interpret mode on
    MXU keys."""
    for k, v in (("IYOKAN_BR_IMPL", "v3"), ("IYOKAN_POLY_BACKEND", "mxu"),
                 ("IYOKAN_MM_DTYPE", "int8"),
                 ("IYOKAN_PALLAS_INTERPRET", "1"),
                 ("IYOKAN_FUSE_LEVELS", "1")):
        monkeypatch.setenv(k, v)
    for k in ("IYOKAN_EP", "IYOKAN_NO_UNROLL", "IYOKAN_UNROLL_MAX"):
        monkeypatch.delenv(k, raising=False)
    jpm._mm_dtypes.cache_clear()
    jpm._use_full_fwd.cache_clear()
    try:
        tfe = _mac2_cycles(toy_sk, toy_ek, 2)
    finally:
        jpm._mm_dtypes.cache_clear()
        jpm._use_full_fwd.cache_clear()
    assert tops.gate_route(tfe.engine.keys.bk_for(48), TP) == "v3-unrolled"


def test_mac2_tk_small_matches_jax(toy_sk, toy_ek, monkeypatch):
    """(c) IYOKAN_TK_SMALL=1, IYOKAN_TK_SMALL_MAX=16: MAC-2's levels bucket
    to 16 or 48 rows (chunks of 16 and 32), so rows take both the unrolled
    small-batch slab and the main fat slab; JAX runs pallas_tk in interpret
    mode on both."""
    _tk_knobs(monkeypatch, {"IYOKAN_TK_SMALL": "1",
                            "IYOKAN_TK_SMALL_MAX": "16"})
    for k, v in (("IYOKAN_PALLAS_INTERPRET", "1"),
                 ("IYOKAN_FUSE_LEVELS", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("IYOKAN_BOOT_CHUNK", raising=False)
    tfe = _mac2_cycles(toy_sk, toy_ek, 2)
    keys = tfe.engine.keys
    taken = {id(keys.bk_for(int(s)))
             for pl_ in tfe.engine.c.levels
             for s in ttfhe.jax_chunk_sizes(len(pl_.bin_out),
                                            len(pl_.mux_out), 2048)}
    assert taken == {id(keys.bk_tk), id(keys.bk_tk_small)}


def test_mac2_default_matches_jax_v3(toy_sk, toy_ek, monkeypatch):
    """(d) the port at its defaults (no PREP_KNOBS set: the port's rule)
    against the JAX Frontend under IYOKAN_BR_IMPL=v3 (MXU keys, its K3 in
    interpret mode): every MAC-2 level is at most 48 rows, so both run K3
    at M = 3 on the unrolled key, ciphertext for ciphertext."""
    for k in tops.PREP_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in (("IYOKAN_POLY_BACKEND", "mxu"), ("IYOKAN_MM_DTYPE", "int8"),
                 ("IYOKAN_PALLAS_INTERPRET", "1"),
                 ("IYOKAN_FUSE_LEVELS", "1")):
        monkeypatch.setenv(k, v)
    jpm._mm_dtypes.cache_clear()
    jpm._use_full_fwd.cache_clear()
    try:
        tfe = _mac2_cycles(toy_sk, toy_ek, 2, monkeypatch,
                           jax_env=(("IYOKAN_BR_IMPL", "v3"),))
    finally:
        jpm._mm_dtypes.cache_clear()
        jpm._use_full_fwd.cache_clear()
    keys = tfe.engine.keys
    assert keys.port_routing and keys.bk_tk is None
    assert ttfhe.route_counts(tfe.engine).keys() == {"levels"}
    assert set(ttfhe.route_counts(tfe.engine)["levels"]) == {"v3-unrolled"}
