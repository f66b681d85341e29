"""Torch gate-path ops (iyokan_tpu_torch.crypto.ops) against the JAX ones.

Same numpy inputs (full-range u32 words, so bit 31 is set in about half of
them) through iyokan_tpu.crypto.ops and its torch counterpart; results must
be bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iyokan_tpu import gates
from iyokan_tpu.crypto import ops as jops
from iyokan_tpu_torch import params as tparams
from iyokan_tpu_torch.crypto import ops as tops


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def _t(a):
    return tops.u32_tensor(a, "cpu")


def _same(got_t, want_j):
    np.testing.assert_array_equal(tops.u32_numpy(got_t), np.asarray(want_j))


def test_u32_roundtrip():
    a = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = _t(a)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tops.u32_numpy(t), a)
    v = tops.to_u64(t)
    assert int(v.min()) >= 0 and int(v.max()) == 0xFFFFFFFF
    assert torch.equal(tops.from_u64(v + (5 << 32)), t)


@pytest.mark.parametrize("seed", [0, 1])
def test_modswitch(toy, seed):
    rng = np.random.default_rng(seed)
    x = _u32(rng, (7, toy.n + 1))
    x[0, :4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    got = tops._modswitch(_t(x), toy.logN)
    want = jops._modswitch(jnp.asarray(x), toy.logN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_rot_poly(toy, seed):
    rng = np.random.default_rng(seed)
    poly = _u32(rng, (9, toy.N))
    r = rng.integers(0, 2 * toy.N, 9).astype(np.int32)
    r[:3] = [0, toy.N, 2 * toy.N - 1]
    got = tops.rot_poly(_t(poly), torch.from_numpy(r), toy.N)
    want = jops.rot_poly(jnp.asarray(poly), jnp.asarray(r), toy.N)
    _same(got, want)


@pytest.mark.parametrize("idx", [0, 5, 255])
def test_sample_extract(toy, idx):
    rng = np.random.default_rng(idx)
    trlwe = _u32(rng, (4, 2, toy.N))
    got = tops.sample_extract(_t(trlwe), idx)
    want = jops.sample_extract(jnp.asarray(trlwe), idx)
    _same(got, want)


def test_ks_digits(toy):
    rng = np.random.default_rng(2)
    a = _u32(rng, (3, toy.N))
    got = tops._ks_digits(_t(a), toy.ks_t, toy.ks_basebit)
    want = jops._ks_digits(jnp.asarray(a), toy.ks_t, toy.ks_basebit, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_keyswitch_10(toy, toy_ek):
    """Both key forms (i32 bit patterns and the float64 copy) equal the JAX
    key switch on the u32 key (bf16 limb matmuls on the CPU)."""
    rng = np.random.default_rng(4)
    tlwe1 = _u32(rng, (6, toy.N + 1))
    key = toy_ek.ksk.reshape(toy.N * toy.ks_t, toy.n + 1)
    want = jops.keyswitch_10(jnp.asarray(tlwe1), jnp.asarray(key), toy)
    kt = _t(key)
    _same(tops.keyswitch_10(_t(tlwe1), kt, tparams.TOY), want)
    _same(tops.keyswitch_10(_t(tlwe1), kt.to(torch.float64), tparams.TOY),
          want)


@pytest.mark.parametrize("kind", gates.BINARY_KINDS)
def test_gate_linear(toy, kind):
    rng = np.random.default_rng(kind)
    A = _u32(rng, (5, toy.n + 1))
    B = _u32(rng, (5, toy.n + 1))
    ca, cb, k = (np.full(5, c, np.int32) for c in gates.GATE_LIN[kind])
    got = tops.gate_linear(_t(A), _t(B), torch.from_numpy(ca),
                           torch.from_numpy(cb), torch.from_numpy(k),
                           tparams.TOY)
    want = jops.gate_linear(jnp.asarray(A), jnp.asarray(B), jnp.asarray(ca),
                            jnp.asarray(cb), jnp.asarray(k), toy)
    _same(got, want)


def test_hom_not(toy):
    c = _u32(np.random.default_rng(8), (4, toy.n + 1))
    c[0, 0] = 0x80000000
    _same(tops.hom_not(_t(c)), jops.hom_not(jnp.asarray(c)))
