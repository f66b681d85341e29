"""The torch port's two-prime NTT and CRT64 external products
(iyokan_tpu_torch.crypto.ntt / polymul) against the JAX package's
crypto/ntt.py and CRT64Backend, and the 64-bit torus helpers (decompose2,
rot_poly and sample_extract on u64 words) against jnp.uint64, bit for bit.

The JAX side is built with explicit uint64 dtypes: the JAX package allows
64-bit dtypes only where asked (iyokan_tpu/__init__.py), and jnp.asarray
without a dtype would narrow u64 inputs to u32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iyokan_tpu import params as jparams
from iyokan_tpu.crypto import ntt as jntt
from iyokan_tpu.crypto import ops as jops
from iyokan_tpu.crypto import polymul as jpm
from iyokan_tpu_torch import params as tparams
from iyokan_tpu_torch.crypto import ntt as tntt
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.crypto import polymul as tpm

TP = tparams.TOY
JP = jparams.TOY
CRT64 = jpm.CRT64Backend()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _u64_words(rng, shape):
    """Uniform u64 words (numpy's integers() stops below 2^63 for u64)."""
    return (rng.integers(0, 1 << 63, shape, dtype=np.uint64) * np.uint64(2)
            + rng.integers(0, 2, shape, dtype=np.uint64))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jcall(fn, *args):
    """fn(*args) of the JAX package, jitted whole (far quicker to compile
    on the CPU than op by op), as numpy."""
    return np.asarray(jax.jit(fn)(*args))


def test_constants_match():
    assert tntt.PRIMES == jntt.PRIMES
    assert tntt.INV_P1_MOD_P2 == jntt._INV_P1_MOD_P2
    for N in (256, 1024, 2048):
        for k in ("psirev", "psiinvrev", "ninv"):
            np.testing.assert_array_equal(tntt.tables(N)[k],
                                          jntt.tables(N)[k])


@pytest.mark.parametrize("N", [256, 1024])
@pytest.mark.parametrize("pi", [0, 1])
def test_ntt_fwd_inv_match_jax(N, pi):
    rng = np.random.default_rng(N + pi)
    x = rng.integers(0, tntt.PRIMES[pi], (3, N), dtype=np.int64)
    fwd = tntt.ntt_fwd(_t(x), N, pi)
    xj = jnp.asarray(x, jnp.int64)
    np.testing.assert_array_equal(
        fwd.numpy(), jcall(lambda v: jntt.ntt_fwd(v, N, pi), xj))
    np.testing.assert_array_equal(
        tntt.ntt_inv(_t(x), N, pi).numpy(),
        jcall(lambda v: jntt.ntt_inv(v, N, pi), xj))
    np.testing.assert_array_equal(tntt.ntt_inv(fwd, N, pi).numpy(), x)


def test_crt_center_matches_jax():
    rng = np.random.default_rng(2)
    r1 = rng.integers(0, tntt.P1, 4096, dtype=np.int64)
    r2 = rng.integers(0, tntt.P2, 4096, dtype=np.int64)
    # the edges: 0, +-1 and the largest magnitudes on both sides
    for v in (0, 1, -1, tntt.P1P2 // 2 - 1, -(tntt.P1P2 // 2)):
        r1[:1], r2[:1] = v % tntt.P1, v % tntt.P2
        got = tntt.crt_center(_t(r1), _t(r2)).numpy()
        assert got[0] == v
        np.testing.assert_array_equal(got, jcall(
            jntt.crt_center, jnp.asarray(r1, jnp.int64),
            jnp.asarray(r2, jnp.int64)))


@pytest.mark.parametrize("G", [1, 7])
def test_crt64_extprod1_matches_jax(G):
    rng = np.random.default_rng(10 + G)
    rows = rng.integers(0, 1 << 32, (2 * TP.l, 2, TP.N), dtype=np.uint32)
    d = rng.integers(-32, 32, (G, 2 * TP.l, TP.N), dtype=np.int32)
    jprep = jcall(lambda r: CRT64.prep1(r, JP), jnp.asarray(rows))
    tprep = tpm.prep1(_t(rows.view(np.int32)), TP)
    assert tprep.dtype == torch.int32
    np.testing.assert_array_equal(tprep.numpy(), jprep)
    got = tpm.extprod1(_t(d), tprep, TP).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, jcall(
        lambda x, g: CRT64.extprod1(x, g, JP), jnp.asarray(d),
        jnp.asarray(jprep)))


@pytest.mark.parametrize("RR", [2 * 5, 6 * 5])
def test_crt64_extprod2_matches_jax(RR):
    """lvl2: the plain (2l2) and the 2-bit-unrolled (3*2l2) row counts,
    digits over the full [-Bg2/2, Bg2/2) range, uniform u64 rows."""
    rng = np.random.default_rng(RR)
    rows = _u64_words(rng, (RR, 2, TP.N2))
    d = rng.integers(-128, 128, (3, RR, TP.N2), dtype=np.int32)
    jprep = jcall(lambda r: CRT64.prep2(r, JP), jnp.asarray(rows, jnp.uint64))
    tprep = tpm.prep2(_t(rows.view(np.int64)), TP)
    np.testing.assert_array_equal(tprep.numpy(), jprep)
    want = jcall(lambda x, g: CRT64.extprod2(x, g, JP), jnp.asarray(d),
                 jnp.asarray(jprep))
    assert want.dtype == np.uint64
    np.testing.assert_array_equal(
        tpm.extprod2(_t(d), tprep, TP).numpy().view(np.uint64), want)


def test_decompose2_matches_jax():
    rng = np.random.default_rng(3)
    x = _u64_words(rng, (4, 2, TP.N2))
    x[0, 0, :4] = [0, 1 << 63, (1 << 64) - 1, (1 << 63) - 1]
    want = np.asarray(jops.decompose2(jnp.asarray(x, jnp.uint64), JP))
    got = tops.decompose2(_t(x.view(np.int64)), TP)
    assert got.dtype == torch.int32 and got.shape == (4, 2 * TP.l2, TP.N2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_u64_rot_poly_and_sample_extract_match_jax():
    rng = np.random.default_rng(4)
    x = _u64_words(rng, (5, 2, TP.N2))
    r = np.array([0, 1, TP.N2 - 1, TP.N2, 2 * TP.N2 - 1], np.int32)
    want = np.asarray(jops.rot_poly(jnp.asarray(x, jnp.uint64),
                                    jnp.asarray(r)[:, None], TP.N2))
    got = tops.rot_poly(_t(x.view(np.int64)), _t(r)[:, None], TP.N2)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    for idx in (0, 3):
        want = np.asarray(jops.sample_extract2(jnp.asarray(x, jnp.uint64),
                                               idx))
        got = tops.sample_extract(_t(x.view(np.int64)), idx)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
