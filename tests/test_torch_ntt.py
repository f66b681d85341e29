"""The torch port's two-prime NTT and CRT64 external products
(iyokan_tpu_torch.crypto.ntt / polymul) against the JAX package's
crypto/ntt.py and CRT64Backend, and the 64-bit torus helpers (decompose2,
rot_poly and sample_extract on u64 words) against jnp.uint64, bit for bit.

The JAX side is built with explicit uint64 dtypes: the JAX package allows
64-bit dtypes only where asked (iyokan_tpu/__init__.py), and jnp.asarray
without a dtype would narrow u64 inputs to u32.

The NTT kernels' 32-bit arithmetic (csrc/ntt.cuh: Shoup products with the
host table's companions, Montgomery-reduced row sums) and their transform
schedule (shared-memory stage pairs, register stages with warp shuffles)
are modelled in torch int64 / numpy and held against (a b) mod p and the
plain transforms.
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


# --------------------------------------------------------------------------- #
# the NTT kernels' arithmetic and transform schedule (csrc/ntt.cuh), modelled
# in torch int64 / numpy on the CPU
# --------------------------------------------------------------------------- #

MASK32 = (1 << 32) - 1


def shoup_mul(a, w, ws, P):
    """csrc/ntt.cuh:shoup_mul: q = umulhi(a, w'), r = a w - q P (mod 2^32,
    in [0, 2P)), one conditional subtract; a < P."""
    q = (a * ws) >> 32
    r = (a * w - q * P) & MASK32
    assert int(r.max()) < 2 * P
    return torch.where(r >= P, r - P, r)


def mont_sum(a, b, P):
    """csrc/ntt.cuh:mont_reduce of the lazily summed products sum_j a_j b_j
    (the last dim, at most 4 terms, each below P^2, the sum below 2^64 kept
    as 32-bit halves): T 2^-32 mod P."""
    prod = a * b                                        # each < 2^62
    hi = (prod >> 32).sum(-1)
    lo = (prod & MASK32).sum(-1)
    hi, lo = hi + (lo >> 32), lo & MASK32               # T = hi 2^32 + lo
    assert int(hi.max()) < 2 * P                        # T < 2P 2^32
    pinv = pow(P, -1, 1 << 32)
    pinv_s = pinv - (1 << 32) if pinv >> 31 else pinv   # signed: no overflow
    m = (lo * pinv_s) & MASK32
    r = hi - ((m * P) >> 32)                            # exact, in (-P, 2P)
    r = torch.where(r < 0, r + P, r)
    return torch.where(r >= P, r - P, r)


@pytest.mark.parametrize("pi", [0, 1])
def test_kernel_product_arithmetic_model(pi):
    """The kernels' 32-bit products equal (a b) mod P on seeded random
    residues and the edges 0, 1, P - 1: Shoup with the host table's
    companions, the key form's Montgomery product (b stored as b 2^32 mod P)
    and the lazily reduced row sums of 1 to 4 terms."""
    P = tntt.PRIMES[pi]
    rng = np.random.default_rng(40 + pi)
    edges = np.array([0, 1, P - 1], np.int64)
    a = np.concatenate([rng.integers(0, P, 4000), np.repeat(edges, 3)])
    b = np.concatenate([rng.integers(0, P, 4000), np.tile(edges, 3)])
    want = torch.from_numpy(a * b % P)
    a, b = _t(a), _t(b)
    assert torch.equal(shoup_mul(a, b, _t(tntt.shoup_companion(b.numpy(), P)),
                                 P), want)
    key = (b << 32) % P                                  # Montgomery form
    assert torch.equal(mont_sum(a[:, None], key[:, None], P), want)
    for terms in (2, 3, 4):
        n = a.shape[0] // terms * terms
        aa, kk = a[:n].reshape(-1, terms), key[:n].reshape(-1, terms)
        want = (aa * b[:n].reshape(-1, terms) % P).sum(-1) % P
        assert torch.equal(mont_sum(aa, kk, P), want)
    # the largest sum the kernels form: 4 products of P - 1 by P - 1
    top = torch.full((1, 4), P - 1, dtype=torch.int64)
    assert int(mont_sum(top, (top << 32) % P, P)) == 4


@pytest.mark.parametrize("N", [64, 256, 1024])
def test_kernel_tables(N):
    """kernel_tables: twiddles and psi powers minus one with their Shoup
    companions floor(w 2^32 / p), and the key factor N^-1 2^32 mod p."""
    t = tntt.kernel_tables(N, "cpu")
    tw = t.tw.numpy().view(np.uint32).astype(np.int64)
    pw = t.pw.numpy().view(np.uint32).astype(np.int64)
    for i, P in enumerate(tntt.PRIMES):
        ref = tntt.tables(N)
        np.testing.assert_array_equal(tw[i, 0, :, 0], ref["psirev"][i])
        np.testing.assert_array_equal(tw[i, 1, :, 0], ref["psiinvrev"][i])
        np.testing.assert_array_equal(tw[i, :, :, 1],
                                      (tw[i, :, :, 0] << 32) // P)
        np.testing.assert_array_equal(pw[i, :, 0],
                                      (tntt.psi_powers(N)[i] - 1) % P)
        np.testing.assert_array_equal(pw[i, :, 1], (pw[i, :, 0] << 32) // P)
        f = tntt.key_factor(N)[i]
        assert f * N % P == (1 << 32) % P
        assert t.scale[2 * i: 2 * i + 2] == (f, (f << 32) // P)


def _next_pairs(a, b, bit):
    """csrc/ntt.cuh:next_pairs across the 32 lanes of a warp."""
    lane = np.arange(32)
    hi = ((lane >> bit) & 1).astype(bool)
    got = np.where(hi, a, b)[lane ^ (1 << bit)]
    return np.where(hi, got, a), np.where(hi, b, got)


def _ct(u, v, w, P):
    v = v * w % P
    return (u + v) % P, (u - v) % P


def _gs(u, v, w, P):
    return (u + v) % P, (u - v) * w % P


def _kernel_fwd(x, N, pi, first_lt=None):
    """csrc/ntt.cuh:ntt_fwd's schedule: shared-memory stages of span >= 64
    two at a time (residues i0 + e 2^(lt-1), e < 4, one item; the span 64
    alone where it is left over), then per warp 64 residues in registers
    (two a lane) for spans 32..1; stages above first_lt (at least 5) were
    done by the caller."""
    P, w = tntt.PRIMES[pi], tntt.tables(N)["psirev"][pi]
    logN, lane = N.bit_length() - 1, np.arange(32)
    first_lt = logN - 1 if first_lt is None else first_lt
    x, lt = x.copy(), first_lt
    while lt >= 6:
        base = 1 << (logN - 1 - lt)
        if lt >= 7:
            h, kk = 1 << (lt - 1), np.arange(N // 4)
            j = kk >> (lt - 1)
            i0 = (j << (lt + 1)) + (kk & (h - 1))
            v = [x[i0 + e * h] for e in range(4)]
            v[0], v[2] = _ct(v[0], v[2], w[base + j], P)
            v[1], v[3] = _ct(v[1], v[3], w[base + j], P)
            v[0], v[1] = _ct(v[0], v[1], w[2 * base + 2 * j], P)
            v[2], v[3] = _ct(v[2], v[3], w[2 * base + 2 * j + 1], P)
            for e in range(4):
                x[i0 + e * h] = v[e]
            lt -= 2
        else:
            k = np.arange(N // 2)
            i0 = ((k >> 6) << 7) + (k & 63)
            x[i0], x[i0 + 64] = _ct(x[i0], x[i0 + 64], w[base + (k >> 6)], P)
            lt -= 1
    for blk in range(N // 64):
        y, k = x[64 * blk: 64 * blk + 64], 32 * blk + lane
        a, b = y[lane].copy(), y[lane + 32].copy()
        for lt in range(5, -1, -1):
            if lt < 5:
                a, b = _next_pairs(a, b, lt)
            a, b = _ct(a, b, w[(1 << (logN - 1 - lt)) + (k >> lt)], P)
        y[2 * lane], y[2 * lane + 1] = a, b
    return x


def _kernel_inv(x, N, pi):
    """csrc/ntt.cuh:ntt_inv's schedule (unscaled): spans 1..32 in
    registers, then the shared-memory stages two at a time (the last
    alone where it is left over)."""
    P, w = tntt.PRIMES[pi], tntt.tables(N)["psiinvrev"][pi]
    logN, lane = N.bit_length() - 1, np.arange(32)
    x = x.copy()
    for blk in range(N // 64):
        y, k = x[64 * blk: 64 * blk + 64], 32 * blk + lane
        a, b = y[2 * lane].copy(), y[2 * lane + 1].copy()
        for lt in range(6):
            if lt:
                a, b = _next_pairs(a, b, lt - 1)
            a, b = _gs(a, b, w[(1 << (logN - 1 - lt)) + (k >> lt)], P)
        y[lane], y[lane + 32] = a, b
    lt = 6
    while lt < logN:
        base = 1 << (logN - 1 - lt)
        if lt + 1 < logN:
            t, kk = 1 << lt, np.arange(N // 4)
            j = kk >> lt
            i0 = (j << (lt + 2)) + (kk & (t - 1))
            v = [x[i0 + e * t] for e in range(4)]
            v[0], v[1] = _gs(v[0], v[1], w[base + 2 * j], P)
            v[2], v[3] = _gs(v[2], v[3], w[base + 2 * j + 1], P)
            v[0], v[2] = _gs(v[0], v[2], w[(base >> 1) + j], P)
            v[1], v[3] = _gs(v[1], v[3], w[(base >> 1) + j], P)
            for e in range(4):
                x[i0 + e * t] = v[e]
            lt += 2
        else:
            t, k = 1 << lt, np.arange(N // 2)
            i0 = ((k >> lt) << (lt + 1)) + (k & (t - 1))
            x[i0], x[i0 + t] = _gs(x[i0], x[i0 + t], w[base + (k >> lt)], P)
            lt += 1
    return x


@pytest.mark.parametrize("N", [64, 128, 256, 1024, 2048])
@pytest.mark.parametrize("pi", [0, 1])
def test_kernel_transform_schedule(N, pi):
    """The order in which csrc/ntt.cuh runs the butterflies (stage pairs in
    shared memory, the register stages' lane pairs and warp shuffles; the
    first two stages, one at N = 128, none at N = 64, done by the caller as
    br_cluster.cuh does with the digits) computes ntt_fwd, and the unscaled
    inverse times N^-1 is ntt_inv."""
    P = tntt.PRIMES[pi]
    x = np.random.default_rng(N + pi).integers(0, P, N)
    want = tntt.ntt_fwd(_t(x), N, pi).numpy()
    np.testing.assert_array_equal(_kernel_fwd(x, N, pi), want)
    logN, w = N.bit_length() - 1, tntt.tables(N)["psirev"][pi]
    if logN >= 8:     # residues c, c + N/4, c + N/2, c + 3N/4 of an item
        q = [x[e * N // 4: (e + 1) * N // 4] for e in range(4)]
        q[0], q[2] = _ct(q[0], q[2], w[1], P)
        q[1], q[3] = _ct(q[1], q[3], w[1], P)
        q[0], q[1] = _ct(q[0], q[1], w[2], P)
        q[2], q[3] = _ct(q[2], q[3], w[3], P)
        first, rest = np.concatenate(q), logN - 3
    elif logN == 7:
        first, rest = np.concatenate(_ct(x[:N // 2], x[N // 2:], w[1], P)), 5
    else:
        first, rest = x, 5
    np.testing.assert_array_equal(_kernel_fwd(first, N, pi, rest), want)
    ninv = int(tntt.tables(N)["ninv"][pi])
    np.testing.assert_array_equal(_kernel_inv(x, N, pi) * ninv % P,
                                  tntt.ntt_inv(_t(x), N, pi).numpy())
