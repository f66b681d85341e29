"""K7, circuit bootstrapping's lvl2 blind rotation in the torch port
(iyokan_tpu_torch.ops.br2), against the JAX package.

On the CPU the wrapper runs its plain twin `blind_rotate2_ref`; with
tolerance 0 (the results are exact integers mod 2^64) the port's
crypto/ops.blind_rotate2 must equal iyokan_tpu.crypto.ops.blind_rotate2
(the CRT64 backend, jitted) on the same seeded numpy inputs, on the plain
and the 2-bit-unrolled key, at G = 1, 3, 8.  K7's cluster form
(csrc/br2_ntt.cu) is modelled in torch: the kernel form of the key reads
back to prep2's; the rows plan (ops/br2.rows_per_cluster) gives one wave
wherever R_MAX rows a cluster allow it; and a model of the step loop,
grouped into clusters of R rows by the plan (each CTA's shared memory one
flat region: the digit rows [l2][R][N], then the sums [v][h][R][N] over
them; each key word read once a cluster-step for its R rows; the short
last cluster repeating row G - 1 and never written back; the kernel's
Montgomery arithmetic -- four products, a conditional subtract, the
fifth -- with its bounds asserted, the exchange, the unscaled inverse,
Garner per part and half) equals the twin on both key forms.  The
dispatch is held on both sides: a CPU tensor runs the twin and loads no
library; a tensor on the card reaches K7's C entry (a recording stand-in
for the ctypes library) with the launch's arguments, the plan's rows a
cluster among them, and never the twin, and a failed build or launch
raises, naming K7.  The variant specs (tools/k7_*.json) each edit their
source line exactly once.  The kernel itself is held
against the twin on the card (cuda-marked tests here, and chip_smoke.py's
K7 phase at cggi128).
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iyokan_tpu import params as jparams
from iyokan_tpu.crypto import ops as jops
from iyokan_tpu.crypto import polymul as jpm
from iyokan_tpu_torch import params as tparams
from iyokan_tpu_torch.crypto import ntt as tntt
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.crypto import polymul as tpm
from iyokan_tpu_torch.ops import br2, nvcc

TP = tparams.TOY
JP = jparams.TOY
CRT64 = jpm.CRT64Backend()
MASK32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rows(ek, unrolled):
    """The CB key rows u64 [steps, RR, 2, N2]: bk2, or bk2u as the
    unrolled key's 3*2l2 rows a step."""
    if unrolled:
        return ek.bk2u.reshape(ek.bk2u.shape[0], 6 * JP.l2, 2, JP.N2)
    return ek.bk2


def _t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


@pytest.fixture(scope="module")
def keys(toy_ek):
    """prep2 of the plain and the unrolled CB key, each with its K7 form."""
    return [br2.attach_kernel_key2(tpm.prep2(_t64(_rows(toy_ek, u)), TP), TP)
            for u in (False, True)]


def _case(G, seed):
    """Random lvl0 ciphertexts u32 [G, n+1] and per-row test vectors u64
    [G, N2]."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 32, (G, JP.n + 1), dtype=np.uint32),
            rng.integers(0, 1 << 64, (G, JP.N2), dtype=np.uint64))


# --------------------------------------------------------------------------- #
# the twin against the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("unrolled", [False, True], ids=["bk2", "bk2u"])
def test_twin_equals_jax(toy_ek, keys, monkeypatch, unrolled, G):
    """crypto/ops.blind_rotate2 on CPU tensors runs the twin once, and its
    u64 words equal the JAX package's blind_rotate2 exactly."""
    ct, testv = _case(G, 100 * unrolled + G)
    want = np.asarray(jax.jit(
        lambda t, r, tv: jops.blind_rotate2(t, CRT64.prep2(r, JP), tv, JP,
                                            CRT64))(
        jnp.asarray(ct), jnp.asarray(_rows(toy_ek, unrolled), jnp.uint64),
        jnp.asarray(testv, jnp.uint64)))
    calls = []
    real = br2.blind_rotate2_ref

    def twin(*args):
        calls.append(args[1].shape[0])
        return real(*args)

    monkeypatch.setattr(br2, "blind_rotate2_ref", twin)
    got = tops.blind_rotate2(_t32(ct), keys[unrolled], _t64(testv), TP)
    assert calls == [G]
    assert want.dtype == np.uint64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_rotation_steps_odd_n(keys):
    """The unrolled key's steps are (a1, a2, a1 + a2 mod 2N2) of each
    key-bit pair, an odd n padded with a2 = 0; the plain key's one
    amount a step."""
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.integers(0, 2 * TP.N2, (7, 4),
                                         dtype=np.int32))
    bk_u = torch.zeros((4, 6 * TP.l2, 2, 4, TP.N2), dtype=torch.int64)
    st = br2.rotation_steps(rows, bk_u, TP)
    assert st.dtype == torch.int32 and tuple(st.shape) == (4, 3, 4)
    assert torch.equal(st[:, 0], rows[0::2])
    assert torch.equal(st[:3, 1], rows[1::2]) and not st[3, 1].any()
    assert torch.equal(st[:3, 2], (rows[0::2][:3] + rows[1::2])
                       % (2 * TP.N2))
    assert torch.equal(br2.rotation_steps(rows, keys[0][:7], TP),
                       rows[:, None])


def test_bad_inputs_raise(keys):
    G = 2
    acc = torch.zeros((G, 2, TP.N2), dtype=torch.int64)
    st = torch.zeros((keys[1].shape[0], 3, G), dtype=torch.int32)
    with pytest.raises(ValueError, match="acc must be"):
        br2.br2(st, acc.to(torch.int32), keys[1], TP)
    with pytest.raises(ValueError, match="steps must be"):
        br2.br2(st[:, :1], acc, keys[1], TP)
    with pytest.raises(ValueError, match="steps must be"):
        br2.br2(st.to(torch.int64), acc, keys[1], TP)
    with pytest.raises(ValueError, match="neither"):
        br2.br2(st, acc, keys[1][:, :7], TP)
    with pytest.raises(ValueError, match="no kernel form"):
        br2.kernel_key2_of(keys[1][:2])


# --------------------------------------------------------------------------- #
# K7's cluster form (csrc/br2_ntt.cu), modelled in torch
# --------------------------------------------------------------------------- #


def _key_back2(kk, p):
    """The kernel form [S, P, 2 (u), M, l2, 2 (v), 2 (h), N2] read back to
    prep2's [S, M*2l2, 2 (v), 4 (2*prime + half), N2]: times N2 2^-32 mod
    p, rows m*2l2 + u*l2 + j."""
    S, P, _, M = kk.shape[:4]
    back = torch.stack([kk[:, i].to(torch.int64) * pow(
        tntt.key_factor(p.N2)[i], -1, prime) % prime
        for i, prime in enumerate(tntt.PRIMES)], dim=1)
    # [S, P, u, M, j, v, h, N] -> [S, M, u, j, v, P, h, N]
    return back.permute(0, 3, 2, 4, 5, 1, 6, 7).reshape(
        S, M * 2 * p.l2, 2, 2 * P, p.N2)


@pytest.mark.parametrize("which", [0, 1], ids=["bk2", "bk2u"])
def test_kernel_key2_reads_back_to_prep2(keys, which):
    """The kernel form of the plain (M = 1) and the unrolled (M = 3) key
    reads back to polymul.prep2's key bit for bit, and one step of
    extprod2 on the read-back key equals the step on prep2's key."""
    key = keys[which]
    kk = br2.kernel_key2_of(key)
    M = 1 + 2 * which
    assert kk.shape == (key.shape[0], 2, 2, M, TP.l2, 2, 2, TP.N2)
    assert kk.dtype == torch.int32 and int(kk.min()) >= 0
    back = _key_back2(kk, TP)
    assert torch.equal(back, key)
    rng = np.random.default_rng(which)
    d = torch.from_numpy(rng.integers(-128, 128, (3, 2 * M * TP.l2, TP.N2),
                                      dtype=np.int32))
    assert torch.equal(tpm.extprod2(d, back[1], TP),
                       tpm.extprod2(d, key[1], TP))


def _mont_sum5(d, k, P):
    """K7's key row sum of five products (the last dim), each below P^2:
    four summed in 64 bits, one conditional subtract of P 2^32, the fifth
    added, then csrc/ntt.cuh:mont_reduce (T 2^-32 mod P); T is kept as
    32-bit halves hi 2^32 + lo."""
    prod = d * k                                        # each < 2^62
    hi = (prod[..., :4] >> 32).sum(-1)
    lo = (prod[..., :4] & MASK32).sum(-1)
    hi, lo = hi + (lo >> 32), lo & MASK32
    assert int(hi.max()) < 2 * P                        # 4 P^2 < 2P 2^32
    hi = torch.where(hi >= P, hi - P, hi)               # T >= P 2^32
    hi = hi + (prod[..., 4] >> 32)
    lo = lo + (prod[..., 4] & MASK32)
    hi, lo = hi + (lo >> 32), lo & MASK32
    assert int(hi.max()) < 2 * P                        # T < 2P 2^32
    pinv = pow(P, -1, 1 << 32)
    pinv_s = pinv - (1 << 32) if pinv >> 31 else pinv
    m = (lo * pinv_s) & MASK32
    r = hi - ((m * P) >> 32)
    r = torch.where(r < 0, r + P, r)
    return torch.where(r >= P, r - P, r)


def _k7_model(steps, acc, bk2, p, clusters):
    """A torch model of K7's step loop at R = rows_per_cluster(G, clusters)
    rows a cluster.  Per cluster and step, CTA (prime pi, part u) holds
    one flat region of l2 R N words: it transforms part u's l2 digit rows
    of each rotated difference of its R rows in turn into [l2][R][N] and
    adds their products with the kernel-form key (each key word read once
    for the R rows, counted) into four sums a row (_mont_sum5, added mod p
    over m); the sums go over the digit rows as [v][h][R][N]; output u
    ([h][R][N] at u 2RN) takes the other part's sums of output u, runs the
    unscaled inverse of each half, and Garner with the other prime's CTA
    gives lo (at idx) and hi (idx + RN) as centred integers: acc[r][u] +=
    lo + (hi << 32) mod 2^64.  Returns (acc, key reads per word)."""
    kk = br2.kernel_key2(bk2, p).to(torch.int64)
    N, L, M = p.N2, p.l2, kk.shape[3]
    G, S = acc.shape[0], kk.shape[0]
    R = br2.rows_per_cluster(G, clusters)
    RN = R * N
    assert 4 * RN <= L * RN                     # the sums fit the region
    reads = torch.zeros(kk.shape[:7], dtype=torch.int64)
    out = acc.clone()
    for g0 in range(0, G, R):
        rows = [min(g0 + r, G - 1) for r in range(R)]   # short: repeat G-1
        a = {(pi, u): acc[rows, u].clone() for pi in range(2)
             for u in range(2)}                         # [R, N] per CTA
        for i in range(S):
            region = {}
            for pi, P in enumerate(tntt.PRIMES):
                for u in range(2):
                    x = a[pi, u]
                    sums = {}
                    for m in range(M):
                        diff = tops.rot_poly(x, steps[i, m, rows],
                                             N) - x     # [R, N], part u
                        d = tops.decompose2(torch.stack([diff, diff], 1),
                                            p)[:, :L].to(
                                                torch.int64) % P  # [R, L, N]
                        reg = torch.zeros(L * RN, dtype=torch.int64)
                        reg.view(L, R, N).copy_(
                            tntt.ntt_fwd(d, N, pi).transpose(0, 1))
                        dig = reg.view(L, R, N).permute(1, 2, 0)  # [R,N,L]
                        for vh in range(4):
                            v, h = divmod(vh, 2)
                            reads[i, pi, u, m, :, v, h] += 1
                            t = _mont_sum5(dig, kk[i, pi, u, m, :, v, h].T[
                                None], P)                # [R, N]
                            assert int(t.max()) < P
                            sums[vh] = t if m == 0 else (sums[vh] + t) % P
                    reg[:4 * RN].view(4, R, N).copy_(torch.stack(
                        [sums[vh] for vh in range(4)]))
                    region[pi, u] = reg
            for pi, P in enumerate(tntt.PRIMES):        # after barrier 1
                for u in range(2):
                    own = region[pi, u][u * 2 * RN: (u + 1) * 2 * RN]
                    add = region[pi, 1 - u][u * 2 * RN: (u + 1) * 2 * RN]
                    own.copy_(tntt.ntt_inv(((own + add) % P).view(
                        2 * R, N), N, pi).reshape(-1) * N % P)
            for pi in range(2):                         # after barrier 2
                for u in range(2):
                    r1 = region[0, u][u * 2 * RN: (u + 1) * 2 * RN]
                    r2 = region[1, u][u * 2 * RN: (u + 1) * 2 * RN]
                    lo = tntt.crt_center(r1[:RN], r2[:RN])
                    hi = tntt.crt_center(r1[RN:], r2[RN:])
                    a[pi, u] = a[pi, u] + (lo + (hi << 32)).view(R, N)
        for u in range(2):
            assert torch.equal(a[0, u], a[1, u])        # both primes agree
            for r in range(R):
                if g0 + r < G:
                    out[g0 + r, u] = a[0, u][r]
    return out, reads


def _model_case(keys, which, G, clusters):
    """The model against the twin over 3 steps at G rows on a card of
    `clusters` clusters; returns R."""
    rng = np.random.default_rng(7 + which + 10 * (G - 3))
    S, M = 3, 1 + 2 * which
    acc = _t64(rng.integers(0, 1 << 64, (G, 2, TP.N2), dtype=np.uint64))
    st = torch.from_numpy(rng.integers(0, 2 * TP.N2, (S, M, G),
                                       dtype=np.int32))
    key = keys[which][:S]
    got, reads = _k7_model(st, acc, key, TP, clusters)
    R = br2.rows_per_cluster(G, clusters)
    assert torch.equal(reads, torch.full_like(reads, -(-G // R)))
    assert torch.equal(got, br2.blind_rotate2_ref(st, acc, key, TP))
    return R


@pytest.mark.parametrize("which", [0, 1], ids=["bk2", "bk2u"])
def test_k7_model_equals_twin(keys, which):
    """The cluster-form model equals blind_rotate2_ref over 3 steps of the
    plain and the unrolled key, on random u64 accumulators and amounts, at
    G = 3 on a card of 30 clusters: one row a cluster."""
    assert _model_case(keys, which, 3, 30) == 1


@pytest.mark.parametrize("which", [0, 1], ids=["bk2", "bk2u"])
@pytest.mark.parametrize("G,clusters", [(5, 2), (7, 3), (4, 2)],
                         ids=["3+2", "3+3+1", "2+2"])
def test_k7_model_rows_a_cluster_equal_twin(keys, which, G, clusters):
    """The model at several rows a cluster equals the twin on both keys:
    R = 3 with a short last cluster (G = 5 on 2 clusters: 3 + 2; G = 7 on
    3: 3 + 3 + 1, two repeated rows) and R = 2 (G = 4 on 2); each key word
    is read once a cluster-step, not once a row."""
    R = _model_case(keys, which, G, clusters)
    assert R == -(-G // clusters)


@pytest.mark.parametrize("clusters", [30, 17])
@pytest.mark.parametrize("G", [1, 30, 31, 60, 61, 69, 90, 91, 200])
def test_rows_per_cluster(G, clusters):
    """R = min(R_MAX, ceil(G / C)): one row a cluster up to C rows, two up
    to 2C, three up to 3C, all in one wave; beyond 3C, R_MAX rows a
    cluster in ceil(ceil(G / 3) / C) waves.  At C = 30 memmac's 69 rows
    take 23 clusters of 3."""
    R = br2.rows_per_cluster(G, clusters)
    n = -(-G // R)                                  # clusters launched
    assert br2.R_MAX == 3 and 1 <= R <= br2.R_MAX and R <= G
    assert (n - 1) * R < G <= n * R                 # the last one short
    if G <= br2.R_MAX * clusters:                   # one wave, fewest rows
        assert n <= clusters and (R == 1 or -(-G // (R - 1)) > clusters)
    else:
        assert R == br2.R_MAX and n > clusters
    want = {1: 1, 30: 1, 31: 2, 60: 2, 61: 3, 69: 3, 90: 3, 91: 3, 200: 3}
    if clusters == 30:
        assert R == want[G]
        assert G != 69 or n == 23
    assert br2.rows_per_cluster(G, clusters, 1) == 1


def test_rows_per_cluster_refuses_nonsense():
    for args in ((0, 30), (5, 0), (5, 30, 0)):
        with pytest.raises(ValueError):
            br2.rows_per_cluster(*args)


# --------------------------------------------------------------------------- #
# the dispatch
# --------------------------------------------------------------------------- #


def test_cpu_tensor_runs_the_twin_and_loads_no_library(keys, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor loaded a kernel library")

    monkeypatch.setattr(nvcc, "load", refuse)
    monkeypatch.setattr(nvcc, "build", refuse)
    before = br2.LAUNCHES
    ct, testv = _case(2, 5)
    got = tops.blind_rotate2(_t32(ct), keys[1], _t64(testv), TP)
    assert br2.LAUNCHES == before and got.shape == (2, 2, TP.N2)


class _OnCard(torch.Tensor):
    """A host tensor that reports itself on the card (is_cuda), so the
    dispatch takes the kernel path where there is no card."""

    @property
    def is_cuda(self):
        return True


class _Lib:
    """A recording stand-in for the ctypes library of csrc/br2_ntt.cu: a
    card that holds `clusters` clusters at once, a library built for
    `r_max` rows a cluster.  Like the C launcher it refuses an R out of
    [1, min(G, r_max)], and records each call's grid (clusters)."""

    def __init__(self, rc=0, clusters=30, r_max=3):
        self.rc, self.calls, self.grids = rc, [], []
        self.clusters, self.r_max = clusters, r_max

    def br2_ntt(self, *args):
        G, R = args[4], args[11]
        if not 1 <= R <= min(G, self.r_max):
            return 1                                 # invalid value
        self.calls.append(args)
        self.grids.append(-(-G // R))
        return self.rc

    def br2_ntt_plan(self, N, l, M, R, device, out):
        R = R or self.r_max
        regions = 2 if R <= 2 else 1            # csrc: br2_regions
        out[0], out[1] = (16 + 8 * R + 20 * R * regions) * N, self.clusters
        out[2], out[3] = R, self.r_max
        return 0 if R <= self.r_max else 1

    def br2_error_string(self, rc):
        return b"unspecified launch failure"


def _on_card(monkeypatch, lib):
    """The host stand-ins a launch needs where there is no card: the
    library, the current stream and device."""
    monkeypatch.setattr(nvcc, "load", lambda name, bind: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def refuse(*a):
        raise AssertionError("the card path fell back to the twin")

    monkeypatch.setattr(br2, "blind_rotate2_ref", refuse)


@pytest.mark.parametrize("which", [0, 1], ids=["bk2", "bk2u"])
def test_card_tensor_reaches_k7(keys, monkeypatch, which):
    """blind_rotate2 on a tensor on the card launches K7 once (one C call
    with the launch's arguments: the accumulator's copy, the steps, the
    key's kernel form, G, S, M, N2, l2, Bgbit2 and decompose2's offset)
    and never runs the twin."""
    lib = _Lib()
    _on_card(monkeypatch, lib)
    G = 4
    ct, testv = _case(G, 9)
    tl = torch.Tensor._make_subclass(_OnCard, _t32(ct))
    assert tl.is_cuda
    before = br2.LAUNCHES
    key = keys[which]
    out = tops.blind_rotate2(tl, key, _t64(testv), TP)
    assert br2.LAUNCHES == before + 1 and len(lib.calls) == 1
    (acc_p, st_p, kk_p, tw_p, g, s, m, n2, l2, bg, off, rows, dev,
     stream) = lib.calls[0]
    assert acc_p == out.data_ptr() and kk_p == key.kernel_key.data_ptr()
    assert (g, s, m, n2, l2, bg) == (G, key.shape[0], 1 + 2 * which, TP.N2,
                                     TP.l2, TP.Bgbit2)
    assert rows == 1 and lib.grids == [G]           # G <= 30 clusters
    # decompose2's centring (Bg2/2 a level) and rounding bit, as a u64
    assert off == tops.decompose2_offset(TP) == sum(
        128 << (64 - 8 * (j + 1)) for j in range(5)) + (1 << (63 - 40))


@pytest.mark.parametrize("r_max", [3, 1])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7])
def test_card_launch_passes_the_plans_rows(keys, monkeypatch, G, r_max):
    """On a card that holds 2 clusters at once, the launch passes C the
    plan's rows a cluster, min(r_max, ceil(G / 2)) from the library's own
    R_MAX (3, or 1 in the tools/k7_rows.json variant), and C launches
    ceil(G / R) clusters: one wave up to 2 r_max rows."""
    lib = _Lib(clusters=2, r_max=r_max)
    _on_card(monkeypatch, lib)
    acc = torch.Tensor._make_subclass(_OnCard, torch.zeros(
        (G, 2, TP.N2), dtype=torch.int64))
    st = torch.zeros((keys[1].shape[0], 3, G), dtype=torch.int32)
    br2.br2(st, acc, keys[1], TP)
    R = br2.rows_per_cluster(G, 2, r_max)
    assert [c[11] for c in lib.calls] == [R] == [min(r_max, -(-G // 2))]
    assert lib.grids == [-(-G // R)]
    assert (lib.grids[0] <= 2) == (G <= 2 * r_max)


def test_card_failures_raise_naming_k7(keys, monkeypatch):
    """A failed launch and a failed build raise, naming K7; neither falls
    back to the twin."""
    _on_card(monkeypatch, _Lib(rc=719))
    ct, testv = _case(2, 11)
    tl = torch.Tensor._make_subclass(_OnCard, _t32(ct))
    with pytest.raises(RuntimeError, match="K7 .* launch failed"):
        tops.blind_rotate2(tl, keys[1], _t64(testv), TP)

    def broken(name, bind):
        raise RuntimeError(f"{name}: nvcc failed (1)")

    monkeypatch.setattr(nvcc, "load", broken)
    with pytest.raises(RuntimeError, match="K7 .* failed to build"):
        tops.blind_rotate2(tl, keys[1], _t64(testv), TP)


def test_device_keys_carry_the_kernel_form(toy_ek):
    """DeviceKeys builds the CB key's kernel form once, beside it."""
    dk = tops.DeviceKeys.from_evalkey(toy_ek, "cpu")
    assert torch.equal(br2.kernel_key2_of(dk.bk2),
                       br2.kernel_key2(dk.bk2, TP))
    assert br2.attach_kernel_key2(dk.bk2, TP).kernel_key is \
        br2.kernel_key2_of(dk.bk2)                  # not rebuilt


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("params,G,steps,M", [
    ("toy", 1, 3, 1), ("toy", 8, 3, 3), ("cggi128", 1, 2, 3),
    ("cggi128", 3, 3, 1), ("cggi128", 69, 2, 3), ("toy", 61, 2, 3),
    ("cggi128", 31, 2, 3), ("cggi128", 61, 2, 1), ("cggi128", 90, 2, 3),
    ("cggi128", 91, 2, 1)])
def test_k7_equals_twin_on_card(params, G, steps, M):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    p = tparams.by_name(params)
    rng = np.random.default_rng(G + M)
    rows = rng.integers(0, 1 << 64, (steps, 2 * p.l2 * M, 2, p.N2),
                        dtype=np.uint64)
    key = br2.attach_kernel_key2(tpm.prep2(_t64(rows).cuda(), p), p)
    acc = _t64(rng.integers(0, 1 << 64, (G, 2, p.N2),
                            dtype=np.uint64)).cuda()
    st = torch.from_numpy(rng.integers(0, 2 * p.N2, (steps, M, G),
                                       dtype=np.int32)).cuda()
    want = br2.blind_rotate2_ref(st, acc, key, p)
    before = br2.LAUNCHES
    got = br2.br2(st, acc, key, p)
    torch.cuda.synchronize()
    assert br2.LAUNCHES == before + 1
    _, clusters, _, r_max = br2.cluster_plan(p, M)
    R = br2.rows_per_cluster(G, clusters, r_max)
    assert br2.last_launch() == (4 * -(-G // R), 4, br2.THREADS, R)
    assert torch.equal(got, want)


def test_k7_threads_spec_edits_the_thread_count(tmp_path):
    """tools/k7_threads.json (chip_smoke.py's 512-thread K7 variant) edits
    exactly BR2_THREADS in a copy of csrc/br2_ntt.cu."""
    import os
    import re

    from iyokan_tpu_torch.tools import br_variants
    spec = br_variants.load_spec(os.path.join(
        os.path.dirname(nvcc.CSRC), "tools", "k7_threads.json"))
    dirs = dict(br_variants.prepare(spec, str(tmp_path)))
    assert dirs["base"] == nvcc.CSRC
    base = open(os.path.join(nvcc.CSRC, br2.SOURCE)).read()
    text = open(os.path.join(dirs["512-threads"], br2.SOURCE)).read()
    assert "constexpr int BR2_THREADS = 1024;" in base
    assert text == re.sub("constexpr int BR2_THREADS = 1024;",
                          "constexpr int BR2_THREADS = 512;", base)
    assert f"int BR2_THREADS = {br2.THREADS};" in base


def _spec_edits(name):
    """The (file text before, pattern, replacement, variant) of every edit
    of tools/<name>, each on the sources of the variant before it (as
    tools/br_variants.py applies a cumulative spec)."""
    import os

    from iyokan_tpu_torch.tools import br_variants
    spec = br_variants.load_spec(os.path.join(
        os.path.dirname(nvcc.CSRC), "tools", name))
    texts = {}
    out = []
    for variant, edits in spec.items():
        for fn, pat, rep in edits:
            if fn not in texts:
                texts[fn] = open(os.path.join(nvcc.CSRC, fn)).read()
            out.append((texts[fn], pat, rep, variant))
            texts[fn] = re.sub(pat, rep, texts[fn])
    return spec, out


@pytest.mark.parametrize("name", ["k7_threads.json", "k7_rows.json",
                                  "k7_ablation.json", "k7_forms.json"])
def test_k7_specs_match_their_source_once(name, tmp_path):
    """Every edit of the K7 variant specs matches its source exactly once
    (on the sources of the variant before it), and tools/br_variants.py
    prepares each variant as a copy of csrc/ with those edits."""
    from iyokan_tpu_torch.tools import br_variants
    spec, edits = _spec_edits(name)
    assert list(spec)[0] == "base" and not spec["base"] and edits
    for text, pat, _, variant in edits:
        assert len(re.findall(pat, text)) == 1, (variant, pat)
    dirs = dict(br_variants.prepare(spec, str(tmp_path)))
    assert dirs["base"] == nvcc.CSRC and len(dirs) == len(spec)


def test_k7_rows_spec_builds_one_row_a_cluster():
    """tools/k7_rows.json is the R_MAX = 1 variant: today's one row a
    cluster on the same source; the source's R_MAX is ops/br2.R_MAX."""
    _, edits = _spec_edits("k7_rows.json")
    (text, pat, rep, _), = edits
    assert f"constexpr int BR2_R_MAX = {br2.R_MAX};" in text
    assert re.sub(pat, rep, text) == text.replace(
        f"constexpr int BR2_R_MAX = {br2.R_MAX};",
        "constexpr int BR2_R_MAX = 1;")


def test_k7_ablation_removes_each_phase():
    """tools/k7_ablation.json takes away, one after another, the cluster
    barriers (1 and 2 as block barriers, 3 as nothing), the forward
    transforms after the digit stages, the inverse, the key reads and
    Garner's CRT (K4's tools/br_ablation.json, for K7)."""
    spec, edits = _spec_edits("k7_ablation.json")
    assert list(spec) == ["base", "no-cluster-barriers",
                          "no-forward-after-digits", "no-inverse",
                          "no-key-reads", "no-garner"]
    after = edits[-1][0]
    for _, pat, rep, _ in edits[-1:]:
        after = re.sub(pat, rep, after)
    for gone in ("cluster.sync();  // 1", "cluster.sync();  // 2",
                 "barrier.cluster.arrive;", "barrier.cluster.wait;",
                 "ntt_fwd<", "ntt_inv<", "__ldg(", "crt_pair(own"):
        assert gone not in after, gone
