"""The lvl1 external product of the torch port (iyokan_tpu_torch.ops.extprod)
and the lvl1 CMUX built on it, against the JAX package.

On the CPU the wrapper runs its plain twin (the CRT64 polymul.extprod1); it
must equal, bit for bit,
  * the JAX Pallas kernel K6 (ops/pallas_ep.extprod1_fused) in interpret
    mode on an MXUBackend.prep1 + prep_kernel_key key (int8 matmuls, as on
    the TPU), and the JAX CRT64Backend.extprod1;
  * per-row key selection (K = 2, the RAM write tree) row by row, with the
    index on the host (its range checked there);
  * decompose1 / extprod_term / cmux / trgsw_invert of the JAX package;
  * the NTT blind-rotation route (IYOKAN_EP=pallas, IYOKAN_BR_IMPL not
    tkey): the JAX package's exact CRT64 blind rotation, per batch and
    through the whole engine on MAC-2.
The kernel's cluster schedule (csrc/extprod1_ntt.cu: CTA (prime, part)
reduces and transforms its half of the digit rows, Montgomery sums of l
products against the prep1 key, the exchange of partials, the inverse
scaled by N^-1 2^32, Garner) is modelled in torch and equals the twin and
the JAX kernel at RR = 2l and 3*2l, K = 1 and 2, on digits at the edges.
The CUDA kernel itself is held against the twin on the card (cuda-marked
tests here, and chip_smoke.py at cggi128).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iyokan_tpu import gates
from iyokan_tpu import packet as jpacket
from iyokan_tpu import params as jparams
from iyokan_tpu.circuit.blueprint import Blueprint as JBlueprint
from iyokan_tpu.crypto import host as jhost
from iyokan_tpu.crypto import ops as jops
from iyokan_tpu.crypto import polymul as jpm
from iyokan_tpu.engine.driver import Frontend as JFrontend
from iyokan_tpu.ops import pallas_ep
from iyokan_tpu_torch import params as tparams
from iyokan_tpu_torch.circuit.blueprint import Blueprint as TBlueprint
from iyokan_tpu_torch.crypto import ntt as tntt
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.crypto import polymul as tpm
from iyokan_tpu_torch.engine.driver import Frontend as TFrontend
from iyokan_tpu_torch.ops import br, extprod

DATA = os.path.join(os.path.dirname(__file__), "data")
sys.path.insert(0, DATA)
import gen_mac  # noqa: E402

TP = tparams.TOY
JP = jparams.TOY
CRT64 = jpm.CRT64Backend()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def mxu_int8(monkeypatch):
    """The JAX MXUBackend as on the TPU (int8 operands, s32 accumulation):
    its bf16 default fails in XLA:CPU's dot."""
    monkeypatch.setenv("IYOKAN_MM_DTYPE", "int8")
    jpm._mm_dtypes.cache_clear()
    jpm._use_full_fwd.cache_clear()
    yield jpm.MXUBackend()
    jpm._mm_dtypes.cache_clear()
    jpm._use_full_fwd.cache_clear()


@pytest.fixture()
def ntt_route(monkeypatch):
    """Gate blind rotations on the NTT route, in both packages, with the
    2-bit-unrolled small-batch key on, as by default (batches of at most
    256 rows take it in both)."""
    monkeypatch.setenv("IYOKAN_EP", "pallas")
    monkeypatch.setenv("IYOKAN_BR_IMPL", "ntt")
    monkeypatch.delenv("IYOKAN_NO_UNROLL", raising=False)
    monkeypatch.delenv("IYOKAN_UNROLL_MAX", raising=False)
    monkeypatch.setenv("IYOKAN_FUSE_LEVELS", "1")


def _t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def jcall(fn, *args):
    """fn(*args) of the JAX package, jitted whole (far quicker to compile
    on the CPU than op by op), as numpy."""
    return np.asarray(jax.jit(fn)(*args))


def _inputs(seed, G, K=1, N=TP.N, l=TP.l):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, (K, 2 * l, 2, N), dtype=np.uint32)
    d = rng.integers(-32, 32, (G, 2 * l, N), dtype=np.int32)
    return rows, d, rng


# --------------------------------------------------------------------------- #
# the twin
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("G", [1, 8, 70])
def test_twin_equals_k6_interpret(mxu_int8, G):
    rows, d, _ = _inputs(G, G)
    key = pallas_ep.prep_kernel_key(mxu_int8.prep1(jnp.asarray(rows), JP),
                                    JP.N)[0]
    want = np.asarray(pallas_ep.extprod1_fused(jnp.asarray(d), key, JP,
                                               interpret=True))
    np.testing.assert_array_equal(want, jcall(
        lambda x, r: CRT64.extprod1(x, CRT64.prep1(r, JP), JP),
        jnp.asarray(d), jnp.asarray(rows[0])))
    got = extprod.extprod1(torch.from_numpy(d), tpm.prep1(_t32(rows), TP),
                           None, TP)
    np.testing.assert_array_equal(_u32(got), want)


def test_twin_key_index():
    """K = 2, mixed indices: row g takes key idx[g]."""
    rows, d, rng = _inputs(3, 9, K=2)
    idx = rng.integers(0, 2, 9).astype(np.int32)
    idx[:2] = [0, 1]
    want = jcall(lambda x, r: CRT64.extprod1(x, CRT64.prep1(r, JP)[idx], JP),
                 jnp.asarray(d), jnp.asarray(rows))
    got = extprod.extprod1(torch.from_numpy(d), tpm.prep1(_t32(rows), TP),
                           torch.from_numpy(idx), TP)
    np.testing.assert_array_equal(_u32(got), want)


def test_bad_inputs_raise():
    rows, d, _ = _inputs(4, 3, K=2)
    keys = tpm.prep1(_t32(rows), TP)
    dd = torch.from_numpy(d)
    with pytest.raises(ValueError, match="needs idx"):
        extprod.extprod1(dd, keys, None, TP)
    with pytest.raises(ValueError, match="out of range"):
        extprod.extprod1(dd, keys, torch.tensor([0, 1, 2], dtype=torch.int32),
                         TP)
    with pytest.raises(ValueError, match="int32"):
        extprod.extprod1(dd.to(torch.int64), keys[:1], None, TP)
    with pytest.raises(ValueError, match="keys must be"):
        extprod.extprod1(dd[:, :5], keys[:1], None, TP)


@pytest.mark.parametrize("bad", [-1, 2])
def test_host_index_out_of_range_raises(bad):
    """An index on the host is checked there: out of [0, K) raises, through
    extprod1 and through the CMUX the RAM write tree calls."""
    rows, d, _ = _inputs(5, 3, K=2)
    keys = tpm.prep1(_t32(rows), TP)
    idx = torch.tensor([0, bad, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="out of range"):
        extprod.extprod1(torch.from_numpy(d), keys, idx, TP)
    c = torch.zeros((3, 2, TP.N), dtype=torch.int32)
    with pytest.raises(ValueError, match="out of range"):
        tops.cmux(keys, c, c, TP, idx=idx)


# --------------------------------------------------------------------------- #
# the kernel's cluster schedule, modelled in torch
# --------------------------------------------------------------------------- #


def _ep_cluster(digits, keys, idx, p):
    """A torch model of csrc/extprod1_ntt.cu: CTA (prime pi, part u) takes
    digit rows m*2l + u*l + j as residues, transforms them, forms the
    partial products of both outputs v against the prep1 key (a Montgomery
    sum of l products per m: x 2^-32), takes the other part's partial of
    its output u, runs the unscaled inverse and scales it by N^-1 2^32
    (Shoup, the host table's companion); Garner with the other prime's
    CTA gives out[g, u]."""
    from tests.test_torch_ntt import mont_sum, shoup_mul

    G, RR, N = digits.shape
    l, M = p.l, RR // (2 * p.l)
    k = keys[idx.long() if idx is not None else torch.zeros(G, dtype=int)]
    k = k.to(torch.int64) & tops.MASK32                # [G, RR, 2, P, N]
    d = digits.to(torch.int64)
    scale = tntt.kernel_tables(N, "cpu").scale
    res = []
    for pi, P in enumerate(tntt.PRIMES):
        part = []
        for u in range(2):
            rows = [m * 2 * l + u * l + j for m in range(M) for j in range(l)]
            x = d[:, rows]
            dig = tntt.ntt_fwd(torch.where(x < 0, x + P, x), N, pi)
            sums = []
            for v in range(2):
                sv = 0
                for m in range(M):
                    sl = slice(m * l, (m + 1) * l)
                    t = mont_sum(dig[:, sl].transpose(1, 2),
                                 k[:, rows[sl], v, pi].transpose(1, 2), P)
                    sv = (sv + t) % P
                sums.append(sv)
            part.append(sums)
        res.append([shoup_mul(tntt.ntt_inv((part[u][u] + part[1 - u][u]) % P,
                                           N, pi) * N % P,
                              scale[2 * pi], scale[2 * pi + 1], P)
                    for u in range(2)])
    out = [tntt.crt_center(res[0][u], res[1][u]) for u in range(2)]
    return tops.from_u64(torch.stack(out, dim=1))


def _edge_digits(rng, G, RR, Bg, N=TP.N):
    """Random digits in [-Bg/2, Bg/2] with whole rows and runs at the edges
    -Bg/2, 0 and Bg/2."""
    d = rng.integers(-Bg // 2, Bg // 2 + 1, (G, RR, N)).astype(np.int32)
    for r, e in zip(range(RR), (-Bg // 2, 0, Bg // 2)):
        d[:, r] = e
    d[:, :, : N // 4] = -Bg // 2
    d[0, RR - 1, N // 2:] = Bg // 2
    return d


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("G", [1, 8, 70])
@pytest.mark.parametrize("RR", [6, 18])
def test_cluster_model_equals_twin_and_k6_interpret(mxu_int8, RR, G, K):
    """The cluster-form model == extprod1_ref (K = 2: mixed indices on the
    host) == pallas_ep.extprod1_fused in interpret mode, row by row of its
    key, at RR = 2l and 3*2l, on digits at the edges -Bg/2, 0, Bg/2."""
    rng = np.random.default_rng(RR * 100 + G * 3 + K)
    rows = rng.integers(0, 1 << 32, (K, RR, 2, TP.N), dtype=np.uint32)
    d = _edge_digits(rng, G, RR, 1 << TP.Bgbit)
    idx = None
    if K > 1:
        pol = rng.integers(0, K, G).astype(np.int32)
        pol[: min(G, 2)] = [1, 0][: min(G, 2)]
        idx = torch.from_numpy(pol)
    keys = tpm.prep1(_t32(rows), TP)
    got = _ep_cluster(torch.from_numpy(d), keys, idx, TP)
    assert torch.equal(got, extprod.extprod1(torch.from_numpy(d), keys, idx,
                                             TP))
    jkey = pallas_ep.prep_kernel_key(mxu_int8.prep1(jnp.asarray(rows), JP),
                                     JP.N)
    fused = jax.jit(lambda x, k: pallas_ep.extprod1_fused(x, k, JP,
                                                          interpret=True))
    want = np.stack([np.asarray(fused(jnp.asarray(d), jkey[k]))
                     for k in range(K)])
    want = want[0] if idx is None else want[idx.numpy(), np.arange(G)]
    np.testing.assert_array_equal(_u32(got), want)


# --------------------------------------------------------------------------- #
# the lvl1 CMUX
# --------------------------------------------------------------------------- #


def test_cmux_ops_match_jax(toy_sk):
    rng = np.random.default_rng(11)
    trgsw = np.stack([jhost.trgsw1_encrypt(toy_sk, m, rng) for m in (0, 1)])
    c1 = rng.integers(0, 1 << 32, (2, 3, 2, JP.N), dtype=np.uint32)
    c0 = rng.integers(0, 1 << 32, (2, 3, 2, JP.N), dtype=np.uint32)
    np.testing.assert_array_equal(
        tops.decompose1(_t32(c1), TP).numpy(),
        jcall(lambda x: jops.decompose1(x, JP), jnp.asarray(c1)))
    np.testing.assert_array_equal(
        _u32(tops.trgsw_invert(_t32(trgsw), TP)),
        jcall(lambda g: jops.trgsw_invert(g, JP), jnp.asarray(trgsw)))
    jprep = jcall(lambda g: CRT64.prep1(g, JP), jnp.asarray(trgsw))
    tprep = tops.prep_trgsw(_t32(trgsw), TP)       # [2, 2l, 2, P, N]
    np.testing.assert_array_equal(tprep.numpy(), jprep)
    jcmux = jax.jit(lambda g, a, b: jops.cmux(g, a, b, JP, CRT64))
    for m in (0, 1):
        want = np.asarray(jcmux(jprep[m], c1, c0))
        np.testing.assert_array_equal(
            _u32(tops.cmux(tprep[m], _t32(c1), _t32(c0), TP)), want)
    # per-row keys over the leading dims (the RAM write tree's K = 2)
    idx = np.array([[0, 1, 1], [1, 0, 0]], np.int32)
    want = np.asarray(jcmux(jprep[idx], c1, c0))
    got = tops.cmux(tprep, _t32(c1), _t32(c0), TP,
                    idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(_u32(got), want)


# --------------------------------------------------------------------------- #
# the NTT blind-rotation route
# --------------------------------------------------------------------------- #


def test_ntt_route_blind_rotate_matches_jax(toy_sk, toy_ek, ntt_route):
    """Both keys of the route: the plain key (batches over 256 rows, one
    extprod1 per step) and the 2-bit-unrolled key (up to 256 rows, one
    3*2l-row extprod1 per key-bit pair)."""
    dk = tops.DeviceKeys.from_evalkey(toy_ek, "cpu", with_cb=False)
    assert dk.bk_tk is None and dk.bk_for(257) is dk.bk_ntt
    assert dk.bk_for(256) is dk.bk_ntt_u
    rng = np.random.default_rng(12)
    a = np.array([0, 0, 1, 1, 1], np.uint8)
    b = np.array([0, 1, 0, 1, 1], np.uint8)
    A = _t32(jhost.encrypt_bits(toy_sk, a, rng))
    B = _t32(jhost.encrypt_bits(toy_sk, b, rng))
    ca, cb, k = (torch.full((5,), c, dtype=torch.int32)
                 for c in gates.GATE_LIN[gates.NAND])
    pre = tops.gate_linear(A, B, ca, cb, k, TP)
    testv = np.full(JP.N, JP.mu, np.uint32)
    bku = toy_ek.bku.reshape(toy_ek.bku.shape[0], 6 * JP.l, 2, JP.N)
    for jkey, batch in ((toy_ek.bk, 257), (bku, 5)):
        want = jcall(
            lambda t, bk, tv: jops.blind_rotate(t, CRT64.prep1(bk, JP), tv,
                                                JP, CRT64),
            _u32(pre), jkey, testv)
        got = tops.blind_rotate(pre, dk.bk_for(batch), _t32(testv), TP)
        np.testing.assert_array_equal(_u32(got), want)
        out = tops.keyswitch_10(tops.sample_extract(got, 0), dk.ksk_f64, TP)
        np.testing.assert_array_equal(jhost.decrypt_bits(toy_sk, _u32(out)),
                                      1 - (a & b))


def test_ntt_route_engine_matches_jax(toy_sk, toy_ek, ntt_route):
    """MAC-2 for 2 cycles: the port's engine on the NTT route and the JAX
    engine on its exact CRT64 route give identical ciphertexts."""
    W, cycles = 2, 2
    av, bv = [3, 2], [1, 3]
    bits = {n: np.array([(v >> k) & 1 for v in vals for k in range(W)],
                        np.uint8) for n, vals in (("a", av), ("b", bv))}
    req = jpacket.PlainPacket(bits=bits).encrypt(toy_sk, seed=2)
    bp = os.path.join(DATA, f"mac{W}.toml")
    tfe = TFrontend("tfhe", TBlueprint(bp), req, eval_key=toy_ek,
                    device="cpu")
    assert tfe.engine.keys.bk_ntt is not None
    tfe.go(cycles)
    jfe = JFrontend("tfhe", JBlueprint(bp), req, eval_key=toy_ek)
    jfe.go(cycles)
    got = tfe.make_result_packet()
    np.testing.assert_array_equal(got.bits["acc"],
                                  jfe.make_result_packet().bits["acc"])
    acc = got.decrypt(toy_sk).bits["acc"]
    assert sum(int(x) << k for k, x in enumerate(acc)) == \
        gen_mac.expected(W, av, bv, cycles)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("params,G,K", [
    ("toy", 1, 1), ("toy", 8, 2), ("toy", 130, 1),
    ("cggi128", 1, 1), ("cggi128", 33, 2), ("cggi128", 1024, 1)])
def test_kernel_equals_twin_on_card(params, G, K):
    _card()
    p = tparams.by_name(params)
    rows, d, rng = _inputs(G + K, G, K=K, N=p.N, l=p.l)
    keys = tpm.prep1(_t32(rows).cuda(), p)
    dd = torch.from_numpy(d).cuda()
    idx = None
    if K > 1:
        idx = torch.from_numpy(rng.integers(0, K, G).astype(np.int32)).cuda()
    before = extprod.LAUNCHES
    got = extprod.extprod1(dd, keys, idx, p)
    assert extprod.LAUNCHES == before + 1
    want = extprod.extprod1_ref(dd, keys, idx, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("RR", [6, 18])
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("G", [1, 8, 63, 64, 1024, 2048])
def test_cluster_kernel_equals_twin_at_cggi128(G, K, RR):
    """K6 at cggi128, one cluster of four CTAs a row (512 or 256 threads by
    the card's cap at that RR), == the twin on edge digits; K = 2 with a
    host index."""
    _card()
    p = tparams.CGGI128
    rng = np.random.default_rng(G * 7 + K + RR)
    rows = rng.integers(0, 1 << 32, (K, RR, 2, p.N), dtype=np.uint32)
    d = torch.from_numpy(_edge_digits(rng, G, RR, 1 << p.Bgbit, p.N)).cuda()
    keys = tpm.prep1(_t32(rows).cuda(), p)
    idx = None if K == 1 else torch.from_numpy(
        rng.integers(0, K, G).astype(np.int32))
    before = extprod.LAUNCHES
    got = extprod.extprod1(d, keys, idx, p)
    want = extprod.extprod1_ref(d, keys, idx, p)
    torch.cuda.synchronize()
    assert extprod.LAUNCHES == before + 1
    cap = extprod.cluster_plan(p, RR, br.NARROW_THREADS)[1]
    assert extprod.last_launch() == (br.CLUSTER * G, br.CLUSTER,
                                     br.threads_for(G, cap))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_memory_engine_on_card_equals_cpu(toy_sk, toy_ek):
    """tiny-ram for 2 cycles: the port on the card (both kernels) gives
    the CPU run's ciphertexts and RAM stores, bit for bit."""
    _card()
    from iyokan_tpu_torch.ops import tkey

    init = np.zeros(16, np.uint8)
    init[12:16] = 1
    req = jpacket.PlainPacket(ram={"ramA": init}, bits={
        "addr": np.array([0, 1, 1, 1], np.uint8),
        "wren": np.array([1, 0], np.uint8),
        "wdata": np.array([1, 1, 0, 1, 0, 0, 0, 0], np.uint8)}).encrypt(
        toy_sk, seed=4)
    bp = os.path.join(DATA, "tiny-ram.toml")
    res = {}
    for dev in ("cpu", "cuda"):
        before = (tkey.LAUNCHES, extprod.LAUNCHES)
        fe = TFrontend("tfhe", TBlueprint(bp), req, eval_key=toy_ek,
                       device=dev)
        fe.go(2)
        res[dev] = fe.make_result_packet()
        grew = (tkey.LAUNCHES > before[0], extprod.LAUNCHES > before[1])
        assert grew == ((dev == "cuda"),) * 2
    np.testing.assert_array_equal(res["cuda"].bits["rdata"],
                                  res["cpu"].bits["rdata"])
    np.testing.assert_array_equal(res["cuda"].ram["ramA"],
                                  res["cpu"].ram["ramA"])
