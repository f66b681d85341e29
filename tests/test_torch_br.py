"""The NTT blind-rotation kernels of the torch port (iyokan_tpu_torch.ops.br:
K5 and K4; ops.br3: K3), against the JAX package.

On the CPU each wrapper runs its plain twin; with tolerance 0 (the results
are exact integers mod 2^32) it must equal
  * K5 / K4: the JAX kernels blind_rotate_pallas (ops/pallas_br.py) and
    blind_rotate_pallas2 (ops/pallas_br2.py) in interpret mode on an
    MXUBackend.prep1 key (int8 matmuls, as on the TPU), and JAX's CRT64
    XLA blind_rotate, at G = 1, 8, 13;
  * K3: blind_rotate_pallas3 (ops/pallas_br3.py) in interpret mode on the
    MXU plain key (M = 1) and 2-bit-unrolled key (M = 3), with
    IYOKAN_BR3_TW12 unset and "vpu" (an arithmetic variant of the JAX
    kernel with the same result; the port does not read it), and at an odd
    n, where the last key-bit pair is padded.
K3/K4's cluster form (csrc/br_cluster.cuh) is modelled in torch: the
kernel form of the key reads back to prep1's, a model of the step loop
(per-(prime, part) partials from the kernel-form key with the kernels'
Montgomery and Shoup arithmetic, the exchange, the unscaled inverse,
Garner per part) equals the twins and, through them, the JAX kernels, and
the threads-a-CTA plan covers every batch.  The CUDA kernels are held
against the twins on the card (cuda-marked tests here, and chip_smoke.py
at cggi128).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iyokan_tpu import params as jparams
from iyokan_tpu.crypto import host as jhost
from iyokan_tpu.crypto import ops as jops
from iyokan_tpu.crypto import polymul as jpm
from iyokan_tpu.ops import pallas_br, pallas_br2, pallas_br3
from iyokan_tpu_torch import params as tparams
from iyokan_tpu_torch.crypto import ntt as tntt
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.crypto import polymul as tpm
from iyokan_tpu_torch.ops import br, br3, nvcc

TP = tparams.TOY
JP = jparams.TOY
CRT64 = jpm.CRT64Backend()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mxu_keys(toy_ek):
    """The bootstrapping key and the 2-bit-unrolled key in the JAX
    MXUBackend.prep1 layout (four 16-bit primes, the TPU's slot order), as
    the mxu_bk / mxu_bku fixtures of tests/test_br3.py build them, and the
    JAX kernels in interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IYOKAN_MM_DTYPE", "int8")
        mp.setenv("IYOKAN_PALLAS_INTERPRET", "1")
        jpm._mm_dtypes.cache_clear()
        jpm._use_full_fwd.cache_clear()
        be = jpm.MXUBackend()
        prep = jax.jit(lambda b: be.prep1(b, JP))
        yield prep(jnp.asarray(toy_ek.bk)), prep(jnp.asarray(_bku(toy_ek)))
    jpm._mm_dtypes.cache_clear()
    jpm._use_full_fwd.cache_clear()


@pytest.fixture(scope="module")
def port_keys(toy_ek):
    """The port's CRT64 prep1 plain and unrolled keys."""
    return (tpm.prep1(_t32(toy_ek.bk), TP), tpm.prep1(_t32(_bku(toy_ek)), TP))


def _bku(ek):
    return ek.bku.reshape(ek.bku.shape[0], 6 * JP.l, 2, JP.N)


def _t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def jcall(fn, *args):
    """fn(*args) of the JAX package, jitted whole, as numpy."""
    return np.asarray(jax.jit(fn)(*args))


def _batch(sk, G, seed):
    rng = np.random.default_rng(seed)
    return jhost.encrypt_bits(sk, rng.integers(0, 2, G, dtype=np.uint8), rng)


def _testv(p):
    return np.full(p.N, p.mu, np.uint32)


# --------------------------------------------------------------------------- #
# K5 and K4
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kernel", ["pallas", "pallas2"])
@pytest.mark.parametrize("G", [1, 8, 13])
def test_cmux_twin_equals_jax_kernel(toy_sk, toy_ek, mxu_keys, port_keys,
                                     kernel, G):
    """K5 (one launch per step) and K4 (one launch in all) against the JAX
    kernel in interpret mode and JAX's CRT64 XLA blind rotation."""
    ct = _batch(toy_sk, G, 100 + G)
    tv = _testv(JP)
    jfn = (pallas_br.blind_rotate_pallas if kernel == "pallas"
           else pallas_br2.blind_rotate_pallas2)
    want = jcall(lambda t, bk: jfn(t, bk, jnp.asarray(tv), JP), ct,
                 mxu_keys[0])
    np.testing.assert_array_equal(want, jcall(
        lambda t, bk: jops.blind_rotate(t, CRT64.prep1(bk, JP),
                                        jnp.asarray(tv), JP, CRT64),
        ct, toy_ek.bk))
    tfn = (br.blind_rotate_pallas if kernel == "pallas"
           else br.blind_rotate_pallas2)
    np.testing.assert_array_equal(
        _u32(tfn(_t32(ct), port_keys[0], _t32(tv), TP)), want)


def test_cmux_step_twin_is_one_step_of_the_loop(port_keys):
    """br_step (the whole key and a step index) is one step of br_loop, on
    random accumulators."""
    rng = np.random.default_rng(5)
    acc = _t32(rng.integers(0, 1 << 32, (3, 2, TP.N), dtype=np.uint32))
    rows = torch.from_numpy(rng.integers(0, 2 * TP.N, (2, 3),
                                         dtype=np.int32))
    bk = port_keys[0][:2].contiguous()
    step = br.br_step(br.br_step(acc, rows[0], bk, 0, TP), rows[1], bk, 1, TP)
    assert torch.equal(step, br.br_loop(rows, acc, bk, TP))
    assert torch.equal(step, br.cmux_steps_ref(rows, acc, bk, TP))


@pytest.mark.parametrize("first,S", [(0, 64), (5, 3), (63, 1)])
def test_br_steps_equal_twin(port_keys, first, S):
    """br_steps over the key's steps first .. first + S - 1 (one K5 launch
    a step on the card) equals cmux_steps_ref on those steps and S calls of
    br_step."""
    rng = np.random.default_rng(first + S)
    acc = _t32(rng.integers(0, 1 << 32, (4, 2, TP.N), dtype=np.uint32))
    rows = torch.from_numpy(rng.integers(0, 2 * TP.N, (S, 4),
                                         dtype=np.int32))
    bk = port_keys[0]
    got = br.br_steps(rows, acc, bk, TP, first=first)
    assert torch.equal(got, br.cmux_steps_ref(rows, acc,
                                              bk[first: first + S], TP))
    step = acc
    for i in range(S):
        step = br.br_step(step, rows[i], bk, first + i, TP)
    assert torch.equal(step, got)


def test_br_steps_rotation_equals_jax_kernel(toy_sk, mxu_keys, port_keys):
    """K5's whole rotation, br_steps over all n steps from the set-up, equals
    the JAX kernel (pallas_br.blind_rotate_pallas, its fori_loop of n
    launches) in interpret mode."""
    from iyokan_tpu_torch.ops.tkey import _setup

    ct = _batch(toy_sk, 5, 44)
    tv = _testv(JP)
    want = jcall(lambda t, bk: pallas_br.blind_rotate_pallas(
        t, bk, jnp.asarray(tv), JP), ct, mxu_keys[0])
    rows, acc = _setup(_t32(ct), _t32(tv), TP)
    np.testing.assert_array_equal(
        _u32(br.br_steps(rows, acc, port_keys[0], TP)), want)


def test_br_steps_bad_inputs_raise(port_keys):
    """A key step sliced off the key, a range past its end or a negative
    step index raise."""
    acc = torch.zeros((2, 2, TP.N), dtype=torch.int32)
    rows = torch.zeros((3, 2), dtype=torch.int32)
    bk = port_keys[0]
    with pytest.raises(ValueError, match="key must be"):
        br.br_step(acc, rows[0], bk[0], 0, TP)
    with pytest.raises(ValueError, match="rotation amounts"):
        br.br_steps(rows, acc, bk, TP, first=TP.n - 2)
    with pytest.raises(ValueError, match="step index"):
        br.br_step(acc, rows[0], bk, -1, TP)


def test_cmux_bad_inputs_raise(port_keys):
    acc = torch.zeros((2, 2, TP.N), dtype=torch.int32)
    rows = torch.zeros((TP.n, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="rotation amounts"):
        br.br_loop(rows[:3], acc, port_keys[0], TP)
    with pytest.raises(ValueError, match="key must be"):
        br.br_loop(rows[:32], acc, port_keys[1], TP)
    with pytest.raises(ValueError, match="acc must be"):
        br.br_loop(rows, acc.to(torch.int64), port_keys[0], TP)
    with pytest.raises(ValueError, match="contiguous"):
        br.br_loop(rows[:, :1], acc[:1], port_keys[0].transpose(3, 4)
                   .contiguous().transpose(3, 4), TP)


# --------------------------------------------------------------------------- #
# K3
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tw12", ["", "vpu"])
@pytest.mark.parametrize("M", [1, 3])
def test_v3_twin_equals_jax_kernel(toy_sk, mxu_keys, port_keys, monkeypatch,
                                   M, tw12):
    """K3 on the plain (M = 1) and the unrolled key (M = 3); TW12 changes
    the JAX kernel's arithmetic but not its result."""
    monkeypatch.setenv("IYOKAN_BR3_TW12", tw12)
    ct = _batch(toy_sk, 13, 7 + M)
    tv = _testv(JP)
    k = 0 if M == 1 else 1
    want = jcall(lambda t, bk: pallas_br3.blind_rotate_pallas3(
        t, bk, jnp.asarray(tv), JP), ct, mxu_keys[k])
    before = br3.LAUNCHES
    got = br3.blind_rotate_pallas3(_t32(ct), port_keys[k], _t32(tv), TP)
    assert br3.LAUNCHES == before                  # the twin, on the CPU
    np.testing.assert_array_equal(_u32(got), want)


def test_unrolled_routes_odd_n(mxu_keys, monkeypatch):
    """An odd n (9 key bits: 5 pair steps, the last with a2 = 0) on random
    unrolled keys: K3 at M = 3 equals the JAX kernel, and the port's exact
    unrolled route (IYOKAN_BR_IMPL=ntt: with no knob set an unrolled key
    runs K3) equals JAX's CRT64 XLA unrolled route."""
    monkeypatch.setenv("IYOKAN_BR_IMPL", "ntt")
    jp = dataclasses.replace(JP, n=9)
    tp = dataclasses.replace(TP, n=9)
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 1 << 32, (5, 6 * JP.l, 2, JP.N), dtype=np.uint32)
    tlwe0 = rng.integers(0, 1 << 32, (4, 10), dtype=np.uint32)
    tv = rng.integers(0, 1 << 32, JP.N, dtype=np.uint32)
    be = jpm.MXUBackend()
    want = jcall(lambda t, r, v: pallas_br3.blind_rotate_pallas3(
        t, be.prep1(r, jp), v, jp), tlwe0, rows, tv)
    key = tpm.prep1(_t32(rows), tp)
    assert tops.gate_route(key, tp) == "ntt-unrolled"
    got = br3.blind_rotate_pallas3(_t32(tlwe0), key, _t32(tv), tp)
    np.testing.assert_array_equal(_u32(got), want)
    want = jcall(lambda t, r, v: jops.blind_rotate(
        t, CRT64.prep1(r, jp), v, jp, CRT64), tlwe0, rows, tv)
    got = tops.blind_rotate(_t32(tlwe0), key, _t32(tv), tp)
    np.testing.assert_array_equal(_u32(got), want)


def test_rotation_steps(port_keys):
    """The amounts K3 reads: [n, 1, G] on the plain key; (a1, a2, a1 + a2
    mod 2N) per pair on the unrolled key, an odd n padded with a2 = 0."""
    rows = torch.arange(3 * 4, dtype=torch.int32).reshape(3, 4) * 40
    tp = dataclasses.replace(TP, n=3)
    plain = torch.zeros((3, 2 * TP.l, 2, 2, TP.N), dtype=torch.int32)
    unrolled = torch.zeros((2, 6 * TP.l, 2, 2, TP.N), dtype=torch.int32)
    assert torch.equal(br3.rotation_steps(rows, plain, tp), rows[:, None])
    st = br3.rotation_steps(rows, unrolled, tp)
    assert st.shape == (2, 3, 4) and st.dtype == torch.int32
    assert torch.equal(st[0, 0], rows[0]) and torch.equal(st[0, 1], rows[1])
    assert torch.equal(st[0, 2], (rows[0] + rows[1]) % (2 * TP.N))
    assert torch.equal(st[1, 0], rows[2])
    assert not st[1, 1].any() and torch.equal(st[1, 2], rows[2])


# --------------------------------------------------------------------------- #
# the cluster form of K3/K4 (csrc/br_cluster.cuh), modelled in torch
# --------------------------------------------------------------------------- #


def _key_back(kk, p):
    """The kernel form [S, P, 2, M, l, 2, N] read back to prep1's
    [S, M*2l, 2, P, N]: times N 2^-32 mod p, rows m*2l + u*l + j."""
    S, P, _, M = kk.shape[:4]
    back = torch.stack([kk[:, i].to(torch.int64) * pow(
        tntt.key_factor(p.N)[i], -1, prime) % prime
        for i, prime in enumerate(tntt.PRIMES)], dim=1)
    return back.permute(0, 3, 2, 4, 5, 1, 6).reshape(
        S, M * 2 * p.l, 2, P, p.N).to(torch.int32)


@pytest.mark.parametrize("which", [0, 1])
def test_kernel_key_reads_back_to_prep1(port_keys, which):
    """The kernel form of the plain (M = 1) and the unrolled (M = 3) key
    reads back to polymul.prep1's key bit for bit."""
    key = port_keys[which]
    kk = br.kernel_key(key, TP)
    M = 1 if which == 0 else 3
    assert kk.shape == (key.shape[0], 2, 2, M, TP.l, 2, TP.N)
    assert kk.dtype == torch.int32 and int(kk.min()) >= 0
    assert torch.equal(_key_back(kk, TP), key)


def test_device_keys_carry_kernel_forms(toy_ek, monkeypatch):
    """DeviceKeys builds each NTT key's kernel form once, beside it; a view
    of a key has none, and the launcher's lookup refuses it."""
    monkeypatch.setenv("IYOKAN_BR_IMPL", "v3")
    dk = tops.DeviceKeys.from_evalkey(toy_ek, "cpu", with_cb=False)
    for key in (dk.bk_ntt, dk.bk_ntt_u):
        assert torch.equal(br.kernel_key_of(key), br.kernel_key(key, TP))
        assert br.attach_kernel_key(key, TP).kernel_key is \
            br.kernel_key_of(key)                     # not rebuilt
    with pytest.raises(ValueError, match="no kernel form"):
        br.kernel_key_of(dk.bk_ntt[:2])


def _cluster_steps(amounts, acc, bk, p, v3):
    """A torch model of the kernels' step loop in the cluster form: CTA
    (prime pi, part u) transforms part u's digit rows, forms the partial key
    products of both outputs from the kernel-form key (Montgomery sums of
    l products, K3's psi^(a(2k+1)) - 1 applied per m by Shoup), takes the
    other part's partial of its output, runs the unscaled inverse, and
    Garner with the other prime's CTA updates acc[u]."""
    from tests.test_torch_ntt import mont_sum, shoup_mul

    kk = br.kernel_key(bk, p).to(torch.int64)
    tabs = tntt.kernel_tables(p.N, "cpu")
    pw = tabs.pw.to(torch.int64) & tops.MASK32
    l, N, M = p.l, p.N, kk.shape[3]
    odd = 2 * torch.from_numpy(tntt._bit_reverse(
        np.arange(N), N.bit_length() - 1)) + 1
    acc = acc.clone()
    for i in range(kk.shape[0]):
        a = amounts[i].to(torch.int64)                     # [M, G]
        x = acc if v3 else tops.to_u64(tops.rot_poly(
            acc, amounts[i, 0][:, None], N)) - tops.to_u64(acc)
        d_all = tops.decompose1(x, p).to(torch.int64)      # [G, 2l, N]
        res = {}
        for pi, P in enumerate(tntt.PRIMES):
            part = {}
            for u in range(2):
                d = d_all[:, u * l: (u + 1) * l]           # part u's rows
                dig = tntt.ntt_fwd(d % P, N, pi)           # [G, l, N]
                out = []
                for v in range(2):
                    sv = 0
                    for m in range(M):
                        t = mont_sum(dig.transpose(1, 2),
                                     kk[i, pi, u, m, :, v].T[None], P)
                        if v3:
                            e = (a[m][:, None] * odd) % (2 * N)
                            t = shoup_mul(t, pw[pi, e, 0], pw[pi, e, 1], P)
                            sv = (sv + t) % P
                        else:
                            sv = t
                    out.append(sv)
                part[u] = out
            # the exchange, then the unscaled inverse of each output u
            res[pi] = [tntt.ntt_inv((part[u][u] + part[1 - u][u]) % P, N, pi)
                       * N % P for u in range(2)]
        for u in range(2):
            upd = tntt.crt_center(res[0][u], res[1][u])
            acc[:, u] = tops.from_u64(tops.to_u64(acc[:, u]) + upd)
    return acc


@pytest.mark.parametrize("case", ["K4", "K3 M=1", "K3 M=3"])
def test_cluster_model_equals_twins(port_keys, case):
    """The cluster-form model equals cmux_steps_ref (K4) and br3_ref (K3,
    M = 1 and 3) on random accumulators and amounts at toy parameters."""
    rng = np.random.default_rng(len(case))
    G, S = 5, 3
    acc = _t32(rng.integers(0, 1 << 32, (G, 2, TP.N), dtype=np.uint32))
    key = port_keys[1 if case.endswith("3") else 0][:S].contiguous()
    if case == "K4":
        rows = torch.from_numpy(rng.integers(0, 2 * TP.N, (S, G),
                                             dtype=np.int32))
        want = br.cmux_steps_ref(rows, acc, key, TP)
        got = _cluster_steps(rows[:, None], acc, key, TP, v3=False)
    else:
        M = int(case[-1])
        st = torch.from_numpy(rng.integers(0, 2 * TP.N, (S, M, G),
                                           dtype=np.int32))
        want = br3.br3_ref(st, acc, key, TP)
        got = _cluster_steps(st, acc, key, TP, v3=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["pallas", "pallas2", "v3 M=1",
                                  "v3 M=3 odd n"])
def test_cluster_model_equals_jax_kernel(toy_sk, mxu_keys, port_keys, kind):
    """Through the twins: the cluster-form model of a whole blind rotation
    equals the JAX kernel in interpret mode (pallas_br2; pallas_br3 on the
    plain key and, at an odd n of 9 key bits, on random unrolled keys;
    pallas_br with the model run one step a launch, K5's form: the
    accumulator leaves the model after every step)."""
    from iyokan_tpu_torch.ops.tkey import _setup

    tv = _testv(JP)
    if kind == "v3 M=3 odd n":
        jp, tp = dataclasses.replace(JP, n=9), dataclasses.replace(TP, n=9)
        rng = np.random.default_rng(11)
        rows = rng.integers(0, 1 << 32, (5, 6 * JP.l, 2, JP.N),
                            dtype=np.uint32)
        ct = rng.integers(0, 1 << 32, (4, 10), dtype=np.uint32)
        be = jpm.MXUBackend()
        want = jcall(lambda t, r: pallas_br3.blind_rotate_pallas3(
            t, be.prep1(r, jp), jnp.asarray(tv), jp), ct, rows)
        key = tpm.prep1(_t32(rows), tp)
    else:
        jp, tp, key = JP, TP, port_keys[0]
        ct = _batch(toy_sk, 4, 21)
        jfn = {"pallas": pallas_br.blind_rotate_pallas,
               "pallas2": pallas_br2.blind_rotate_pallas2}.get(
                   kind, pallas_br3.blind_rotate_pallas3)
        want = jcall(lambda t, bk: jfn(t, bk, jnp.asarray(tv), JP), ct,
                     mxu_keys[0])
    rows, acc = _setup(_t32(ct), _t32(tv), tp)
    if kind == "pallas":
        got = acc
        for i in range(tp.n):
            got = _cluster_steps(rows[i: i + 1, None], got, key[i: i + 1],
                                 tp, v3=False)
    elif kind == "pallas2":
        got = _cluster_steps(rows[:, None], acc, key, tp, v3=False)
    else:
        got = _cluster_steps(br3.rotation_steps(rows, key, tp), acc, key, tp,
                             v3=True)
    np.testing.assert_array_equal(_u32(got), want)


def test_cluster_threads_plan():
    """At every G from 1 to 2048 (one cluster a row), 512 threads a CTA
    exactly while the card holds all G clusters at that size (the cap
    cudaOccupancyMaxActiveClusters reports: 62 on an H100 80GB HBM3),
    else 256."""
    for cap in (1, 30, 62, 124):
        for G in range(1, 2049):
            assert br.threads_for(G, cap) == (
                br.NARROW_THREADS if G <= cap else br.WIDE_THREADS)


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """A kernel library is named by its source and every csrc/ header the
    source includes, directly or through another header."""
    assert nvcc.sources(br.SOURCE) == [br.SOURCE, "br_cluster.cuh", "ntt.cuh"]
    assert nvcc.sources(br3.SOURCE) == [br3.SOURCE, "br_cluster.cuh",
                                        "ntt.cuh"]
    assert nvcc.sources("extprod1_ntt.cu") == ["extprod1_ntt.cu",
                                               "br_cluster.cuh", "ntt.cuh"]
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n #include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(nvcc, "CSRC", str(tmp_path))
    assert nvcc.sources("k.cu") == ["k.cu", "a.cuh", "b.cuh"]
    before = nvcc.lib_path("k.cu")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert nvcc.lib_path("k.cu") != before


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")


def _random_case(p, G, steps, rr, seed):
    """Random accumulators, amounts and a prepared random key (with its
    kernel form) on the card."""
    rng = np.random.default_rng(seed)
    acc = _t32(rng.integers(0, 1 << 32, (G, 2, p.N), dtype=np.uint32)).cuda()
    rows = rng.integers(0, 1 << 32, (steps, rr, 2, p.N), dtype=np.uint32)
    key = br.attach_kernel_key(tpm.prep1(_t32(rows).cuda(), p), p)
    amounts = torch.from_numpy(
        rng.integers(0, 2 * p.N, (steps, G), dtype=np.int32)).cuda()
    return acc, amounts, key


@pytest.mark.cuda
@pytest.mark.parametrize("params,G,steps", [
    ("toy", 1, 3), ("toy", 13, 5), ("cggi128", 1, 2), ("cggi128", 70, 4)])
def test_cmux_kernels_equal_twin_on_card(params, G, steps):
    _card()
    p = tparams.by_name(params)
    acc, rows, key = _random_case(p, G, steps, 2 * p.l, G + steps)
    want = br.cmux_steps_ref(rows, acc, key, p)
    before = (br.STEP_LAUNCHES, br.LOOP_LAUNCHES)
    got = br.br_loop(rows, acc, key, p)
    step = acc
    for i in range(steps):
        step = br.br_step(step, rows[i], key, i, p)
    torch.cuda.synchronize()
    assert (br.STEP_LAUNCHES, br.LOOP_LAUNCHES) == (before[0] + steps,
                                                    before[1] + 1)
    assert torch.equal(got, want) and torch.equal(step, want)


@pytest.mark.cuda
@pytest.mark.parametrize("params,G,steps,M", [
    ("toy", 1, 3, 1), ("toy", 13, 3, 3), ("cggi128", 1, 2, 3),
    ("cggi128", 70, 4, 1), ("cggi128", 33, 3, 3)])
def test_v3_kernel_equals_twin_on_card(params, G, steps, M):
    _card()
    p = tparams.by_name(params)
    acc, a, key = _random_case(p, G, steps, 2 * p.l * M, G + 7 * M)
    rng = np.random.default_rng(G)
    st = torch.from_numpy(rng.integers(0, 2 * p.N, (steps, M, G),
                                       dtype=np.int32)).cuda()
    want = br3.br3_ref(st, acc, key, p)
    before = br3.LAUNCHES
    got = br3.br3(st, acc, key, p)
    torch.cuda.synchronize()
    assert br3.LAUNCHES == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 64, 133, 256, 2048])
@pytest.mark.parametrize("kernel,M", [("K4", 1), ("K3", 1), ("K3", 3)])
def test_cluster_kernels_equal_twin_at_cggi128(kernel, M, G):
    """K4 and K3 (M = 1, 3), one cluster of four CTAs a row, == their twins
    on random keys (3 steps)."""
    _card()
    p = tparams.CGGI128
    acc, a, key = _random_case(p, G, 3, 2 * p.l * M, G + M)
    before = (br.LOOP_LAUNCHES, br3.LAUNCHES)
    if kernel == "K4":
        want = br.cmux_steps_ref(a, acc, key, p)
        got = br.br_loop(a, acc, key, p)
        grid = br.last_launch()
    else:
        st = torch.from_numpy(np.random.default_rng(G).integers(
            0, 2 * p.N, (3, M, G), dtype=np.int32)).cuda()
        want = br3.br3_ref(st, acc, key, p)
        got = br3.br3(st, acc, key, p)
        grid = br3.last_launch()
    torch.cuda.synchronize()
    assert (br.LOOP_LAUNCHES - before[0]) + (br3.LAUNCHES - before[1]) == 1
    assert grid[:2] == (br.CLUSTER * G, br.CLUSTER)
    assert grid[2] in (br.WIDE_THREADS, br.NARROW_THREADS)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cluster_kernels_refuse_a_key_without_kernel_form():
    _card()
    p = tparams.TOY
    acc, a, key = _random_case(p, 2, 2, 2 * p.l, 3)
    bare = key.clone()
    with pytest.raises(ValueError, match="no kernel form"):
        br.br_loop(a, acc, bare, p)
    with pytest.raises(ValueError, match="no kernel form"):
        br3.br3(a[:, None], acc, bare, p)
    with pytest.raises(ValueError, match="no kernel form"):
        br.br_steps(a, acc, bare, p)
    with pytest.raises(ValueError, match="key must be"):
        br.br_step(acc, a[0], key[0], 0, p)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 62, 63, 64, 256, 2048])
def test_k5_equals_twin_at_cggi128(G):
    """K5 at cggi128: 3 steps from one br_steps call are 3 launches, each
    G clusters of four CTAs, == the twin; the 512/256-thread switch falls
    where the card's cap puts it (62 clusters on an H100 80GB HBM3)."""
    _card()
    p = tparams.CGGI128
    acc, a, key = _random_case(p, G, 3, 2 * p.l, G + 17)
    want = br.cmux_steps_ref(a, acc, key, p)
    before = br.STEP_LAUNCHES
    got = br.br_steps(a, acc, key, p)
    torch.cuda.synchronize()
    assert br.STEP_LAUNCHES == before + 3
    grid = br.last_launch()
    cap = br.cluster_plan(p, br.NARROW_THREADS)[1]
    assert grid == (br.CLUSTER * G, br.CLUSTER, br.threads_for(G, cap))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_routes_on_card_equal_cpu(toy_sk, toy_ek, monkeypatch):
    """Each route's blind rotation at toy keys: the card equals the CPU."""
    _card()
    ct = _batch(toy_sk, 9, 3)
    for impl in ("pallas", "pallas2", "v3"):
        monkeypatch.setenv("IYOKAN_BR_IMPL", impl)
        for thr in ("0", "256"):
            monkeypatch.setenv("IYOKAN_UNROLL_MAX", thr)
            res = []
            for dev in ("cpu", "cuda"):
                dk = tops.DeviceKeys.from_evalkey(toy_ek, dev, with_cb=False)
                tv = torch.full((TP.N,), TP.mu, dtype=torch.int32,
                                device=dev)
                res.append(tops.blind_rotate(_t32(ct).to(dev), dk.bk_for(9),
                                             tv, TP).cpu())
            assert torch.equal(res[0], res[1]), (impl, thr)
