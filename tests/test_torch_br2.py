"""K7, circuit bootstrapping's lvl2 blind rotation in the torch port
(iyokan_tpu_torch.ops.br2), against the JAX package.

On the CPU the wrapper runs its plain twin `blind_rotate2_ref`; with
tolerance 0 (the results are exact integers mod 2^64) the port's
crypto/ops.blind_rotate2 must equal iyokan_tpu.crypto.ops.blind_rotate2
(the CRT64 backend, jitted) on the same seeded numpy inputs, on the plain
and the 2-bit-unrolled key, at G = 1, 3, 8.  K7's cluster form
(csrc/br2_ntt.cu) is modelled in torch: the kernel form of the key reads
back to prep2's, and a model of the step loop (per-(prime, part) sums from
the kernel-form key with the kernel's Montgomery arithmetic -- four
products, a conditional subtract, the fifth -- the exchange, the unscaled
inverse, Garner per part and half) equals the twin on both key forms.  The
dispatch is held on both sides: a CPU tensor runs the twin and loads no
library; a tensor on the card reaches K7's C entry (a recording stand-in
for the ctypes library) with the launch's arguments and never the twin,
and a failed build or launch raises, naming K7.  The kernel itself is held
against the twin on the card (cuda-marked tests here, and chip_smoke.py's
K7 phase at cggi128).
"""

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


def _k7_model(steps, acc, bk2, p):
    """A torch model of K7's step loop: CTA (prime pi, part u) transforms
    part u's l2 digit rows of each rotated difference in turn and adds
    their products with the kernel-form key into the sums of outputs v x
    halves h (_mont_sum5, added mod p over m); output u takes the other
    part's sums, runs the unscaled inverse of each half, and Garner with
    the other prime's CTA gives lo and hi as centred integers: acc[u] +=
    lo + (hi << 32) mod 2^64."""
    kk = br2.kernel_key2(bk2, p).to(torch.int64)
    N, L, M = p.N2, p.l2, kk.shape[3]
    acc = acc.clone()
    for i in range(kk.shape[0]):
        digits = [tops.decompose2(tops.rot_poly(acc, steps[i, m][:, None],
                                                N) - acc, p).to(torch.int64)
                  for m in range(M)]                       # [G, 2l2, N]
        res = {}
        for pi, P in enumerate(tntt.PRIMES):
            part = {}
            for u in range(2):
                s = {}
                for m in range(M):
                    dig = tntt.ntt_fwd(digits[m][:, u * L: (u + 1) * L] % P,
                                       N, pi).transpose(1, 2)  # [G, N, L]
                    for v in range(2):
                        for h in range(2):
                            t = _mont_sum5(dig, kk[i, pi, u, m, :, v, h].T[
                                None], P)
                            s[v, h] = t if m == 0 else (s[v, h] + t) % P
                part[u] = s
            res[pi] = {(u, h): tntt.ntt_inv(
                (part[u][u, h] + part[1 - u][u, h]) % P, N, pi) * N % P
                for u in range(2) for h in range(2)}
        for u in range(2):
            lo = tntt.crt_center(res[0][u, 0], res[1][u, 0])
            hi = tntt.crt_center(res[0][u, 1], res[1][u, 1])
            acc[:, u] = acc[:, u] + lo + (hi << 32)
    return acc


@pytest.mark.parametrize("which", [0, 1], ids=["bk2", "bk2u"])
def test_k7_model_equals_twin(keys, which):
    """The cluster-form model equals blind_rotate2_ref over 3 steps of the
    plain and the unrolled key, on random u64 accumulators and amounts."""
    rng = np.random.default_rng(7 + which)
    G, S, M = 3, 3, 1 + 2 * which
    acc = _t64(rng.integers(0, 1 << 64, (G, 2, TP.N2), dtype=np.uint64))
    st = torch.from_numpy(rng.integers(0, 2 * TP.N2, (S, M, G),
                                       dtype=np.int32))
    key = keys[which][:S]
    assert torch.equal(_k7_model(st, acc, key, TP),
                       br2.blind_rotate2_ref(st, acc, key, TP))


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
    """A recording stand-in for the ctypes library of csrc/br2_ntt.cu."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def br2_ntt(self, *args):
        self.calls.append(args)
        return self.rc

    def br2_ntt_plan(self, N, l, M, device, out):
        out[0], out[1] = 155648, 30
        return 0

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
    (acc_p, st_p, kk_p, tw_p, g, s, m, n2, l2, bg, off, dev,
     stream) = lib.calls[0]
    assert acc_p == out.data_ptr() and kk_p == key.kernel_key.data_ptr()
    assert (g, s, m, n2, l2, bg) == (G, key.shape[0], 1 + 2 * which, TP.N2,
                                     TP.l2, TP.Bgbit2)
    # decompose2's centring (Bg2/2 a level) and rounding bit, as a u64
    assert off == tops.decompose2_offset(TP) == sum(
        128 << (64 - 8 * (j + 1)) for j in range(5)) + (1 << (63 - 40))


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
    ("cggi128", 3, 3, 1), ("cggi128", 69, 2, 3)])
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
    assert br2.last_launch()[:2] == (4 * G, 4)
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
