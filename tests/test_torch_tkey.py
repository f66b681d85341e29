"""Toeplitz-slab blind rotation of the torch port (iyokan_tpu_torch.ops.tkey).

On the CPU the wrapper runs its plain torch twin; it must equal
  * at L=4 key limbs and the full gadget: the exact CMUX blind rotation of
    the JAX package (crt64 NTT path), and
  * on every slab layout (fat, thin, fat2, 2-bit unrolled; L = 3, 4; lb =
    1..3): the JAX Pallas kernel in interpret mode on the same slab, in each
    of the JAX package's forms of it (serial and pipelined kernels, split
    and full dots, K-major or not), and at an odd n on the unrolled slab,
bit for bit, at awkward batch sizes.  The CUDA kernel itself is compared
with the twin on the card (cuda-marked tests here, and chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iyokan_tpu import gates
from iyokan_tpu import params as jparams
from iyokan_tpu.crypto import host as jhost
from iyokan_tpu.crypto import ops as jops
from iyokan_tpu.ops import pallas_tk
from iyokan_tpu_torch import params as tparams
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.crypto import polymul as tpm
from iyokan_tpu_torch.ops import tkey

P = tparams.TOY
BATCHES = [1, 5, 16, 17]
# the JAX package's knobs that pick the form of its kernel (schedule only)
FORM_KNOBS = ("IYOKAN_TK_KMAJ", "IYOKAN_TK_DOTS", "IYOKAN_TK_CHAINS",
              "IYOKAN_TK_PIPE")
# form -> (key source, limbs, layout, lb, the JAX knobs of that form)
FORMS = {
    "thin": ("bk", 3, "thin", 2, {}),                # serial, non-fat
    "fat2": ("bk", 3, "fat2", 2, {}),                # pipe, K-major
    "fat2-kmaj0": ("bk", 3, "fat2", 2, {"IYOKAN_TK_KMAJ": "0"}),
    "fat-dots-full": ("bk", 3, "fat", 2, {"IYOKAN_TK_DOTS": "full"}),
    "fat-chains1": ("bk", 3, "fat", 2, {"IYOKAN_TK_CHAINS": "1"}),
    "unrolled": ("bku", 3, "fat", 2, {}),
    "fat-L4-lb3": ("bk", 4, "fat", 3, {}),
    "fat-L3-lb1": ("bk", 3, "fat", 1, {}),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def slab_default(toy_ek):
    L, lay, lb = tops.tkey_default_config(P)
    return tpm.tkey_kernel_key(toy_ek.bk, P, L, lay, lb=lb)


@pytest.fixture(scope="module")
def slabs(toy_ek):
    """form -> its slab (built once per module)."""
    bku = toy_ek.bku.reshape(toy_ek.bku.shape[0], 6 * P.l, 2, P.N)
    return {name: tpm.tkey_kernel_key(bku if src == "bku" else toy_ek.bk,
                                      P, limbs, layout, lb=lb)
            for name, (src, limbs, layout, lb, _) in FORMS.items()}


def _inputs(toy_sk, G, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, G, dtype=np.uint8)
    ct = jhost.encrypt_bits(toy_sk, bits, rng)
    testv = np.full(P.N, P.mu, np.uint32)
    return ct, testv


@pytest.mark.parametrize("G", BATCHES)
def test_twin_equals_exact_cmux_4limb(toy, toy_sk, toy_ek, G, monkeypatch):
    """L=4, lb=l: the slab product is exact, so the twin equals the exact
    CMUX blind rotation (contract of test_tkey_blind_rotate_bitexact_4limb)."""
    monkeypatch.delenv("IYOKAN_BR_IMPL", raising=False)
    jdk = jops.DeviceKeys.from_evalkey(toy_ek)
    ct, testv = _inputs(toy_sk, G, G)
    slab = torch.from_numpy(tpm.tkey_kernel_key(toy_ek.bk, P, 4, "fat"))
    got = tkey.blind_rotate_tkey(tops.u32_tensor(ct, "cpu"), slab,
                                 tops.u32_tensor(testv, "cpu"), P)
    want = jops.blind_rotate(jnp.asarray(ct), jdk.bkntt, jnp.asarray(testv),
                             toy, jdk.backend)
    np.testing.assert_array_equal(tops.u32_numpy(got), np.asarray(want))


@pytest.mark.parametrize("G", BATCHES)
def test_twin_equals_pallas_default(toy, toy_sk, slab_default, G,
                                    monkeypatch):
    """Default L=3, lb=2 slab: twin == pallas_tk.blind_rotate_tkey
    (interpret mode) on the same slab."""
    monkeypatch.setenv("IYOKAN_PALLAS_INTERPRET", "1")
    ct, testv = _inputs(toy_sk, G, 100 + G)
    got = tkey.blind_rotate_tkey(tops.u32_tensor(ct, "cpu"),
                                 torch.from_numpy(slab_default),
                                 tops.u32_tensor(testv, "cpu"), P)
    want = pallas_tk.blind_rotate_tkey(jnp.asarray(ct),
                                       jnp.asarray(slab_default),
                                       jnp.asarray(testv), toy)
    np.testing.assert_array_equal(tops.u32_numpy(got), np.asarray(want))


@pytest.mark.parametrize("kind", [gates.NAND, gates.AND, gates.XOR])
def test_gate_truth_tables(toy_sk, toy_ek, kind):
    """linear combination -> bootstrap -> key switch decrypts to the gate's
    truth table on every input pair."""
    dk = tops.DeviceKeys.from_evalkey(toy_ek, "cpu")
    a = np.array([0, 0, 1, 1] * 3, np.uint8)
    b = np.array([0, 1, 0, 1] * 3, np.uint8)
    rng = np.random.default_rng(kind)
    A = tops.u32_tensor(jhost.encrypt_bits(toy_sk, a, rng), "cpu")
    B = tops.u32_tensor(jhost.encrypt_bits(toy_sk, b, rng), "cpu")
    ca, cb, k = (torch.full((len(a),), c, dtype=torch.int32)
                 for c in gates.GATE_LIN[kind])
    pre = tops.gate_linear(A, B, ca, cb, k, P)
    lvl1 = tops.gate_bootstrap_tlwe1(pre, dk.bk_tk, P)
    out = jhost.decrypt_bits(toy_sk,
                             tops.u32_numpy(tops.keyswitch_10(
                                 lvl1, dk.ksk_f64, P)))
    want = {gates.NAND: 1 - (a & b), gates.AND: a & b,
            gates.XOR: a ^ b}[kind]
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("G", [1, 5, 17])
@pytest.mark.parametrize("form", list(FORMS))
def test_layout_twin_equals_pallas(toy, toy_sk, slabs, form, G, monkeypatch):
    """Each layout's twin == pallas_tk.blind_rotate_tkey (interpret mode)
    on the same slab, in each form of the JAX kernel: the knobs that pick
    the form change the schedule, not the result."""
    monkeypatch.setenv("IYOKAN_PALLAS_INTERPRET", "1")
    for k in FORM_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in FORMS[form][4].items():
        monkeypatch.setenv(k, v)
    slab = slabs[form]
    layout, L, lb, M = tkey.slab_config(torch.from_numpy(slab), P)
    assert (layout, L, lb) == (
        "unrolled" if form == "unrolled" else FORMS[form][2],
        FORMS[form][1], FORMS[form][3])
    ct, testv = _inputs(toy_sk, G, 200 + G)
    got = tkey.blind_rotate_tkey(tops.u32_tensor(ct, "cpu"),
                                 torch.from_numpy(slab),
                                 tops.u32_tensor(testv, "cpu"), P)
    want = pallas_tk.blind_rotate_tkey(jnp.asarray(ct), jnp.asarray(slab),
                                       jnp.asarray(testv), toy)
    np.testing.assert_array_equal(tops.u32_numpy(got), np.asarray(want))


def test_unrolled_odd_n_equals_pallas(monkeypatch):
    """An odd n (9 key bits: 5 pair steps, the last with a2 = 0) on a
    random 2-bit-unrolled slab: twin == pallas_tk in interpret mode."""
    monkeypatch.setenv("IYOKAN_PALLAS_INTERPRET", "1")
    for k in FORM_KNOBS:
        monkeypatch.delenv(k, raising=False)
    jp = dataclasses.replace(jparams.TOY, n=9)
    tp = dataclasses.replace(P, n=9)
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 1 << 32, (5, 6 * P.l, 2, P.N), dtype=np.uint32)
    slab = tpm.tkey_kernel_key(rows, tp, 3, "fat", lb=2)
    tlwe0 = rng.integers(0, 1 << 32, (6, tp.n + 1), dtype=np.uint32)
    tv = rng.integers(0, 1 << 32, P.N, dtype=np.uint32)
    assert tkey.slab_config(torch.from_numpy(slab), tp)[0] == "unrolled"
    got = tkey.blind_rotate_tkey(tops.u32_tensor(tlwe0, "cpu"),
                                 torch.from_numpy(slab),
                                 tops.u32_tensor(tv, "cpu"), tp)
    want = pallas_tk.blind_rotate_tkey(jnp.asarray(tlwe0),
                                       jnp.asarray(slab), jnp.asarray(tv), jp)
    np.testing.assert_array_equal(tops.u32_numpy(got), np.asarray(want))


def test_fat2_window_math_where_the_dropped_limb_is_minus_128(
        toy, toy_sk, toy_ek, monkeypatch):
    """At L=3 the fat2 slab's negated first copy is not the limb-wise
    negation of the second where a key coefficient's low byte is 0x80 (the
    dropped limb is -128 both ways: cggi128's b-part noise hits it, toy
    noise never does).  Forced here on every b-part coefficient: the twin
    computes fat2's window math, as JAX's non-K-major kernel does, while
    JAX's K-major branch (the default at small batches) reads the second
    copy only and so gives the fat slab's result."""
    monkeypatch.setenv("IYOKAN_PALLAS_INTERPRET", "1")
    for k in FORM_KNOBS:
        monkeypatch.delenv(k, raising=False)
    bk = toy_ek.bk.copy()
    bk[:, :, 1, :] = (bk[:, :, 1, :] & np.uint32(0xFFFFFF00)) | np.uint32(0x80)
    fat2 = tpm.tkey_kernel_key(bk, P, 3, "fat2", lb=2)
    fat = tpm.tkey_kernel_key(bk, P, 3, "fat", lb=2)
    ct, testv = _inputs(toy_sk, 5, 77)
    args = (tops.u32_tensor(ct, "cpu"), tops.u32_tensor(testv, "cpu"))
    got = tops.u32_numpy(tkey.blind_rotate_tkey(args[0],
                                                torch.from_numpy(fat2),
                                                args[1], P))
    on_fat = tops.u32_numpy(tkey.blind_rotate_tkey(args[0],
                                                   torch.from_numpy(fat),
                                                   args[1], P))
    assert not np.array_equal(got, on_fat)

    def jax_fat2():
        return np.asarray(pallas_tk.blind_rotate_tkey(
            jnp.asarray(ct), jnp.asarray(fat2), jnp.asarray(testv), toy))

    np.testing.assert_array_equal(jax_fat2(), on_fat)        # K-major
    monkeypatch.setenv("IYOKAN_TK_KMAJ", "0")
    np.testing.assert_array_equal(jax_fat2(), got)


N_, C3, C4 = P.N, 768, 1024


@pytest.mark.parametrize("shape,want", [
    ((2, 5 * N_, C3), ("fat", 3, 2, 1)),
    ((2, 4 * N_, C3), ("fat", 3, 1, 1)),
    ((2, 6 * N_, C4), ("fat", 4, 3, 1)),
    ((2, 5, N_, C3), ("thin", 3, 2, 1)),
    ((2, 10 * N_, C3), ("fat2", 3, 2, 1)),
    # 12 rows a step: fat2 at lb=3 wins over unrolled at lb=1
    ((2, 12 * N_, C3), ("fat2", 3, 3, 1)),
    ((2, 15 * N_, C3), ("unrolled", 3, 2, 3)),
    ((2, 18 * N_, C4), ("unrolled", 4, 3, 3)),
    ((2, 7 * N_, C3), None),           # no layout has 7 rows a step
    ((2, 3 * N_, C3), None),           # lb = 0
    ((2, 5 * N_ + 128, C3), None),     # not a whole number of rows
    ((2, 5 * N_, 512), None),          # L = 2
    ((2, 3, N_, C3), None),            # thin, lb = 0
    ((2, 5, N_ // 2, C3), None),       # thin at another N
    ((5 * N_, C3), None),              # 2-d
])
def test_slab_config_reads_and_refuses(shape, want):
    """slab_config reads the layout from the shape as pallas_tk does and
    raises on a slab it cannot place (no other layout is tried)."""
    slab = torch.empty(shape, dtype=torch.int8)
    if want is None:
        with pytest.raises(ValueError, match="cannot place|columns"):
            tkey.slab_config(slab, P)
    else:
        assert tkey.slab_config(slab, P) == want


def test_ambiguous_or_non_int8_slab_raises(toy_ek):
    """The 2-bit-unrolled slab at lb=1 would have fat2's 12 rows a step at
    l=3: tkey_kernel_key refuses it, as the JAX package's does; and a slab
    that is not int8 is refused."""
    bku = toy_ek.bku.reshape(toy_ek.bku.shape[0], 6 * P.l, 2, P.N)
    with pytest.raises(ValueError, match="ambiguous"):
        tpm.tkey_kernel_key(bku, P, 3, "fat", lb=1)
    with pytest.raises(ValueError, match="dtype|int8"):
        tkey.slab_config(torch.empty((2, 5 * N_, C3), dtype=torch.int32), P)


def test_bad_inputs_raise(toy_sk, slab_default):
    ct, testv = _inputs(toy_sk, 2, 0)
    slab = torch.from_numpy(slab_default)
    with pytest.raises(ValueError, match="int32"):
        tkey.blind_rotate_tkey(torch.from_numpy(ct.astype(np.int64)), slab,
                               tops.u32_tensor(testv, "cpu"), P)
    with pytest.raises(ValueError, match="n\\+1"):
        tkey.blind_rotate_tkey(tops.u32_tensor(ct[:, 1:], "cpu"), slab,
                               tops.u32_tensor(testv, "cpu"), P)


def test_cuda_request_without_card_raises(toy_ek):
    """No CPU fallback for a CUDA request: it raises where no card is."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tops.check_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tops.DeviceKeys.from_evalkey(toy_ek, "cuda")


def test_split_k_covers_the_card():
    k_tiles = 5 * 1024 // 64                   # cggi128, lb=2
    for Gp in (16, 32, 64, 128, 512, 2048):
        s = tkey._split_k(Gp, k_tiles)
        assert 1 <= s <= min(k_tiles, tkey.MAX_SPLIT) and s & (s - 1) == 0
        assert s == 1 or (Gp // 16) * 8 * s <= tkey.SPLIT_GRID
    # the H100 sweep's best splits (PERF.md, split sweep)
    assert [tkey._split_k(g, k_tiles) for g in (16, 64, 256, 2048)] == \
        [16, 8, 2, 1]
    assert tkey._split_k(16, 4) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("G,limbs,lb", [
    (1, 3, 2), (5, 3, 2), (64, 3, 2), (130, 3, 2), (17, 4, 3), (33, 3, 1)])
def test_kernel_equals_twin_on_card(toy_sk, toy_ek, G, limbs, lb):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    ct, testv = _inputs(toy_sk, G, 7 + G)
    slab = tpm.tkey_kernel_key(toy_ek.bk, P, limbs, "fat", lb=lb)
    args = (tops.u32_tensor(ct, "cuda"), torch.from_numpy(slab).cuda(),
            tops.u32_tensor(testv, "cuda"), P)
    before = tkey.LAUNCHES
    got = tkey.blind_rotate_tkey(*args)
    assert tkey.LAUNCHES == before + 1
    want = tkey.blind_rotate_tkey_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form,G", [
    ("thin", 1), ("thin", 33), ("fat2", 5), ("fat2", 64), ("unrolled", 1),
    ("unrolled", 17), ("unrolled", 130)])
def test_layout_kernel_equals_twin_on_card(toy_sk, slabs, form, G):
    """The thin, fat2 and unrolled kernels == their twins on the card, one
    launch counted under the slab's layout (the fat slab's L and lb:
    test_kernel_equals_twin_on_card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    ct, testv = _inputs(toy_sk, G, 11 + G)
    slab = torch.from_numpy(slabs[form]).cuda()
    layout = tkey.slab_config(slab, P)[0]
    args = (tops.u32_tensor(ct, "cuda"), slab,
            tops.u32_tensor(testv, "cuda"), P)
    before = tkey.LAYOUT_LAUNCHES[layout]
    got = tkey.blind_rotate_tkey(*args)
    assert tkey.LAYOUT_LAUNCHES[layout] == before + 1
    want = tkey.blind_rotate_tkey_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
