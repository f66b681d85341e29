"""Toeplitz-slab blind rotation of the torch port (iyokan_tpu_torch.ops.tkey).

On the CPU the wrapper runs its plain torch twin; it must equal
  * at L=4 key limbs and the full gadget: the exact CMUX blind rotation of
    the JAX package (crt64 NTT path), and
  * on every slab layout (fat, thin, fat2, 2-bit unrolled; L = 3, 4; lb =
    1..3): the JAX Pallas kernel in interpret mode on the same slab, in each
    of the JAX package's forms of it (serial and pipelined kernels, split
    and full dots, K-major or not), and at an odd n on the unrolled slab,
bit for bit, at awkward batch sizes.  The slab lies on the device
K-contiguous (tkey.k_contiguous): DeviceKeys builds it so, the twin takes
either storage, the kernel path refuses a row-major one, and a torch model
of the wgmma form's k-tile schedule equals the twin.  The CUDA kernel
itself is compared with the twin on the card (cuda-marked tests here, and
chip_smoke.py).
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
from iyokan_tpu_torch.crypto.ops import MASK32
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
def test_gate_truth_tables(toy_sk, toy_ek, kind, monkeypatch):
    """linear combination -> bootstrap -> key switch decrypts to the gate's
    truth table on every input pair, on the tkey slab (IYOKAN_BR_IMPL=tkey:
    the port's default builds no slab)."""
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
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
    args = (tops.u32_tensor(ct, "cuda"), tkey.k_contiguous(slab, "cuda"),
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
    slab = tkey.k_contiguous(slabs[form], "cuda")
    layout = tkey.slab_config(slab, P)[0]
    args = (tops.u32_tensor(ct, "cuda"), slab,
            tops.u32_tensor(testv, "cuda"), P)
    before = tkey.LAYOUT_LAUNCHES[layout]
    got = tkey.blind_rotate_tkey(*args)
    assert tkey.LAYOUT_LAUNCHES[layout] == before + 1
    want = tkey.blind_rotate_tkey_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
# K-contiguous storage and the wgmma form's schedule
# --------------------------------------------------------------------------- #

# the layouts' forms in FORMS: fat (L=3, lb=2), thin, fat2, unrolled, fat L=4
KC_FORMS = ["fat-dots-full", "thin", "fat2", "unrolled", "fat-L4-lb3"]
# DeviceKeys knobs -> the layout of the slab they build
KC_KNOBS = [({}, "fat"), ({"IYOKAN_TK_LAYOUT": "thin"}, "thin"),
            ({"IYOKAN_TK_LAYOUT": "fat2"}, "fat2"),
            ({"IYOKAN_TK_UNROLL": "1"}, "unrolled")]


def _k_strides(shape):
    """The strides of the K-contiguous view of a slab of logical shape
    [n, ..., C]: storage [n, C, ...]."""
    n, C, rest = shape[0], shape[-1], shape[1:-1]
    inner = [int(np.prod(rest[i + 1:], dtype=np.int64))
             for i in range(len(rest))]
    return (C * int(np.prod(rest)), *inner, int(np.prod(rest)))


@pytest.mark.parametrize("env,layout", KC_KNOBS,
                         ids=[lay for _, lay in KC_KNOBS])
def test_device_keys_store_the_slab_k_contiguous(toy_ek, monkeypatch, env,
                                                 layout):
    """DeviceKeys.from_evalkey places each layout's slab K-contiguous, with
    tkey_kernel_key's logical shape and values."""
    for k in ("IYOKAN_TK_LAYOUT", "IYOKAN_TK_UNROLL", "IYOKAN_TK_SMALL",
              "IYOKAN_TKEY_LIMBS", "IYOKAN_TK_LB", "IYOKAN_EP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    dk = tops.DeviceKeys.from_evalkey(toy_ek, "cpu", with_cb=False)
    slab = dk.bk_tk
    assert tkey.slab_config(slab, P)[0] == layout
    assert tkey.is_k_contiguous(slab) and not slab.is_contiguous()
    assert slab.stride() == _k_strides(tuple(slab.shape))
    src = (toy_ek.bku.reshape(toy_ek.bku.shape[0], 6 * P.l, 2, P.N)
           if layout == "unrolled" else toy_ek.bk)
    want = tpm.tkey_kernel_key(src, P, 3, "fat" if layout == "unrolled"
                               else layout, lb=2)
    np.testing.assert_array_equal(slab.numpy(), want)


@pytest.mark.parametrize("form", KC_FORMS)
def test_twin_takes_either_storage(toy, toy_sk, slabs, form, monkeypatch):
    """The twin on the K-contiguous slab == the twin on the row-major slab
    == pallas_tk (interpret mode), at G = 5."""
    monkeypatch.setenv("IYOKAN_PALLAS_INTERPRET", "1")
    for k in FORM_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in FORMS[form][4].items():
        monkeypatch.setenv(k, v)
    ct, testv = _inputs(toy_sk, 5, 300)
    args = (tops.u32_tensor(ct, "cpu"), tops.u32_tensor(testv, "cpu"))
    kc = tkey.k_contiguous(slabs[form])
    assert tkey.is_k_contiguous(kc)
    got = tkey.blind_rotate_tkey(args[0], kc, args[1], P)
    row_major = tkey.blind_rotate_tkey(
        args[0], torch.from_numpy(slabs[form]), args[1], P)
    assert torch.equal(got, row_major)
    want = pallas_tk.blind_rotate_tkey(jnp.asarray(ct),
                                       jnp.asarray(slabs[form]),
                                       jnp.asarray(testv), toy)
    np.testing.assert_array_equal(tops.u32_numpy(got), np.asarray(want))


def test_kernel_path_refuses_a_row_major_slab(toy_sk, slab_default):
    """The kernel path takes only the K-contiguous storage (no per-call
    conversion) and raises on a row-major slab before it builds or
    launches anything; check_inputs lets both through for a slab."""
    row_major = torch.from_numpy(slab_default)
    kc = tkey.k_contiguous(slab_default)
    with pytest.raises(ValueError, match="K-contiguous"):
        tkey.check_k_contiguous(row_major)
    tkey.check_k_contiguous(kc)
    ct, testv = _inputs(toy_sk, 3, 5)
    tl, tv = tops.u32_tensor(ct, "cpu"), tops.u32_tensor(testv, "cpu")
    cfg, rows, acc = tkey._prepare(tl, row_major, tv, P)
    with pytest.raises(ValueError, match="K-contiguous"):
        tkey._steps_kernel(rows, acc, row_major, P, cfg)
    for slab in (row_major, kc):
        tkey.check_inputs(tl, slab, tv, P, P.n, slab=True)
    with pytest.raises(ValueError, match="contiguous"):
        tkey.check_inputs(tl, kc, tv, P, P.n)


def _model_steps(rows, acc, slab, p, cfg):
    """The wgmma form of the step product in plain torch, tile by tile as
    the kernel runs it: for each output block K, 128-gate M tile (gates
    past G read as zeros) and (part u, 64-coefficient block cb) N tile of
    L x 64 slab columns, the k-tiles in tkey.k_tile_order, the accumulator
    negated on entering and leaving the wrapped ones (not on fat2, which
    reads the first copy instead), then the limb recombination.  Returns
    the final accumulator and the most sign flips a tile made."""
    layout, L, lb, M = cfg
    N, NB = p.N, p.N // 128
    RR = M * (p.l + lb)
    RT = RR * N
    phys = slab.movedim(-1, 1).reshape(slab.shape[0], slab.shape[-1], -1)
    G = acc.shape[0]
    Gp = -(-G // 128) * 128
    a = tops.to_u64(acc)
    most_flips = 0
    for i in range(phys.shape[0]):
        d = tkey._digits_ref(a, rows[M * i: M * (i + 1)], p, lb)
        ext = (d.reshape(G, RT) if layout == "thin" else
               d.reshape(G, RR, NB, 128).permute(0, 2, 1, 3).reshape(G, RT))
        ext = torch.cat([ext, ext.new_zeros((Gp - G, RT))]).double()
        bk = phys[i].double()                            # [C, KT]
        upd = torch.zeros((Gp, 2, N), dtype=torch.int64)
        for K in range(NB):
            order = tkey.k_tile_order(K, layout, RT, N, RR)
            assert sorted(t for t, *_ in order) == list(range(RT // 128))
            for g0 in range(0, Gp, 128):
                for u in range(2):
                    for cb in range(2):
                        cols = [(u * L + li) * 128 + cb * 64 + c
                                for li in range(L) for c in range(64)]
                        b = bk[cols]
                        s = torch.zeros((128, L * 64), dtype=torch.float64)
                        neg, flips = False, 0
                        for _, acol, bkc, wrap in order:
                            w = wrap and layout != "fat2"
                            if w != neg:
                                s, neg, flips = -s, w, flips + 1
                            s = s + (ext[g0: g0 + 128, acol: acol + 128]
                                     @ b[:, bkc: bkc + 128].t())
                        if neg:
                            s = -s
                        most_flips = max(most_flips, flips)
                        s = s.to(torch.int64).reshape(128, L, 64)
                        v = sum(s[:, li] << (8 * (4 - L + li))
                                for li in range(L))
                        upd[g0: g0 + 128, u,
                            K * 128 + cb * 64: K * 128 + cb * 64 + 64] += v
        a = (a + upd[:G]) & MASK32
    return tops.from_u64(a), most_flips


@pytest.mark.parametrize("G", [5, 130])
@pytest.mark.parametrize("form", KC_FORMS)
def test_wgmma_schedule_model_equals_twin(form, G):
    """The wgmma form's k-tile schedule (plain rows first, the wrapped
    ones under a negated accumulator; thin's segments; fat2's copy
    switch; M tiles of one block K), modelled in torch on a random
    K-contiguous slab at toy parameters (n = 6, every layout), equals the
    twin bit for bit, with at most two sign flips a tile."""
    _, limbs, layout, lb, _ = FORMS[form]
    tp = dataclasses.replace(P, n=6)
    rng = np.random.default_rng(len(form) * 1000 + G)
    unrolled = form == "unrolled"
    keyrows = rng.integers(0, 1 << 32, (3, 6 * P.l, 2, P.N) if unrolled
                           else (6, 2 * P.l, 2, P.N), dtype=np.uint32)
    slab = tkey.k_contiguous(tpm.tkey_kernel_key(keyrows, tp, limbs, layout,
                                                 lb=lb))
    tlwe0 = tops.u32_tensor(rng.integers(0, 1 << 32, (G, tp.n + 1),
                                         dtype=np.uint32), "cpu")
    tv = tops.u32_tensor(rng.integers(0, 1 << 32, P.N, dtype=np.uint32),
                         "cpu")
    cfg, rows, acc = tkey._prepare(tlwe0, slab, tv, tp)
    assert cfg[0] == ("unrolled" if unrolled else layout)
    got, flips = _model_steps(rows, acc, slab, tp, cfg)
    assert flips <= 2
    assert torch.equal(got, tkey._steps_ref(rows, acc, slab, tp, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [16, 112, 128, 144, 2048])
@pytest.mark.parametrize("form", KC_FORMS)
def test_both_forms_equal_twin_on_card(toy_sk, slabs, form, G):
    """Each layout's kernel == its twin at Gp = 16, 112, 128, 144, 2048,
    in the form the route picks and in the per-step forms, one launch
    counted under each form."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    rng = np.random.default_rng(G)
    ct = jhost.encrypt_bits(toy_sk, rng.integers(0, 2, G, dtype=np.uint8),
                            rng)
    slab = tkey.k_contiguous(slabs[form], "cuda")
    args = (tops.u32_tensor(ct, "cuda"), slab,
            tops.u32_tensor(np.full(P.N, P.mu, np.uint32), "cuda"), P)
    want = tkey.blind_rotate_tkey_ref(*args)
    picked = tkey.route_form(tkey.slab_config(slab, P)[0], G)
    for f in (None, *(f for f in ("wgmma", "mma") if f != picked)):
        before = dict(tkey.FORM_LAUNCHES)
        got = tkey.blind_rotate_tkey(*args, form=f)
        torch.cuda.synchronize()
        assert tkey.FORM_LAUNCHES[f or picked] == before[f or picked] + 1
        assert torch.equal(got, want), (form, G, f)
