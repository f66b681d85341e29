"""Toeplitz-slab blind rotation of the torch port (iyokan_tpu_torch.ops.tkey).

On the CPU the wrapper runs its plain torch twin; it must equal
  * at L=4 key limbs and the full gadget: the exact CMUX blind rotation of
    the JAX package (crt64 NTT path), and
  * at the default L=3, lb=2: the JAX Pallas kernel in interpret mode on the
    same slab,
bit for bit, at awkward batch sizes.  The CUDA kernel itself is compared
with the twin on the card (cuda-marked test here, and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iyokan_tpu import gates
from iyokan_tpu.crypto import host as jhost
from iyokan_tpu.crypto import ops as jops
from iyokan_tpu.ops import pallas_tk
from iyokan_tpu_torch import params as tparams
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.crypto import polymul as tpm
from iyokan_tpu_torch.ops import tkey

P = tparams.TOY
BATCHES = [1, 5, 16, 17]


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


@pytest.mark.parametrize("layout,limbs,lb", [
    ("thin", 3, 2), ("fat2", 3, 2), ("unrolled", 3, 3)])
def test_non_fat_slab_raises(toy_sk, toy_ek, layout, limbs, lb):
    if layout == "unrolled":
        src = toy_ek.bku.reshape(toy_ek.bku.shape[0], 6 * P.l, 2, P.N)
        slab = tpm.tkey_kernel_key(src, P, limbs, "fat", lb=lb)
    else:
        slab = tpm.tkey_kernel_key(toy_ek.bk, P, limbs, layout, lb=lb)
    ct, testv = _inputs(toy_sk, 2, 0)
    with pytest.raises(ValueError, match="layout"):
        tkey.blind_rotate_tkey(tops.u32_tensor(ct, "cpu"),
                               torch.from_numpy(slab),
                               tops.u32_tensor(testv, "cpu"), P)


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
