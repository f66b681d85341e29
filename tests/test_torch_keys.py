"""Key material of the torch port (iyokan_tpu_torch) against the JAX package.

The same seeds must give byte-identical secret keys, eval keys and
ciphertexts in both packages (host.py is shared numpy code), the port's
Toeplitz slab must equal the JAX slab, and DeviceKeys.from_evalkey must carry
the JAX package's prepared key tensors across unchanged.
"""

import numpy as np
import pytest
import torch

from iyokan_tpu import packet as jpacket
from iyokan_tpu.crypto import host as jhost
from iyokan_tpu.crypto import ops as jops
from iyokan_tpu.crypto import polymul as jpm
from iyokan_tpu_torch import packet as tpacket
from iyokan_tpu_torch import params as tparams
from iyokan_tpu_torch.crypto import host as thost
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.crypto import polymul as tpm


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_same_seed_same_keys(toy):
    jsk = jhost.keygen(toy, seed=5)
    tsk = thost.keygen(tparams.TOY, seed=5)
    for f in ("s0", "s1", "s2"):
        _assert_same(getattr(jsk, f), getattr(tsk, f))
    jek = jhost.genevalkey(jsk, seed=6)
    tek = thost.genevalkey(tsk, seed=6)
    for f in ("bk", "bk2", "ksk", "pksk", "bku", "bk2u"):
        _assert_same(getattr(jek, f), getattr(tek, f))


def test_same_seed_same_ciphertexts(toy, toy_sk):
    tsk = thost.SecretKey(tparams.TOY, toy_sk.s0, toy_sk.s1, toy_sk.s2)
    bits = np.random.default_rng(3).integers(0, 2, 40, dtype=np.uint8)
    _assert_same(jhost.encrypt_bits(toy_sk, bits, np.random.default_rng(9)),
                 thost.encrypt_bits(tsk, bits, np.random.default_rng(9)))
    req = {"bits": {"x": bits}, "rom": {"r": bits[:16]}}
    jt = jpacket.PlainPacket(**req).encrypt(toy_sk, seed=11)
    tt = tpacket.PlainPacket(**req).encrypt(tsk, seed=11)
    for f in ("bits", "rom", "rom_tlwe"):
        for k in getattr(jt, f):
            _assert_same(getattr(jt, f)[k], getattr(tt, f)[k])


def test_key_files_interchange(toy_sk, toy_ek, tmp_path):
    """Files written by one package load in the other, unchanged."""
    toy_sk.save(str(tmp_path / "sk"))
    toy_ek.save(str(tmp_path / "ek"))
    tsk = thost.SecretKey.load(str(tmp_path / "sk"))
    tek = thost.EvalKey.load(str(tmp_path / "ek"))
    _assert_same(tsk.s1, toy_sk.s1)
    _assert_same(tek.bk, toy_ek.bk)
    tek.save(str(tmp_path / "ek2"))
    back = jhost.EvalKey.load(str(tmp_path / "ek2"))
    _assert_same(back.ksk, toy_ek.ksk)
    assert back.params == toy_ek.params


@pytest.mark.parametrize("limbs,layout,lb", [
    (3, "fat", 2), (4, "fat", 3), (3, "fat", 1), (4, "thin", None),
    (3, "fat2", 2),
])
def test_slab_matches_jax(toy, toy_ek, limbs, layout, lb):
    want = jpm.tkey_kernel_key(toy_ek.bk, toy, limbs, layout, lb=lb)
    got = tpm.tkey_kernel_key(toy_ek.bk, tparams.TOY, limbs, layout, lb=lb)
    _assert_same(got, want)


def test_device_keys_match_jax(toy, toy_ek, monkeypatch):
    """Under IYOKAN_BR_IMPL=tkey the JAX DeviceKeys hold the fat L=3, lb=2
    slab and the u32 key-switch key; the port's tensors equal them."""
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", "0")     # no slab file in /tmp
    jdk = jops.DeviceKeys.from_evalkey(toy_ek)
    tdk = tops.DeviceKeys.from_evalkey(toy_ek, "cpu")
    _assert_same(tdk.bk_tk.numpy(), np.asarray(jdk.bkntt))
    _assert_same(tops.u32_numpy(tdk.ksk_mat), np.asarray(jdk.ksk_mat))
    assert torch.equal(tdk.ksk_f64, tdk.ksk_mat.to(torch.float64))
    assert tdk.device == torch.device("cpu")


def test_unquantized_bk_masks_warn(toy_ek, monkeypatch):
    """On the tkey slab's route (IYOKAN_BR_IMPL=tkey); the port's default
    builds no slab, and its K3 route is exact on any mask."""
    import dataclasses

    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", "0")

    bk = toy_ek.bk.copy()
    bk[:, :, 0, :] |= np.uint32(1)
    ek = dataclasses.replace(toy_ek, bk=bk)
    with pytest.warns(UserWarning, match="unquantized"):
        tops.DeviceKeys.from_evalkey(ek, "cpu")


def test_cuda_keys_without_card_raise(toy_ek):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tops.DeviceKeys.from_evalkey(toy_ek, "cuda")
