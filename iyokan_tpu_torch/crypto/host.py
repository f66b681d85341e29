"""Host-side (numpy) TFHE key generation, encryption and decryption.

Everything here runs once per run on the host: key material, packet
encryption/decryption (the equivalents of ``encryptBits`` / ``encryptROM`` /
``encryptRAM`` and their decrypt counterparts, reference src/packet.hpp:68-189)
and the golden phase computations the tests use.  The performance-critical
*homomorphic* operations live in :mod:`iyokan_tpu_torch.crypto.ops` (torch).
Copied unchanged from iyokan_tpu/crypto/host.py: the same seed gives
byte-identical keys and ciphertexts in both packages.

All polynomial products needed on the host are of the form
``uint poly * binary key poly``; they are computed exactly with an FFT over
16-bit limbs (error << 0.5, then rounded), so keys and test vectors are
bit-reproducible across platforms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..params import Params, by_name

# --------------------------------------------------------------------------- #
# exact negacyclic polynomial arithmetic (host)
# --------------------------------------------------------------------------- #


def _negacyclic_conv_small(a: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Exact negacyclic convolution of int arrays with small values.

    ``a``: [..., N] with |entries| < 2**17, ``s``: [N] binary (or small).
    Result is exact int64: the float64 FFT error is < 0.5 for these ranges
    (max |coeff| ~ N * 2^17, well under the 2^53 mantissa).
    """
    N = a.shape[-1]
    w = np.exp(1j * np.pi * np.arange(N) / N)
    fa = np.fft.fft(a * w)
    fs = np.fft.fft(s * w)
    c = np.fft.ifft(fa * fs) * w.conj()
    return np.rint(c.real).astype(np.int64)


def polymul_bin_u32(a: np.ndarray, s: np.ndarray) -> np.ndarray:
    """(a * s) mod (X^N + 1) over Z_{2^32}; a: uint32 [..., N], s binary [N]."""
    a = np.asarray(a, np.uint32)
    lo = (a & np.uint32(0xFFFF)).astype(np.int64)
    hi = (a >> np.uint32(16)).astype(np.int64)
    clo = _negacyclic_conv_small(lo, s.astype(np.int64))
    chi = _negacyclic_conv_small(hi, s.astype(np.int64))
    return (clo.astype(np.uint64) + (chi.astype(np.uint64) << np.uint64(16))).astype(
        np.uint32
    )


def polymul_bin_u64(a: np.ndarray, s: np.ndarray) -> np.ndarray:
    """(a * s) mod (X^N + 1) over Z_{2^64}; a: uint64 [..., N], s binary [N]."""
    a = np.asarray(a, np.uint64)
    acc = np.zeros(a.shape, np.uint64)
    for limb in range(4):
        part = ((a >> np.uint64(16 * limb)) & np.uint64(0xFFFF)).astype(np.int64)
        c = _negacyclic_conv_small(part, s.astype(np.int64)).astype(np.uint64)
        acc += c << np.uint64(16 * limb)  # uint64 wrap-around is the torus mod
    return acc


def negacyclic_conv_i64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact reference negacyclic convolution for tests (O(N^2), int64)."""
    N = a.shape[-1]
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    full = np.zeros(a.shape[:-1] + (2 * N - 1,), np.int64)
    for i in range(N):
        full[..., i : i + N] += a[..., i : i + 1] * b
    out = full[..., :N].copy()
    out[..., : N - 1] -= full[..., N:]
    return out


# --------------------------------------------------------------------------- #
# keys
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class SecretKey:
    params: Params
    s0: np.ndarray  # uint8 [n]   lvl0 LWE key (binary)
    s1: np.ndarray  # uint8 [N]   lvl1 ring key (binary)
    s2: np.ndarray  # uint8 [N2]  lvl2 ring key (binary)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            np.savez_compressed(
                f, kind="secret-key", params=self.params.name,
                s0=self.s0, s1=self.s1, s2=self.s2,
            )

    @staticmethod
    def load(path: str) -> "SecretKey":
        z = np.load(path, allow_pickle=False)
        if "kind" not in z.files or str(z["kind"]) != "secret-key":
            raise ValueError(f"{path!r} is not a secret key file")
        return SecretKey(by_name(str(z["params"])), z["s0"], z["s1"], z["s2"])


@dataclasses.dataclass
class EvalKey:
    """Evaluation key: everything the engine needs without the secret.

    Contents (the equivalent of the reference's EvalKey assembled at
    src/iyokan-packet.cpp:150-160: iksk + bk(fft) lvl01 + bkfft lvl02 +
    privksk4cb lvl21):

      bk    uint32 [n, 2l, 2, N]      TRGSW_lvl1(s0_i), gate-bootstrap key
      bk2   uint64 [n, 2l2, 2, N2]    TRGSW_lvl2(s0_i), circuit-bootstrap key
      ksk   uint32 [N, t, n+1]        TLWE_lvl0(s1_z * 2^(32-(j+1)*basebit))
      pksk  uint32 [2, N2, t21, 2, N] TRLWE_lvl1 rows for the two private
                                      functions f0(x) = -s1*x, f1(x) = x
    """

    params: Params
    bk: np.ndarray
    bk2: np.ndarray
    ksk: np.ndarray
    pksk: np.ndarray
    # 2-bit key-unrolled bootstrapping key: TRGSW_lvl1 of
    # (s_2i*(1-s_2i+1), s_2i+1*(1-s_2i), s_2i*s_2i+1) per key-bit pair --
    # halves the sequential depth of the blind rotation.
    bku: np.ndarray = None
    # lvl2 analog of bku for the circuit-bootstrap rotation (see genevalkey)
    bk2u: np.ndarray = None

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            np.savez(
                f, kind="eval-key", params=self.params.name,
                bk=self.bk, bk2=self.bk2, ksk=self.ksk, pksk=self.pksk,
                bku=(self.bku if self.bku is not None
                     else np.zeros((0,), np.uint32)),
                bk2u=(self.bk2u if self.bk2u is not None
                      else np.zeros((0,), np.uint64)),
            )

    @staticmethod
    def load(path: str) -> "EvalKey":
        z = np.load(path, allow_pickle=False)
        if "kind" not in z.files or str(z["kind"]) != "eval-key":
            raise ValueError(f"{path!r} is not an eval key file")
        bku = z["bku"] if "bku" in z.files and z["bku"].size else None
        bk2u = z["bk2u"] if "bk2u" in z.files and z["bk2u"].size else None
        return EvalKey(
            by_name(str(z["params"])), z["bk"], z["bk2"], z["ksk"], z["pksk"],
            bku, bk2u,
        )


def keygen(params: Params, seed: Optional[int] = None) -> SecretKey:
    rng = np.random.default_rng(seed)
    return SecretKey(
        params,
        rng.integers(0, 2, params.n, dtype=np.uint8),
        rng.integers(0, 2, params.N, dtype=np.uint8),
        rng.integers(0, 2, params.N2, dtype=np.uint8),
    )


# --------------------------------------------------------------------------- #
# lvl0 TLWE
# --------------------------------------------------------------------------- #


def _gauss32(rng, alpha: float, shape) -> np.ndarray:
    return np.rint(rng.normal(0.0, alpha * 2.0 ** 32, shape)).astype(np.int64).astype(
        np.uint32
    )


def _gauss64(rng, alpha: float, shape) -> np.ndarray:
    return np.rint(rng.normal(0.0, alpha * 2.0 ** 64, shape)).astype(np.int64).astype(
        np.uint64
    )


def tlwe0_encrypt(sk: SecretKey, msg_u32: np.ndarray, rng) -> np.ndarray:
    """Encrypt torus values under s0.  msg_u32: uint32 [...]; -> uint32 [..., n+1]."""
    p = sk.params
    msg = np.asarray(msg_u32, np.uint32)
    a = rng.integers(0, 1 << 32, msg.shape + (p.n,), dtype=np.uint32)
    b = (
        (a.astype(np.uint64) * sk.s0.astype(np.uint64)).sum(-1).astype(np.uint32)
        + msg
        + _gauss32(rng, p.alpha, msg.shape)
    )
    return np.concatenate([a, b[..., None].astype(np.uint32)], axis=-1)

def tlwe0_phase(sk: SecretKey, ct: np.ndarray) -> np.ndarray:
    a, b = ct[..., : sk.params.n], ct[..., sk.params.n]
    return (
        b - (a.astype(np.uint64) * sk.s0.astype(np.uint64)).sum(-1).astype(np.uint32)
    ).astype(np.uint32)


def encrypt_bits(sk: SecretKey, bits: np.ndarray, rng) -> np.ndarray:
    """Reference ``encryptBits`` (src/packet.hpp:68-76): bit -> TLWE(+-1/8)."""
    mu = np.uint32(sk.params.mu)
    msg = np.where(np.asarray(bits, bool), mu, (~(mu) + np.uint32(1)))
    return tlwe0_encrypt(sk, msg, rng)


def decrypt_bits(sk: SecretKey, ct: np.ndarray) -> np.ndarray:
    """Sign test on the phase: phase in (0, 1/2) => 1."""
    return (tlwe0_phase(sk, ct) < np.uint32(1 << 31)).astype(np.uint8)


def trivial_tlwe0(params: Params, bits: np.ndarray) -> np.ndarray:
    """Noiseless TLWE of bits (reference HomCONSTANTONE/ZERO semantics)."""
    bits = np.asarray(bits, bool)
    out = np.zeros(bits.shape + (params.n + 1,), np.uint32)
    mu = np.uint32(params.mu)
    out[..., params.n] = np.where(bits, mu, (~(mu) + np.uint32(1)))
    return out


# --------------------------------------------------------------------------- #
# lvl1 / lvl2 TRLWE
# --------------------------------------------------------------------------- #


def trlwe1_encrypt(sk: SecretKey, msg_poly: np.ndarray, alpha: float, rng,
                   mask_grid_bits: int = 0) -> np.ndarray:
    """msg_poly: uint32 [..., N] -> TRLWE uint32 [..., 2, N].

    mask_grid_bits > 0 draws the mask `a` from the 2^mask_grid_bits-grid
    (low bits zero) instead of the full torus: used for the bootstrapping
    key so the Toeplitz-slab kernel's top-3-limb int8 key representation
    is EXACT on the mask component (see genevalkey for the security
    argument and the noise analysis that motivates it)."""
    p = sk.params
    msg = np.asarray(msg_poly, np.uint32)
    a = rng.integers(0, 1 << 32, msg.shape, dtype=np.uint32)
    if mask_grid_bits:
        a &= np.uint32((0xFFFFFFFF << mask_grid_bits) & 0xFFFFFFFF)
    b = polymul_bin_u32(a, sk.s1) + msg + _gauss32(rng, alpha, msg.shape)
    return np.stack([a, b], axis=-2)


def trlwe1_phase(sk: SecretKey, ct: np.ndarray) -> np.ndarray:
    a, b = ct[..., 0, :], ct[..., 1, :]
    return (b - polymul_bin_u32(a, sk.s1)).astype(np.uint32)


def trlwe2_encrypt(sk: SecretKey, msg_poly: np.ndarray, alpha: float, rng) -> np.ndarray:
    msg = np.asarray(msg_poly, np.uint64)
    a = rng.integers(0, 1 << 63, msg.shape, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, msg.shape, dtype=np.uint64)
    b = polymul_bin_u64(a, sk.s2) + msg + _gauss64(rng, alpha, msg.shape)
    return np.stack([a, b], axis=-2)


def trlwe2_phase(sk: SecretKey, ct: np.ndarray) -> np.ndarray:
    a, b = ct[..., 0, :], ct[..., 1, :]
    return (b - polymul_bin_u64(a, sk.s2)).astype(np.uint64)


# --------------------------------------------------------------------------- #
# TRGSW (gadget) encryptions -- used for the bootstrapping keys
# --------------------------------------------------------------------------- #


def trgsw1_encrypt(sk: SecretKey, m: int, rng) -> np.ndarray:
    """TRGSW_lvl1 of a small scalar m -> uint32 [2l, 2, N].

    Row (i, j) = TRLWE(0) + m * g_j on component i, g_j = 2^(32-(j+1)*Bgbit).
    """
    p = sk.params
    rows = trlwe1_encrypt(sk, np.zeros((2 * p.l, p.N), np.uint32), p.alpha1, rng)
    for j in range(p.l):
        g = np.uint32((m << (32 - (j + 1) * p.Bgbit)) & 0xFFFFFFFF)
        rows[j, 0, 0] += g          # part 'a'
        rows[p.l + j, 1, 0] += g    # part 'b'
    return rows


def trgsw2_encrypt(sk: SecretKey, m: int, rng) -> np.ndarray:
    p = sk.params
    rows = trlwe2_encrypt(sk, np.zeros((2 * p.l2, p.N2), np.uint64), p.alpha2, rng)
    for j in range(p.l2):
        g = np.uint64((m << (64 - (j + 1) * p.Bgbit2)) & 0xFFFFFFFFFFFFFFFF)
        rows[j, 0, 0] += g
        rows[p.l2 + j, 1, 0] += g
    return rows


def genevalkey(sk: SecretKey, seed: Optional[int] = None,
               with_cb: bool = True) -> EvalKey:
    """Assemble the evaluation key (cf. reference src/iyokan-packet.cpp:150-160).

    with_cb=False skips the circuit-bootstrapping material (bk2 / pksk),
    which is only needed for blueprints with CMUX memories
    (reference needsCircuitKey, src/iyokan.hpp:1897-1906).
    """
    p = sk.params
    rng = np.random.default_rng(seed)

    # --- bootstrapping-key mask quantization ---------------------------------
    # The bk/bku TRGSW masks are drawn from the 256-grid (low byte zero)
    # by default.  Why: the TPU engine's Toeplitz-slab kernel represents
    # each key coefficient as its top 3 balanced radix-256 limbs
    # (crypto/polymul.py:tkey_prep1); for a full-torus mask the dropped
    # limb is a ~2^-25.8 per-coefficient error on the MASK component,
    # which the phase multiplies by the secret s1 (||s1||^2 ~ N/2) --
    # accumulated over the n CMUX steps that is sigma ~ 2^-15.3 *
    # sqrt(N/2 * n) ~ 2^-6, enough to corrupt cascaded gates (~1.5e-3
    # error/gate at cggi128).  With masks on the 256-grid, balanced limb 0
    # is identically zero: the 3-limb slab is EXACT on the mask component
    # and only the benign b-component truncation remains (enters the
    # phase directly: sigma ~ 2^-10.6 total, vs the 2^-8.8 bootstrap
    # noise).  Security: the instance is equivalent (divide by 256) to
    # RLWE mod 2^24 with rounded noise -- the noise-to-modulus gap,
    # which drives lattice-attack cost, is 25 bits exactly as in the
    # full-torus instance (an LWR-style rounding argument); the gadget
    # constants m*2^(32-(j+1)*Bgbit) stay on the grid whenever
    # 32 - l*Bgbit >= 8, which holds for all shipped parameter sets.
    # Opt out (e.g. for interop experiments) with IYOKAN_BK_MASK_BITS=32.
    import os as _os

    qbits = 32 - int(_os.environ.get("IYOKAN_BK_MASK_BITS", "24"))
    if qbits < 0 or 32 - p.l * p.Bgbit < qbits:
        qbits = 0

    # --- gate bootstrapping key: TRGSW_lvl1(s0_i), batched encryption -------
    zeros = trlwe1_encrypt(sk, np.zeros((p.n, 2 * p.l, p.N), np.uint32),
                           p.alpha1, rng, mask_grid_bits=qbits)
    for j in range(p.l):
        g = (sk.s0.astype(np.uint64) << (32 - (j + 1) * p.Bgbit)).astype(np.uint32)
        zeros[:, j, 0, 0] += g
        zeros[:, p.l + j, 1, 0] += g
    bk = zeros

    # --- 2-bit unrolled gate bootstrapping key ------------------------------
    # pair i covers key bits (2i, 2i+1) (odd n padded with a zero bit);
    # messages (sa*(1-sb), sb*(1-sa), sa*sb) select among
    # {1, X^a1, X^a2, X^(a1+a2)} in one fused 3-product step.
    s0p = np.concatenate([sk.s0, np.zeros((-len(sk.s0)) % 2, np.uint8)])
    sa, sb = s0p[0::2].astype(np.uint64), s0p[1::2].astype(np.uint64)
    msgs = np.stack([sa * (1 - sb), sb * (1 - sa), sa * sb], axis=1)  # [n2,3]
    zu = trlwe1_encrypt(
        sk, np.zeros((len(sa), 3, 2 * p.l, p.N), np.uint32), p.alpha1, rng,
        mask_grid_bits=qbits,
    )
    for j in range(p.l):
        g = (msgs << np.uint64(32 - (j + 1) * p.Bgbit)).astype(np.uint32)
        zu[:, :, j, 0, 0] += g
        zu[:, :, p.l + j, 1, 0] += g
    bku = zu

    # --- circuit bootstrapping key: TRGSW_lvl2(s0_i) ------------------------
    if with_cb:
        z2 = trlwe2_encrypt(
            sk, np.zeros((p.n, 2 * p.l2, p.N2), np.uint64), p.alpha2, rng
        )
        for j in range(p.l2):
            g = sk.s0.astype(np.uint64) << np.uint64(64 - (j + 1) * p.Bgbit2)
            z2[:, j, 0, 0] += g
            z2[:, p.l2 + j, 1, 0] += g
        bk2 = z2

        # 2-bit unrolled circuit-bootstrapping key: the lvl2 analog of bku
        # (same pair messages), halving the sequential depth of the
        # latency-bound CB blind rotation (~23 rows/cycle on cahp-diamond)
        z2u = trlwe2_encrypt(
            sk, np.zeros((len(sa), 3, 2 * p.l2, p.N2), np.uint64),
            p.alpha2, rng
        )
        for j in range(p.l2):
            g2 = msgs << np.uint64(64 - (j + 1) * p.Bgbit2)   # [n2, 3]
            z2u[:, :, j, 0, 0] += g2
            z2u[:, :, p.l2 + j, 1, 0] += g2
        bk2u = z2u
    else:
        bk2 = np.zeros((0, 2 * p.l2, 2, p.N2), np.uint64)
        bk2u = np.zeros((0, 3, 2 * p.l2, 2, p.N2), np.uint64)

    # --- identity key switch lvl1 -> lvl0 (signed-digit scalar rows) --------
    # row (z, j) = TLWE_s0( s1_z * 2^(32-(j+1)*basebit) )
    ks_shifts = (32 - np.arange(1, p.ks_t + 1) * p.ks_basebit).astype(np.uint64)
    msgs = (sk.s1.astype(np.uint64)[:, None] << ks_shifts[None, :]).astype(
        np.uint32
    )
    ksk = tlwe0_encrypt(sk, msgs, rng)

    # --- private functional key switch lvl2 -> lvl1 -------------------------
    # f1(x) = x            : row (z, j) = TRLWE_s1( s2_z * 2^(32-(j+1)*bb) )
    # f0(x) = -s1(X) * x   : row (z, j) = TRLWE_s1( -s1 * s2_z * 2^(32-(j+1)*bb) )
    if with_cb:
        shifts = (32 - np.arange(1, p.pks_t + 1) * p.pks_basebit).astype(
            np.uint64
        )
        scal = (sk.s2.astype(np.uint64)[:, None] << shifts[None, :]).astype(
            np.uint32
        )
        msg1 = np.zeros((p.N2, p.pks_t, p.N), np.uint32)
        msg1[..., 0] = scal
        neg_s1 = ((~(sk.s1.astype(np.uint32)) + np.uint32(1))).astype(np.uint32)
        msg0 = scal[..., None].astype(np.uint32) * neg_s1[None, None, :]
        pksk0 = trlwe1_encrypt(sk, msg0, p.alpha_pks, rng)
        pksk1 = trlwe1_encrypt(sk, msg1, p.alpha_pks, rng)
        pksk = np.stack([pksk0, pksk1], axis=0)
    else:
        pksk = np.zeros((2, 0, p.pks_t, 2, p.N), np.uint32)

    return EvalKey(p, bk.astype(np.uint32), bk2.astype(np.uint64),
                   ksk.astype(np.uint32), pksk.astype(np.uint32),
                   bku.astype(np.uint32), bk2u.astype(np.uint64))


# --------------------------------------------------------------------------- #
# packet-level encryption (ROM / RAM encodings)
# --------------------------------------------------------------------------- #


def encrypt_rom(sk: SecretKey, bits: np.ndarray, rng) -> np.ndarray:
    """Pack bits coefficient-wise into TRLWEs, +-mu per coefficient.

    Mirrors reference ``encryptROM`` (src/packet.hpp:78-97): TRLWE #i holds
    bits [i*N, (i+1)*N), zero padded.
    """
    p = sk.params
    bits = np.asarray(bits, bool)
    n_tr = max(1, -(-bits.size // p.N))
    mu = np.uint32(p.mu)
    coeffs = np.zeros((n_tr * p.N,), np.uint32)
    coeffs[: bits.size] = np.where(bits, mu, (~(mu) + np.uint32(1)))
    return trlwe1_encrypt(sk, coeffs.reshape(n_tr, p.N), p.alpha1, rng)


def decrypt_rom(sk: SecretKey, ct: np.ndarray) -> np.ndarray:
    """All coefficients of all TRLWEs -> bits (reference decryptROM)."""
    ph = trlwe1_phase(sk, ct)
    return (ph.reshape(-1) < np.uint32(1 << 31)).astype(np.uint8)


def encrypt_ram(sk: SecretKey, bits: np.ndarray, rng) -> np.ndarray:
    """One TRLWE per bit, value in coefficient 0 (reference encryptRAM)."""
    p = sk.params
    bits = np.asarray(bits, bool)
    mu = np.uint32(p.mu)
    coeffs = np.zeros((bits.size, p.N), np.uint32)
    coeffs[:, 0] = np.where(bits, mu, (~(mu) + np.uint32(1)))
    return trlwe1_encrypt(sk, coeffs, p.alpha1, rng)


def decrypt_ram(sk: SecretKey, ct: np.ndarray) -> np.ndarray:
    ph = trlwe1_phase(sk, ct)
    return (ph[..., 0] < np.uint32(1 << 31)).astype(np.uint8)
