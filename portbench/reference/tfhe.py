"""Decryption of a result packet's ciphertexts with the secret key, and
their phase errors, in plain NumPy.

TLWE lvl0: uint32 [..., n + 1] = (a, b), phase b - <a, s0> mod 2^32.
TRLWE lvl1: uint32 [..., 2, N] = (a, b), phase b - a * s1 in
Z_2^32[X]/(X^N + 1); a RAM bit sits in coefficient 0, whose product term
is a_0 s_0 - sum_{j >= 1} a_{N-j} s_j.
A bit is 1 where the phase lies in [0, 1/2) of the torus; its ideal phase
is +1/8 (1) or -1/8 (0).  The phase error is the distance to that ideal,
reported in sixteenths of the torus: a bit decrypts wrong at 2.
"""

from __future__ import annotations

import numpy as np

MU = 1 << 29                  # 1/8 of the 32-bit torus
SIXTEENTHS = 16.0 / 2.0 ** 32


def secret_key(params: dict, seed: int) -> dict:
    """Binary keys s0 [n], s1 [N], s2 [N2] drawn from `seed` in that order
    (the draw the packet tool's key file format holds)."""
    rng = np.random.default_rng(seed)
    return {"s0": rng.integers(0, 2, params["n"], dtype=np.uint8),
            "s1": rng.integers(0, 2, params["N"], dtype=np.uint8),
            "s2": rng.integers(0, 2, params["N2"], dtype=np.uint8)}


def tlwe_phase(ct: np.ndarray, s0: np.ndarray) -> np.ndarray:
    ct = np.asarray(ct, np.uint32)
    n = s0.shape[0]
    dot = (ct[..., :n].astype(np.uint64) * s0.astype(np.uint64)).sum(-1)
    return (ct[..., n].astype(np.uint64) - dot).astype(np.uint32)


def trlwe_phase0(ct: np.ndarray, s1: np.ndarray) -> np.ndarray:
    """Coefficient 0 of each TRLWE's phase."""
    ct = np.asarray(ct, np.uint32)
    a, b0 = ct[..., 0, :].astype(np.uint64), ct[..., 1, 0].astype(np.uint64)
    s = s1.astype(np.uint64)
    # a * s at X^0: a_0 s_0 - sum_{j>=1} a_{N-j} s_j (mod 2^32)
    plus = a[..., 0] * s[0]
    minus = (a[..., :0:-1] * s[1:]).sum(-1)
    return (b0 - plus + minus).astype(np.uint32)


def bits_and_errors(phase: np.ndarray, want: np.ndarray):
    """(decrypted bits, phase errors in sixteenths of the torus against the
    ideal phase of the bits `want`)."""
    phase = np.asarray(phase, np.uint32)
    bits = (phase < np.uint32(1 << 31)).astype(np.uint8)
    ideal = np.where(np.asarray(want, bool), np.uint32(MU),
                     np.uint32((1 << 32) - MU))
    diff = (phase - ideal).astype(np.uint32).view(np.int32).astype(np.int64)
    return bits, np.abs(diff) * SIXTEENTHS
