"""Negacyclic NTT over two CRT primes, in torch int64.

Counterpart of iyokan_tpu/crypto/ntt.py, and the same transforms: the
external products of the CMUX memories and of circuit bootstrapping are
``small signed digit poly  x  torus poly``, computed exactly over the
integers with a two-prime CRT NTT and then reduced mod 2^32 (or, for the
64-bit torus, per 32-bit half):

  lvl1: |digit| <= Bg/2 = 32, torus < 2^32, N = 1024  =>  |conv| < 2^49.6
  lvl2 halves: |digit| <= 128, half < 2^32, N2 = 2048 =>  |conv| < 2^55

  P1 * P2 ~= 2^61.8, so the centred CRT reconstruction is exact in int64.

Forward: merged-psi Cooley-Tukey with bit-reversed output; inverse:
Gentleman-Sande consuming bit-reversed input.  Every product is of two
residues below 2^31, so (x * s) % p fits int64; torch's `%` is `remainder`
(the sign of the divisor), as jnp's `%` is.
"""

from __future__ import annotations

import functools
import typing

import numpy as np
import torch

P1 = 2013265921  # 15 * 2^27 + 1
P2 = 1811939329  # 27 * 2^26 + 1
PRIMES = (P1, P2)
_GENERATORS = {P1: 31, P2: 13}

P1P2 = P1 * P2
INV_P1_MOD_P2 = pow(P1, -1, P2)


def _bit_reverse(x: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(bits):
        out |= ((x >> i) & 1) << (bits - 1 - i)
    return out


@functools.lru_cache(maxsize=None)
def tables(N: int) -> dict:
    """Per-ring-size twiddle tables for both primes (host numpy, cached):
    psirev / psiinvrev int64 [2, N] (bit-reversed powers of the primitive
    2N-th root and of its inverse), ninv int64 [2]."""
    logn = int(np.log2(N))
    assert 1 << logn == N
    out = {"psirev": [], "psiinvrev": [], "ninv": []}
    rev = _bit_reverse(np.arange(N), logn)
    for p in PRIMES:
        psi = pow(_GENERATORS[p], (p - 1) // (2 * N), p)
        assert pow(psi, N, p) == p - 1
        pows = np.array([pow(psi, i, p) for i in range(N)], np.int64)
        ipows = np.array([pow(psi, -i % (2 * N), p) for i in range(N)],
                         np.int64)
        out["psirev"].append(pows[rev])
        out["psiinvrev"].append(ipows[rev])
        out["ninv"].append(pow(N, -1, p))
    return {"psirev": np.stack(out["psirev"]),
            "psiinvrev": np.stack(out["psiinvrev"]),
            "ninv": np.array(out["ninv"], np.int64)}


_DEV_TABLES = {}


def device_tables(N: int, device) -> dict:
    """tables(N) as int64 tensors on `device` (cached per device)."""
    key = (N, str(device))
    if key not in _DEV_TABLES:
        _DEV_TABLES[key] = {k: torch.from_numpy(v).to(device)
                            for k, v in tables(N).items()}
    return _DEV_TABLES[key]


@functools.lru_cache(maxsize=None)
def psi_powers(N: int) -> np.ndarray:
    """psi^e mod p for e in [0, 2N), both primes: int64 [2, 2N].  Slot pos
    of ntt_fwd's output holds the value at psi^(2k+1), k = bit-reverse(pos),
    so X^a multiplies that slot by psi^(a(2k+1) mod 2N)."""
    out = []
    for p in PRIMES:
        psi = pow(_GENERATORS[p], (p - 1) // (2 * N), p)
        out.append([pow(psi, e, p) for e in range(2 * N)])
    return np.array(out, np.int64)


def shoup_companion(w, p: int):
    """floor(w * 2^32 / p) of fixed multipliers w in [0, p) (int or int64
    array): the kernels' a * w mod p is a*w - umulhi(a, w') * p, then one
    conditional subtract (csrc/ntt.cuh:shoup_mul)."""
    return (np.asarray(w, np.int64) << 32) // p


def key_factor(N: int) -> tuple:
    """Per prime N^-1 * 2^32 mod p: the NTT kernels' key form carries it
    (ops/br.py:kernel_key), so a Montgomery reduction of a key product
    (times 2^-32) leaves the product times N^-1 and the inverse transform
    needs no scaling pass; K6 scales its inverse by it instead."""
    return tuple((pow(N, -1, p) << 32) % p for p in PRIMES)


class KernelTables(typing.NamedTuple):
    """The NTT kernels' (csrc/ntt.cuh) tables on one device.

    tw     int32 [2 primes, 2, N, 2]: psirev (forward) and psiinvrev
           (inverse) of each prime, each entry (w, its Shoup companion) as
           u32 bit patterns
    pw     int32 [2 primes, 2N, 2]: (psi^e - 1 mod p, its companion) for e
           in [0, 2N): K3's X^a - 1 at slot k is psi^(a(2k+1)) - 1
    scale  (w, w') of key_factor for P1, then P2, as Python ints
    """
    tw: torch.Tensor
    pw: torch.Tensor
    scale: tuple


_KERNEL_TABLES = {}


def _with_companion(w: np.ndarray, p: int) -> np.ndarray:
    return np.stack([w, shoup_companion(w, p)], axis=-1)


def kernel_tables(N: int, device) -> KernelTables:
    """kernel tables of ring size N on `device`, cached per device."""
    key = (N, str(device))
    if key not in _KERNEL_TABLES:
        t, pows = tables(N), psi_powers(N)
        tw = np.stack([np.stack([_with_companion(t["psirev"][i], p),
                                 _with_companion(t["psiinvrev"][i], p)])
                       for i, p in enumerate(PRIMES)])
        pw = np.stack([_with_companion((pows[i] - 1) % p, p)
                       for i, p in enumerate(PRIMES)])
        scale = tuple(int(v) for f, p in zip(key_factor(N), PRIMES)
                      for v in (f, shoup_companion(f, p)))
        _KERNEL_TABLES[key] = KernelTables(
            *(torch.from_numpy(a.astype(np.uint32).view(np.int32))
              .to(device).contiguous() for a in (tw, pw)), scale)
    return _KERNEL_TABLES[key]


def ntt_fwd(x: torch.Tensor, N: int, pi: int) -> torch.Tensor:
    """Forward negacyclic NTT; x int64 [..., N] in [0, p); bit-reversed
    output."""
    p = PRIMES[pi]
    psirev = device_tables(N, x.device)["psirev"][pi]
    x = x.to(torch.int64)
    lead = x.shape[:-1]
    m = 1
    while m < N:
        t = N // (2 * m)
        x = x.reshape(*lead, m, 2, t)
        s = psirev[m: 2 * m].reshape(m, 1)
        u = x[..., 0, :]
        v = (x[..., 1, :] * s) % p
        x = torch.stack([(u + v) % p, (u - v) % p], dim=-2).reshape(*lead, N)
        m *= 2
    return x


def ntt_inv(x: torch.Tensor, N: int, pi: int) -> torch.Tensor:
    """Inverse negacyclic NTT; consumes bit-reversed input, natural output."""
    p = PRIMES[pi]
    tab = device_tables(N, x.device)
    psiinvrev = tab["psiinvrev"][pi]
    ninv = int(tables(N)["ninv"][pi])
    x = x.to(torch.int64)
    lead = x.shape[:-1]
    m = N
    while m > 1:
        h = m // 2
        t = N // m
        x = x.reshape(*lead, h, 2, t)
        s = psiinvrev[h: 2 * h].reshape(h, 1)
        u = x[..., 0, :]
        v = x[..., 1, :]
        x = torch.stack([(u + v) % p, ((u - v) * s) % p],
                        dim=-2).reshape(*lead, N)
        m = h
    return (x * ninv) % p


def crt_center(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """CRT-reconstruct the centred integer in (-P1P2/2, P1P2/2), int64
    (Garner: x = r1 + P1 * ((r2 - r1) * P1^-1 mod P2), below P1P2 < 2^62)."""
    r1 = r1.to(torch.int64)
    diff = (r2.to(torch.int64) - r1) % P2
    t = (diff * INV_P1_MOD_P2) % P2
    x = r1 + P1 * t
    return torch.where(x >= P1P2 // 2, x - P1P2, x)
