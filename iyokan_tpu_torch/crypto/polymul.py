"""External-product keys and plain products (counterpart of
iyokan_tpu/crypto/polymul.py).

Two forms of the same exact product `digits (x) TRGSW rows`:

* the CRT64 NTT backend (`prep1`/`extprod1` at lvl1, `prep2`/`extprod2` at
  lvl2; iyokan_tpu's CRT64Backend): two 31-bit primes, crypto/ntt.py, exact
  over the integers and then reduced mod 2^32 (mod 2^64 at lvl2).  lvl2
  (circuit bootstrapping) runs it on every device; at lvl1 it is the plain
  twin of the extprod1_ntt kernel (ops/extprod.py), whose key layout it
  defines.  (The TPU's MXU backend -- four 16-bit primes, int8-limb twiddle
  matmuls -- is TPU-shaped and not ported.)
* the Toeplitz-slab ("tkey") key, host side, numpy constructors copied
  verbatim from iyokan_tpu/crypto/polymul.py: the negacyclic convolution of
  the per-gate digit polynomials against the *shared* per-step TRGSW rows
  becomes a plain int8 matrix product against a precomputed Toeplitz window
  of the key, exact mod 2^32 -- no primes, no Barrett, no CRT.

  out[g, u, 128K + b] = sum_{j,t} ext[g, j, 128(K+1) + t] * slab[j,u][t, b]

with ext = [d, -d] the negacyclic digit extension and
slab[t, b] = E[N - 128 + b - t], where E[m] = -key[m] for 0 <= m < N,
+key[m + N] for -128 <= m < 0, +key[0] for m = N.

The key is limb-decomposed into balanced radix-256 int8 limbs; the top
`limbs` of 4 are kept.  host.genevalkey samples bk masks on the 256-grid, so
the 3-limb slab is exact on the mask component and only the b-component
truncation remains (see iyokan_tpu/crypto/polymul.py for the noise budget).
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import Params
from . import ntt

MASK32 = 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# the CRT64 NTT backend
# --------------------------------------------------------------------------- #


def prep1(rows: torch.Tensor, p: Params) -> torch.Tensor:
    """TRGSW rows i32 [..., RR, 2, N] (u32 bit patterns) -> NTT residues
    int32 [..., RR, 2, P=2, N] (bit-reversed order, each below 2^31)."""
    v = rows.to(torch.int64) & MASK32
    outs = [ntt.ntt_fwd(v % prime, p.N, pi)
            for pi, prime in enumerate(ntt.PRIMES)]
    return torch.stack(outs, dim=-2).to(torch.int32)


def extprod1(digits: torch.Tensor, prep: torch.Tensor,
             p: Params) -> torch.Tensor:
    """digits int [..., RR, N]; prep int32 [..., RR, 2, P, N] (leading dims
    broadcastable against the digits') -> i32 [..., 2, N], the negacyclic
    sum_r digits[r] * rows[r, u] mod 2^32."""
    from .ops import from_u64

    outs = []
    for pi, prime in enumerate(ntt.PRIMES):
        dn = ntt.ntt_fwd(digits.to(torch.int64) % prime, p.N, pi)
        g = prep[..., pi, :].to(torch.int64)
        s = ((dn[..., :, None, :] * g) % prime).sum(dim=-3) % prime
        outs.append(ntt.ntt_inv(s, p.N, pi))
    return from_u64(ntt.crt_center(outs[0], outs[1]))


def prep2(rows: torch.Tensor, p: Params) -> torch.Tensor:
    """TRGSW lvl2 rows int64 [..., RR, 2, N2] (u64 bit patterns) -> NTT
    residues of their 32-bit halves, int64 [..., RR, 2, P*2, N2] (index
    2*prime + half)."""
    lo = rows & MASK32
    hi = (rows >> 32) & MASK32           # arithmetic shift, then mask
    halves = torch.stack([lo, hi], dim=-2)
    outs = [ntt.ntt_fwd(halves % prime, p.N2, pi)
            for pi, prime in enumerate(ntt.PRIMES)]
    st = torch.stack(outs, dim=-3)       # [..., RR, 2, P, 2, N2]
    return st.reshape(*st.shape[:-3], 4, st.shape[-1])


def extprod2(digits: torch.Tensor, prep: torch.Tensor,
             p: Params) -> torch.Tensor:
    """digits int [..., RR, N2]; prep int64 [..., RR, 2, 4, N2] -> int64
    [..., 2, N2], u64 bit patterns of the product mod 2^64: each 32-bit
    half of the key is an exact product (|conv| < 2^55), recombined as
    lo + (hi << 32) with two's-complement wrap."""
    outs = []
    for pi, prime in enumerate(ntt.PRIMES):
        dn = ntt.ntt_fwd(digits.to(torch.int64) % prime, p.N2, pi)
        g = prep[..., 2 * pi: 2 * pi + 2, :]               # both halves
        s = ((dn[..., :, None, None, :] * g) % prime).sum(dim=-4) % prime
        outs.append(ntt.ntt_inv(s, p.N2, pi))              # [..., 2, 2, N2]
    c = ntt.crt_center(outs[0], outs[1])
    return c[..., 0, :] + (c[..., 1, :] << 32)


# --------------------------------------------------------------------------- #
# the Toeplitz-slab key (host numpy)
# --------------------------------------------------------------------------- #


def tkey_prep1(bk_u32: np.ndarray, p: Params, limbs: int = 3) -> np.ndarray:
    """Host: TRGSW rows u32 [n, RR, 2, N] -> Toeplitz slabs
    int8 [n, RR, 2, limbs, N, 128] (limbs are the TOP `limbs` balanced
    radix-256 digits: scales 256^(4-limbs) .. 256^3)."""
    n, RR, two, N = bk_u32.shape
    assert N % 128 == 0 and two == 2
    key = bk_u32.astype(np.int64)
    # E[m] over m in [-128, N]: stored at index m + 128, length N + 129
    E = np.empty((n, RR, 2, N + 129), np.int64)
    E[..., 128 : 128 + N] = -key
    E[..., :128] = key[..., N - 128 :]
    E[..., 128 + N] = key[..., 0]
    # balanced radix-256 limbs, top `limbs` kept
    v = E & 0xFFFFFFFF
    v = np.where(v >> 31, v - (1 << 32), v)           # centered mod 2^32
    ls = []
    for _ in range(4):
        l0 = ((v + 128) & 255) - 128
        ls.append(l0.astype(np.int8))
        v = (v - l0) >> 8
    lim = np.stack(ls[4 - limbs :], axis=-2)          # [n, RR, 2, L, N+129]
    # slab[t, b] = E[N - 128 + b - t] = buf[(N + b) - t] with buf = lim
    # (index m+128); as_strided: stride -1 over t, +1 over b, base N + b=0
    s = lim.strides[-1]
    view = np.lib.stride_tricks.as_strided(
        lim[..., N:],                                  # base at m = N - 128
        shape=lim.shape[:-1] + (N, 128),
        strides=lim.strides[:-1] + (-s, s),
    )
    return np.ascontiguousarray(view)


def tkey_extprod_ref(digits: np.ndarray, slabs: np.ndarray,
                     limbs: int) -> np.ndarray:
    """Numpy reference of the slab matmul path (for tests): digits int
    [G, RR, N], slabs int8 [RR, 2, L, N, 128] -> u32 [G, 2, N]."""
    G, RR, N = digits.shape
    ext = np.concatenate([digits, -digits], axis=-1).astype(np.int64)
    out = np.zeros((G, 2, N), np.int64)
    for K in range(N // 128):
        w = 128 * (K + 1)
        lhs = ext[:, :, w : w + N]                     # [G, RR, N]
        for u in range(2):
            for li in range(limbs):
                z = np.einsum(
                    "gjt,jtb->gb", lhs, slabs[:, u, li].astype(np.int64)
                )
                sh = 8 * (4 - limbs + li)
                out[:, u, 128 * K : 128 * K + 128] += z << sh
    return (out & 0xFFFFFFFF).astype(np.uint32)


def tkey_kernel_key(bk_u32: np.ndarray, p: Params, limbs: int = 3,
                    layout: str = "thin", lb: int = None) -> np.ndarray:
    """Host: TRGSW rows -> the ops/pallas_tk kernel key layout.

    layout="thin": int8 [n, 2l, N, 2*limbs*128] -- one dot per (j, K).
    layout="fat":  int8 [n, 2l*N, 2*limbs*128] with contraction rows
    ordered (t//128, j, t%128), matching the 128-lane-interleaved digit
    extension -- j folds into the contraction, one dot per K.
    layout="fat2": int8 [n, 2*(2l*N), C] = the fat slab of the NEGATED key
    rows followed by the fat slab of the key: output block K is then ONE
    contiguous-window dot ext . bk[2lN - cut : 2*2lN - cut] (the negacyclic
    wraparound sign is baked into the first copy), instead of two
    complementary dots and a subtraction.  The negation happens BEFORE the
    balanced-limb decomposition (a limb of -128 has no int8 negative).
    Columns are (u, limb, 128) in all layouts.

    lb < p.l drops the least-significant b-part gadget rows (asymmetric
    gadget): the b-part decomposition error enters the phase directly
    (not via the secret), so 2 digits add only sigma ~ 2^-9.7 against the
    2^-8.8 bootstrap noise while cutting contraction rows 2l -> l+lb."""
    if lb is not None and not 1 <= lb <= p.l:
        # lb=0 would make a fat2 slab's row count collide with the plain
        # fat layout (2*(l+0) == l+l), so the kernel's row-count layout
        # inference would silently misread it -- reject early.
        raise ValueError(f"lb={lb} out of range: need 1 <= lb <= l={p.l}")
    if bk_u32.ndim == 4 and bk_u32.shape[1] == 3 * 2 * p.l:
        # 2-bit unrolled input (bku): rows per pair step are
        # (m, part, j)-ordered; the asymmetric gadget drops the
        # low b-part digits of each of the 3 products.
        lbe = p.l if lb is None else lb
        if 3 * (p.l + lbe) <= 4 * p.l:
            # would collide with a fat2 row count (e.g. l=3, lb=1:
            # 3*(3+1) == 2*(3+3)); the kernel infers fat2 there
            raise ValueError(
                f"unrolled slab with lb={lbe} at l={p.l} is ambiguous "
                "with a fat2 layout; use a larger lb")
        if lbe < p.l:
            zu = bk_u32.reshape(bk_u32.shape[0], 3, 2 * p.l,
                                *bk_u32.shape[2:])
            bk_u32 = np.concatenate(
                [zu[:, :, : p.l], zu[:, :, p.l : p.l + lbe]], axis=2
            ).reshape(bk_u32.shape[0], 3 * (p.l + lbe), *bk_u32.shape[2:])
    elif (lb is not None and lb < p.l and bk_u32.ndim == 4
            and bk_u32.shape[1] == 2 * p.l):
        bk_u32 = np.concatenate(
            [bk_u32[:, : p.l], bk_u32[:, p.l : p.l + lb]], axis=1
        )

    def fat(src):
        slab = tkey_prep1(src, p, limbs)       # [n, RR, 2, L, N, 128]
        k = np.transpose(slab, (0, 1, 4, 2, 3, 5))
        k = np.ascontiguousarray(
            k.reshape(k.shape[:3] + (2 * limbs * 128,))
        )                                      # [n, RR, N, 2L*128]
        if layout == "thin":
            return k
        n, RR, N, C = k.shape
        kf = k.reshape(n, RR, N // 128, 128, C).transpose(0, 2, 1, 3, 4)
        return np.ascontiguousarray(kf.reshape(n, RR * N, C))

    if layout != "fat2":
        return fat(bk_u32)
    neg = ((0 - bk_u32.astype(np.int64)) & 0xFFFFFFFF).astype(np.uint32)
    return np.concatenate([fat(neg), fat(bk_u32)], axis=1)
