"""Toeplitz-slab key expansion (the "tkey" external product), host side.

Numpy slab constructors copied verbatim from iyokan_tpu/crypto/polymul.py
(the NTT backends of that module are not ported): the negacyclic convolution of the
per-gate digit polynomials against the *shared* per-step TRGSW rows becomes
a plain int8 matrix product against a precomputed Toeplitz window of the
key, exact mod 2^32 -- no primes, no Barrett, no CRT.

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

from ..params import Params


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
