"""Batched homomorphic operations (torch).

Counterpart of iyokan_tpu/crypto/ops.py.  Everything is batched over gates:
the levelized executor evaluates all ready gates of a circuit level in one
call.  Gate bootstrapping, the lvl1 CMUX (decompose1 / extprod_term / cmux
/ trgsw_invert), and circuit bootstrapping (blind_rotate2 on the 64-bit
torus, privks, circuit_bootstrap).

Torus representation: torch has no unsigned 32/64-bit arithmetic.
lvl0/lvl1 torus values live in int32 tensors as uint32 bit patterns;
arithmetic that may wrap is done in int64 on values in [0, 2^32) and masked
(`to_u64`, `from_u64`), so a right shift of such a value is logical.  lvl2
torus values live in int64 tensors as uint64 bit patterns: + - * and
negation wrap mod 2^64 in two's complement, and every right shift is
arithmetic, so it is masked right after (`(x >> s) & mask`).

Shapes (i32 = int32 bit patterns of u32, i64 = int64 bit patterns of u64):
  TLWE lvl0   i32 [..., n+1]
  TLWE lvl1   i32 [..., N+1]
  TRLWE lvl1  i32 [..., 2, N]
  TRGSW lvl1  i32 [..., 2l, 2, N]     row i*l+j: digit j on part i
  TRLWE lvl2  i64 [..., 2, N2]
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import tempfile
import warnings

import numpy as np
import torch

from ..params import Params
from ..parallel import mesh as mesh_mod
from . import polymul
from .host import EvalKey

MASK32 = 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# uint32 <-> int32 bit patterns
# --------------------------------------------------------------------------- #


def to_u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 value in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def from_u64(v: torch.Tensor) -> torch.Tensor:
    """int64 (any value) -> int32 bit pattern of v mod 2^32."""
    v = v & MASK32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 array -> int32 bit-pattern tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy uint32 array (a host copy, also of
    a CPU tensor: the engine updates its state in place)."""
    return t.detach().to("cpu", copy=True).numpy().view(np.uint32)


def u64_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint64 array -> int64 bit-pattern tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(a, np.uint64))
    return torch.from_numpy(a.view(np.int64)).to(device)


def _i64(v: int) -> int:
    """A 64-bit constant (mod 2^64) as the int64 of the same bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


# --------------------------------------------------------------------------- #
# gadget decomposition
# --------------------------------------------------------------------------- #


def decompose1_offset(p: Params) -> int:
    """decompose1's offset, below 2^32: Bg/2 per level centres the digits,
    half the last level's unit rounds the truncated tail to nearest."""
    offset = sum((p.Bg // 2) << (32 - (j + 1) * p.Bgbit) for j in range(p.l))
    return (offset + (1 << (31 - p.l * p.Bgbit))) & MASK32


def decompose1(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Signed gadget decomposition, 32-bit torus.

    x: [..., 2, N], i32 bit patterns or any int64 (taken mod 2^32) ->
    int32 [..., 2l, N], digit (i*l+j) for part i (decompose1_offset).
    """
    xp = (x.to(torch.int64) + decompose1_offset(p)) & MASK32
    outs = [((xp >> (32 - (j + 1) * p.Bgbit)) & (p.Bg - 1)) - p.Bg // 2
            for j in range(p.l)]
    dig = torch.stack(outs, dim=-2).to(torch.int32)     # [..., 2, l, N]
    return dig.reshape(*dig.shape[:-3], 2 * p.l, dig.shape[-1])


def decompose2(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Signed gadget decomposition, 64-bit torus: i64 [..., 2, N2] ->
    int32 [..., 2l2, N2] (row i*l2+j)."""
    offset = sum((p.Bg2 // 2) << (64 - (j + 1) * p.Bgbit2)
                 for j in range(p.l2))
    offset += 1 << (63 - p.l2 * p.Bgbit2)
    xp = x + _i64(offset)
    outs = [((xp >> (64 - (j + 1) * p.Bgbit2)) & (p.Bg2 - 1)) - p.Bg2 // 2
            for j in range(p.l2)]
    dig = torch.stack(outs, dim=-2).to(torch.int32)
    return dig.reshape(*dig.shape[:-3], 2 * p.l2, dig.shape[-1])


# --------------------------------------------------------------------------- #
# external product / CMUX (lvl1)
# --------------------------------------------------------------------------- #


def prep_trgsw(trgsw: torch.Tensor, p: Params) -> torch.Tensor:
    """i32 TRGSW rows [..., 2l, 2, N] -> the CRT64-prepared key
    int32 [..., 2l, 2, P, N] that ops/extprod.py consumes."""
    return polymul.prep1(trgsw, p)


def extprod_term(g_prep: torch.Tensor, c: torch.Tensor, p: Params,
                 idx: torch.Tensor = None) -> torch.Tensor:
    """TRGSW (x) TRLWE product term decomp(c) * G as i32 [..., 2, N].

    g_prep: one prepared TRGSW [2l, 2, P, N], or, with idx, a stack
    [K, 2l, 2, P, N] of which row r of c takes key idx[r] (idx: int
    [...] over c's leading dims; ops/extprod.py checks a host index's range
    there and copies it to the card, and a card index's on the card, with
    no device sync either way).  Runs ops/extprod.extprod1: the
    extprod1_ntt kernel for a CUDA tensor, its plain twin on the CPU."""
    from ..ops.extprod import extprod1

    lead = c.shape[:-2]
    d = decompose1(c, p).reshape(-1, 2 * p.l, p.N)
    if idx is None:
        keys = g_prep[None]
    else:
        keys = g_prep
        idx = idx.expand(lead).reshape(-1)
    return extprod1(d, keys, idx, p).reshape(*lead, 2, p.N)


def cmux(g_prep: torch.Tensor, c1: torch.Tensor, c0: torch.Tensor,
         p: Params, idx: torch.Tensor = None) -> torch.Tensor:
    """CMUX(g, c1, c0) = c0 + g (x) (c1 - c0): g ? c1 : c0 (TFHEpp CMUXFFT
    as the reference ROM/RAM trees use it)."""
    c0u = to_u64(c0)
    diff = to_u64(c1) - c0u
    return from_u64(c0u + to_u64(extprod_term(g_prep, diff, p, idx)))


def trgsw_invert(trgsw: torch.Tensor, p: Params) -> torch.Tensor:
    """TRGSW(1-m) from TRGSW(m): the trivial gadget of 1 minus the rows
    (TFHEpp's CircuitBootstrappingFFTwithInv pair)."""
    # the gadget 2^(32 - (j+1) Bgbit) made on the device (no host copy)
    val = torch.ones(p.l, dtype=torch.int64, device=trgsw.device) << (
        32 - p.Bgbit * torch.arange(1, p.l + 1, device=trgsw.device))
    g = torch.zeros((2 * p.l, 2, p.N), dtype=torch.int64,
                    device=trgsw.device)
    g[: p.l, 0, 0] = val
    g[p.l:, 1, 0] = val
    return from_u64(g - to_u64(trgsw))


# --------------------------------------------------------------------------- #
# polynomial rotation / sample extraction
# --------------------------------------------------------------------------- #


def _negate_where(cond: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """-v where cond, else v, on v's torus: i32 (u32 patterns) or i64 (u64
    patterns, whose negation wraps mod 2^64)."""
    if v.dtype == torch.int64:
        return torch.where(cond, -v, v)
    u = to_u64(v)
    return from_u64(torch.where(cond, -u, u))


def rot_poly(poly: torch.Tensor, r: torch.Tensor, N: int) -> torch.Tensor:
    """X^r * poly mod (X^N + 1), batched.

    poly: i32 or i64 [..., N]; r: integer [...] broadcastable against the
    leading dims (one rotation amount per batch row), values in [0, 2N).
    Coefficient k of the result is poly[m] for m = (k - r) mod 2N below N,
    and -poly[m - N] otherwise.
    """
    k = torch.arange(N, device=poly.device)
    m = torch.remainder(k - r.to(torch.int64)[..., None], 2 * N)
    shape = torch.broadcast_shapes(poly.shape, m.shape)
    m = m.expand(shape)
    src = torch.where(m < N, m, m - N)
    v = torch.gather(poly.expand(shape), -1, src)
    return _negate_where(m >= N, v)


def sample_extract(trlwe: torch.Tensor, idx: int) -> torch.Tensor:
    """TRLWE [..., 2, N] -> TLWE [..., N+1] extracting coefficient idx
    (lvl1 i32 or lvl2 i64).

    a'_j = a_{idx-j} (j <= idx), -a_{N+idx-j} (j > idx); b' = b_idx.
    """
    N = trlwe.shape[-1]
    j = torch.arange(N, device=trlwe.device)
    src = torch.remainder(idx - j, N)
    a2 = _negate_where(j > idx, trlwe[..., 0, :][..., src])
    b = trlwe[..., 1, idx: idx + 1]
    return torch.cat([a2, b], dim=-1)


# --------------------------------------------------------------------------- #
# identity key switch lvl1 -> lvl0
# --------------------------------------------------------------------------- #


def _ks_digits(a: torch.Tensor, t: int, basebit: int) -> torch.Tensor:
    """Signed digits of each 32-bit torus coefficient, int64 [..., t]."""
    base = 1 << basebit
    prec = t * basebit
    off = (1 << (32 - prec - 1)) + sum(
        (base // 2) << (32 - (j + 1) * basebit) for j in range(t)
    )
    xp = (to_u64(a) + (off & MASK32)) & MASK32
    ds = [((xp >> (32 - (j + 1) * basebit)) & (base - 1)) - base // 2
          for j in range(t)]
    return torch.stack(ds, dim=-1)


def keyswitch_10(tlwe1: torch.Tensor, ksk_mat: torch.Tensor,
                 p: Params) -> torch.Tensor:
    """Identity key switch lvl1 -> lvl0 as one dense matmul.

    tlwe1: i32 [..., N+1]; ksk_mat: [N*t, n+1], the i32 key or its float64
    copy (DeviceKeys.ksk_f64).  The i32 bit pattern read as a signed value
    is the centred representative of the key mod 2^32, so one float64
    product of the signed digits against it is exact: |d| <= base/2 = 1
    and |key| <= 2^31 over K = N*t = 16384 rows bound every partial sum by
    2^14 * 2^31 = 2^45 < 2^53.  The sum is reduced mod 2^32 after the
    product.  (No TF32 or bf16 anywhere: float64 is never downcast.)
    """
    a = tlwe1[..., : p.N]
    b = tlwe1[..., p.N]
    d = _ks_digits(a, p.ks_t, p.ks_basebit)
    d = d.reshape(*d.shape[:-2], p.N * p.ks_t)
    key = ksk_mat if ksk_mat.dtype == torch.float64 else ksk_mat.to(
        torch.float64)
    acc = torch.matmul(d.to(torch.float64), key).to(torch.int64)
    out = -acc
    out[..., p.n] += to_u64(b)
    return from_u64(out)


# --------------------------------------------------------------------------- #
# blind rotation (lvl1) and the batched gate bootstrap
# --------------------------------------------------------------------------- #


def _modswitch(x: torch.Tensor, log2n: int) -> torch.Tensor:
    """i32 torus -> Z_{2N} with rounding, int32."""
    sh = 32 - log2n - 1
    v = ((to_u64(x) + (1 << (sh - 1))) & MASK32) >> sh
    return (v & ((1 << (log2n + 1)) - 1)).to(torch.int32)


def gate_route(bk_prep: torch.Tensor, p: Params) -> str:
    """The route a gate blind rotation takes on this key, as iyokan_tpu's
    blind_rotate dispatches on its key's layout and IYOKAN_BR_IMPL (see
    DeviceKeys for the table):

    "tkey"         int8 slab, any layout: ops/tkey.py (K1, K2);
    "pallas"       plain key, IYOKAN_BR_IMPL=pallas: ops/br.py, K5 per step;
    "pallas2"      plain key, IYOKAN_BR_IMPL=pallas2: ops/br.py, K4;
    "v3"           plain key, IYOKAN_BR_IMPL=v3: ops/br3.py, K3 at M = 1;
    "v3-unrolled"  unrolled key, IYOKAN_BR_IMPL=v3: K3 at M = 3;
    "ntt-step"     plain key otherwise (and always under IYOKAN_EP=pallas,
                   where the JAX package holds a K6 kernel-layout key):
                   rotate -> decompose1 -> extprod1 per step;
    "ntt-unrolled" unrolled key otherwise: 3 rotated differences, one
                   3*2l-row extprod1 per key-bit pair.
    The plain key is int32 [n, 2l, 2, P, N], the unrolled one int32
    [ceil(n/2), 3*2l, 2, P, N] (polymul.prep1)."""
    if bk_prep.dtype == torch.int8:
        return "tkey"
    impl = os.environ.get("IYOKAN_BR_IMPL")
    lead = tuple(bk_prep.shape[:2]) if bk_prep.dim() == 5 else ()
    if lead == ((p.n + 1) // 2, 6 * p.l):
        return "v3-unrolled" if impl == "v3" else "ntt-unrolled"
    if lead != (p.n, 2 * p.l):
        raise ValueError(
            f"blind-rotation key {tuple(bk_prep.shape)} {bk_prep.dtype} is "
            "neither a tkey slab nor a prepared [n, 2l, 2, P, N] NTT key "
            "(plain or 2-bit unrolled)")
    if os.environ.get("IYOKAN_EP") != "pallas" and impl in (
            "pallas", "pallas2", "v3"):
        return impl
    return "ntt-step"


def blind_rotate(tlwe0: torch.Tensor, bk_prep: torch.Tensor,
                 testv: torch.Tensor, p: Params) -> torch.Tensor:
    """Batched blind rotation lvl0 -> TRLWE lvl1: i32 [G, 2, N] with phase
    testv * X^{-phase_2N}, on the route gate_route gives: a kernel of
    ops/tkey.py, ops/br.py or ops/br3.py, or a loop of extprod1 launches
    (ops/extprod.py, the extprod1_ntt kernel on the card) over the plain
    key (one per step) or the unrolled key (one per key-bit pair; the 2-bit
    unrolling X^(a1 s1 + a2 s2) = 1 + s1(1-s2)(X^a1 - 1) + s2(1-s1)(X^a2 - 1)
    + s1 s2 (X^(a1+a2) - 1) halves the sequential depth)."""
    route = gate_route(bk_prep, p)
    if route == "tkey":
        from ..ops.tkey import blind_rotate_tkey

        # under a mesh each shard runs the kernel on its own rows against
        # the one slab (iyokan_tpu's shard_map of the tkey kernel, on the
        # same G % n and G // n rule)
        return mesh_mod.shard_batch(
            tlwe0, lambda t: blind_rotate_tkey(t, bk_prep, testv, p))
    if route in ("pallas", "pallas2"):
        from ..ops import br

        fn = br.blind_rotate_pallas if route == "pallas" else \
            br.blind_rotate_pallas2
        return fn(tlwe0, bk_prep, testv, p)
    if route.startswith("v3"):
        from ..ops.br3 import blind_rotate_pallas3

        return blind_rotate_pallas3(tlwe0, bk_prep, testv, p)
    from ..ops.extprod import extprod1
    from ..ops.tkey import _setup

    rows, acc = _setup(tlwe0, testv, p)
    return ntt_route_steps(rows, acc, bk_prep, p, extprod1)


def pair_amounts(rows: torch.Tensor, steps: int, N: int):
    """The rotation amounts of a 2-bit-unrolled key's steps from rows int
    [n, G] (one per key bit): a1, a2 and (a1 + a2) mod 2N of each
    key-bit pair, each [steps, G] for steps = ceil(n/2), an odd n padded
    with a2 = 0."""
    pad = 2 * steps - rows.shape[0]
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
    a1, a2 = rows[0::2], rows[1::2]
    return a1, a2, (a1 + a2) % (2 * N)


def ntt_route_steps(rows: torch.Tensor, acc: torch.Tensor,
                    bk_prep: torch.Tensor, p: Params,
                    product) -> torch.Tensor:
    """The ntt-step / ntt-unrolled loop of blind_rotate from its set-up
    (rows int32 [n, G], acc i32 [G, 2, N]; ops/tkey._setup), with
    `product` as the lvl1 external product: ops/extprod.extprod1 on the
    route, its twin extprod1_ref where chip_smoke.py holds the route on the
    card against it.  The key's row count picks the loop: 3*2l rows a
    step is the unrolled key."""
    unrolled = bk_prep.shape[1] == 6 * p.l
    if unrolled:
        amounts = pair_amounts(rows, bk_prep.shape[0], p.N)
    for i in range(bk_prep.shape[0]):
        u = to_u64(acc)
        if unrolled:
            d = torch.cat([decompose1(to_u64(rot_poly(acc, a[i][:, None],
                                                      p.N)) - u, p)
                           for a in amounts], dim=-2)         # [G, 3*2l, N]
        else:
            d = decompose1(to_u64(rot_poly(acc, rows[i][:, None], p.N)) - u,
                           p)
        acc = from_u64(u + to_u64(product(d, bk_prep[i][None], None, p)))
    return acc


def gate_bootstrap_tlwe1(pre: torch.Tensor, bk_prep: torch.Tensor,
                         p: Params) -> torch.Tensor:
    """pre-linear-combined TLWE lvl0 batch -> TLWE lvl1 (+-mu) batch."""
    testv = torch.full((p.N,), p.mu, dtype=torch.int32, device=pre.device)
    acc = blind_rotate(pre, bk_prep, testv, p)
    return sample_extract(acc, 0)


# --------------------------------------------------------------------------- #
# blind rotation lvl2 (circuit bootstrapping inner loop)
# --------------------------------------------------------------------------- #


def blind_rotate2(tlwe0: torch.Tensor, bk2_prep: torch.Tensor,
                  testv: torch.Tensor, p: Params) -> torch.Tensor:
    """Batched blind rotation lvl0 -> TRLWE lvl2 (64-bit torus).

    tlwe0: i32 [G, n+1]; bk2_prep: polymul.prep2 of the plain key
    [n, 2l2, 2, N2] or of the 2-bit-unrolled key [ceil(n/2), 3*2l2, 2, N2]
    (host.genevalkey's bk2u: one fused 3-product step per key-bit pair,
    half the sequential depth); testv: i64 [N2] or one per row [G, N2].
    Returns i64 [G, 2, N2].  The external products are the CRT64 twin
    (polymul.extprod2) on every device: the JAX package runs lvl2 on XLA,
    with no Pallas kernel.
    """
    G = tlwe0.shape[0]
    abar = _modswitch(tlwe0[:, : p.n], p.logN2).to(torch.int64)
    bbar = _modswitch(tlwe0[:, p.n], p.logN2).to(torch.int64)
    acc_b = rot_poly(testv.expand(G, p.N2),
                     torch.remainder(-bbar, 2 * p.N2), p.N2)
    acc = torch.stack([torch.zeros_like(acc_b), acc_b], dim=1)

    if bk2_prep.shape[-4] == 6 * p.l2:
        nh = bk2_prep.shape[0]
        pad = 2 * nh - p.n
        if pad:
            abar = torch.cat([abar, abar.new_zeros((G, pad))], dim=1)
        a1s, a2s = abar[:, 0::2], abar[:, 1::2]
        rs = torch.stack([a1s, a2s, (a1s + a2s) % (2 * p.N2)])  # [3, G, nh]
        for i in range(nh):
            rot = rot_poly(acc[None], rs[:, :, i, None], p.N2)  # [3,G,2,N2]
            d = decompose2(rot - acc[None], p)                  # [3,G,2l2,N2]
            d = d.transpose(0, 1).reshape(G, 6 * p.l2, p.N2)
            acc = acc + polymul.extprod2(d, bk2_prep[i], p)
        return acc

    for i in range(p.n):
        rot = rot_poly(acc, abar[:, i, None], p.N2)
        acc = acc + polymul.extprod2(decompose2(rot - acc, p), bk2_prep[i], p)
    return acc


# --------------------------------------------------------------------------- #
# private functional key switch lvl2 -> lvl1, circuit bootstrapping
# --------------------------------------------------------------------------- #


def _ks_digits64(a: torch.Tensor, t: int, basebit: int) -> torch.Tensor:
    """Signed digits of each 64-bit torus coefficient, int64 [..., t]."""
    base = 1 << basebit
    prec = t * basebit
    off = (1 << (64 - prec - 1)) + sum(
        (base // 2) << (64 - (j + 1) * basebit) for j in range(t))
    xp = a + _i64(off)
    ds = [((xp >> (64 - (j + 1) * basebit)) & (base - 1)) - base // 2
          for j in range(t)]
    return torch.stack(ds, dim=-1)


def privks(tlwe2: torch.Tensor, pksk_mat: torch.Tensor, part: int,
           p: Params) -> torch.Tensor:
    """TLWE lvl2 i64 [..., N2+1] -> TRLWE lvl1 i32 [..., 2, N] under
    f0(x) = -s1*x (part=0) or f1(x) = x (part=1).

    pksk_mat: [N2*t, 2N], the i32 key or its centred float64 copy
    (DeviceKeys.pksk_f64).  One float64 product is exact, as in
    keyswitch_10: |d| <= 4 over K = N2*t = 20480 rows and |key| <= 2^31
    bound every partial sum by 2^47.3 < 2^53; the sum is reduced mod 2^32
    after the product.
    """
    a = tlwe2[..., : p.N2]
    b = tlwe2[..., p.N2]
    d = _ks_digits64(a, p.pks_t, p.pks_basebit)
    d = d.reshape(*d.shape[:-2], p.N2 * p.pks_t)
    key = pksk_mat if pksk_mat.dtype == torch.float64 else pksk_mat.to(
        torch.float64)
    acc = torch.matmul(d.to(torch.float64), key).to(torch.int64)
    out = (-acc).reshape(*acc.shape[:-1], 2, p.N)
    # trivial realization of f(b): f1 -> b-part const, f0 -> a-part const
    out[..., part, 0] += ((b + (1 << 31)) >> 32) & MASK32
    return from_u64(out)


def circuit_bootstrap(tlwe0: torch.Tensor, bk2_prep: torch.Tensor,
                      pksk_mats, p: Params) -> torch.Tensor:
    """Batched circuit bootstrapping: TLWE lvl0 bits i32 [G, n+1] -> TRGSW
    lvl1 i32 [G, 2l, 2, N].

    For digit j (1-based): one lvl2 blind rotation with test vector
    mu_j = 2^(64-j*Bgbit-1) gives TLWE2(+-mu_j); adding the trivial mu_j
    maps it to TLWE2(m * 2^(64-j*Bgbit)); the two private key switches
    embed it as TRGSW rows (part 0: -s1*m*g_j, part 1: m*g_j).  All l
    rotations share the phase, so they run as ONE batch of l*G rows (row
    j*G + g) with per-row test vectors.
    """
    G = tlwe0.shape[0]
    # mu_j made on the device (no host copy: a graph can hold it)
    mus = torch.ones(p.l, dtype=torch.int64, device=tlwe0.device) << (
        63 - p.Bgbit * torch.arange(1, p.l + 1, device=tlwe0.device))
    mus = mus.repeat_interleave(G)                       # [l*G]
    acc2 = blind_rotate2(tlwe0.repeat(p.l, 1), bk2_prep,
                         mus[:, None].expand(p.l * G, p.N2), p)
    tl2 = sample_extract(acc2, 0)                        # [l*G, N2+1]
    tl2[:, p.N2] += mus
    parts = [privks(tl2, pksk_mats[part], part, p).reshape(p.l, G, 2, p.N)
             for part in (0, 1)]
    return torch.cat(parts).movedim(0, -3)               # [G, 2l, 2, N]


# --------------------------------------------------------------------------- #
# device-resident keys
# --------------------------------------------------------------------------- #


def tkey_default_config(p: Params):
    """The tkey slab's config (limbs, layout, lb), read from the JAX
    package's knobs as iyokan_tpu/crypto/ops.py:tkey_default_config reads
    them: IYOKAN_TKEY_LIMBS (default 3 key limbs), IYOKAN_TK_LAYOUT (fat,
    thin or fat2; default fat) and IYOKAN_TK_LB (b-part digits of the
    asymmetric gadget, default min(2, l), whose noise budget
    tests/test_noise_and_params.py asserts).  Raises on an lb outside
    [1, l]."""
    L = int(os.environ.get("IYOKAN_TKEY_LIMBS", "3"))
    lay = os.environ.get("IYOKAN_TK_LAYOUT", "fat")
    lb = int(os.environ.get("IYOKAN_TK_LB", str(min(2, p.l))))
    if not 1 <= lb <= p.l:
        raise ValueError(
            f"IYOKAN_TK_LB={lb} out of range: need 1 <= lb <= l={p.l} (lb=0 "
            "would be misread as a plain fat layout by the slab's row-count "
            "inference)")
    return L, lay, lb


DEVICE_ENV = "IYOKAN_TORCH_DEVICE"


def default_device() -> torch.device:
    """The device of an entry point whose caller names none: the one
    IYOKAN_TORCH_DEVICE names (cpu runs the kernels' plain twins), else
    the card.  Raises where there is no card and the variable is unset:
    nothing falls back to the CPU unasked."""
    name = os.environ.get(DEVICE_ENV)
    if name:
        return check_device(name)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card (torch.cuda.is_available() is False); to run on "
            f"the CPU, set {DEVICE_ENV}=cpu or pass device='cpu'")
    return torch.device("cuda")


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False (no CPU fallback for a CUDA request)")
    return device


def unroll_max(tkey: bool) -> int:
    """IYOKAN_UNROLL_MAX: the largest batch that takes the unrolled key,
    by default 0 on the tkey route and 256 on the others (JAX bk_for)."""
    return int(os.environ.get("IYOKAN_UNROLL_MAX", "0" if tkey else "256"))


def _warn_unquantized(src: np.ndarray, L: int) -> None:
    if L < 4 and np.any(src[:2, :, 0, :] & ((1 << (8 * (4 - L))) - 1)):
        # host.genevalkey quantizes bk masks to the 256-grid so the
        # truncated slab is exact on the mask component; a key with
        # full-torus masks rides this kernel with ~2^-6 phase noise --
        # enough to corrupt cascaded gates.
        warnings.warn(
            "eval key has unquantized bootstrapping-key masks: the "
            f"{L}-limb Toeplitz-slab kernel adds ~2^-6 phase noise on such "
            "keys. Regenerate the eval key (host.genevalkey quantizes masks "
            "by default) or set IYOKAN_TKEY_LIMBS=4.")


# Knobs that change what from_evalkey prepares (the JAX package's list):
# part of both caches' fingerprint.
PREP_KNOBS = ("IYOKAN_BR_IMPL", "IYOKAN_TK_LAYOUT", "IYOKAN_TKEY_LIMBS",
              "IYOKAN_NO_UNROLL", "IYOKAN_TK_UNROLL", "IYOKAN_EP",
              "IYOKAN_TK_LB", "IYOKAN_TK_SMALL", "IYOKAN_UNROLL_MAX",
              "IYOKAN_KS_I8")

# The in-process LRU of prepared keys (iyokan_tpu/crypto/ops.py's
# _DEVICE_KEY_CACHE): one key set holds GBs on the card at cggi128 (the
# slab alone 2.5 GB), so only the IYOKAN_KEY_CACHE_SLOTS (default 2) most
# recent are kept.
_DEVICE_KEY_CACHE: "collections.OrderedDict" = collections.OrderedDict()


def clear_device_key_cache() -> None:
    """Drop every prepared key set the in-process cache holds."""
    _DEVICE_KEY_CACHE.clear()


def key_fingerprint(ek: EvalKey, with_cb: bool) -> tuple:
    """The JAX package's fingerprint of a key preparation: parameter set,
    CB material, a hash of the leading rows of each key component (an
    eval key's components come from one RNG stream, so any difference
    shows there) and every PREP_KNOBS value."""
    h = hashlib.sha1()
    h.update(np.asarray(ek.bk[:2]).tobytes())
    h.update(np.asarray(ek.ksk[:1]).tobytes())
    if with_cb:
        h.update(np.asarray(ek.bk2[:1]).tobytes())
        h.update(np.asarray(ek.pksk[:1, :1]).tobytes())
        if ek.bk2u is not None and ek.bk2u.size:
            h.update(np.asarray(ek.bk2u[:1]).tobytes())
    if ek.bku is not None:
        h.update(np.asarray(ek.bku[:1]).tobytes())
    return (ek.params.name, bool(with_cb), h.hexdigest(),
            tuple(os.environ.get(k) for k in PREP_KNOBS))


def slab_cache_path(fingerprint: tuple, role: str):
    """The on-disk cache file of a tkey slab (role "main" or "small") of
    the preparation `fingerprint`, or None: IYOKAN_SLAB_CACHE=0 turns the
    cache off, a directory value moves it; by default it lies in
    IYOKAN_KEY_CACHE, else the temporary directory's iyokan-keys
    (/tmp/iyokan-keys where TMPDIR is unset).  The host build of a
    cggi128 slab takes seconds that np.load saves every new process."""
    d = os.environ.get("IYOKAN_SLAB_CACHE", "")
    if d == "0":
        return None
    if not d:
        d = os.environ.get("IYOKAN_KEY_CACHE",
                           os.path.join(tempfile.gettempdir(), "iyokan-keys"))
    tag = hashlib.sha1(repr((fingerprint, role)).encode()).hexdigest()[:16]
    return os.path.join(d, f"tkslab-{tag}.npy")


def _load_slab(path, steps: int):
    """A cached slab (int8, `steps` steps), or None where the file is
    missing, unreadable or not such a slab."""
    if not path or not os.path.exists(path):
        return None
    try:
        slab = np.load(path)
    except (OSError, ValueError, EOFError):
        return None
    if slab.dtype != np.int8 or slab.ndim < 3 or slab.shape[0] != steps:
        return None
    return slab


def _slab(src: np.ndarray, p: Params, L: int, layout: str, lb: int,
          device, path=None) -> torch.Tensor:
    """The tkey slab of `src` on `device`, stored K-contiguous (the
    kernel's storage; ops/tkey.py:k_contiguous) with the logical shape
    tkey_kernel_key gives.  path: its disk cache file (slab_cache_path):
    the logical row-major slab is read from there, or built and written
    there atomically (os.replace)."""
    from ..ops.tkey import k_contiguous

    slab = _load_slab(path, src.shape[0])
    if slab is None:
        slab = polymul.tkey_kernel_key(src, p, L, layout, lb=lb)
        if path:
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    np.save(f, slab)
                os.replace(tmp, path)
            except OSError:
                pass
    return k_contiguous(slab, device)


@dataclasses.dataclass
class DeviceKeys:
    """Evaluation key prepared for the runtime ops on one device.

    bk_tk     int8 Toeplitz slab (tkey route; None on the others), in the
              layout tkey_default_config names (ops/tkey.py reads it from
              the shape), stored K-contiguous (ops/tkey.py:k_contiguous)
              as a view of the logical shape: fat [n, (l+lb)*N, 2*L*128], thin
              [n, l+lb, N, 2*L*128] or fat2 [n, 2*(l+lb)*N, 2*L*128]; or,
              under IYOKAN_TK_UNROLL (not 0) with the fat layout, the
              2-bit-unrolled slab [nh, 3*(l+lb)*N, 2*L*128] of bku
    bk_tk_small  the 2-bit-unrolled slab of bku for batches of at most
              IYOKAN_TK_SMALL_MAX rows (default 256), built only under
              IYOKAN_TK_SMALL=1 with the fat layout when bk_tk is not
              already unrolled; else None
    ksk_mat   i32  [N*t, n+1]              identity key-switch key
    ksk_f64   f64  [N*t, n+1]              ksk_mat as centred float64
    bk_ntt    i32  [n, 2l, 2, P, N]        CRT64-prepared bk (non-tkey
                                           routes; None on tkey)
    bk_ntt_u  i32  [nh, 3*2l, 2, P, N]     CRT64-prepared 2-bit-unrolled bk
                                           (bku, nh = ceil(n/2)), or None;
                                           each NTT key carries its K3/K4
                                           kernel form (ops/br.py:
                                           attach_kernel_key), built here
    bk2       i64  [nh, 3*2l2, 2, 4, N2]   prepared 2-bit-unrolled CB key
                                           (bk2u; [n, 2l2, ...] from bk2
                                           when the key has no bk2u or
                                           IYOKAN_NO_UNROLL is set)
    pksk_f64  2 x f64 [N2*t, 2N]           private key-switch keys, centred
    The last two are None without circuit-bootstrapping material.

    Gate keys and routes follow iyokan_tpu's from_evalkey, bk_for and
    blind_rotate on the TPU (MXU backend) row for row; the port's plain
    key is always the CRT64 prep1 key.  bk_for(batch) gives the unrolled
    NTT key to batches of at most thr = unroll_max() rows when it exists,
    then bk_tk_small to batches of at most IYOKAN_TK_SMALL_MAX rows when it
    exists, else the plain key, and blind_rotate routes on the key
    (gate_route):

    IYOKAN_BR_IMPL  IYOKAN_EP=pallas  plain key (batch > thr)  unrolled key
    unset / tkey    any               tkey slab bk_tk, thr = 0 (thr > 0:
                                      (ops/tkey.py, every      ntt-unrolled)
                                      layout)
    pallas          no                K5                       ntt-unrolled
    pallas2         no                K4                       ntt-unrolled
    v3              no                K3, M = 1                K3, M = 3
    any non-tkey    yes               ntt-step (K6 per step)   v3: K3, M = 3;
                                                               else
                                                               ntt-unrolled
    other (ntt, .)  no                ntt-step                 ntt-unrolled

    thr is IYOKAN_UNROLL_MAX (default 256, and 0 on tkey, where the
    unrolled key is built only for a positive value); IYOKAN_NO_UNROLL
    set means no unrolled key (and the plain CB key bk2).  ntt-unrolled
    runs extprod1 at 3*2l rows, one launch per key-bit pair.  The tkey
    knobs that change the slab, and so the result, are read as the JAX
    package reads them: IYOKAN_TKEY_LIMBS, IYOKAN_TK_LAYOUT, IYOKAN_TK_LB
    (tkey_default_config), IYOKAN_TK_UNROLL, IYOKAN_TK_SMALL and
    IYOKAN_TK_SMALL_MAX.  Those that only schedule the TPU kernel are not
    carried over: IYOKAN_TK_DOTS, IYOKAN_TK_CHAINS, IYOKAN_TK_PIPE,
    IYOKAN_TK_KMAJ, IYOKAN_TK_SLOTS, IYOKAN_TK_EXT8, IYOKAN_TK_PRECHECK,
    IYOKAN_PALLAS_BG and IYOKAN_TK_ABLATE.
    """

    params: Params
    device: torch.device
    bk_tk: torch.Tensor
    ksk_mat: torch.Tensor
    ksk_f64: torch.Tensor
    bk_ntt: torch.Tensor = None
    bk_ntt_u: torch.Tensor = None
    bk_tk_small: torch.Tensor = None
    bk2: torch.Tensor = None
    pksk_f64: tuple = None

    def bk_for(self, batch: int) -> torch.Tensor:
        """The gate blind-rotation key for a batch of `batch` rows (the
        size of the JAX call this one mirrors, not the rows it runs), in
        JAX's order: the unrolled NTT key up to unroll_max() rows, then
        bk_tk_small up to IYOKAN_TK_SMALL_MAX rows, each when it exists,
        else the route's plain key (blind_rotate routes on its layout)."""
        tkey = self.bk_tk is not None
        if self.bk_ntt_u is not None and batch <= unroll_max(tkey):
            return self.bk_ntt_u
        if self.bk_tk_small is not None and batch <= int(
                os.environ.get("IYOKAN_TK_SMALL_MAX", "256")):
            return self.bk_tk_small
        return self.bk_tk if tkey else self.bk_ntt

    @staticmethod
    def from_evalkey(ek: EvalKey, device, with_cb: bool = True
                     ) -> "DeviceKeys":
        """Carry the numpy EvalKey (the same object and file in both
        packages) to `device` as the port's tensors.  The circuit-
        bootstrapping material is carried when with_cb and the key has it
        (ek.bk2 non-empty), as iyokan_tpu's DeviceKeys.from_evalkey does;
        NTT preparation runs on `device`.

        Both caches of the JAX package (neither changes a result): the
        in-process LRU returns the DeviceKeys of an earlier call with the
        same key_fingerprint on the same device (IYOKAN_KEY_CACHE_SLOTS
        entries, default 2), and each tkey slab goes through its disk
        cache (slab_cache_path, IYOKAN_SLAB_CACHE)."""
        device = check_device(device)
        with_cb = bool(with_cb and ek.bk2.shape[0] != 0)
        fp = key_fingerprint(ek, with_cb)
        slots = int(os.environ.get("IYOKAN_KEY_CACHE_SLOTS", "2"))
        hit = _DEVICE_KEY_CACHE.get((fp, str(device)))
        if hit is not None:
            _DEVICE_KEY_CACHE.move_to_end((fp, str(device)))
            return hit
        dk = DeviceKeys._prepare(ek, device, with_cb, fp)
        if slots > 0:
            _DEVICE_KEY_CACHE[(fp, str(device))] = dk
            while len(_DEVICE_KEY_CACHE) > slots:
                _DEVICE_KEY_CACHE.popitem(last=False)
        return dk

    @staticmethod
    def _prepare(ek: EvalKey, device, with_cb: bool, fp: tuple
                 ) -> "DeviceKeys":
        p = ek.params
        # the tkey slab unless IYOKAN_BR_IMPL names another route (the
        # port's default, as the JAX package's on the TPU)
        tkey = os.environ.get("IYOKAN_BR_IMPL", "tkey") == "tkey"
        no_unroll = bool(os.environ.get("IYOKAN_NO_UNROLL"))
        bku = (None if ek.bku is None else
               ek.bku.reshape(ek.bku.shape[0], 6 * p.l, 2, p.N))
        bk_tk = bk_tk_small = bk_ntt = bk_ntt_u = None
        if not tkey:
            bk_ntt = polymul.prep1(u32_tensor(ek.bk, device), p)
        else:
            L, lay, lb = tkey_default_config(p)
            # the main slab from bku under IYOKAN_TK_UNROLL (fat layout
            # only), and the small-batch unrolled slab under
            # IYOKAN_TK_SMALL=1 unless the main one already is
            tku = (bku is not None and lay == "fat"
                   and os.environ.get("IYOKAN_TK_UNROLL", "0") != "0")
            src = bku if tku else ek.bk
            _warn_unquantized(src, L)
            bk_tk = _slab(src, p, L, lay, lb, device,
                          slab_cache_path(fp, "main"))
            if (not tku and bku is not None and lay == "fat"
                    and os.environ.get("IYOKAN_TK_SMALL", "0") == "1"):
                bk_tk_small = _slab(bku, p, L, "fat", lb, device,
                                    slab_cache_path(fp, "small"))
        if (bku is not None and not no_unroll
                and (not tkey or unroll_max(True) > 0)):
            bk_ntt_u = polymul.prep1(u32_tensor(bku, device), p)
        # K3/K4 read the NTT keys in their kernel form, built once here
        from ..ops.br import attach_kernel_key

        for key in (bk_ntt, bk_ntt_u):
            if key is not None:
                attach_kernel_key(key, p)
        ksk_mat = u32_tensor(ek.ksk.reshape(p.N * p.ks_t, p.n + 1), device)
        dk = DeviceKeys(p, device, bk_tk, ksk_mat, ksk_mat.to(torch.float64),
                        bk_ntt, bk_ntt_u, bk_tk_small)
        if with_cb:
            # the depth-halved unrolled key whenever present, as the JAX
            # package's bk2_for (CB batches are small: l rows per address
            # bit, so the rotation is latency-bound)
            if ek.bk2u is not None and ek.bk2u.size and not no_unroll:
                src2 = ek.bk2u.reshape(ek.bk2u.shape[0], 6 * p.l2, 2, p.N2)
            else:
                src2 = ek.bk2
            dk.bk2 = polymul.prep2(u64_tensor(src2, device), p)
            dk.pksk_f64 = tuple(
                u32_tensor(ek.pksk[i].reshape(p.N2 * p.pks_t, 2 * p.N),
                           device).to(torch.float64)
                for i in (0, 1))
        return dk


# --------------------------------------------------------------------------- #
# batched homomorphic gates
# --------------------------------------------------------------------------- #


def gate_linear(A: torch.Tensor, B: torch.Tensor, ca: torch.Tensor,
                cb: torch.Tensor, kmu: torch.Tensor,
                p: Params) -> torch.Tensor:
    """pre = ca*A + cb*B + k*mu per row (mod 2^32); coefficients int [G].
    Products are taken in int64 (XOR's coefficient 2 would overflow int32)."""
    pre = (to_u64(A) * ca.to(torch.int64)[:, None]
           + to_u64(B) * cb.to(torch.int64)[:, None])
    pre[:, p.n] += kmu.to(torch.int64) * p.mu
    return from_u64(pre)


def hom_not(c: torch.Tensor) -> torch.Tensor:
    """NOT: torus negation, no bootstrap (reference HomNOT)."""
    return from_u64(-to_u64(c))
