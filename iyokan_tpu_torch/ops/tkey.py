"""Toeplitz-slab blind rotation: the CUDA kernel's wrapper and plain twin.

Counterpart of iyokan_tpu/ops/pallas_tk.py (`blind_rotate_tkey`, kernels
`_kernel_pipe` and `_kernel`), fat layout only.  Per CMUX step i and gate g:

  x_u   = X^{abar[g,i]} * acc_u - acc_u + off_u           (u = part a, b)
  ext   = signed gadget digits of x (l for part a, lb for part b), int8,
          lanes ordered (block b, part, j, 128) like the slab's rows
  s_K   = -ext[:, :cut] . bk[RT-cut:] + ext[:, cut:] . bk[:RT-cut]
          (cut = 128*RR*(K+1), RR = l+lb, RT = RR*N, one dot per output
          block K of 128 coefficients; int32-exact: |d| <= 32, |limb| <=
          128, contraction 5120 at cggi128 -> |s| < 2^25)
  acc_u[:, 128K:128K+128] += sum_li s_K[:, (u*L+li)*128 : +128]
                             << 8*(4-L+li)          (mod 2^32)

`blind_rotate_tkey` runs the hand-written Hopper kernel
(csrc/tkey_blind_rotate.cu) for a CUDA tensor and the plain torch twin
(`blind_rotate_tkey_ref`) for a CPU tensor; nothing else selects between
them.  LAUNCHES counts kernel launches (one per blind rotation run on the
card).
"""

from __future__ import annotations

import ctypes

import torch

from ..crypto import ops as cops
from ..params import Params
from . import nvcc

LAUNCHES = 0          # blind rotations launched on the card
BLOCK_G = 16          # gate tile of the kernel; batches are padded to it
SOURCE = "tkey_blind_rotate.cu"


# --------------------------------------------------------------------------- #
# slab layout and host-side set-up (shared by the kernel and the twin)
# --------------------------------------------------------------------------- #


def slab_config(bk_tk: torch.Tensor, p: Params):
    """(L, lb) of a fat slab int8 [n, (l+lb)*N, 2*L*128]; raises on any
    other layout (thin, fat2 doubled slab, 2-bit unrolled) -- row-count
    inference as in pallas_tk.blind_rotate_tkey."""
    if bk_tk.dim() != 3:
        raise ValueError(
            f"tkey slab must be the fat layout [n, RR*N, 2L*128]; got a "
            f"{bk_tk.dim()}-d key (thin layout is not ported)")
    if bk_tk.dtype != torch.int8:
        raise ValueError(f"tkey slab must be int8, got {bk_tk.dtype}")
    rr, rem = divmod(bk_tk.shape[1], p.N)
    if rem or not 1 <= rr - p.l <= p.l:
        raise ValueError(
            f"tkey slab with {bk_tk.shape[1]} rows/step at N={p.N}, l={p.l} "
            "is not a fat layout (fat2 and 2-bit unrolled slabs are not "
            "ported)")
    C = bk_tk.shape[2]
    if C % 256 or C // 256 not in (3, 4):
        raise ValueError(f"tkey slab has {C} columns; need 2*L*128, L=3|4")
    return C // 256, rr - p.l


def _round_off(p: Params, ndig: int) -> int:
    """Centering + rounding offset of an ndig-digit gadget decomposition."""
    o = sum((p.Bg // 2) << (32 - (j + 1) * p.Bgbit) for j in range(ndig))
    o += 1 << (31 - ndig * p.Bgbit)
    return o & cops.MASK32


def _setup(tlwe0: torch.Tensor, testv: torch.Tensor, p: Params):
    """Modswitch, rotation rows int32 [n, G] and the initial accumulator
    i32 [G, 2, N] = (0, X^{-bbar} * testv)."""
    G = tlwe0.shape[0]
    abar = cops._modswitch(tlwe0[:, : p.n], p.logN)
    bbar = cops._modswitch(tlwe0[:, p.n], p.logN)
    acc_b = cops.rot_poly(testv.expand(G, p.N),
                          torch.remainder(-bbar.to(torch.int64), 2 * p.N),
                          p.N)
    acc = torch.stack([torch.zeros_like(acc_b), acc_b], dim=1)
    return abar.t().contiguous(), acc.contiguous()


def check_inputs(tlwe0, key, testv, p: Params, steps: int):
    """A blind rotation's inputs (every kernel route's): tlwe0 i32
    [G, n+1], testv i32 [N] and a contiguous key of `steps` steps, on one
    device."""
    if tlwe0.dtype != torch.int32 or testv.dtype != torch.int32:
        raise ValueError("tlwe0 and testv must be int32 (u32 bit patterns)")
    if tlwe0.dim() != 2 or tlwe0.shape[1] != p.n + 1:
        raise ValueError(f"tlwe0 must be [G, n+1={p.n + 1}], got "
                         f"{tuple(tlwe0.shape)}")
    if tuple(testv.shape) != (p.N,):
        raise ValueError(f"testv must be [N={p.N}]")
    if key.shape[0] != steps:
        raise ValueError(f"key has {key.shape[0]} steps, need {steps} "
                         f"(n={p.n})")
    if not (tlwe0.device == key.device == testv.device):
        raise ValueError(
            f"device mismatch: tlwe0 {tlwe0.device}, key {key.device}, "
            f"testv {testv.device}")
    if not key.is_contiguous():
        raise ValueError("the key must be contiguous")


# --------------------------------------------------------------------------- #
# the plain twin
# --------------------------------------------------------------------------- #


def _steps_ref(rows: torch.Tensor, acc: torch.Tensor, bk_tk: torch.Tensor,
               p: Params, L: int, lb: int) -> torch.Tensor:
    """The n CMUX steps in plain torch: digits, split dots, recombination,
    accumulation.  The dots run in float64, which is exact here (|s| <
    2^25 << 2^53; float32 is not: 5120*32*128 = 2^24.3)."""
    N = p.N
    NB = N // 128
    RR = p.l + lb
    RT = RR * N
    G = acc.shape[0]
    offs = (_round_off(p, p.l), _round_off(p, lb))
    ndig = (p.l, lb)
    a = cops.to_u64(acc)                               # [G, 2, N] int64
    for i in range(bk_tk.shape[0]):
        rot = cops.to_u64(cops.rot_poly(cops.from_u64(a), rows[i][:, None],
                                        N))
        x = (rot - a + torch.tensor(offs, device=a.device)[:, None]) \
            & cops.MASK32                              # [G, 2, N]
        digs = []
        for part in range(2):
            for j in range(ndig[part]):
                sh = 32 - (j + 1) * p.Bgbit
                digs.append(((x[:, part] >> sh) & (p.Bg - 1)) - p.Bg // 2)
        d = torch.stack(digs, dim=1)                   # [G, RR, N]
        # lanes (block, part, j, 128)
        ext = d.reshape(G, RR, NB, 128).permute(0, 2, 1, 3).reshape(G, RT)
        ext = ext.to(torch.float64)
        bk = bk_tk[i].to(torch.float64)                # [RT, 2L*128]
        outs = []
        for K in range(NB):
            cut = 128 * RR * (K + 1)
            s = -(ext[:, :cut] @ bk[RT - cut:])
            if cut < RT:
                s = s + ext[:, cut:] @ bk[: RT - cut]
            outs.append(s.to(torch.int64))             # [G, 2L*128]
        s = torch.stack(outs, dim=1).reshape(G, NB, 2, L, 128)
        upd = torch.zeros((G, NB, 2, 128), dtype=torch.int64,
                          device=a.device)
        for li in range(L):
            upd += s[:, :, :, li] * (1 << (8 * (4 - L + li)))
        a = (a + upd.permute(0, 2, 1, 3).reshape(G, 2, N)) & cops.MASK32
    return cops.from_u64(a)


def blind_rotate_tkey_ref(tlwe0: torch.Tensor, bk_tk: torch.Tensor,
                          testv: torch.Tensor, p: Params) -> torch.Tensor:
    """The plain torch twin of the kernel, on any device: i32 [G, 2, N]."""
    L, lb = slab_config(bk_tk, p)
    check_inputs(tlwe0, bk_tk, testv, p, p.n)
    rows, acc = _setup(tlwe0, testv, p)
    return _steps_ref(rows, acc, bk_tk, p, L, lb)


# --------------------------------------------------------------------------- #
# the CUDA kernel: build, bind, launch
# --------------------------------------------------------------------------- #


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tkey_blind_rotate.restype = ci
    lib.tkey_blind_rotate.argtypes = [
        vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
        ctypes.c_uint32, ctypes.c_uint32, ci, vp]
    lib.tkey_error_string.restype = ctypes.c_char_p
    lib.tkey_error_string.argtypes = [ci]


SPLIT_GRID = 2 * 132  # tiles the contraction split aims for: two per SM
MAX_SPLIT = 16        # deeper splits lose more to atomics than they gain


def _split_k(Gp: int, k_tiles: int) -> int:
    """Contraction split for small batches: the largest power of two that
    keeps the grid within SPLIT_GRID tiles (two 256-thread tiles fit an
    H100 SM's registers), at most MAX_SPLIT and k_tiles (the 64-row
    contraction tiles).  Measured best on the H100 at G = 16, 64, 256
    (PERF.md, split sweep)."""
    tiles = (Gp // BLOCK_G) * 2 * 4
    s = 1
    while (2 * s <= min(k_tiles, MAX_SPLIT)
           and tiles * 2 * s <= SPLIT_GRID):
        s *= 2
    return s


def _steps_kernel(rows: torch.Tensor, acc: torch.Tensor, bk_tk: torch.Tensor,
                  p: Params, L: int, lb: int) -> torch.Tensor:
    """All n CMUX steps on the card; returns the new accumulator."""
    global LAUNCHES
    lib = nvcc.load(SOURCE, _bind)
    G = acc.shape[0]
    pad = (-G) % BLOCK_G
    if pad:
        acc = torch.cat([acc, acc.new_zeros((pad, 2, p.N))])
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], pad))], 1)
    acc = acc.contiguous()
    rows = rows.contiguous()
    Gp = G + pad
    RT = (p.l + lb) * p.N
    ext = torch.empty((Gp, RT), dtype=torch.int8, device=acc.device)
    dev = acc.device.index if acc.device.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    rc = lib.tkey_blind_rotate(
        rows.data_ptr(), acc.data_ptr(), bk_tk.data_ptr(), ext.data_ptr(),
        Gp, bk_tk.shape[0], p.N, p.l, lb, p.Bgbit, L,
        _split_k(Gp, RT // 64),
        _round_off(p, p.l), _round_off(p, lb), dev, stream)
    if rc != 0:
        raise RuntimeError(
            f"tkey kernel launch failed: {lib.tkey_error_string(rc)}")
    LAUNCHES += 1
    return acc[:G]


def blind_rotate_tkey(tlwe0: torch.Tensor, bk_tk: torch.Tensor,
                      testv: torch.Tensor, p: Params) -> torch.Tensor:
    """Blind rotation lvl0 -> TRLWE lvl1 against a fat tkey slab.

    tlwe0: i32 [G, n+1]; bk_tk: int8 [n, (l+lb)*N, 2*L*128] from
    crypto/polymul.tkey_kernel_key(..., layout="fat"); testv: i32 [N].
    Returns i32 [G, 2, N].  A CUDA input runs the Hopper kernel, a CPU
    input the plain twin; there is no fallback between them."""
    L, lb = slab_config(bk_tk, p)
    check_inputs(tlwe0, bk_tk, testv, p, p.n)
    rows, acc = _setup(tlwe0, testv, p)
    if acc.is_cuda:
        return _steps_kernel(rows, acc, bk_tk, p, L, lb)
    if acc.device.type != "cpu":
        raise ValueError(f"unsupported device {acc.device}")
    return _steps_ref(rows, acc, bk_tk, p, L, lb)
