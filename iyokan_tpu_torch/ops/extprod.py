"""Lvl1 external product: the CUDA kernel's wrapper and its plain twin.

Counterpart of iyokan_tpu/ops/pallas_ep.py (`extprod1_fused`, kernel
`_ep_kernel`, "K6"): digits int32 [G, RR, N] x one prepared TRGSW -> the
negacyclic products i32 [G, 2, N], exact mod 2^32.  The key is the port's
CRT64 prep1 layout (crypto/polymul.prep1 = ops.prep_trgsw):

  keys  int32 [K, RR, 2, P=2, N]   residues mod the two NTT primes of
                                   crypto/ntt.py, bit-reversed order

with a per-row key index idx int32 [G] in [0, K) (None: every row takes
key 0).  K = 1 is K6's shared key step (the ROM and RAM-read CMUX trees,
the NTT blind rotation); K = 2 serves the RAM write tree, where each
address row picks the normal or the inverted selector of one address bit.
The index may come on the host (a CPU tensor): its range is checked there
and the wrapper copies it to the card; an index on the card (the engine
builds the RAM write tree's once) is checked on the card by a device-side
assertion.  Neither syncs, so a CUDA graph can hold the call.

`extprod1` runs the hand-written Hopper kernel (csrc/extprod1_ntt.cu) for a
CUDA tensor and the plain torch twin (`extprod1_ref` = the CRT64 backend's
polymul.extprod1) for a CPU tensor; nothing else selects between them.
The kernel is the cluster form of csrc/br_cluster.cuh (one cluster of
br.CLUSTER = 4 CTAs a row, (prime, part); RR = 2l or 3*2l at l = 3,
another RR or l raises), of br.threads_for's threads a CTA by this
kernel's own cap per RR.  LAUNCHES counts kernel launches; `last_launch`
reads the grid, cluster size and threads a CTA the C launcher last used.
"""

from __future__ import annotations

import ctypes

import torch

from ..crypto import ntt, polymul
from ..params import Params
from . import br, nvcc

LAUNCHES = 0          # external-product kernels launched on the card
SOURCE = "extprod1_ntt.cu"


def _check(digits: torch.Tensor, keys: torch.Tensor, idx, p: Params):
    if digits.dtype != torch.int32 or keys.dtype != torch.int32:
        raise ValueError("digits and keys must be int32")
    if digits.dim() != 3 or digits.shape[-1] != p.N:
        raise ValueError(f"digits must be [G, RR, N={p.N}], got "
                         f"{tuple(digits.shape)}")
    RR = digits.shape[1]
    if keys.dim() != 5 or tuple(keys.shape[1:]) != (
            RR, 2, len(ntt.PRIMES), p.N):
        raise ValueError(f"keys must be [K, RR={RR}, 2, "
                         f"{len(ntt.PRIMES)}, N={p.N}], got "
                         f"{tuple(keys.shape)}")
    if keys.device != digits.device:
        raise ValueError(f"device mismatch: digits {digits.device}, keys "
                         f"{keys.device}")
    if idx is not None:
        if idx.shape != digits.shape[:1] or idx.device not in (
                torch.device("cpu"), digits.device):
            raise ValueError(f"idx must be [G={digits.shape[0]}] on the "
                             f"host or on {digits.device}")
        if idx.is_cuda:
            # on the card, asynchronously: no sync, capturable
            torch._assert_async(((idx >= 0) & (idx < keys.shape[0])).all(),
                                f"idx out of range [0, {keys.shape[0]})")
        elif idx.numel():
            lo, hi = torch.stack(torch.aminmax(idx)).tolist()
            if lo < 0 or hi >= keys.shape[0]:
                raise ValueError(f"idx out of range [0, {keys.shape[0]})")
    elif keys.shape[0] != 1:
        raise ValueError("a stack of K > 1 keys needs idx")


def extprod1_ref(digits: torch.Tensor, keys: torch.Tensor, idx,
                 p: Params) -> torch.Tensor:
    """The plain torch twin of the kernel, on any device: i32 [G, 2, N]."""
    _check(digits, keys, idx, p)
    if idx is None:
        return polymul.extprod1(digits, keys[0], p)
    idx = idx.to(digits.device)
    out = torch.empty((digits.shape[0], 2, p.N), dtype=torch.int32,
                      device=digits.device)
    for k in range(keys.shape[0]):
        rows = (idx == k).nonzero().flatten()
        if rows.numel():
            out[rows] = polymul.extprod1(digits[rows], keys[k], p)
    return out


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.extprod1_ntt.restype = ci
    lib.extprod1_ntt.argtypes = [vp, vp, vp, vp,
                                 ctypes.POINTER(ctypes.c_uint32), vp, ci, ci,
                                 ci, ci, ci, ci, vp]
    lib.extprod1_ntt_plan.restype = ci
    lib.extprod1_ntt_plan.argtypes = [ci, ci, ci, ci,
                                      ctypes.POINTER(ctypes.c_longlong)]
    lib.extprod1_ntt_last_launch.restype = None
    lib.extprod1_ntt_last_launch.argtypes = [ctypes.POINTER(ci)]
    lib.extprod1_error_string.restype = ctypes.c_char_p
    lib.extprod1_error_string.argtypes = [ci]


def cluster_plan(p: Params, RR: int, nt: int, device=None) -> tuple:
    """(dynamic shared memory bytes a CTA, clusters the card holds at once)
    of the kernel at RR digit rows and nt threads a CTA on `device`'s card;
    raises where the card refuses (builds and loads the library)."""
    lib = nvcc.load(SOURCE, _bind)
    out = (ctypes.c_longlong * 2)()
    return br.check_plan(lib.extprod1_ntt_plan(
        p.N, RR, nt, br.device_index(device), out), out,
        lib.extprod1_error_string)


def last_launch() -> tuple:
    """(CTAs, cluster size, threads a CTA) of the last launch, as the C
    launcher made it."""
    out = (ctypes.c_int * 3)()
    nvcc.load(SOURCE, _bind).extprod1_ntt_last_launch(out)
    return tuple(int(v) for v in out)


def _launch(digits, keys, idx, p: Params) -> torch.Tensor:
    global LAUNCHES
    lib = nvcc.load(SOURCE, _bind)
    digits = digits.contiguous()
    keys = keys.contiguous()
    if idx is not None:   # from the host: an asynchronous copy
        idx = idx.to(device=digits.device, dtype=torch.int32,
                     non_blocking=True).contiguous()
    G, RR, N = digits.shape
    dev = digits.device
    nt = br.threads_for(G, br.narrow_cap(SOURCE, lambda n: cluster_plan(
        p, RR, n, dev), RR, p, dev))
    out = torch.empty((G, 2, N), dtype=torch.int32, device=dev)
    tabs = ntt.kernel_tables(N, dev)
    rc = lib.extprod1_ntt(
        digits.data_ptr(), keys.data_ptr(),
        None if idx is None else idx.data_ptr(), tabs.tw.data_ptr(),
        (ctypes.c_uint32 * 4)(*tabs.scale), out.data_ptr(), G, RR, N,
        keys.shape[0], nt, br.device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("extprod1_ntt kernel launch failed: "
                           f"{lib.extprod1_error_string(rc)}")
    LAUNCHES += 1
    return out


def extprod1(digits: torch.Tensor, keys: torch.Tensor, idx,
             p: Params) -> torch.Tensor:
    """sum_r digits[g, r] (x) keys[idx[g], r, u] -> i32 [G, 2, N].

    digits: int32 [G, RR, N], |d| <= Bg/2; keys: int32 [K, RR, 2, P, N]
    from polymul.prep1; idx: int [G] in [0, K), on the host or on the
    digits' card, or None (key 0).  A CUDA input
    runs the Hopper kernel, a CPU input the plain twin; there is no
    fallback between them."""
    _check(digits, keys, idx, p)
    if digits.shape[0] == 0:
        return digits.new_zeros((0, 2, p.N))
    if digits.is_cuda:
        return _launch(digits, keys, idx, p)
    if digits.device.type != "cpu":
        raise ValueError(f"unsupported device {digits.device}")
    return extprod1_ref(digits, keys, idx, p)
