"""Decompose-first NTT blind rotation: the CUDA kernel's wrapper and its
plain twin.

Counterpart of iyokan_tpu/ops/pallas_br3.py (`blind_rotate_pallas3`,
kernel `_kernel`, "K3"; IYOKAN_BR_IMPL=v3): the whole loop in one launch,
each step in the decompose-first form

  acc += sum_m (X^{a_m} - 1) * (decompose1(acc) (x) bk[i, 2l*m : 2l*(m+1)])
                                                                 (mod 2^32)

M = 1 on the plain key int32 [n, 2l, 2, P, N] (one amount per step); M = 3
on the 2-bit-unrolled key int32 [ceil(n/2), 3*2l, 2, P, N] (amounts a1, a2,
a1 + a2 of key bits 2i, 2i+1; an odd n pads the last pair with a2 = 0).
`rotation_steps` builds the amounts int32 [steps, M, G] as
pallas_br3.py:405-416 does.  Both keys are crypto/polymul.prep1's CRT64
layout.  The integer before the mod-2^32 reduction is exact in both
packages, so the result is the JAX kernel's bit for bit (csrc/br3_ntt.cu
has the bound).  The decompose-first form is not the standard CMUX: its
result differs from ops/br.py's, and it doubles the per-step decomposition
noise variance, as on the TPU.

IYOKAN_BR3_TW12 (a variant of the TPU kernel's arithmetic with the same
result) is not read; IYOKAN_BR3_ABLATE and IYOKAN_PALLAS_BG (TPU ablation
and block knobs) are not ported.

`br3` launches csrc/br3_ntt.cu for CUDA tensors and runs the plain twin
`br3_ref` for CPU tensors; nothing else selects between them.  The kernel
is the cluster form of csrc/br_cluster.cuh, as K4's (ops/br.py: one
cluster of four CTAs a row; the key's kernel form `kernel_key`, which the
launch reads and never builds).  LAUNCHES counts the launches (one per
blind rotation).
"""

from __future__ import annotations

import ctypes

import torch

from ..crypto import ops as cops
from ..crypto import polymul
from ..params import Params
from . import br, nvcc
from .br import check_steps, ring_args

LAUNCHES = 0          # K3 launches: one per blind rotation
SOURCE = "br3_ntt.cu"


def _m_of(bk: torch.Tensor, p: Params) -> int:
    """M = 1 for the plain key's 2l rows a step, 3 for the unrolled 3*2l."""
    rr = bk.shape[1] if bk.dim() == 5 else 0
    if rr not in (2 * p.l, 6 * p.l):
        raise ValueError(f"key {tuple(bk.shape)} has neither 2l = {2 * p.l} "
                         f"nor 3*2l = {6 * p.l} rows a step")
    return rr // (2 * p.l)


def rotation_steps(rows: torch.Tensor, bk: torch.Tensor,
                   p: Params) -> torch.Tensor:
    """The amounts int32 [steps, M, G] of rows int32 [n, G]: [n, 1, G] for
    the plain key; for the unrolled key (steps = ceil(n/2)) the pairs
    (a1, a2, a1 + a2 mod 2N), an odd n padded with a2 = 0."""
    if _m_of(bk, p) == 1:
        return rows[:, None, :].contiguous()
    return torch.stack(cops.pair_amounts(rows, bk.shape[0], p.N), dim=1).to(
        torch.int32).contiguous()


def _check(steps, acc, bk, p: Params) -> int:
    M = _m_of(bk, p)
    check_steps(steps, acc, bk, 2 * p.l * M, p)
    if steps.dim() != 3 or steps.shape[1] != M:
        raise ValueError(f"steps must be int32 [steps, M={M}, G], got "
                         f"{tuple(steps.shape)}")
    return M


def br3_ref(steps: torch.Tensor, acc: torch.Tensor, bk: torch.Tensor,
            p: Params) -> torch.Tensor:
    """The plain torch twin of the kernel, on any device: the
    decompose-first steps of `steps` int32 [S, M, G] against bk
    [S, M*2l, 2, P, N] from acc i32 [G, 2, N], with X^a - 1 applied in the
    coefficient domain; returns the new acc."""
    M = _check(steps, acc, bk, p)
    RR = 2 * p.l
    for i in range(bk.shape[0]):
        d = cops.decompose1(acc, p)
        upd = cops.to_u64(acc)
        for m in range(M):
            y = polymul.extprod1(d, bk[i, RR * m: RR * (m + 1)], p)
            rot = cops.rot_poly(y, steps[i, m][:, None], p.N)
            upd = upd + cops.to_u64(rot) - cops.to_u64(y)
        acc = cops.from_u64(upd)
    return acc


def _bind(lib):
    vp, ci, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.br3_ntt.restype = ci
    lib.br3_ntt.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, u32,
                            ci, ci, vp]
    lib.br3_ntt_plan.restype = ci
    lib.br3_ntt_plan.argtypes = [ci, ci, ci, ci, ci,
                                 ctypes.POINTER(ctypes.c_longlong)]
    lib.br3_ntt_last_launch.restype = None
    lib.br3_ntt_last_launch.argtypes = [ctypes.POINTER(ci)]
    lib.br3_error_string.restype = ctypes.c_char_p
    lib.br3_error_string.argtypes = [ci]


def cluster_plan(p: Params, M: int, nt: int, device=None) -> tuple:
    """(dynamic shared memory bytes a CTA, clusters the card holds at once)
    of K3 at M and nt threads a CTA on `device`'s card; raises where the
    card refuses (builds and loads the library)."""
    lib = nvcc.load(SOURCE, _bind)
    out = (ctypes.c_longlong * 2)()
    return br.check_plan(lib.br3_ntt_plan(p.N, p.l, M, nt,
                                          br.device_index(device), out),
                         out, lib.br3_error_string)


def last_launch() -> tuple:
    """(CTAs, cluster size, threads a CTA) of the last K3 launch, as the C
    launcher made it."""
    out = (ctypes.c_int * 3)()
    nvcc.load(SOURCE, _bind).br3_ntt_last_launch(out)
    return tuple(int(v) for v in out)


def _launch(steps, acc, bk, M: int, p: Params) -> torch.Tensor:
    global LAUNCHES
    lib = nvcc.load(SOURCE, _bind)
    kk = br.kernel_key_of(bk)
    out = acc.clone(memory_format=torch.contiguous_format)  # updated in place
    steps = steps.contiguous()
    tabs, off, dev, stream = ring_args(acc, p)
    nt = br.threads_for(acc.shape[0], br.narrow_cap(
        SOURCE, lambda n: cluster_plan(p, M, n, acc.device), M, p,
        acc.device))
    rc = lib.br3_ntt(out.data_ptr(), steps.data_ptr(), kk.data_ptr(),
                     tabs.tw.data_ptr(), tabs.pw.data_ptr(), acc.shape[0],
                     bk.shape[0], M, p.N, p.l, p.Bgbit, off, nt, dev, stream)
    if rc != 0:
        raise RuntimeError("br3_ntt kernel launch failed: "
                           f"{lib.br3_error_string(rc)}")
    LAUNCHES += 1
    return out


def br3(steps: torch.Tensor, acc: torch.Tensor, bk: torch.Tensor,
        p: Params) -> torch.Tensor:
    """K3: every decompose-first step, steps int32 [S, M, G] against bk
    int32 [S, M*2l, 2, P, N] (with its kernel form), in one launch of G
    clusters; returns the new acc.  A CUDA input runs the kernel, a CPU
    input the twin."""
    M = _check(steps, acc, bk, p)
    if acc.shape[0] == 0:
        return acc.clone()
    if acc.is_cuda:
        return _launch(steps, acc, bk, M, p)
    if acc.device.type != "cpu":
        raise ValueError(f"unsupported device {acc.device}")
    return br3_ref(steps, acc, bk, p)


def blind_rotate_pallas3(tlwe0: torch.Tensor, bk: torch.Tensor,
                         testv: torch.Tensor, p: Params) -> torch.Tensor:
    """Blind rotation lvl0 -> TRLWE lvl1 i32 [G, 2, N] in one K3 launch
    (iyokan_tpu's blind_rotate_pallas3), on the plain key (M = 1) or the
    2-bit-unrolled key (M = 3)."""
    from .tkey import _setup, check_inputs

    check_inputs(tlwe0, bk, testv, p,
                 p.n if _m_of(bk, p) == 1 else (p.n + 1) // 2)
    rows, acc = _setup(tlwe0, testv, p)
    return br3(rotation_steps(rows, bk, p), acc, bk, p)
