"""NTT blind rotation, standard CMUX step: the CUDA kernels' wrappers and
their plain twin.

Counterpart of iyokan_tpu/ops/pallas_br.py (`blind_rotate_pallas`, kernel
`_step_kernel`, "K5": one CMUX step per launch; IYOKAN_BR_IMPL=pallas) and
iyokan_tpu/ops/pallas_br2.py (`blind_rotate_pallas2`, kernel `_kernel`,
"K4": the whole n-step loop in one launch; IYOKAN_BR_IMPL=pallas2).  Both
compute pallas_br.py's `step_math` per CMUX step i and row g:

  acc[g] += decompose1(X^{a[i,g]} * acc[g] - acc[g]) (x) bk[i]   (mod 2^32)

with acc i32 [G, 2, N], the rotation amounts a int32 [n, G] in [0, 2N)
(ops/tkey._setup: the modswitched lvl0 mask) and bk the CRT64-prepared
plain key int32 [n, 2l, 2, P=2, N] (crypto/polymul.prep1).  The integer
before the mod-2^32 reduction is exact in both packages, so the result is
the JAX kernels' bit for bit (csrc/br_ntt.cu has the bound).

`br_step` (K5) and `br_loop` (K4) launch csrc/br_ntt.cu for CUDA tensors
and run the plain twin `cmux_steps_ref` for CPU tensors; nothing else
selects between them.  STEP_LAUNCHES and LOOP_LAUNCHES count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..crypto import ntt, polymul
from ..crypto import ops as cops
from ..params import Params
from . import nvcc

STEP_LAUNCHES = 0     # K5 launches: one per CMUX step
LOOP_LAUNCHES = 0     # K4 launches: one per blind rotation
SOURCE = "br_ntt.cu"


# --------------------------------------------------------------------------- #
# checks and launch arguments (shared with ops/br3.py)
# --------------------------------------------------------------------------- #


def check_steps(amounts, acc, bk, RR: int, p: Params):
    """amounts int32 [S, ..., G], acc i32 [G, 2, N], bk int32
    [S, RR, 2, P, N], one device; the key must be contiguous (the kernels
    read it in place)."""
    P = len(ntt.PRIMES)
    if acc.dtype != torch.int32 or acc.dim() != 3 or \
            tuple(acc.shape[1:]) != (2, p.N):
        raise ValueError(f"acc must be int32 [G, 2, N={p.N}], got "
                         f"{acc.dtype} {tuple(acc.shape)}")
    if bk.dtype != torch.int32 or bk.dim() != 5 or \
            tuple(bk.shape[1:]) != (RR, 2, P, p.N):
        raise ValueError(f"key must be int32 [steps, {RR}, 2, {P}, {p.N}], "
                         f"got {bk.dtype} {tuple(bk.shape)}")
    if amounts.dtype != torch.int32 or amounts.shape[0] != bk.shape[0] or \
            amounts.shape[-1] != acc.shape[0]:
        raise ValueError(f"rotation amounts must be int32 [steps="
                         f"{bk.shape[0]}, ..., G={acc.shape[0]}], got "
                         f"{amounts.dtype} {tuple(amounts.shape)}")
    if not (amounts.device == acc.device == bk.device):
        raise ValueError(f"device mismatch: amounts {amounts.device}, acc "
                         f"{acc.device}, key {bk.device}")
    if not bk.is_contiguous():
        raise ValueError("the key must be contiguous")


def ring_args(acc: torch.Tensor, p: Params) -> tuple:
    """The csrc/ntt.cuh kernels' ring arguments for a launch on acc's card:
    (tables, psi powers, offset, ninv1, ninv2, device index, stream)."""
    tab, psipow = ntt.kernel_tables(p.N, acc.device)
    ninv = ntt.tables(p.N)["ninv"]
    dev = acc.device.index if acc.device.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    return (tab, psipow, cops.decompose1_offset(p), int(ninv[0]),
            int(ninv[1]), dev, stream)


# --------------------------------------------------------------------------- #
# the plain twin
# --------------------------------------------------------------------------- #


def cmux_steps_ref(rows: torch.Tensor, acc: torch.Tensor, bk: torch.Tensor,
                   p: Params) -> torch.Tensor:
    """The plain torch twin of both kernels, on any device: the S =
    bk.shape[0] CMUX steps of rows int32 [S, G] against bk int32
    [S, 2l, 2, P, N], from acc i32 [G, 2, N]; returns the new acc."""
    check_steps(rows, acc, bk, 2 * p.l, p)
    for i in range(bk.shape[0]):
        rot = cops.rot_poly(acc, rows[i][:, None], p.N)
        d = cops.decompose1(cops.to_u64(rot) - cops.to_u64(acc), p)
        acc = cops.from_u64(cops.to_u64(acc)
                            + cops.to_u64(polymul.extprod1(d, bk[i], p)))
    return acc


# --------------------------------------------------------------------------- #
# the CUDA kernels: bind, launch
# --------------------------------------------------------------------------- #


def _bind(lib):
    vp, ci, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.br_ntt_step.restype = ci
    lib.br_ntt_step.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, u32, u32,
                                u32, ci, vp]
    lib.br_ntt_loop.restype = ci
    lib.br_ntt_loop.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, u32, u32,
                                u32, ci, vp]
    lib.br_ntt_error_string.restype = ctypes.c_char_p
    lib.br_ntt_error_string.argtypes = [ci]
    lib.br_ntt_smem.restype = ctypes.c_size_t
    lib.br_ntt_smem.argtypes = [ci, ci]


def smem_bytes(p: Params) -> int:
    """Dynamic shared memory of a K5 or K4 block at p, as the launcher
    sizes it (builds and loads the library)."""
    return nvcc.load(SOURCE, _bind).br_ntt_smem(p.N, p.l)


def _launch(rows, acc, bk, p: Params, loop: bool) -> torch.Tensor:
    global STEP_LAUNCHES, LOOP_LAUNCHES
    lib = nvcc.load(SOURCE, _bind)
    out = acc.clone(memory_format=torch.contiguous_format)  # updated in place
    rows = rows.contiguous()
    tab, _, off, ninv1, ninv2, dev, stream = ring_args(acc, p)
    G = acc.shape[0]
    if loop:
        rc = lib.br_ntt_loop(out.data_ptr(), rows.data_ptr(), bk.data_ptr(),
                             tab.data_ptr(), G, bk.shape[0], p.N, p.l,
                             p.Bgbit, off, ninv1, ninv2, dev, stream)
    else:
        rc = lib.br_ntt_step(out.data_ptr(), rows.data_ptr(), bk.data_ptr(),
                             tab.data_ptr(), G, p.N, p.l, p.Bgbit, off,
                             ninv1, ninv2, dev, stream)
    if rc != 0:
        raise RuntimeError(f"br_ntt {'loop' if loop else 'step'} kernel "
                           f"launch failed: {lib.br_ntt_error_string(rc)}")
    if loop:
        LOOP_LAUNCHES += 1
    else:
        STEP_LAUNCHES += 1
    return out


def _dispatch(rows, acc, bk, p: Params, loop: bool) -> torch.Tensor:
    check_steps(rows, acc, bk, 2 * p.l, p)
    if acc.shape[0] == 0:
        return acc.clone()
    if acc.is_cuda:
        return _launch(rows, acc, bk, p, loop)
    if acc.device.type != "cpu":
        raise ValueError(f"unsupported device {acc.device}")
    return cmux_steps_ref(rows, acc, bk, p)


def br_step(acc: torch.Tensor, a: torch.Tensor, key: torch.Tensor,
            p: Params) -> torch.Tensor:
    """K5: one CMUX step of every row, acc i32 [G, 2, N] with amounts a
    int32 [G] against one prepared key step int32 [2l, 2, P, N]; returns
    the new acc.  A CUDA input runs the kernel, a CPU input the twin."""
    return _dispatch(a[None], acc, key[None], p, loop=False)


def br_loop(rows: torch.Tensor, acc: torch.Tensor, bk: torch.Tensor,
            p: Params) -> torch.Tensor:
    """K4: all CMUX steps, rows int32 [n, G] against bk int32
    [n, 2l, 2, P, N], in one launch; returns the new acc.  A CUDA input
    runs the kernel, a CPU input the twin."""
    return _dispatch(rows, acc, bk, p, loop=True)


# --------------------------------------------------------------------------- #
# the blind rotations (IYOKAN_BR_IMPL=pallas and pallas2)
# --------------------------------------------------------------------------- #


def _setup(tlwe0, bk, testv, p: Params):
    from .tkey import _setup, check_inputs

    check_inputs(tlwe0, bk, testv, p, p.n)
    return _setup(tlwe0, testv, p)


def blind_rotate_pallas(tlwe0: torch.Tensor, bk: torch.Tensor,
                        testv: torch.Tensor, p: Params) -> torch.Tensor:
    """Blind rotation lvl0 -> TRLWE lvl1 i32 [G, 2, N], one K5 launch per
    CMUX step (iyokan_tpu's blind_rotate_pallas); bk int32 [n, 2l, 2, P, N]
    from polymul.prep1."""
    rows, acc = _setup(tlwe0, bk, testv, p)
    for i in range(p.n):
        acc = br_step(acc, rows[i], bk[i], p)
    return acc


def blind_rotate_pallas2(tlwe0: torch.Tensor, bk: torch.Tensor,
                         testv: torch.Tensor, p: Params) -> torch.Tensor:
    """Blind rotation lvl0 -> TRLWE lvl1 i32 [G, 2, N] in one K4 launch
    (iyokan_tpu's blind_rotate_pallas2); bk as blind_rotate_pallas."""
    rows, acc = _setup(tlwe0, bk, testv, p)
    return br_loop(rows, acc, bk, p)
