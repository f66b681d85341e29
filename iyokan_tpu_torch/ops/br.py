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

K4, K5 (and K3, ops/br3.py) run in the cluster form of
csrc/br_cluster.cuh: one cluster of CLUSTER = 4 CTAs (prime, part) per row
(built for l = 3, every parameter set of the repo; another l raises), of
NARROW_THREADS threads a CTA while the card holds every row's cluster at
once at that size, else WIDE_THREADS (`threads_for`).  K5 is K4's kernel
run one step a launch (S = 1, the accumulator in global memory between
steps): `br_steps` makes one C call (br_ntt_steps) that launches the n
steps back to back, the counterpart of the JAX fori_loop.  They read the key
in its kernel form (`kernel_key`: a reordered copy of the prep1 residues
times N^-1 2^32 mod p), built once beside the prep1 key and kept as its
attribute (`attach_kernel_key`; crypto/ops.py:DeviceKeys.from_evalkey
does it for bk_ntt and bk_ntt_u); a launch on a key without one raises,
and so does a card that cannot hold a cluster (there is no other form).

`br_steps` / `br_step` (K5) and `br_loop` (K4) launch csrc/br_ntt.cu for
CUDA tensors and run the plain twin `cmux_steps_ref` for CPU tensors;
nothing else selects between them.  STEP_LAUNCHES (from the count the C
entry returns) and LOOP_LAUNCHES count the launches; `last_launch` reads
the grid, cluster size and threads a CTA the C launcher last used.
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
CLUSTER = 4           # CTAs a row in K3-K6: (prime p, part u)
WIDE_THREADS = 256    # threads a K3-K6 CTA at wide batches
NARROW_THREADS = 512  # and while all G clusters fit on the card at once
_CAPS = {}            # (source, M, N, l, device) -> clusters at 512 threads


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
    (ntt.KernelTables, decompose1's offset, device index, stream)."""
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    return (ntt.kernel_tables(p.N, acc.device), cops.decompose1_offset(p),
            device_index(acc.device), stream)


# --------------------------------------------------------------------------- #
# the cluster form's plan and key (K4 here, K3 in ops/br3.py)
# --------------------------------------------------------------------------- #


def threads_for(G: int, narrow_cap: int) -> int:
    """Threads a K3-K6 CTA at G rows: NARROW_THREADS while the card holds
    all G clusters at once at that size (narrow_cap clusters,
    cudaOccupancyMaxActiveClusters), so each row gets twice the warps on
    the same wave; WIDE_THREADS from there (more CTAs an SM)."""
    return NARROW_THREADS if G <= narrow_cap else WIDE_THREADS


def narrow_cap(source: str, query, M: int, p: Params, device) -> int:
    """Clusters of NARROW_THREADS-thread CTAs the card holds at once for
    the kernel, read once per (kernel, card) through query(nt); M tells a
    source's instances apart (K3's M, K6's RR)."""
    key = (source, M, p.N, p.l, str(device))
    if key not in _CAPS:
        _CAPS[key] = query(NARROW_THREADS)[1]
    return _CAPS[key]


def kernel_key(bk: torch.Tensor, p: Params) -> torch.Tensor:
    """The K3/K4 kernel form of a prep1 key bk int32 [S, M*2l, 2, P, N]
    (rows m*2l + u*l + j): int32 [S, P, 2 (u), M, l, 2 (v), N], the residue
    k * N^-1 * 2^32 mod p of bk[s, m*2l + u*l + j, v, p] (ntt.key_factor),
    so CTA (p, u) reads one contiguous slice a step.  Built on bk's device,
    32 steps at a time."""
    S, RR = bk.shape[:2]
    M = RR // (2 * p.l)
    shape = (len(ntt.PRIMES), 1, 1, 1, 1, 1)
    f = torch.tensor(ntt.key_factor(p.N), dtype=torch.int64,
                     device=bk.device).reshape(shape)
    primes = torch.tensor(ntt.PRIMES, dtype=torch.int64,
                          device=bk.device).reshape(shape)
    out = torch.empty((S, len(ntt.PRIMES), 2, M, p.l, 2, p.N),
                      dtype=torch.int32, device=bk.device)
    for s0 in range(0, S, 32):
        k = bk[s0: s0 + 32].reshape(-1, M, 2, p.l, 2, len(ntt.PRIMES), p.N)
        out[s0: s0 + 32] = (k.permute(0, 5, 2, 1, 3, 4, 6).to(torch.int64)
                            * f % primes).to(torch.int32)
    return out


def attach_kernel_key(bk: torch.Tensor, p: Params) -> torch.Tensor:
    """Build bk's kernel form once and keep it as bk.kernel_key (a view or
    slice of bk is another tensor and has none); returns bk."""
    if getattr(bk, "kernel_key", None) is None:
        bk.kernel_key = kernel_key(bk, p)
    return bk


def kernel_key_of(bk: torch.Tensor) -> torch.Tensor:
    """bk's kernel form; raises for a key without one (the kernels never
    build it per launch)."""
    kk = getattr(bk, "kernel_key", None)
    if kk is None:
        raise ValueError("this key has no kernel form: build it once with "
                         "ops.br.attach_kernel_key (DeviceKeys.from_evalkey "
                         "does)")
    return kk


# --------------------------------------------------------------------------- #
# the plain twin
# --------------------------------------------------------------------------- #


def cmux_steps_ref(rows: torch.Tensor, acc: torch.Tensor, bk: torch.Tensor,
                   p: Params) -> torch.Tensor:
    """The plain torch twin of K4 and K5, on any device: the S =
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
    for fn in (lib.br_ntt_loop, lib.br_ntt_steps):
        fn.restype = ci
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, u32, ci, ci, vp]
    lib.br_ntt_loop_plan.restype = ci
    lib.br_ntt_loop_plan.argtypes = [ci, ci, ci, ci,
                                     ctypes.POINTER(ctypes.c_longlong)]
    lib.br_ntt_last_launch.restype = None
    lib.br_ntt_last_launch.argtypes = [ctypes.POINTER(ci)]
    lib.br_ntt_error_string.restype = ctypes.c_char_p
    lib.br_ntt_error_string.argtypes = [ci]


def check_plan(rc: int, out, err) -> tuple:
    """(smem, clusters) from a *_plan call's out, or raise its error."""
    if rc != 0:
        raise RuntimeError(f"the card refuses the cluster launch: {err(rc)}")
    return int(out[0]), int(out[1])


def device_index(device) -> int:
    """The CUDA ordinal of `device` (None: the current card)."""
    dev = torch.device(device if device is not None else "cuda")
    return dev.index if dev.index is not None else torch.cuda.current_device()


def cluster_plan(p: Params, nt: int, device=None) -> tuple:
    """(dynamic shared memory bytes a CTA, clusters the card holds at once)
    of K4 (and K5, the same kernel) at nt threads a CTA on `device`'s
    card; raises where the card refuses (builds and loads the library)."""
    lib = nvcc.load(SOURCE, _bind)
    out = (ctypes.c_longlong * 2)()
    return check_plan(lib.br_ntt_loop_plan(p.N, p.l, nt, device_index(device),
                                           out), out, lib.br_ntt_error_string)


def last_launch() -> tuple:
    """(CTAs, cluster size, threads a CTA) of the last K4 launch or K5
    step, as the C launcher made it."""
    out = (ctypes.c_int * 3)()
    nvcc.load(SOURCE, _bind).br_ntt_last_launch(out)
    return tuple(int(v) for v in out)


def _launch(rows, acc, kk, p: Params, loop: bool) -> torch.Tensor:
    """K4 (loop) or K5 over the kernel-form key steps kk, on a copy of acc
    (updated in place: one copy per call, not per step)."""
    global STEP_LAUNCHES, LOOP_LAUNCHES
    lib = nvcc.load(SOURCE, _bind)
    out = acc.clone(memory_format=torch.contiguous_format)
    rows = rows.contiguous()
    tabs, off, dev, stream = ring_args(acc, p)
    G = acc.shape[0]
    nt = threads_for(G, narrow_cap(SOURCE, lambda n: cluster_plan(
        p, n, acc.device), 1, p, acc.device))
    fn = lib.br_ntt_loop if loop else lib.br_ntt_steps
    rc = fn(out.data_ptr(), rows.data_ptr(), kk.data_ptr(),
            tabs.tw.data_ptr(), G, rows.shape[0], p.N, p.l, p.Bgbit, off, nt,
            dev, stream)
    if loop and rc == 0:
        LOOP_LAUNCHES += 1
    elif not loop and rc > 0:
        STEP_LAUNCHES += rc
    else:
        raise RuntimeError(f"br_ntt {'loop' if loop else 'steps'} kernel "
                           f"launch failed: {lib.br_ntt_error_string(abs(rc))}")
    return out


def _dispatch(rows, acc, bk, p: Params, loop: bool,
              first: int = 0) -> torch.Tensor:
    """K4 over all of bk, or K5 over its steps first .. first + S - 1 (S =
    rows.shape[0])."""
    if first < 0:
        raise ValueError(f"step index {first} < 0")
    steps = bk if loop else bk[first: first + rows.shape[0]]
    check_steps(rows, acc, steps, 2 * p.l, p)
    if acc.shape[0] == 0 or steps.shape[0] == 0:
        return acc.clone()
    if acc.is_cuda:
        kk = kernel_key_of(bk)
        return _launch(rows, acc, kk if loop else kk[first: first + len(rows)],
                       p, loop)
    if acc.device.type != "cpu":
        raise ValueError(f"unsupported device {acc.device}")
    return cmux_steps_ref(rows, acc, steps, p)


def br_steps(rows: torch.Tensor, acc: torch.Tensor, bk: torch.Tensor,
             p: Params, first: int = 0) -> torch.Tensor:
    """K5: the CMUX steps first .. first + S - 1 of bk int32 [n, 2l, 2, P,
    N] (with its kernel form), rows int32 [S, G] their amounts, from acc
    i32 [G, 2, N]; one launch a step, S launches from one C call; returns
    the new acc.  A CUDA input runs the kernel, a CPU input the twin."""
    return _dispatch(rows, acc, bk, p, loop=False, first=first)


def br_step(acc: torch.Tensor, a: torch.Tensor, bk: torch.Tensor, i: int,
            p: Params) -> torch.Tensor:
    """K5, one step: CMUX step i of bk int32 [n, 2l, 2, P, N] (the whole
    key with its kernel form; a slice bk[i] has none) for every row of acc
    i32 [G, 2, N], amounts a int32 [G]; returns the new acc."""
    return br_steps(a[None], acc, bk, p, first=i)


def br_loop(rows: torch.Tensor, acc: torch.Tensor, bk: torch.Tensor,
            p: Params) -> torch.Tensor:
    """K4: all CMUX steps, rows int32 [n, G] against bk int32
    [n, 2l, 2, P, N] (with its kernel form), in one launch of G clusters;
    returns the new acc.  A CUDA input runs the kernel, a CPU input the
    twin."""
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
    CMUX step, all from one call (iyokan_tpu's blind_rotate_pallas and its
    fori_loop); bk int32 [n, 2l, 2, P, N] from polymul.prep1, with its
    kernel form."""
    rows, acc = _setup(tlwe0, bk, testv, p)
    return br_steps(rows, acc, bk, p)


def blind_rotate_pallas2(tlwe0: torch.Tensor, bk: torch.Tensor,
                         testv: torch.Tensor, p: Params) -> torch.Tensor:
    """Blind rotation lvl0 -> TRLWE lvl1 i32 [G, 2, N] in one K4 launch
    (iyokan_tpu's blind_rotate_pallas2); bk as blind_rotate_pallas."""
    rows, acc = _setup(tlwe0, bk, testv, p)
    return br_loop(rows, acc, bk, p)
