"""Lvl2 blind rotation (circuit bootstrapping's inner loop): the CUDA
kernel's wrapper and its plain twin.

Counterpart of the loop of iyokan_tpu/crypto/ops.py:blind_rotate2
(:464-515), one jax.lax.fori_loop that XLA compiles into one device loop
(the JAX package has no Pallas kernel for it).  Here it is "K7": one launch
of csrc/br2_ntt.cu for a whole blind rotation of G rows, each step

  acc[g] += decompose2(X^{a[i,m,g]} * acc[g] - acc[g])_m (x) bk2[i]
                                                                 (mod 2^64)

summed over the M rotations of the step (M = 1 on the plain key
[n, 2l2, 2, 4, N2], one amount a step; M = 3 on the 2-bit-unrolled key
[ceil(n/2), 3*2l2, 2, 4, N2], the amounts a1, a2, a1 + a2 of key bits 2i,
2i+1, an odd n padded with a2 = 0; `rotation_steps` builds them), with acc
i64 [G, 2, N2] on the 64-bit torus (u64 bit patterns) and bk2 the CRT64
key of crypto/polymul.prep2 (residues of each row's two 32-bit halves).
The product of each half is exact over the integers (|conv| < 2^55 against
P1*P2/2 = 2^60.7), so the result is the twin's, and the JAX package's, bit
for bit.

`br2` launches csrc/br2_ntt.cu for CUDA tensors and runs the plain twin
`blind_rotate2_ref` (the loop crypto/ops.py ran before K7) for CPU
tensors; nothing else selects between them, and a failed build or launch
raises.  The kernel is the cluster form of csrc/br_cluster.cuh (clusters
of br.CLUSTER = 4 CTAs, (prime, part)) at N2 = 2048, built for l2 = 5,
Bgbit2 = 8 (every parameter set of the repo; another raises), with up to
R_MAX rows a cluster sharing its key reads: a launch of G rows takes
`rows_per_cluster(G, C)` rows a cluster, C the clusters the card holds at
once at R_MAX's shared memory (`cluster_plan`), so up to R_MAX * C rows
run in one wave.  It reads the key in its kernel form (`kernel_key2`,
built once beside the prep2 key by crypto/ops.py:DeviceKeys.from_evalkey,
`attach_kernel_key2`).  THREADS threads a CTA; one CTA an SM.  LAUNCHES
counts the launches; `last_launch` reads the grid, cluster size, threads
a CTA and rows a cluster the C launcher last used.
"""

from __future__ import annotations

import ctypes

import torch

from ..crypto import ntt, polymul
from ..crypto import ops as cops
from ..params import Params
from . import br, nvcc

LAUNCHES = 0          # K7 launches: one per lvl2 blind rotation
SOURCE = "br2_ntt.cu"
THREADS = 1024        # threads a K7 CTA (csrc/br2_ntt.cu: BR2_THREADS)
R_MAX = 3             # rows a K7 cluster at most (csrc/br2_ntt.cu: BR2_R_MAX)


def _m_of(bk2: torch.Tensor, p: Params) -> int:
    """M = 1 for the plain key's 2l2 rows a step, 3 for the unrolled 3*2l2."""
    rr = bk2.shape[1] if bk2.dim() == 5 else 0
    if rr not in (2 * p.l2, 6 * p.l2):
        raise ValueError(f"lvl2 key {tuple(bk2.shape)} has neither 2l2 = "
                         f"{2 * p.l2} nor 3*2l2 = {6 * p.l2} rows a step")
    return rr // (2 * p.l2)


def rotation_steps(rows: torch.Tensor, bk2: torch.Tensor,
                   p: Params) -> torch.Tensor:
    """The amounts int32 [steps, M, G] of rows int [n, G] (the modswitched
    lvl0 mask, one row per key bit): [n, 1, G] for the plain key; for the
    unrolled key (steps = ceil(n/2)) the pairs (a1, a2, a1 + a2 mod 2N2),
    an odd n padded with a2 = 0."""
    if _m_of(bk2, p) == 1:
        return rows[:, None, :].to(torch.int32).contiguous()
    return torch.stack(cops.pair_amounts(rows, bk2.shape[0], p.N2),
                       dim=1).to(torch.int32).contiguous()


def _check(steps, acc, bk2, p: Params) -> int:
    """steps int32 [S, M, G], acc int64 [G, 2, N2], bk2 int64
    [S, M*2l2, 2, 4, N2], one device; returns M.  Shapes only: nothing
    here reads the card (a CUDA graph may hold the call)."""
    M = _m_of(bk2, p)
    if acc.dtype != torch.int64 or acc.dim() != 3 or \
            tuple(acc.shape[1:]) != (2, p.N2):
        raise ValueError(f"acc must be int64 [G, 2, N2={p.N2}], got "
                         f"{acc.dtype} {tuple(acc.shape)}")
    if bk2.dtype != torch.int64 or tuple(bk2.shape[2:]) != (
            2, 2 * len(ntt.PRIMES), p.N2):
        raise ValueError(f"lvl2 key must be int64 [steps, RR, 2, 4, "
                         f"{p.N2}], got {bk2.dtype} {tuple(bk2.shape)}")
    if steps.dtype != torch.int32 or tuple(steps.shape) != (
            bk2.shape[0], M, acc.shape[0]):
        raise ValueError(f"steps must be int32 [steps={bk2.shape[0]}, "
                         f"M={M}, G={acc.shape[0]}], got {steps.dtype} "
                         f"{tuple(steps.shape)}")
    if not (steps.device == acc.device == bk2.device):
        raise ValueError(f"device mismatch: steps {steps.device}, acc "
                         f"{acc.device}, key {bk2.device}")
    return M


# --------------------------------------------------------------------------- #
# the plain twin
# --------------------------------------------------------------------------- #


def blind_rotate2_ref(steps: torch.Tensor, acc: torch.Tensor,
                      bk2: torch.Tensor, p: Params) -> torch.Tensor:
    """The plain torch twin of K7, on any device: the S = bk2.shape[0]
    steps of `steps` int32 [S, M, G] against bk2 (polymul.prep2 of the
    plain or the unrolled key) from acc i64 [G, 2, N2]; returns the new
    acc.  Each step is polymul.extprod2 of the M rotated differences'
    digit rows (decompose2), concatenated m-major."""
    M = _check(steps, acc, bk2, p)
    G = acc.shape[0]
    if M == 3:
        for i in range(bk2.shape[0]):
            rot = cops.rot_poly(acc[None], steps[i][:, :, None],
                                p.N2)                       # [3,G,2,N2]
            d = cops.decompose2(rot - acc[None], p)         # [3,G,2l2,N2]
            d = d.transpose(0, 1).reshape(G, 6 * p.l2, p.N2)
            acc = acc + polymul.extprod2(d, bk2[i], p)
        return acc
    for i in range(bk2.shape[0]):
        rot = cops.rot_poly(acc, steps[i, 0][:, None], p.N2)
        acc = acc + polymul.extprod2(cops.decompose2(rot - acc, p), bk2[i],
                                     p)
    return acc


# --------------------------------------------------------------------------- #
# the key's kernel form
# --------------------------------------------------------------------------- #


def kernel_key2(bk2: torch.Tensor, p: Params) -> torch.Tensor:
    """K7's form of a prep2 key bk2 int64 [S, M*2l2, 2 (v), 4, N2] (rows
    m*2l2 + u*l2 + j; 4 = 2*prime + half): int32 [S, P, 2 (u), M, l2,
    2 (v), 2 (h), N2], the residue k * N2^-1 * 2^32 mod p (ntt.key_factor),
    so CTA (p, u) reads one contiguous slice a step, a Montgomery reduction
    of a row sum leaves the product times N2^-1 and the inverse needs no
    scaling pass.  Built on bk2's device, 32 steps at a time."""
    S, RR = bk2.shape[:2]
    M = RR // (2 * p.l2)
    P = len(ntt.PRIMES)
    shape = (P, 1, 1, 1, 1, 1, 1)
    f = torch.tensor(ntt.key_factor(p.N2), dtype=torch.int64,
                     device=bk2.device).reshape(shape)
    primes = torch.tensor(ntt.PRIMES, dtype=torch.int64,
                          device=bk2.device).reshape(shape)
    out = torch.empty((S, P, 2, M, p.l2, 2, 2, p.N2), dtype=torch.int32,
                      device=bk2.device)
    for s0 in range(0, S, 32):
        k = bk2[s0: s0 + 32].reshape(-1, M, 2, p.l2, 2, P, 2, p.N2)
        out[s0: s0 + 32] = (k.permute(0, 5, 2, 1, 3, 4, 6, 7) * f
                            % primes).to(torch.int32)
    return out


def attach_kernel_key2(bk2: torch.Tensor, p: Params) -> torch.Tensor:
    """Build bk2's kernel form once and keep it as bk2.kernel_key (a view
    or slice of bk2 is another tensor and has none); returns bk2."""
    if getattr(bk2, "kernel_key", None) is None:
        bk2.kernel_key = kernel_key2(bk2, p)
    return bk2


def kernel_key2_of(bk2: torch.Tensor) -> torch.Tensor:
    """bk2's kernel form; raises for a key without one (K7 never builds it
    per launch)."""
    kk = getattr(bk2, "kernel_key", None)
    if kk is None:
        raise ValueError("this lvl2 key has no kernel form: build it once "
                         "with ops.br2.attach_kernel_key2 "
                         "(DeviceKeys.from_evalkey does)")
    return kk


# --------------------------------------------------------------------------- #
# the CUDA kernel: bind, plan, launch
# --------------------------------------------------------------------------- #


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.br2_ntt.restype = ci
    lib.br2_ntt.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                            ctypes.c_uint64, ci, ci, vp]
    lib.br2_ntt_plan.restype = ci
    lib.br2_ntt_plan.argtypes = [ci, ci, ci, ci, ci,
                                 ctypes.POINTER(ctypes.c_longlong)]
    lib.br2_ntt_last_launch.restype = None
    lib.br2_ntt_last_launch.argtypes = [ctypes.POINTER(ci)]
    lib.br2_error_string.restype = ctypes.c_char_p
    lib.br2_error_string.argtypes = [ci]


def _lib() -> ctypes.CDLL:
    """The loaded K7 library (built at first use); a failed build raises,
    naming K7."""
    try:
        return nvcc.load(SOURCE, _bind)
    except (OSError, RuntimeError) as e:
        raise RuntimeError(f"K7 ({SOURCE}) failed to build or load: {e}") \
            from e


def rows_per_cluster(G: int, clusters: int, r_max: int = R_MAX) -> int:
    """K7's rows a cluster for a launch of G rows on a card that holds
    `clusters` clusters at once: the fewest that fit all G rows in one wave,
    ceil(G / clusters), at most r_max (beyond r_max * clusters rows the
    ceil(G / r_max) clusters run in waves).  The launch is ceil(G / R)
    clusters, the last one holding the rest."""
    if G < 1 or clusters < 1 or r_max < 1:
        raise ValueError(f"rows_per_cluster({G}, {clusters}, {r_max})")
    return min(r_max, -(-G // clusters))


def cluster_plan(p: Params, M: int, device=None, rows: int = 0) -> tuple:
    """(dynamic shared memory bytes a CTA, clusters the card holds at once,
    rows a cluster, the library's R_MAX) of K7 at M and `rows` rows a
    cluster (0: R_MAX) on `device`'s card; raises where the card refuses
    (builds and loads the library)."""
    lib = _lib()
    out = (ctypes.c_longlong * 4)()
    smem, clusters = br.check_plan(
        lib.br2_ntt_plan(p.N2, p.l2, M, rows, br.device_index(device), out),
        out, lib.br2_error_string)
    return smem, clusters, int(out[2]), int(out[3])


def last_launch() -> tuple:
    """(CTAs, cluster size, threads a CTA, rows a cluster) of the last K7
    launch, as the C launcher made it."""
    out = (ctypes.c_int * 4)()
    _lib().br2_ntt_last_launch(out)
    return tuple(int(v) for v in out)


def _launch(steps, acc, bk2, M: int, p: Params) -> torch.Tensor:
    """K7 over every step of bk2's kernel form, on a copy of acc (updated
    in place), at rows_per_cluster rows a cluster."""
    global LAUNCHES
    lib = _lib()
    kk = kernel_key2_of(bk2)
    G = acc.shape[0]
    dev = br.device_index(acc.device)
    _, clusters, _, r_max = cluster_plan(p, M, acc.device)
    rows = rows_per_cluster(G, clusters, r_max)
    out = acc.clone(memory_format=torch.contiguous_format)
    steps = steps.contiguous()
    tabs = ntt.kernel_tables(p.N2, acc.device)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    rc = lib.br2_ntt(out.data_ptr(), steps.data_ptr(), kk.data_ptr(),
                     tabs.tw.data_ptr(), G, bk2.shape[0], M, p.N2, p.l2,
                     p.Bgbit2, cops.decompose2_offset(p), rows, dev, stream)
    if rc != 0:
        raise RuntimeError(f"K7 ({SOURCE}) launch failed: "
                           f"{lib.br2_error_string(rc).decode()}")
    LAUNCHES += 1
    return out


def br2(steps: torch.Tensor, acc: torch.Tensor, bk2: torch.Tensor,
        p: Params) -> torch.Tensor:
    """K7: every step of a lvl2 blind rotation, steps int32 [S, M, G]
    (rotation_steps) against bk2 int64 [S, M*2l2, 2, 4, N2] (with its
    kernel form), from acc i64 [G, 2, N2], in one launch of ceil(G / R)
    clusters of R = rows_per_cluster rows; returns the new acc.  A CUDA
    input runs the kernel, a CPU input the twin."""
    M = _check(steps, acc, bk2, p)
    if acc.shape[0] == 0:
        return acc.clone()
    if acc.is_cuda:
        return _launch(steps, acc, bk2, M, p)
    if acc.device.type != "cpu":
        raise ValueError(f"unsupported device {acc.device}")
    return blind_rotate2_ref(steps, acc, bk2, p)
