"""Toeplitz-slab blind rotation: the CUDA kernel's wrapper and plain twin.

Counterpart of iyokan_tpu/ops/pallas_tk.py (`blind_rotate_tkey`, kernels
`_kernel_pipe` and `_kernel`) on every slab layout that
crypto/polymul.tkey_kernel_key builds (RR = l+lb digit rows, C = 2*L*128
columns ordered (u, limb, 128)):

  fat       int8 [n, RR*N, C], contraction rows (block, j, 128)
  thin      int8 [n, RR, N, C]
  fat2      int8 [n, 2*RR*N, C]: the negated key's fat slab, then the key's
  unrolled  int8 [ceil(n/2), 3*RR*N, C]: the fat slab of the 2-bit-unrolled
            key bku, one step a key-bit pair, rows (block, m, part, j, 128)

Per step i, gate g and rotation m < M (M = 3 on the unrolled slab, with
amounts a1, a2, a1+a2 mod 2N of the pair; else M = 1):

  x_mu  = X^{r_m[g]} * acc_u - acc_u + off_u             (u = part a, b)
  d     = signed gadget digits of x (l for part a, lb for part b), rows
          (m, part, j)
  s_K   = the slab product of output block K (128 coefficients):
    fat, unrolled  -ext[:, :cut] . bk[RT-cut:] + ext[:, cut:] . bk[:RT-cut]
                   (ext = d with lanes (block, m, part, j, 128), RT =
                   M*RR*N contraction rows, cut = 128*M*RR*(K+1))
    fat2           ext . bk[RT-cut : 2*RT-cut]
    thin           sum_j [d, -d][:, j, 128(K+1) : 128(K+1)+N] . bk[j]
  acc_u[:, 128K:128K+128] += sum_li s_K[:, (u*L+li)*128 : +128]
                             << 8*(4-L+li)          (mod 2^32)

Every s_K is exact in int32 and in float64: |d| <= 32, |limb| <= 128, and
at most 3*5*1024 = 15360 contraction rows at cggi128 bound it by 2^26.
fat2 is its own math: at L=3 its negated copy is not the limb-wise
negation of the key's where a coefficient's dropped limb is -128, so it
differs from the fat result there (pallas_tk's K-major branch, which reads
the second copy only, gives the fat result instead).

The slab lies on the device contraction-contiguous (`k_contiguous`):
physical [n, C, RT] for fat and unrolled, [n, C, 2RT] for fat2 and
[n, C, RR, N] for thin, exposed as a transposed view with the logical shape
above, so `slab_config`, the twin and byte comparisons see the layouts as
tkey_kernel_key builds them.  Both forms of the kernel read B K-major; the
kernel path takes only that storage (`check_k_contiguous`) and never
converts a slab per call (2.5 GB at cggi128).  The twin takes either.

`blind_rotate_tkey` runs the hand-written Hopper kernel
(csrc/tkey_blind_rotate.cu) for a CUDA tensor and the plain torch twin
(`blind_rotate_tkey_ref`, each layout's own form above) for a CPU tensor;
nothing else selects between them, and a slab it cannot place raises.  On
the card a rotation takes one of three forms (`form`, else `route_form`):

  loop   the persistent form (csrc/tkey_loop.cuh): all steps in one
         cooperative launch of clusters of NB CTAs (`loop_plan`); it
         serves fat and thin (LOOP_ROUTED), and the route gives it their
         padded batches below LOOP_MAX_G;
  mma    the per-step mma.sync form (conv_kernel, split contraction;
         digits_kernel: two launches a step), the other batches below
         WGMMA_MIN_G: fat's and thin's from 32 gates, where the H100 runs
         it faster than the persistent form (PERF.md section 5), and those
         of fat2 and the unrolled slab, which the persistent form does not
         serve;
  wgmma  the per-step wgmma form (conv_wgmma_kernel, digits_kernel),
         batches of at least WGMMA_MIN_G.

LAUNCHES counts blind rotations run on the card, LAYOUT_LAUNCHES the same
per layout, FORM_LAUNCHES per form.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..crypto import ops as cops
from ..params import Params
from . import nvcc

LAUNCHES = 0          # blind rotations launched on the card
LAYOUT_LAUNCHES = {"fat": 0, "thin": 0, "fat2": 0, "unrolled": 0}
FORM_LAUNCHES = {"loop": 0, "wgmma": 0, "mma": 0}
BLOCK_G = 16          # gate tile of the kernel; batches are padded to it
# The route's thresholds, from the H100's forms table (PERF.md section 5):
# padded batches below LOOP_MAX_G gates take the persistent form on the
# layouts of LOOP_ROUTED; the others below WGMMA_MIN_G the mma.sync form;
# from WGMMA_MIN_G on the wgmma form (the two per-step forms tie at 128).
LOOP_MAX_G = 32
WGMMA_MIN_G = 144
LOOP_ROUTED = ("fat", "thin")   # the layouts the persistent form serves
LOOP_CW = 32          # its column tile: coefficients (of all L limbs)
LOOP_GT = 16          # its gate tile
LAST_LOOP = None      # the persistent form's last launch (tkey_loop_plan)
WGMMA_BK = 128        # the wgmma form's k-tile: contraction rows
SOURCE = "tkey_blind_rotate.cu"
# the kernel's layout argument (the unrolled slab is fat at M = 3)
_LAYOUT_ARG = {"fat": 0, "thin": 1, "fat2": 2, "unrolled": 0}


# --------------------------------------------------------------------------- #
# slab layout and host-side set-up (shared by the kernel and the twin)
# --------------------------------------------------------------------------- #


def slab_config(bk_tk: torch.Tensor, p: Params):
    """(layout, L, lb, M) of a tkey slab, read from its rank and rows per
    step with pallas_tk.blind_rotate_tkey's precedence: a 4-d key is thin;
    a 3-d key with (l+lb)*N rows a step is fat, 2(l+lb)*N fat2 and
    3(l+lb)*N unrolled (M = 3), fat2 winning where the last two collide
    (l=3: unrolled lb=1 against fat2 lb=3, which tkey_kernel_key refuses
    to build unrolled).  Raises ValueError on any other slab."""
    if bk_tk.dtype != torch.int8:
        raise ValueError(f"tkey slab must be int8, got {bk_tk.dtype}")
    C = bk_tk.shape[-1]
    if C % 256 or C // 256 not in (3, 4):
        raise ValueError(f"tkey slab has {C} columns; need 2*L*128, L=3|4")
    layout, lb = None, 0
    if bk_tk.dim() == 4 and bk_tk.shape[2] == p.N:
        layout, lb = "thin", bk_tk.shape[1] - p.l
    elif bk_tk.dim() == 3 and bk_tk.shape[1] % p.N == 0:
        rr = bk_tk.shape[1] // p.N
        for lay, k in (("fat", 1), ("fat2", 2), ("unrolled", 3)):
            if rr % k == 0 and 1 <= rr // k - p.l <= p.l:
                layout, lb = lay, rr // k - p.l
                break
    if layout is None or not 1 <= lb <= p.l:
        raise ValueError(
            f"cannot place tkey slab {tuple(bk_tk.shape)} at N={p.N}, "
            f"l={p.l}: not a fat, thin, fat2 or unrolled layout with "
            "1 <= lb <= l")
    return layout, C // 256, lb, 3 if layout == "unrolled" else 1


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


def check_inputs(tlwe0, key, testv, p: Params, steps: int,
                 slab: bool = False):
    """A blind rotation's inputs (every kernel route's): tlwe0 i32
    [G, n+1], testv i32 [N] and a key of `steps` steps, on one device: a
    contiguous key, or for a tkey slab (slab=True) also a K-contiguous
    one."""
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
    if not (key.is_contiguous() or (slab and is_k_contiguous(key))):
        raise ValueError("the key must be contiguous"
                         + (" or K-contiguous (k_contiguous)" if slab else ""))


def is_k_contiguous(slab: torch.Tensor) -> bool:
    """True for a slab whose storage keeps each column's contraction
    contiguous: the view k_contiguous gives ([n, C, ...] storage, logical
    [n, ..., C])."""
    return slab.dim() >= 3 and slab.movedim(-1, 1).is_contiguous()


def check_k_contiguous(slab: torch.Tensor) -> None:
    """The kernel path's storage check: raises ValueError unless the slab
    is K-contiguous (a row-major slab would need a 2.5 GB transpose per
    call at cggi128; make it once with k_contiguous)."""
    if not is_k_contiguous(slab):
        raise ValueError(
            f"the tkey kernel takes the slab K-contiguous (strides "
            f"{tuple(slab.stride())} for shape {tuple(slab.shape)} are not):"
            " build it with ops/tkey.py:k_contiguous")


def k_contiguous(slab, device=None, chunk: int = 32) -> torch.Tensor:
    """The slab (numpy or torch, logical layout [n, ..., C] as
    tkey_kernel_key builds it) on `device` (default: the slab's) with the
    contraction contiguous: storage [n, C, ...], returned as the view of
    logical shape [n, ..., C].  Moved and transposed `chunk` steps at a
    time, so the peak stays near one slab."""
    src = torch.from_numpy(slab) if isinstance(slab, np.ndarray) else slab
    if src.dtype != torch.int8 or src.dim() < 3:
        raise ValueError(f"a tkey slab is int8 [n, ..., C], got "
                         f"{src.dtype} {tuple(src.shape)}")
    device = src.device if device is None else torch.device(device)
    phys = torch.empty((src.shape[0], src.shape[-1], *src.shape[1:-1]),
                       dtype=torch.int8, device=device)
    for i in range(0, src.shape[0], chunk):
        phys[i: i + chunk] = src[i: i + chunk].to(device).movedim(-1, 1)
    return phys.movedim(1, -1)


def _prepare(tlwe0, bk_tk, testv, p: Params):
    """The slab's config, the rotation rows int32 [M*steps, G] (step i's
    M amounts at rows M*i..; on the unrolled slab (a1, a2, a1+a2 mod 2N)
    of each key-bit pair, pallas_tk.py:672-682) and the accumulator."""
    cfg = slab_config(bk_tk, p)
    M = cfg[3]
    steps = (p.n + 1) // 2 if M == 3 else p.n
    check_inputs(tlwe0, bk_tk, testv, p, steps, slab=True)
    rows, acc = _setup(tlwe0, testv, p)
    if M == 3:
        rows = torch.stack(cops.pair_amounts(rows, steps, p.N), dim=1)
        rows = rows.reshape(3 * steps, -1).contiguous()
    return cfg, rows, acc


# --------------------------------------------------------------------------- #
# the plain twin
# --------------------------------------------------------------------------- #


def _digits_ref(a: torch.Tensor, amounts: torch.Tensor, p: Params,
                lb: int) -> torch.Tensor:
    """Signed gadget digits int64 [G, M*(l+lb), N], rows (m, part, j), of
    the rotate-diffs X^r acc - acc (+ the rounding offsets) for each
    amount row r [G] of amounts [M, G]; a: acc as int64 [G, 2, N]."""
    offs = torch.tensor((_round_off(p, p.l), _round_off(p, lb)),
                        device=a.device)[:, None]
    digs = []
    for r in amounts:
        rot = cops.to_u64(cops.rot_poly(cops.from_u64(a), r[:, None], p.N))
        x = (rot - a + offs) & cops.MASK32                    # [G, 2, N]
        for part, ndig in ((0, p.l), (1, lb)):
            for j in range(ndig):
                sh = 32 - (j + 1) * p.Bgbit
                digs.append(((x[:, part] >> sh) & (p.Bg - 1)) - p.Bg // 2)
    return torch.stack(digs, dim=1)


def _steps_ref(rows: torch.Tensor, acc: torch.Tensor, bk_tk: torch.Tensor,
               p: Params, cfg) -> torch.Tensor:
    """The CMUX steps in plain torch, each layout in its own form (module
    docstring): digits, slab products, recombination, accumulation.  The
    products run in float64, which is exact here (|s| < 2^26 << 2^53;
    float32 is not: 5120*32*128 = 2^24.3)."""
    layout, L, lb, M = cfg
    N, NB = p.N, p.N // 128
    RR = M * (p.l + lb)
    RT = RR * N
    G = acc.shape[0]
    a = cops.to_u64(acc)                               # [G, 2, N] int64
    for i in range(bk_tk.shape[0]):
        d = _digits_ref(a, rows[M * i: M * (i + 1)], p, lb).to(torch.float64)
        bk = bk_tk[i].to(torch.float64).reshape(-1, bk_tk.shape[-1])
        if layout == "thin":
            ext = torch.cat([d, -d], dim=-1)           # [G, RR, 2N]
        else:                                          # lanes (block, m,
            ext = d.reshape(G, RR, NB, 128).permute(0, 2, 1, 3).reshape(
                G, RT)                                 # part, j, 128)
        outs = []
        for K in range(NB):
            cut = 128 * RR * (K + 1)
            if layout == "thin":
                w = 128 * (K + 1)                      # each row j's window
                s = ext[:, :, w: w + N].reshape(G, RT) @ bk
            elif layout == "fat2":
                s = ext @ bk[RT - cut: 2 * RT - cut]
            else:
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
    cfg, rows, acc = _prepare(tlwe0, bk_tk, testv, p)
    return _steps_ref(rows, acc, bk_tk, p, cfg)


# --------------------------------------------------------------------------- #
# the CUDA kernel: build, bind, launch
# --------------------------------------------------------------------------- #


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tkey_blind_rotate.restype = ci
    lib.tkey_blind_rotate.argtypes = [
        vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci,
        ctypes.c_uint32, ctypes.c_uint32, ci, vp]
    lib.tkey_loop_rotate.restype = ci
    lib.tkey_loop_rotate.argtypes = [
        vp, vp, vp, vp, ctypes.c_size_t, vp, ci, ci, ci, ci, ci, ci, ci, ci,
        ci, ctypes.c_uint32, ctypes.c_uint32, ci, vp, ctypes.POINTER(ci)]
    lib.tkey_loop_plan.restype = ci
    lib.tkey_loop_plan.argtypes = [ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
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


def k_tile_order(K: int, layout: str, RT: int, N: int, RR: int,
                 bk: int = WGMMA_BK) -> list:
    """The wgmma form's k-tile schedule for output block K, in the order
    the kernel runs it (csrc/tkey_blind_rotate.cu: wrap_order, conv_tile):
    [(t, acol, bkc, wrap)] for the bk-row k-tiles t, where acol is the
    digit extension's column of the tile's first row, bkc the K-contiguous
    slab's contraction coordinate (fat2: RT + r0 for the second copy, r0
    for the first copy's wrapped rows) and wrap says the rows wrap (a
    minus sign, except on fat2).  Every segment's plain rows come first,
    then the wrapped ones."""
    seg = N if layout == "thin" else RT
    shift = 128 if layout == "thin" else 128 * RR
    TS, nseg = seg // bk, RT // seg
    PS = (seg - (K + 1) * shift) // bk
    order = ([j * TS + q for j in range(nseg) for q in range(PS)]
             + [j * TS + q for j in range(nseg) for q in range(PS, TS)])
    out = []
    for t in order:
        r0 = t * bk
        t0 = r0 % seg
        o = t0 + (K + 1) * shift
        wrap = o >= seg
        o -= seg if wrap else 0
        bkc = (r0 if wrap else RT + r0) if layout == "fat2" else r0
        out.append((t, r0 - t0 + o, bkc, wrap))
    return out


def route_form(layout: str, Gp: int) -> str:
    """The form the route gives a padded batch of Gp gates on a slab of
    `layout`: the persistent form below LOOP_MAX_G on LOOP_ROUTED's
    layouts, the mma.sync form below WGMMA_MIN_G, else the wgmma form."""
    if layout in LOOP_ROUTED and Gp < LOOP_MAX_G:
        return "loop"
    return "wgmma" if Gp >= WGMMA_MIN_G else "mma"


def loop_plan(p: Params, cfg, Gp: int) -> dict:
    """The persistent form's plan (csrc/tkey_loop.cuh) for a padded batch
    of Gp gates on a slab of config cfg (slab_config), with column tiles of
    LOOP_CW coefficients and gate tiles of LOOP_GT gates:

      clusters  [(u, ct)]: part u, coefficients [ct*cw, ct*cw + cw) of
                every 128-block, all L limbs: one cluster a column tile;
      columns   {(u, ct): the slab columns (u*L + li)*128 + ct*cw + c,
                ordered (li, c)};
      chunks    [b]: CTA rank b's k-tiles of a step, each the slab
                contraction coordinate of its first row (128 rows each):
                b*bstride + kt*rstride, kt < ktc = l + lb;
      sources   [b][K] = (j, sign): output block K takes from CTA b's
                contraction block the digits of coefficient block j =
                (b + K + 1) mod NB, with sign -1 where b + K + 1 >= NB
                (the rows wrap);
      A rows    (j, gate) for j < NB, gate < gt: the same in every CTA;
                CTA b computes j = b into an exchange buffer, from which
                every CTA of the cluster loads all NB;
      reduces   [b] = K: the output block CTA b sums over its cluster;
      gate_tiles [(first gate, end)]: a step's tiles, one after another.

    Raises ValueError for a layout it does not serve (fat2, unrolled) or a
    bad Gp."""
    layout, L, lb, M = cfg
    if layout not in LOOP_ROUTED:
        raise ValueError(f"the persistent form does not serve {layout}")
    if Gp <= 0 or Gp % BLOCK_G:
        raise ValueError(f"Gp={Gp}: need a positive multiple of {BLOCK_G}")
    cw, gt = LOOP_CW, LOOP_GT
    NB, ktc = p.N // 128, p.l + lb
    bstride, rstride = (128, p.N) if layout == "thin" else (ktc * 128, 128)
    clusters = [(u, ct) for u in range(2) for ct in range(128 // cw)]
    return {
        "NB": NB, "ktc": ktc, "cw": cw, "gt": gt, "L": L,
        "gate_tiles": [(g, g + gt) for g in range(0, Gp, gt)],
        "clusters": clusters,
        "columns": {(u, ct): [(u * L + li) * 128 + ct * cw + c
                              for li in range(L) for c in range(cw)]
                    for u, ct in clusters},
        "chunks": [[b * bstride + kt * rstride for kt in range(ktc)]
                   for b in range(NB)],
        "sources": [[((b + K + 1) % NB, -1 if b + K + 1 >= NB else 1)
                     for K in range(NB)] for b in range(NB)],
        "reduces": list(range(NB)),
    }


def card_loop_plan(p: Params, L: int, lb: int, device=None) -> dict:
    """The persistent form's launch plan on the card (tkey_loop_plan): cw,
    clusters, CTAs a cluster, threads a CTA, shared memory a CTA, slab
    ring slots, the clusters the card holds at once and gt."""
    lib = nvcc.load(SOURCE, _bind)
    dev = torch.cuda.current_device() if device is None else device
    out = (ctypes.c_int * 8)()
    rc = lib.tkey_loop_plan(dev, p.N, p.l, lb, L, out)
    if rc != 0:
        raise RuntimeError(f"tkey persistent form: no plan: "
                           f"{lib.tkey_error_string(rc)}")
    return _plan_dict(out)


def loop_stage_bytes(p: Params, lb: int) -> int:
    """Bytes of the persistent form's exchange buffer (tkey_loop.cuh:
    stage_bytes): the digit rows of two parities and the partials of every
    cluster, then 128 bytes for the grid barrier's word."""
    NB, ktc = p.N // 128, p.l + lb
    return (2 * 128 // LOOP_CW * NB * LOOP_GT
            * (2 * ktc * 128 + NB * LOOP_CW * 4) + 128)


def _plan_dict(out) -> dict:
    return dict(zip(("cw", "clusters", "cluster_ctas", "threads",
                     "smem_bytes", "slab_slots", "clusters_held", "gt"),
                    list(out)))


def _steps_kernel(rows: torch.Tensor, acc: torch.Tensor, bk_tk: torch.Tensor,
                  p: Params, cfg, form=None) -> torch.Tensor:
    """All CMUX steps on the card; returns the new accumulator.  form:
    "loop", "wgmma" or "mma", or None for the route's (route_form)."""
    global LAUNCHES, LAST_LOOP
    check_k_contiguous(bk_tk)
    layout, L, lb, M = cfg
    G = acc.shape[0]
    pad = (-G) % BLOCK_G
    Gp = G + pad
    if form is None:
        form = route_form(layout, Gp)
    if form not in FORM_LAUNCHES:
        raise ValueError(f"form {form!r}: need one of {list(FORM_LAUNCHES)}")
    if form == "loop" and layout not in LOOP_ROUTED:
        raise ValueError(f"the persistent form does not serve {layout}")
    lib = nvcc.load(SOURCE, _bind)
    if pad:
        acc = torch.cat([acc, acc.new_zeros((pad, 2, p.N))])
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], pad))], 1)
    acc = acc.contiguous()
    rows = rows.contiguous()
    RT = M * (p.l + lb) * p.N
    dev = acc.device.index if acc.device.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    if form == "loop":
        scratch = torch.empty_like(acc)
        stage = torch.empty(loop_stage_bytes(p, lb), dtype=torch.int8,
                            device=acc.device)
        used = (ctypes.c_int * 8)()
        rc = lib.tkey_loop_rotate(
            rows.data_ptr(), acc.data_ptr(), scratch.data_ptr(),
            stage.data_ptr(), stage.numel(), bk_tk.data_ptr(), Gp,
            bk_tk.shape[0], p.N, p.l, lb, p.Bgbit, L, M, _LAYOUT_ARG[layout],
            _round_off(p, p.l), _round_off(p, lb), dev, stream, used)
        if rc == 0:
            LAST_LOOP = _plan_dict(used)
    else:
        ext = torch.empty((Gp, RT), dtype=torch.int8, device=acc.device)
        wg = form == "wgmma"
        rc = lib.tkey_blind_rotate(
            rows.data_ptr(), acc.data_ptr(), bk_tk.data_ptr(),
            ext.data_ptr(), Gp, bk_tk.shape[0], p.N, p.l, lb, p.Bgbit, L, M,
            _LAYOUT_ARG[layout], 1 if wg else _split_k(Gp, RT // 64),
            int(wg), _round_off(p, p.l), _round_off(p, lb), dev, stream)
    if rc != 0:
        raise RuntimeError(f"tkey kernel launch failed ({form} form): "
                           f"{lib.tkey_error_string(rc)}")
    LAUNCHES += 1
    LAYOUT_LAUNCHES[layout] += 1
    FORM_LAUNCHES[form] += 1
    return acc[:G]


def blind_rotate_tkey(tlwe0: torch.Tensor, bk_tk: torch.Tensor,
                      testv: torch.Tensor, p: Params,
                      form=None) -> torch.Tensor:
    """Blind rotation lvl0 -> TRLWE lvl1 against a tkey slab of any layout
    (module docstring; crypto/polymul.tkey_kernel_key builds them, and
    k_contiguous places them for the kernel).

    tlwe0: i32 [G, n+1]; bk_tk: int8 slab; testv: i32 [N].  Returns i32
    [G, 2, N].  A CUDA input runs the Hopper kernel, in the form the route
    picks (route_form) unless `form` ("loop", "wgmma" or "mma") names one;
    a CPU input the plain twin; there is no fallback between them."""
    cfg, rows, acc = _prepare(tlwe0, bk_tk, testv, p)
    if acc.is_cuda:
        return _steps_kernel(rows, acc, bk_tk, p, cfg, form)
    if acc.device.type != "cpu":
        raise ValueError(f"unsupported device {acc.device}")
    return _steps_ref(rows, acc, bk_tk, p, cfg)
