"""Microbenchmark kernels (csrc/micro.cu): wrappers and plain twins.

Counterparts of the Pallas kernels of the JAX package's tools:

  tk_loop(x, rhs, steps, mode)      tools/tk_mm_bench.py kern_fat / kern_thin
                                    / kern_pure / kern_puret
  width_loop(x, rhs, steps, ndots)  tools/tk_width_bench.py main.make.kern
  mm_mask(a, b, mask, inner)        tools/microbench.py mm_int8_pallas_case
                                    (inner 1), pk_mm_case, and batched
                                    ([B, M, K] x [B, K, K]) pk_bdot_case
  smallk_loop(w, a, inner)          pk_smallk_case
  alu_loop(x, body, inner, *extra)  _pallas_loop_case with the bodies of
                                    pk_vpu, pk_f32, pk_barrett, pk_roll,
                                    pk_i16, pk_i32var, pk_conv, pk_select

Each takes the JAX kernel's inputs (u32 as int32 bit patterns) and returns
its output; tk_loop and width_loop also return `chk`, int32 [rows]: the sum
mod 2^32, over all steps and dots, of the product columns the tool never
reads (fat/thin: 256..767 of each dot; width: 128..NO-1; zeros for
pure/puret, which read every column).  The kernel computes those columns
anyway and sums them so that none of its products can be dropped; the twin
sums them too.

A CUDA tensor launches the kernel (built at first use by ops/nvcc.py), a
CPU tensor runs the plain twin (`*_ref`); there is no fallback between
them.  The twins take products in float64, exact here: a step's sum is
below 8 * 18432 * 128 * 128 < 2^32 (and 2^53), and each wrapping JAX op is
int64 arithmetic and a mask (the k18432 width case wraps int32 as JAX
does).  LAUNCHES counts kernel launches by `launch_key`.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from . import nvcc

SOURCE = "micro.cu"
LAUNCHES = collections.Counter()   # launch_key -> kernel launches
MODES = ("fat", "thin", "pure", "puret")
MASK32 = 0xFFFFFFFF

# microbench constants (the JAX tools' own)
BARRETT_P = 59393                  # PRIMES1[3] of iyokan_tpu/crypto/polymul
F32_MUL, F32_ADD, F32_MAX = np.float32(1.0001), np.float32(0.5), \
    np.float32(1e6)
ROLL_SHIFT = 128                   # the only shift roll_kernel is built for

# the elementwise kernels' unrolling (csrc/micro.cu): alu_kernel runs
# ALU_UNROLL rounds an iteration on 16 bytes of elements a thread;
# roll_kernel ROLL_PERIOD = 1024 / ROLL_SHIFT rounds (its renaming's
# period) on as many words a thread
ALU_UNROLL = 4
ROLL_PERIOD = 1024 // ROLL_SHIFT
# smallk_kernel packs SMALLK_GROUPS columns of a into a row of its mma.sync
# fragments (m16n8k16: twice the real MACs)
SMALLK_GROUPS = 2

# body -> (C id, dtype, the tool's ops per element and round, extras)
BODIES = {
    "vpu": (0, torch.int32, 11, 0),
    "f32": (1, torch.float32, 11, 0),
    "barrett": (2, torch.int32, 7, 0),
    "roll": (None, torch.int32, 5, 1),
    "i16": (3, torch.int16, 10, 0),
    "i32var": (4, torch.int32, 10, 1),
    "conv": (5, torch.int32, 6, 0),
    "select": (6, torch.int32, 10, 0),
}


def launch_key(fn: str, *shape) -> str:
    """LAUNCHES' key of a launch: the function and its variant (tk_loop:
    mode and BG; width_loop: K, NO, ndots; mm_mask: a's shape; alu_loop:
    the body)."""
    return " ".join([fn] + [str(s) for s in shape])


# --------------------------------------------------------------------------- #
# integer helpers of the twins
# --------------------------------------------------------------------------- #


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product as int64 (float64 products; module docstring)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def _wrap(v: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """int64 -> the signed value of its low `bits` bits (int64)."""
    h = 1 << (bits - 1)
    return ((v + h) & ((1 << bits) - 1)) - h


def _i8(v: torch.Tensor) -> torch.Tensor:
    """.astype(int8) of an integer: the low byte."""
    return _wrap(v, 8).to(torch.int8)


# --------------------------------------------------------------------------- #
# the looped products: configuration shared by the kernel, the twin and the
# L2 traffic figure
# --------------------------------------------------------------------------- #


def tk_config(x: torch.Tensor, rhs: torch.Tensor, mode: str) -> dict:
    """The kernel arguments of tk_loop's mode at x, rhs (the tool's shapes:
    fat/pure/puret x [BG, 12288], rhs [6144, 768] (puret [768, 6144]);
    thin x [BG, 6, 2048], rhs [1024, 768]); raises on any other shape."""
    BG = x.shape[0]
    want = {"fat": ((BG, 12288), (6144, 768)),
            "thin": ((BG, 6, 2048), (1024, 768)),
            "pure": ((BG, 12288), (6144, 768)),
            "puret": ((BG, 12288), (768, 6144))}
    if mode not in want:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if (tuple(x.shape), tuple(rhs.shape)) != want[mode]:
        raise ValueError(f"{mode}: x {tuple(x.shape)}, rhs {tuple(rhs.shape)}"
                         f"; need {want[mode]}")
    base = dict(rows=BG, batches=1, lstride=12288, NO=768, mask=0)
    if mode == "fat":       # 8 dots at windows 768 K
        return dict(base, mode=0, bt=0, seglen=6144, nwin=8, wstride=768,
                    nouter=1, ostride=0, doff=0, accw=0)
    if mode == "thin":      # 8 dots at windows 128 (K+1), a pass per j
        return dict(base, mode=0, bt=0, seglen=1024, nwin=8, wstride=128,
                    nouter=6, ostride=2048, doff=128, accw=0)
    return dict(base, mode=1, bt=int(mode == "puret"), seglen=6144, nwin=8,
                wstride=768, nouter=1, ostride=0, doff=0, accw=768)


def width_config(x: torch.Tensor, rhs: torch.Tensor, ndots: int) -> dict:
    """width_loop's kernel arguments: x [BG, K + 128 ndots], rhs [K, NO]."""
    K, NO = rhs.shape
    if x.dim() != 2 or x.shape[1] != K + 128 * ndots or NO < 128:
        raise ValueError(f"width: x {tuple(x.shape)} for rhs {tuple(rhs.shape)}"
                         f" and {ndots} dots; need [BG, K + 128 ndots], "
                         "NO >= 128")
    return dict(mode=1, bt=0, rows=x.shape[0], batches=1, lstride=x.shape[1],
                NO=NO, seglen=K, nwin=ndots, wstride=128, nouter=1,
                ostride=0, doff=0, accw=128, mask=0)


def mm_config(a: torch.Tensor, b: torch.Tensor, mask: int) -> dict:
    """mm_mask's kernel arguments: a [M, K] x b [K, K], or batched a
    [B, M, K] x b [B, K, K]."""
    batched = a.dim() == 3
    K = a.shape[-1]
    if (a.dim() not in (2, 3) or b.dim() != a.dim()
            or tuple(b.shape[-2:]) != (K, K)
            or (batched and b.shape[0] != a.shape[0])):
        raise ValueError(f"mm_mask: a {tuple(a.shape)}, b {tuple(b.shape)}; "
                         "need [(B,) M, K] x [(B,) K, K]")
    B = a.shape[0] if batched else 1
    return dict(mode=2, bt=0, rows=a.shape[-2], batches=B, lstride=K, NO=K,
                seglen=K, nwin=1, wstride=0, nouter=1, ostride=0, doff=0,
                accw=0, mask=mask)


SMS = 132         # the H100's SMs: a step's grid should cover them
BM = 128          # rows of a step tile (csrc/wgmma_s8.cuh)
BK = 128          # contraction bytes of a k-tile


def step_plan(cfg: dict) -> dict:
    """The step grid of the looped kernel (csrc/micro.cu mm_step_kernel):
    128-row tiles (TILE: of each window) x BN-column tiles x a split of the
    contraction, sized to give at least SMS CTAs.  TILE: BN = 128 (its w_d
    pairs columns c and c + 128 inside a tile), no split.  MM: the widest
    BN of 256, 128, 64, 32 dividing NO whose grid reaches SMS CTAs (else
    the narrowest), no split (neither epilogue is linear).  ACC: BN = 128
    and the smallest power-of-two split of its k-tiles that reaches SMS
    CTAs (the split sums meet by atomics).  Returns bn, m_tiles (every
    window's on TILE), n_tiles, split, k_tiles (a tile's whole sum) and
    ctas."""
    mode, NO, batches = cfg["mode"], cfg["NO"], cfg["batches"]
    if NO % 128 and not (mode == 2 and NO % 64 == 0):
        raise ValueError(f"NO={NO}: the step tiles need a multiple of 128 "
                         "(64 for mm_mask)")
    if cfg["seglen"] % BK:
        raise ValueError(f"seglen={cfg['seglen']}: need a multiple of {BK}")
    m = -(-cfg["rows"] // BM) * (cfg["nwin"] if mode == 0 else 1)
    k_tiles = ((cfg["nwin"] if mode == 1 else 1) * cfg["nouter"]
               * cfg["seglen"] // BK)
    if mode == 2:
        fits = [b for b in (256, 128, 64, 32) if NO % b == 0]
        bn = next((b for b in fits if m * NO // b * batches >= SMS),
                  fits[-1])
    else:
        bn = 128
    split = 1
    while (mode == 1 and m * NO // bn * batches * split < SMS
           and 2 * split <= k_tiles):
        split *= 2
    return dict(bn=bn, m_tiles=m, n_tiles=NO // bn, split=split,
                k_tiles=k_tiles, ctas=m * NO // bn * batches * split)


def l2_bytes_per_step(cfg: dict) -> int:
    """Bytes a step of the looped kernel brings from L2 into shared memory
    (step_plan's tiling): every CTA loads a 128-row A tile and a BN-row B
    tile of 128 bytes for each of its k-tiles."""
    pl = step_plan(cfg)
    return (pl["m_tiles"] * pl["n_tiles"] * cfg["batches"] * pl["k_tiles"]
            * (BM + pl["bn"]) * BK)


def _bind(lib):
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cf = ctypes.c_float
    lib.micro_mm_loop.restype = ci
    lib.micro_mm_loop.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                  ll, ll] + [ci] * 12 + [vp]
    lib.micro_smallk.restype = ci
    lib.micro_smallk.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.micro_alu.restype = ci
    lib.micro_alu.argtypes = [ci, vp, vp, vp, ll, ci, ci, ci, ci, ci, ci,
                              cf, cf, cf, cf, vp]
    lib.micro_roll.restype = ci
    lib.micro_roll.argtypes = [vp, vp, vp, ci, ci, ci, ctypes.c_uint, vp]
    lib.micro_error_string.restype = ctypes.c_char_p
    lib.micro_error_string.argtypes = [ci]


def _lib():
    return nvcc.load(SOURCE, _bind)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(rc: int, what: str, key: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_lib().micro_error_string(rc).decode()}")
    LAUNCHES[key] += 1


def _operands(*ts: torch.Tensor, dtype=torch.int8):
    """Checks the operands share a device and dtype; True for CUDA."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"device mismatch: {[str(u.device) for u in ts]}")
        if t.dtype != dtype:
            raise ValueError(f"need {dtype} operands, got {t.dtype}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _loop_kernel(cfg: dict, lhs, rhs, key: str):
    """Launch the looped product (cfg["steps"] step launches after one
    transpose of a row-major rhs): lhs is updated in place (ACC) or is the
    first of two buffers (TILE, MM; the result is in lhs2 after an odd
    number of steps).  Returns (lhs2, acc, chk)."""
    plan = step_plan(cfg)
    lib = _lib()
    dev = lhs.device
    lhs2 = lhs if cfg["mode"] == 1 else torch.empty_like(lhs)
    acc = torch.zeros((cfg["rows"], max(cfg["accw"], 1)), dtype=torch.int32,
                      device=dev)
    chk = torch.zeros((cfg["batches"], cfg["rows"]), dtype=torch.int32,
                      device=dev)
    rhs = rhs.contiguous()
    rhs_t = None if cfg["bt"] else torch.empty(
        (cfg["batches"] * cfg["NO"], cfg["seglen"]), dtype=torch.int8,
        device=dev)
    rc = lib.micro_mm_loop(
        cfg["mode"], cfg["bt"], lhs.data_ptr(), lhs2.data_ptr(),
        rhs.data_ptr(), None if rhs_t is None else rhs_t.data_ptr(),
        acc.data_ptr(), chk.data_ptr(), cfg["batches"],
        cfg["rows"], cfg["lstride"], cfg["rows"] * cfg["lstride"],
        rhs[0].numel() if cfg["batches"] > 1 else 0, cfg["NO"],
        cfg["seglen"], cfg["nwin"], cfg["wstride"], cfg["nouter"],
        cfg["ostride"], cfg["doff"], cfg["steps"], cfg["accw"], cfg["mask"],
        plan["bn"], plan["split"], _stream(lhs))
    _check(rc, "micro_mm_loop", key)
    return lhs2, acc, chk


# --------------------------------------------------------------------------- #
# T1: tk_mm_bench
# --------------------------------------------------------------------------- #


def tk_loop_ref(x, rhs, steps: int, mode: str):
    """The twin of tk_loop (kern_fat / kern_thin / kern_pure / kern_puret)."""
    tk_config(x, rhs, mode)
    BG = x.shape[0]
    chk = torch.zeros(BG, dtype=torch.int64, device=x.device)
    lhs = x.clone()
    if mode in ("fat", "thin"):
        for _ in range(steps):
            ws = []
            for K in range(8):
                if mode == "fat":
                    s = _mm(lhs[:, 768 * K: 768 * K + 6144], rhs)
                else:
                    w0 = 128 * (K + 1)
                    s = sum(_mm(lhs[:, j, w0: w0 + 1024], rhs)
                            for j in range(6))
                ws.append((s[:, :128] + s[:, 128:256]) & 31)
                chk += s[:, 256:].sum(1)
            upd = torch.cat(ws * (12 if mode == "fat" else 2), dim=1)
            if mode == "thin":
                upd = upd[:, None, :].expand(lhs.shape)
            lhs = upd.to(torch.int8).contiguous()
        return lhs, _wrap(chk).to(torch.int32)
    r = rhs.t() if mode == "puret" else rhs
    acc = torch.zeros((BG, 768), dtype=torch.int64, device=x.device)
    for _ in range(steps):
        s = sum(_mm(lhs[:, 768 * K: 768 * K + 6144], r) for K in range(8))
        acc = _wrap(acc + s)
        lhs[:, :128] = _i8(acc[:, :128])
    return acc.to(torch.int32), _wrap(chk).to(torch.int32)


def tk_loop(x: torch.Tensor, rhs: torch.Tensor, steps: int, mode: str):
    """STEPS steps of tk_mm_bench's kernel of `mode` -> (out, chk): fat and
    thin give the final int8 LHS (x's shape), pure and puret the int32
    accumulator [BG, 768]."""
    cfg = tk_config(x, rhs, mode)
    if not _operands(x, rhs):
        return tk_loop_ref(x, rhs, steps, mode)
    lhs = x.contiguous().clone()
    lhs2, acc, chk = _loop_kernel(dict(cfg, steps=steps), lhs, rhs,
                                  launch_key("tk_loop", mode, x.shape[0]))
    if cfg["mode"] == 1:
        return acc, chk[0]
    return (lhs2 if steps % 2 else lhs).reshape(x.shape), chk[0]


# --------------------------------------------------------------------------- #
# T2: tk_width_bench
# --------------------------------------------------------------------------- #


def width_loop_ref(x, rhs, steps: int, ndots: int):
    """The twin of tk_width_bench's kernel."""
    width_config(x, rhs, ndots)
    K = rhs.shape[0]
    lhs = x.clone()
    acc = torch.zeros((x.shape[0], 128), dtype=torch.int64, device=x.device)
    chk = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for _ in range(steps):
        s = sum(_mm(lhs[:, 128 * d: 128 * d + K], rhs) for d in range(ndots))
        acc = _wrap(acc + s[:, :128])
        chk += s[:, 128:].sum(1)
        lhs[:, :128] = _i8(acc)
    return acc.to(torch.int32), _wrap(chk).to(torch.int32)


def width_loop(x: torch.Tensor, rhs: torch.Tensor, steps: int, ndots: int):
    """STEPS steps of ndots dots [BG, K] x [K, NO] at LHS windows 128 d ->
    (acc int32 [BG, 128], chk)."""
    cfg = width_config(x, rhs, ndots)
    if not _operands(x, rhs):
        return width_loop_ref(x, rhs, steps, ndots)
    _, acc, chk = _loop_kernel(
        dict(cfg, steps=steps), x.contiguous().clone(), rhs,
        launch_key("width_loop", *rhs.shape, ndots))
    return acc, chk[0]


# --------------------------------------------------------------------------- #
# T3: microbench's matrix kernels
# --------------------------------------------------------------------------- #


def mm_mask_ref(a, b, mask: int, inner: int):
    """The twin of mm_mask."""
    mm_config(a, b, mask)
    for _ in range(inner):
        a = (_mm(a, b) & mask).to(torch.int8)
    return a


def mm_mask(a: torch.Tensor, b: torch.Tensor, mask: int, inner: int):
    """`inner` rounds of a <- (a @ b & mask) as int8 (mask < 128); a
    [M, K], b [K, K], or batched [B, M, K] x [B, K, K]."""
    cfg = mm_config(a, b, mask)
    if not 0 <= mask < 128:
        raise ValueError("mask must keep the result in int8: 0 <= mask < 128")
    if not _operands(a, b):
        return mm_mask_ref(a, b, mask, inner)
    lhs = a.contiguous().clone()
    lhs2, _, _ = _loop_kernel(dict(cfg, steps=inner), lhs, b,
                              launch_key("mm_mask", *a.shape))
    return lhs2 if inner % 2 else lhs


def smallk_loop_ref(w, a, inner: int, mask: int = 63):
    """The twin of smallk_loop."""
    shape = a.shape
    a = a.reshape(8, -1)
    for _ in range(inner):
        a = (_mm(w, a) & mask).to(torch.int8)
    return a.reshape(shape)


def smallk_loop(w: torch.Tensor, a: torch.Tensor, inner: int,
                mask: int = 63):
    """`inner` rounds of a <- (w @ a & mask) as int8: w [8, 8], a [8, ...]
    (pk_smallk: [8, Y/128, 128], taken as [8, Y])."""
    if tuple(w.shape) != (8, 8) or a.shape[0] != 8:
        raise ValueError(f"smallk: w {tuple(w.shape)}, a {tuple(a.shape)}; "
                         "need [8, 8] and [8, ...]")
    if not _operands(w, a):
        return smallk_loop_ref(w, a, inner, mask)
    a = a.contiguous()
    out = torch.empty_like(a)
    rc = _lib().micro_smallk(w.contiguous().data_ptr(), a.data_ptr(),
                             out.data_ptr(), a[0].numel(), inner, mask,
                             _stream(a))
    _check(rc, "micro_smallk", launch_key("smallk_loop"))
    return out


# --------------------------------------------------------------------------- #
# T3b: the elementwise loops
# --------------------------------------------------------------------------- #


def _f32_round_div(x: torch.Tensor) -> torch.Tensor:
    """jnp.round(x.astype(f32) * f32(1/p)).astype(i32), p = BARRETT_P."""
    inv = torch.tensor(np.float32(1.0 / BARRETT_P), device=x.device)
    return torch.round(x.to(torch.float32) * inv).to(torch.int64)


def _body_ref(body: str, x: torch.Tensor, extra) -> torch.Tensor:
    """One round of a microbench body in int64 / float64 arithmetic."""
    if body == "f32":
        for _ in range(5):      # fused multiply-add: one rounding to f32
            x = (x.to(torch.float64) * float(F32_MUL)
                 + float(F32_ADD)).to(torch.float32)
        return torch.minimum(x, torch.tensor(F32_MAX, device=x.device))
    if body in ("roll", "select"):
        v = x.to(torch.int64) & MASK32             # u32 values
    else:
        v = x.to(torch.int64)
    if body == "vpu":
        for _ in range(5):
            v = _wrap(v * 3 + 1)
        v = v & 0xFFFFF
    elif body == "barrett":
        v = _wrap(v - _f32_round_div(x) * BARRETT_P + (1 << 21))
    elif body == "roll":
        m = extra[0].to(torch.int64) & MASK32
        r = torch.roll(v, ROLL_SHIFT, dims=-1)
        t = (-2 * r) & MASK32          # m * t mod 2^32 in 16-bit halves
        mt = (m & 0xFFFF) * t + ((((m >> 16) * t) & 0xFFFF) << 16)
        r = (r + mt) & MASK32
        v = (r + 1) & MASK32
    elif body == "i16":
        for _ in range(5):
            v = _wrap(v * 12289 + 1, 16)
    elif body == "i32var":
        y = extra[0].to(torch.int64)
        for _ in range(5):
            v = _wrap(v * y + 1) & 0xFFFFF
    elif body == "conv":
        v = _wrap(v - _f32_round_div(x) + 7)
    elif body == "select":
        for _ in range(5):
            v = torch.where(v > 5, (v + 1) & MASK32, v)
    else:
        raise ValueError(f"unknown body {body!r}: {sorted(BODIES)}")
    return _wrap(v, 16 if body == "i16" else 32).to(x.dtype)


def alu_operands(body: str, device, rng=None, rows: int = 512) -> list:
    """[x, *extras] of microbench's pk_<body> case: x [rows, 8, 1024]
    (roll: [rows, 2, 1024] and a [1, 1, 1024] lane mask; i32var: y of x's
    shape).  rng None: the JAX tool's values (ones; 2^21 for barrett and
    conv; the mask of lanes below 128; y = 3); a numpy Generator: seeded
    random values over each type's range (a third of select's below 8, so
    both branches run)."""
    shape = (rows, 2 if body == "roll" else 8, 1024)
    dtype = BODIES[body][1]
    if rng is None:
        fill = (1 << 21) if body in ("barrett", "conv") else 1
        ins = [torch.full(shape, fill, dtype=dtype)]
        if body == "roll":
            ins.append((torch.arange(1024) < 128).to(torch.int32)
                       .reshape(1, 1, 1024))
        elif body == "i32var":
            ins.append(torch.full(shape, 3, dtype=torch.int32))
        return [t.to(device) for t in ins]
    if body == "f32":
        x = (rng.standard_normal(shape) * 4).astype(np.float32)
    elif body == "i16":
        x = rng.integers(-2**15, 2**15, shape, dtype=np.int16)
    else:
        x = rng.integers(-2**31, 2**31, shape, dtype=np.int32)
        if body == "select":
            x[..., ::3] = rng.integers(0, 8, x[..., ::3].shape)
    ins = [x]
    if body == "roll":
        ins.append(rng.integers(0, 2, (1, 1, 1024), dtype=np.int32))
    elif body == "i32var":
        ins.append(rng.integers(-2**31, 2**31, shape, dtype=np.int32))
    return [torch.from_numpy(a).to(device) for a in ins]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (the kernels' vector
    loads): t itself where it is, else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def alu_loop_ref(x, body: str, inner: int, *extra):
    """The twin of alu_loop."""
    for _ in range(inner):
        x = _body_ref(body, x, extra)
    return x


def alu_loop(x: torch.Tensor, body: str, inner: int, *extra):
    """`inner` rounds of a microbench body (BODIES) on x: vpu, barrett,
    i32var (extra y, x's shape), conv: int32; f32: float32; i16: int16;
    roll (extra mask [..., 1024] of 0/1, broadcast over rows) and select:
    u32 as int32 bit patterns; roll rolls the last axis of 1024."""
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}: {sorted(BODIES)}")
    bid, dtype, _, n_extra = BODIES[body]
    if len(extra) != n_extra:
        raise ValueError(f"{body} takes {n_extra} extra operand(s)")
    if not _operands(x, dtype=dtype):
        return alu_loop_ref(x, body, inner, *extra)
    lib = _lib()
    x = _aligned(x)
    out = torch.empty_like(x)
    if body == "roll":
        m = extra[0].reshape(-1)
        if x.shape[-1] != 1024 or m.numel() != 1024:
            raise ValueError("roll: rows of 1024 words and a [1024] mask")
        _operands(x, m, dtype=torch.int32)
        rc = lib.micro_roll(x.data_ptr(), m.contiguous().data_ptr(),
                            out.data_ptr(), x.numel() // 1024, inner,
                            ROLL_SHIFT, 1, _stream(x))
    else:
        per = 16 // x.element_size()
        if x.numel() % per:
            raise ValueError(f"{body}: the kernel takes 16 bytes a thread; "
                             f"{x.numel()} elements is not a multiple of "
                             f"{per}")
        y = None
        if body == "i32var":
            if extra[0].shape != x.shape:
                raise ValueError("i32var: y must have x's shape")
            _operands(x, extra[0], dtype=torch.int32)
            y = _aligned(extra[0])
        # integers: multiplier, addend, mask (select: the threshold),
        # prime, offset; floats: multiplier, addend, clamp, 1/p
        ints = {"vpu": (3, 1, 0xFFFFF, 0, 0), "barrett": (0, 0, 0, BARRETT_P,
                                                          1 << 21),
                "i16": (12289, 1, 0, 0, 0), "i32var": (0, 1, 0xFFFFF, 0, 0),
                "conv": (0, 0, 0, 0, 7), "select": (0, 1, 5, 0, 0),
                "f32": (0, 0, 0, 0, 0)}[body]
        rc = lib.micro_alu(bid, x.data_ptr(),
                           y.data_ptr() if y is not None else None,
                           out.data_ptr(), x.numel(), inner, *ints,
                           float(F32_MUL), float(F32_ADD), float(F32_MAX),
                           float(np.float32(1.0 / BARRETT_P)), _stream(x))
    _check(rc, "micro_alu", launch_key("alu_loop", body))
    return out
