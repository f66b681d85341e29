"""Stage microbenchmarks of the blind-rotation hot path, on the card.

    BENCH_G=1024 BENCH_ITERS=50 BENCH_INNER=200 \\
        python3 -m iyokan_tpu_torch.tools.microbench [case ...]  (default: all)

The port of tools/microbench.py: the same variables, case names and lines.
Every case is timed by the difference method, (t(4n) - t(n)) / 3n with CUDA
events after a warm-up (the minimum of 3 runs each), which removes launch
and transfer overheads without the JAX tool's fixed subtraction:

  kernel cases (ops/micro.py, csrc/micro.cu), n = BENCH_INNER rounds
  inside one launch, operands resident (registers, shared memory or L2):
    pk_vpu pk_f32 pk_barrett pk_roll pk_i16 pk_i32var pk_conv pk_select
        (alu_loop on [512, 8, 1024]; roll [512, 2, 1024] + a lane mask),
    pk_mm      mm_mask: a <- (a @ b & 127), [3072, 1024] x [1024, 1024],
    pk_smallk  smallk_loop: a <- (w @ a & 63), [8, 8] x [8, 3072*128],
    pk_bdot    batched mm_mask: a <- (a w & 63), [8, 768, 128] x [8, 128,
               128];
  mmp  one mm_mask launch [6G, 1024] x [1024, 1024] & 127, n = BENCH_ITERS
       launches chained;
  torch-op cases, n = BENCH_ITERS applications chained: mm (torch._int_mm,
    [6G, N] x [N, N]), vpu, barrett (center_reduce), rot (rot_poly), decomp
    (decompose1), tkey_step and tkey_step_rot (one Toeplitz-slab step as
    48 L torch._int_mm dots [G, 1024] x [1024, 128]), and
  step  the marginal blind-rotation step on the port's default route (the
        tkey kernel; rotations of 32 and 160 steps), h2d (256 MB to the
        card, host clock).

Not ported: fwd, pw, inv, crt (NOT_PORTED).  Runs on the card, or on the
CPU (the twins) under IYOKAN_TORCH_DEVICE=cpu.  Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from .. import params as params_mod
from ..crypto import host, ops
from ..ops import micro
from .timing import marginal, timed_ms

P = params_mod.CGGI128
PRIME = micro.BARRETT_P     # PRIMES1[3] of the JAX package's 4-prime NTT
i8, i32 = torch.int8, torch.int32

NOT_PORTED = {
    name: "times a stage of the JAX package's 4-prime MXU NTT (polymul."
          "fwd_digits, _inv_dispatch, crt_mod32, PRIMES1); the port's NTT "
          "kernels use two 31-bit primes inside csrc/ntt.cuh, with no host "
          "entry for a stage"
    for name in ("fwd", "pw", "inv", "crt")}


@dataclasses.dataclass
class Bench:
    G: int
    iters: int
    inner: int
    device: torch.device

    @classmethod
    def from_env(cls):
        return cls(int(os.environ.get("BENCH_G", "1024")),
                   int(os.environ.get("BENCH_ITERS", "50")),
                   int(os.environ.get("BENCH_INNER", "200")),
                   ops.default_device())

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()


def chained(op, x0):
    """run(n): n applications of op, each fed the previous output."""
    def run(n):
        x = x0
        for _ in range(n):
            x = op(x)
        return x
    return run


def report(name, dt):
    print(f"{name:34s} {dt * 1e6:10.1f} us/iter   "
          f"({dt * 1e3 * 635:8.1f} ms/635)", flush=True)
    return dt


def center_reduce(x: torch.Tensor, p: int) -> torch.Tensor:
    """iyokan_tpu/crypto/polymul.py:center_reduce: int32 (|x| < 2^31) ->
    the centred residue in (-p/2, p/2], f32 Barrett and one fix-up pair."""
    inv = torch.tensor(np.float32(1.0 / p), device=x.device)
    q = torch.round(x.to(torch.float32) * inv).to(i32)
    r = x - q * p
    r = r - p * (r > p // 2).to(i32)
    return r + p * (r < -(p // 2)).to(i32)


# --------------------------------------------------------------------------- #
# torch-op cases
# --------------------------------------------------------------------------- #


def mm_case(b: Bench):
    a = torch.ones((6 * b.G, P.N), dtype=i8, device=b.device)
    w = torch.ones((P.N, P.N), dtype=i8, device=b.device)
    dt = report("mm_int8 [6G,N]@[N,N]", marginal(chained(
        lambda x: (torch._int_mm(x, w) & 127).to(i8), a), b.iters, b.device))
    print(f"    -> {6 * b.G * P.N * P.N / dt / 1e12:.1f} TOPS")


def mmp_case(b: Bench):
    a = torch.ones((6 * b.G, P.N), dtype=i8, device=b.device)
    w = torch.ones((P.N, P.N), dtype=i8, device=b.device)
    dt = report("mm_int8 pallas", marginal(chained(
        lambda x: micro.mm_mask(x, w, 127, 1), a), b.iters, b.device))
    print(f"    -> {6 * b.G * P.N * P.N / dt / 1e12:.1f} TOPS")


def vpu_case(b: Bench):
    def op(x):
        for _ in range(5):
            x = x * 3 + 1
        return x & 0xFFFF
    x = torch.ones((b.G, 2, P.N), dtype=i32, device=b.device)
    dt = report("vpu 11 i32 ops [G,2,N]",
                marginal(chained(op, x), b.iters, b.device))
    print(f"    -> {11 * b.G * 2 * P.N / dt / 1e12:.2f} Tops/s")


def barrett_case(b: Bench):
    x = torch.full((b.G, 2, P.N), 12345, dtype=i32, device=b.device)
    dt = report("center_reduce [G,2,N]", marginal(chained(
        lambda x: center_reduce(x + 1, PRIME), x), b.iters, b.device))
    print(f"    -> {b.G * 2 * P.N / dt / 1e9:.1f} Gelem/s")


def rot_case(b: Bench):
    acc = torch.ones((b.G, 2, P.N), dtype=i32, device=b.device)
    r = torch.arange(b.G, device=b.device) % (2 * P.N)
    report("rot_poly [G,2,N]", marginal(chained(
        lambda a: ops.rot_poly(a, r[:, None], P.N) + 1, acc), b.iters,
        b.device))


def decomp_case(b: Bench):
    x = torch.ones((b.G, 2, P.N), dtype=i32, device=b.device)
    report("decompose1 [G,2,N]", marginal(chained(
        lambda x: x + ops.decompose1(x, P)[:, :2, :], x), b.iters, b.device))


def step_case(b: Bench):
    """Marginal cost of one CMUX step on the default route (tkey slab)."""
    sk = host.keygen(P, seed=0)
    ek = host.genevalkey(sk, seed=1, with_cb=False)
    keys = ops.DeviceKeys.from_evalkey(ek, b.device, with_cb=False)
    key = keys.bk_for(b.G)
    tlwe = torch.ones((b.G, P.n + 1), dtype=i32, device=b.device)
    testv = torch.full((P.N,), P.mu, dtype=i32, device=b.device)

    def run_n(nsteps):
        pp = dataclasses.replace(P, n=nsteps)
        tl = torch.cat([tlwe[:, :nsteps], tlwe[:, P.n:]], dim=1)
        fn = lambda: ops.blind_rotate(tl, key[:nsteps], testv, pp)  # noqa
        fn()
        b.sync()
        return timed_ms(fn, 1, b.device) / 1e3

    per = (run_n(160) - run_n(32)) / 128
    print(f"{'blind_rotate marginal step':34s} {per * 1e6:10.1f} us/step   "
          f"({per * 635 * 1e3:8.1f} ms/635)", flush=True)


def _tkey_op(b: Bench, L: int, r=None):
    """One Toeplitz-slab step in torch ops (the JAX tool's XLA form):
    decompose, digit extension, 48 L dots [G, 1024] x [1024, 128] against
    per-(j, u, limb) slabs, limb combine, accumulate; with r, the
    rotate-first difference X^r acc - acc is decomposed instead."""
    N = P.N
    slabs = torch.ones((6, 2, L, N, 128), dtype=i8, device=b.device)
    offset = sum((P.Bg // 2) << (32 - (j + 1) * P.Bgbit) for j in range(P.l))
    offset = ops.from_u64(torch.tensor(offset + (1 << (31 - P.l * P.Bgbit))))

    def op(acc):
        x = acc if r is None else ops.rot_poly(acc, r[:, None], N) - acc
        xp = x + offset.to(b.device)
        rows = [(((xp[:, part, :] >> (32 - (j + 1) * P.Bgbit)) & (P.Bg - 1))
                 - P.Bg // 2).to(i8)
                for part in range(2) for j in range(P.l)]
        d8 = torch.stack(rows, dim=1)
        ext = torch.cat([d8, -d8], dim=-1)                 # [G, 6, 2N]
        wins = [[ext[:, j, 128 * (K + 1): 128 * (K + 1) + N].contiguous()
                 for j in range(6)] for K in range(8)]
        outs = []
        for u in range(2):
            z = None
            for li in range(L):
                zl = torch.cat([sum(torch._int_mm(wins[K][j], slabs[j, u, li])
                                    for j in range(6)) for K in range(8)],
                               dim=-1)                     # [G, N]
                zl = zl << (8 * li)
                z = zl if z is None else z + zl
            outs.append(z)
        return acc + torch.stack(outs, dim=1)
    return op


def tkey_step_case(b: Bench):
    L = int(os.environ.get("BENCH_TKEY_L", "3"))
    acc = torch.ones((b.G, 2, P.N), dtype=i32, device=b.device)
    dt = report(f"tkey step L={L} BG={b.G}",
                marginal(chained(_tkey_op(b, L), acc), b.iters,
                         b.device))
    print(f"    -> {48 * L * b.G * P.N * 128 / dt / 1e12:.1f} TOPS   "
          f"(635 steps = {dt * 635 * 1e3:.1f} ms -> "
          f"{b.G / (dt * 635):.0f} gates/s)")


def tkey_step_rot_case(b: Bench):
    L = int(os.environ.get("BENCH_TKEY_L", "3"))
    acc = torch.ones((b.G, 2, P.N), dtype=i32, device=b.device)
    r = torch.arange(b.G, device=b.device) % (2 * P.N)
    dt = report(f"tkey step+rot L={L} BG={b.G}",
                marginal(chained(_tkey_op(b, L, r), acc), b.iters,
                         b.device))
    print(f"    -> 635 steps = {dt * 635 * 1e3:.1f} ms -> "
          f"{b.G / (dt * 635):.0f} gates/s")


def h2d_case(b: Bench):
    a = np.ones((256, 1024, 1024), np.int8)                # 256 MB
    t0 = time.time()
    torch.from_numpy(a).to(b.device)
    b.sync()
    dt = time.time() - t0
    print(f"{'h2d 256MB':34s} {dt * 1e3:10.1f} ms        "
          f"({0.25 / dt:.2f} GB/s; 2.9GB key ~ {2.9 / (0.25 / dt):.0f} s)")


# --------------------------------------------------------------------------- #
# kernel cases: n = BENCH_INNER rounds inside one launch
# --------------------------------------------------------------------------- #


PK_NAMES = {"vpu": "pk_vpu 11 i32 ops", "f32": "pk_f32 11 ops",
            "barrett": "pk_barrett(nofix)+add",
            "roll": "pk_roll+negmask+add", "i16": "pk_i16 10 mult/add",
            "i32var": "pk_i32 5 var-mult", "conv": "pk_conv f32Barrett-no-mult",
            "select": "pk_where 5 rounds"}


def pk_alu_case(body: str):
    def case(b: Bench):
        x, *extra = micro.alu_operands(body, b.device)
        dt = marginal(lambda n: micro.alu_loop(x, body, n, *extra),
                      b.inner, b.device)
        n = x.numel() * micro.BODIES[body][2]
        print(f"{PK_NAMES[body]:34s} {dt * 1e6:10.1f} us/inner   "
              f"{n / dt / 1e12:8.2f} Tops/s", flush=True)
    return case


def pk_mm_case(b: Bench):
    a = torch.ones((3072, 1024), dtype=i8, device=b.device)
    w = torch.ones((1024, 1024), dtype=i8, device=b.device)
    dt = marginal(lambda n: micro.mm_mask(a, w, 127, n), b.inner, b.device)
    print(f"{'pk_mm int8 [3072,1024]@[1024,1024]':34s} {dt * 1e6:10.1f} "
          f"us/inner   {3072 * 1024 * 1024 / dt / 1e12:8.1f} TOPS")


def pk_smallk_case(b: Bench):
    Y = 3072 * 128
    a = torch.ones((8, Y // 128, 128), dtype=i8, device=b.device)
    w = torch.ones((8, 8), dtype=i8, device=b.device)
    dt = marginal(lambda n: micro.smallk_loop(w, a, n), b.inner, b.device)
    print(f"{'pk_smallk [8,8]@[8,384K]':34s} {dt * 1e6:10.1f} us/inner"
          f"   {8 * 8 * Y / dt / 1e12:8.2f} TOPS (K=8)")


def pk_bdot_case(b: Bench):
    a = torch.ones((8, 768, 128), dtype=i8, device=b.device)
    w = torch.ones((8, 128, 128), dtype=i8, device=b.device)
    dt = marginal(lambda n: micro.mm_mask(a, w, 63, n), b.inner, b.device)
    print(f"{'pk_bdot [8,768,128]x[8,128,128]':34s} {dt * 1e6:10.1f} "
          f"us/inner   {8 * 768 * 128 * 128 / dt / 1e12:8.2f} TOPS (batched)")


CASES = {
    "mm": mm_case, "mmp": mmp_case, "vpu": vpu_case,
    "barrett": barrett_case, "rot": rot_case, "decomp": decomp_case,
    "step": step_case,
    **{f"pk_{body}": pk_alu_case(body) for body in micro.BODIES},
    "pk_mm": pk_mm_case, "pk_smallk": pk_smallk_case,
    "pk_bdot": pk_bdot_case,
    "tkey_step": tkey_step_case, "tkey_step_rot": tkey_step_rot_case,
    "h2d": h2d_case,
}


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else list(argv)) or list(CASES)
    for n in names:
        if n in NOT_PORTED:
            raise ValueError(f"{n}: not ported: {NOT_PORTED[n]}")
        if n not in CASES:
            raise ValueError(f"unknown case {n!r}: {sorted(CASES)}")
    b = Bench.from_env()
    print(f"# G={b.G} iters={b.iters} inner={b.inner} device={b.device}"
          + (f" ({torch.cuda.get_device_name(b.device)})"
             if b.device.type == "cuda" else ""), flush=True)
    for n in names:
        CASES[n](b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
