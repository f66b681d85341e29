"""Smoke run of the PyTorch/CUDA port (iyokan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Every phase but 14b runs the route it names, and the JAX package's default
(IYOKAN_BR_IMPL=tkey, set at the start unless given) where it names none;
phase 14b runs the port's own defaults.

Phases, one line each or more:
  1. device     -- nvidia-smi name + power limit, torch.cuda device name;
  2. build      -- the six kernel sources, csrc/tkey_blind_rotate.cu,
                   extprod1_ntt.cu, br_ntt.cu, br3_ntt.cu, br2_ntt.cu and
                   micro.cu (the first and last include csrc/wgmma_s8.cuh,
                   the NTT ones csrc/ntt.cuh, K3-K7 through
                   csrc/br_cluster.cuh), one nvcc each, started together
                   (sm_90a), with ptxas's register lines; the cluster shape
                   of K3, K4 (and K5, K4's kernel one step a launch), K6 at
                   2l and 3*2l rows and K7 at M = 1, 3 and each rows a
                   cluster up to R_MAX (4 CTAs a cluster: prime x part)
                   with each one's
                   shared memory a CTA and the clusters the card holds at
                   once (cudaOccupancyMaxActiveClusters); K1's persistent
                   form's plan as the launcher reports it (column tile,
                   clusters, CTAs a cluster, threads and shared memory a
                   CTA, slab ring slots, clusters the card holds at once)
                   at L = 3, lb = 2 and L = 4, lb = 3; then the SASS
                   opcode mix (cuobjdump -sass) of every int8 product
                   kernel: tkey_loop_kernel, conv_wgmma_kernel, conv_kernel
                   and mm_step_kernel, raising where a wgmma form has no
                   warpgroup MMA (GMMA) instruction (a build that lost
                   sm_90a);
  3. kernel     -- blind_rotate_tkey against its plain torch twin on the card
                   at cggi128 with the real [635, 5120, 768] slab, stored
                   K-contiguous, G = 1, 5, 16, 32 (the persistent form), 64
                   (mma.sync) and 2048 (wgmma), each in the form the route
                   gives it: bit-identical, kernel ms vs twin ms;
                   then the three forms (persistent, wgmma, mma.sync) at
                   G = 1, 5, 16, 32, 64, 128, 144, 192, 256 and 512 (around
                   the route threshold ops/tkey.py LOOP_MAX_G), each == the
                   twin, and the persistent form's step ablation
                   (tools/br_variants.py on tools/k1_loop_ablation.json:
                   the grid barrier, the digits, the A gather, the cluster
                   barriers, the product, the reduction and the slab reads
                   removed one after another) and its clock profile
                   (tools/k1_loop_profile.json: each phase's cycles a
                   step) at G = 16 and 32 on a random fat slab;
  4. gates      -- 2048 NAND gate bootstraps (linear combination, bootstrap,
                   key switch), 0 wrong after decryption, gate bootstraps/s,
                   one wgmma-form launch; K1's ms at G=2048 and the rate
                   beside the card's nvidia-smi name and power limit;
  5. ntt-gates  -- 256 NANDs through the NTT blind-rotation route
                   (IYOKAN_EP=pallas, IYOKAN_BR_IMPL=ntt: 635 extprod1_ntt
                   launches), 0 wrong, ms per batch beside the tkey route's;
  6. tk-layouts -- K2's other slab layouts, one slab at a time on phase 3's
                   eval key, each built by DeviceKeys.from_evalkey under the
                   JAX package's knobs: thin (IYOKAN_TK_LAYOUT=thin), fat2
                   (=fat2), the 2-bit-unrolled main slab (IYOKAN_TK_UNROLL=1)
                   and the fat slab at L=4, lb=3 (IYOKAN_TKEY_LIMBS=4
                   IYOKAN_TK_LB=3): the kernel == its twin (max |diff| 0) at
                   G = 1, 5 (the persistent form; fat2 and unrolled:
                   mma.sync), 64
                   (mma.sync), 2048 (wgmma; and 256 unrolled), kernel ms
                   vs twin ms, one launch of the route's form each;
                   then 2048 NANDs through bk_for on that slab (one launch
                   under its layout), 0 wrong, max phase error, gate
                   bootstraps/s beside phase 4's;
  7. slice      -- MAC-16 (tests/data/mac16.toml) at cggi128 through the CLIs
                   in-process: genkey, genevalkey, toml2packet, enc,
                   iyokan tfhe -c 3, dec, packet2toml; the result equals the
                   plain-mode run and the integer arithmetic, and the tkey
                   kernel's launch count (fat layout) grew during the
                   encrypted run;
  8. tk-slice   -- the same run with IYOKAN_TK_SMALL=1: every level has at
                   most 256 rows, so every rotation takes the unrolled
                   small-batch slab (only unrolled-layout launches); the
                   result equals plain mode and the integers, s/cycle beside
                   phase 7's;
  9. extprod    -- extprod1_ntt against its plain twin on the card at cggi128,
                   on TRGSWs made by the port's circuit bootstrapping (its
                   time is printed): RR = 2l (one TRGSW) and 3*2l (three,
                   the unrolled route's), G = 1, 8, 63, 64, 1024, 2048 and
                   the thread-plan switch of each RR, K = 1 and K = 2 with
                   mixed indices on the host, max |diff| 0, the grid as
                   launched (G clusters of 4), ms a call (CUDA events) and
                   on the device (torch.profiler: at small G the call is
                   the host's) vs twin ms;
  9b. br2       -- K7 (csrc/br2_ntt.cu, ops/br2.py: circuit bootstrapping's
                   lvl2 blind rotation, one launch) against its plain twin
                   blind_rotate2_ref at cggi128 on the memmac key's CB key,
                   unrolled (M = 3, 318 steps) and plain
                   (IYOKAN_NO_UNROLL=1: M = 1, 635 steps), built by
                   DeviceKeys with its kernel form (build time printed), at
                   G = 1, 3, 24, 69 (memmac's 23 bits x l) and the rows
                   plan's thresholds at C clusters at once (C, C + 1,
                   2C + 1, 3C, 3C + 1), inputs from blind_rotate2's set-up
                   on encrypted bits: max |diff| 0, the grid as launched
                   (== ops/br2.py:rows_per_cluster's plan), rows a cluster,
                   shared memory a CTA and waves, kernel ms (CUDA events),
                   device ms (torch.profiler), twin ms, bound ms; then K7's
                   variants at G = 3, 24, 69 on random keys, built in one
                   parallel round (tools/br_variants.py run_specs): 512
                   threads a CTA (tools/k7_threads.json), R_MAX = 1
                   (k7_rows.json) and a step's phases removed one after
                   another (k7_ablation.json), the sources as they are
                   held to the twin;
 10. memory     -- tests/data/memmac.toml (MAC-4 between a 128 x 32 CMUX ROM
                   and two 256 x 8 CMUX RAMs) at cggi128 through the CLIs
                   in-process: genkey, genevalkey (with circuit-bootstrapping
                   keys), toml2packet, enc, iyokan tfhe -c 3, dec; cycle 0
                   writes both RAMs and cycle 2 reads them back; the
                   decrypted @acc / @rdataA / @rdataB and both RAM images
                   equal the plain-mode run and the Python-integer model
                   (tests/data/gen_mac.py); both kernels' launch counts grew
                   during the encrypted run (tkey, extprod1_ntt and K7);
                   s/cycle;
 11. br-kernels -- the NTT blind-rotation kernels against their plain twins
                   at cggi128 on the CRT64 keys of phase 3's eval key (the
                   time to build their K3/K4 kernel form, ops/br.py:
                   kernel_key, is printed): K5 (br_ntt_step: n launches a
                   rotation from one host call, each G clusters of 4 CTAs),
                   K4 (br_ntt_loop), K3 (br3_ntt) at M = 1 on the
                   plain key and M = 3 on the 2-bit-unrolled key (one launch
                   each, G clusters of 4 CTAs as the launcher reports it),
                   max |diff| 0 and kernel ms vs twin ms at G = 1, 64, 256
                   and 2048 (the br-gates phase's batch) and at each
                   thread-plan switch (the most clusters of 512-thread
                   CTAs the card holds, and one more: ops/br.py:
                   threads_for); the exact unrolled route
                   (one extprod1_ntt launch at 3*2l rows per key-bit pair,
                   318 in all) at G = 64 against its twin; and K5's
                   per-launch split at G = 1, 64, 2048 (tools/br_variants.py
                   on tools/k5_launch_ablation.json: programmatic dependent
                   launch, the twiddle loads, the accumulator in and out
                   removed one after another, K4 beside them: what is left
                   over K4 is the launches' ramp and drain);
 12. br-gates   -- 2048 NANDs through the pallas (K5), pallas2 (K4) and v3
                   (K3, M = 1) routes of DeviceKeys.bk_for, each kernel's
                   launches counted from 0 over the run (each launch 2048
                   clusters of 4), 0 wrong, the max
                   phase error of the 2048 outputs in units of 1/16 of the
                   torus, ms per batch and gate_bootstraps_per_sec beside
                   the tkey route's;
 13. br-slice   -- phase 7's MAC-16 run again with IYOKAN_BR_IMPL=v3 (every
                   level takes the unrolled key: K3 at M = 3); the result
                   equals plain mode and the integers, and K3's launch count
                   grew from 0 during the encrypted run, its last launch a
                   grid of clusters of 4;
 14. fusion     -- the engine's execution modes as CUDA graphs: first
                   DeviceKeys.from_evalkey twice on an empty slab disk cache
                   (IYOKAN_SLAB_CACHE; the in-process cache cleared before
                   each): build + write, then read, the read slab == the
                   built one, both times; then MAC-16 x 3 cycles on the
                   tkey route (K1's persistent form), on v3 (K3) and on
                   pallas (K5, IYOKAN_UNROLL_MAX=0) under
                   IYOKAN_FUSE_LEVELS=1 and 8, and memmac x 3 cycles
                   under 1 and 8 at IYOKAN_RAM_REFRESH_PERIOD=2 (at 8 the
                   memory level and each refresh flag's RAM write a graph
                   from its second use: CB on K7, K6, the ROM/RAM trees,
                   both refresh graphs, K1's wgmma form), through the
                   Frontend:
                   each fused result packet (RAM images included) == the
                   route's FUSE=1 packet byte for byte, decrypted == plain
                   == the integers; every graph captured at its second
                   use and replayed at each later one (check_replays), the
                   route's kernels launched by the replays; s/cycle beside
                   FUSE=1's, graphs captured and replayed, the wrapper
                   launches and nodes each holds (cuGraphGetNodes), capture
                   and instantiation seconds, the graph pool's bytes; then
                   CB of memmac's 23 address bits eagerly and as one graph
                   holding one K7 launch, its TRGSWs == the eager twin's
                   (blind_rotate2_ref in K7's place).  Phases
                   7, 8, 10 and 13 pin IYOKAN_FUSE_LEVELS=1 (level by
                   level), so their numbers stay comparable with earlier
                   runs;
 14b. default   -- MAC-16 x 3 cycles and memmac x 16 cycles through the
                   Frontend at the port's own defaults: none of PREP_KNOBS
                   set (crypto/ops.py: K3 at M = 3 on the unrolled key for
                   every gate rotation, no slab), IYOKAN_FUSE_LEVELS and
                   IYOKAN_RAM_REFRESH_PERIOD unset
                   (groups of 8 levels as graphs; memmac's cycle 15
                   refreshes all 4096 RAM bits in 2048-row rotations);
                   decrypted == plain == integers, RAM images included;
                   K3's launches (eager and by the graphs' replays) counted
                   from 0 over each run, no K1, K4 or K5 launch; the
                   engine's route_counts (rows and rotations a cycle by
                   stage and route) printed, every one v3-unrolled;
                   every graph replayed as in phase 14 (memmac: the
                   full refresh write, the reset's, captured at its
                   second use, cycle 15);
 15. mesh       -- the gate-batch mesh (iyokan_tpu_torch/parallel) on the one
                   card: 2048 NANDs at cggi128 under make_mesh(4) == the unsharded
                   batch byte for byte, 0 wrong, K1 launched 4 times
                   (counters) on 512 rows each, gate bootstraps/s both
                   ways, K1 at 512 rows == its twin; MAC-16 (tkey) and
                   memmac x 3 cycles under make_mesh(2) at
                   IYOKAN_FUSE_LEVELS=8: each packet
                   == phase 14's FUSE=1 packet byte for byte, memmac's
                   4096-row RAM refresh split, s/cycle and graph nodes
                   beside phase 14's; then the error-rate tool
                   (tools/measure_error_rate.py) at its defaults on the
                   tkey route: 0 wrong, sigma and margin;
 16. micro      -- the microbenchmark tools T1-T3 (csrc/micro.cu): the SASS
                   opcodes of each elementwise and small-K inner loop; the
                   tools' entry points as a user runs them (tk_mm_bench at
                   BG 512 and 2048 x STEPS 100, tk_width_bench's six cases at
                   BG 512, microbench's mmp and pk_* cases at G 1024, INNER
                   200), every micro kernel launched from 0 there; then each
                   kernel == its twin (max |diff| 0) at those shapes on seeded
                   random and the tools' all-ones inputs, us per step (or
                   inner round, by the tools' difference method), TOP/s,
                   share of the bound, the L2 bytes a step computed from
                   the tiling (printed only: not a measurement), each
                   elementwise loop's IMAD or FFMA rate as issued in its
                   SASS, torch._int_mm on the same per-step product where
                   it takes the shape.
The line before the last is the kernels' JSON record (each kernel's launches
on its path, max |diff| against its twin, ms, twin ms, the bound of the
same work on the card and what sets it; K1's wgmma form, its persistent
and mma.sync forms (small batches, launched by the memory run) and one
record per K2 layout; K3 at the batch its
MAC-16 path runs, G = 64, and at G = 256; K6 at 2l rows (memmac's path)
and at 3*2l rows (the ntt-unrolled route's, G = 64); K7 on the unrolled
key at memmac's 69 rows, launched by the memory phase's run, with its rows
a cluster and shared memory a CTA; no PyTorch
call computes a blind rotation or an external product,
so their library_ms is null; the micro records time torch._int_mm on the
same per-step product where it takes it, per step or round like their
ms; K1 also at a mesh shard's 512 rows, launched 4 times by the
mesh phase), the script's total seconds on a line before them, the last
line the device record.  Any failure raises (non-zero exit, no result line).  Needs
no JAX: the expected values come from the port's plain engine and Python
integers.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

sys.path.insert(0, os.path.join(ROOT, "tests", "data"))

import gen_mac  # noqa: E402
from iyokan_tpu_torch import gates, params  # noqa: E402
from iyokan_tpu_torch import packet as packet_mod  # noqa: E402
from iyokan_tpu_torch.circuit import compile as compile_mod  # noqa: E402
from iyokan_tpu_torch.circuit.blueprint import Blueprint  # noqa: E402
from iyokan_tpu_torch.cli import iyokan_cli, packet_cli  # noqa: E402
from iyokan_tpu_torch.crypto import host, ops  # noqa: E402
from iyokan_tpu_torch.engine.driver import build_design  # noqa: E402
from iyokan_tpu_torch.ops import br, br2, br3, extprod, micro, nvcc  # noqa
from iyokan_tpu_torch.ops import tkey  # noqa: E402
from iyokan_tpu_torch.tools import br_variants, microbench, timing  # noqa
from iyokan_tpu_torch.tools import tk_mm_bench, tk_width_bench  # noqa: E402

WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 20261016
MEM_CYCLES = 3
SLICE_CYCLES = 3
BR_SIZES = (1, 64, 256, 2048)

# The card's peaks for the bounds (H100 SXM, NVIDIA's data sheet at the
# 700 W limit): int8 tensor-core operations, device-memory bytes, and 32-bit
# integer multiplies (64 INT32 lanes a SM a clock x 132 SMs x the 1.98 GHz
# boost clock).  A mulmod of two residues needs at least two of the latter
# (both halves of the 64-bit product), so the NTT kernels' bound counts
# 2 multiplies a mulmod and none for the reduction: a lower bound.
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 132 * 64 * 1.98e9
# the microbenchmarks' elementwise bodies: FP32 lanes (the data sheet's
# 67 TFLOP/s, an FMA counted as 2 operations) and INT32 lanes at the rate
# above, an IMAD counted as 2 operations as the tools count a multiply-add
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 2 * INT32_MULS_PER_S


def bound(n_ops, ops_per_s, nbytes):
    """(bound ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = n_ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ntt_mulmods(p, rr, m=0):
    """Mulmods a row of an NTT kernel costs: per prime, the forward NTTs of
    rr digit rows and the inverse NTTs of the 2 sums (N/2 log2 N butterflies
    each), 2*rr*N pointwise products (m > 0: m*(2*rr + 2)*N products with
    the K3 twiddles instead) and 2N scalings; then 2N Garner products.  One
    extprod1_ntt row, one K5/K4 step (rr = 2l, m = 0), one K3 step (m = M)."""
    t = p.N // 2 * p.logN
    point = m * (2 * rr + 2) * p.N if m else 2 * rr * p.N
    return 2 * ((rr + 2) * t + point + 2 * p.N) + 2 * p.N


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps runs (after one warm-up)."""
    fn()
    return timing.timed_ms(fn, reps, "cuda")


def device_ms(fn, name, reps=20):
    """Mean device ms of the kernels whose name holds `name` per fn() call,
    from torch.profiler's CUDA records over reps calls (after a warm-up),
    or None where the profiler kept no such record.  Where fn() is
    host-bound, CUDA events around the calls time the host, this the
    kernel."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # the profiler may drop a window's kernel records
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0)
                 for e in prof.key_averages() if name in e.key)
        if us:
            return us / 1e3 / reps
    return None


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    say("device", f"nvidia-smi: {smi} | torch: {name} | cards: "
        f"{torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return smi, name


def phase_build(p):
    """Builds every kernel library and prints what ptxas and the cluster
    queries report; returns each cluster kernel's narrow cap (clusters of
    512-thread CTAs the card holds at once: ops/br.py:threads_for)."""
    sources = (tkey.SOURCE, extprod.SOURCE, br.SOURCE, br3.SOURCE,
               br2.SOURCE, micro.SOURCE)
    t0 = time.time()
    paths = nvcc.build(*sources)
    dt = time.time() - t0
    for src, path in zip(sources, paths):
        regs = [ln.split(":", 1)[1].strip()
                for ln in nvcc.LOGS.get(src, "").splitlines()
                if "Used" in ln and "registers" in ln]
        say("build", f"{os.path.relpath(path, ROOT)} (all {len(sources)} "
            f"nvcc in parallel: {dt:.2f} s); ptxas per kernel: {regs}")
    caps = {}
    for nt in (br.WIDE_THREADS, br.NARROW_THREADS):
        plans = {"K4/K5": br.cluster_plan(p, nt),
                 **{f"K3 M={m}": br3.cluster_plan(p, m, nt) for m in (1, 3)},
                 **{f"K6 RR={rr}": extprod.cluster_plan(p, rr, nt)
                    for rr in (2 * p.l, 6 * p.l)}}
        caps[nt] = plans
        say("build", f"clusters of {br.CLUSTER} CTAs (prime x part) of {nt} "
            "threads: " + "; ".join(f"{k} {v[0]} B a CTA, {v[1]} clusters "
                                    "at once" for k, v in plans.items()))
    k7 = {m: br2.cluster_plan(p, m) for m in (1, 3)}
    say("build", f"K7 (br2_ntt, N2 = {p.N2}): clusters of {br.CLUSTER} CTAs "
        f"(prime x part) of {br2.THREADS} threads, up to R_MAX = "
        f"{k7[3][3]} rows a cluster: " + "; ".join(
            f"M={m} R={r}: {v[0]} B a CTA, {v[1]} clusters at once"
            for m in (1, 3) for r in range(1, k7[m][3] + 1)
            for v in [br2.cluster_plan(p, m, rows=r)]))
    for L, lb in ((3, 2), (4, 3)):
        pl = tkey.card_loop_plan(p, L, lb)
        say("build", f"K1's persistent form (tkey_loop_kernel) at L={L} "
            f"lb={lb}: {pl['clusters']} clusters of {pl['cluster_ctas']} "
            f"CTAs ({pl['clusters'] * pl['cluster_ctas']} CTAs, one an SM), "
            f"column tiles of {pl['cw']} coefficients x {L} limbs, "
            f"{pl['threads']} threads and {pl['smem_bytes']} B of shared "
            f"memory a CTA, {pl['slab_slots']} slab ring slots; the card "
            f"holds {pl['clusters_held']} such clusters at once")
    for k in caps[br.NARROW_THREADS]:
        cap = caps[br.NARROW_THREADS][k][1]
        say("build", f"{k} plan (one cluster a row, ops/br.py:threads_for): "
            + ", ".join(f"G={G}: {G} clusters of {br.CLUSTER} x "
                        f"{br.threads_for(G, cap)} threads"
                        for G in sorted(set(BR_SIZES) | {cap, cap + 1})))
    for src in (tkey.SOURCE, micro.SOURCE):
        for label, mix in sass_products(nvcc.lib_path(src)).items():
            say("build", f"SASS of {src} {label}: {sum(mix.values())} "
                f"instructions, "
                f"{sum(v for k, v in mix.items() if 'GMMA' in k)} GMMA, "
                f"{mix.get('IMMA', 0)} IMMA; top opcodes "
                f"{json.dumps(dict(list(mix.items())[:12]))}")
    return {**{k: v[1] for k, v in caps[br.NARROW_THREADS].items()},
            **{f"K7 M={m}": k7[m][1] for m in (1, 3)}}


@contextlib.contextmanager
def knobs(**env):
    """The JAX package's IYOKAN_* knobs, set (None: unset) for a block."""
    saved = {k: os.environ.get(k) for k in env}

    def put(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    put(env)
    try:
        yield
    finally:
        put(saved)


def ntt_route():
    """DeviceKeys on the NTT route (the JAX package's knobs): the gate key
    is the CRT64-prepared bk instead of the 2.5 GB tkey slab."""
    return knobs(IYOKAN_EP="pallas", IYOKAN_BR_IMPL="ntt")


def phase_kernel(p, sk, dk, rng):
    """Kernel vs twin, bit for bit, at the real slab."""
    testv = torch.full((p.N,), p.mu, dtype=torch.int32, device="cuda")
    rows, worst = [], 0
    for G in (1, 5, 16, 32, 64, 2048):
        bits = rng.integers(0, 2, G, dtype=np.uint8)
        ct = ops.u32_tensor(host.encrypt_bits(sk, bits, rng), "cuda")
        got = tkey.blind_rotate_tkey(ct, dk.bk_tk, testv, p)
        want = tkey.blind_rotate_tkey_ref(ct, dk.bk_tk, testv, p)
        torch.cuda.synchronize()
        err = int((ops.to_u64(got) - ops.to_u64(want)).abs().max())
        worst = max(worst, err)
        if err:
            raise AssertionError(f"kernel != twin at G={G}: max |diff| {err}")
        k_ms = cuda_ms(lambda: tkey.blind_rotate_tkey(ct, dk.bk_tk, testv, p),
                       3)
        t_ms = cuda_ms(
            lambda: tkey.blind_rotate_tkey_ref(ct, dk.bk_tk, testv, p), 1)
        form = form_of(G)
        rows.append({"G": G, "form": form, "kernel_ms": k_ms,
                     "twin_ms": t_ms})
        say("kernel", f"G={G}: bit-identical to twin; {form} form {k_ms:.3f}"
            f" ms, twin {t_ms:.3f} ms per blind rotation")
    return rows, worst


def form_of(G, layout="fat"):
    """The form the route gives G gates on a slab of `layout`."""
    return tkey.route_form(layout, -(-G // tkey.BLOCK_G) * tkey.BLOCK_G)


FORM_SIZES = (1, 5, 16, 32, 64, 128, 144, 192, 256, 512)
K1_ABLATION = os.path.join(ROOT, "iyokan_tpu_torch", "tools",
                           "k1_loop_ablation.json")
K1_PROFILE = os.path.join(ROOT, "iyokan_tpu_torch", "tools",
                          "k1_loop_profile.json")
K1_ABLATION_SIZES = (16, 32)


def phase_forms(p, sk, dk, rng, smi):
    """The three forms of K1 on the fat slab at the batches around the
    route threshold: each == the twin, bit for bit, and timed; then the
    persistent form's step ablation (one parallel build of its variants)
    on a random fat slab."""
    testv = torch.full((p.N,), p.mu, dtype=torch.int32, device="cuda")
    rows, worst = [], 0
    for G in FORM_SIZES:
        bits = rng.integers(0, 2, G, dtype=np.uint8)
        ct = ops.u32_tensor(host.encrypt_bits(sk, bits, rng), "cuda")
        want, t_ms = timed(
            lambda: tkey.blind_rotate_tkey_ref(ct, dk.bk_tk, testv, p))
        rec = {"G": G, "picked": form_of(G), "twin_ms": t_ms}
        for form in tkey.FORM_LAUNCHES:
            err = max_diff(tkey.blind_rotate_tkey(ct, dk.bk_tk, testv, p,
                                                  form=form), want)
            worst = max(worst, err)
            if err:
                raise AssertionError(f"{form} form != twin at G={G}: max "
                                     f"|diff| {err}")
            if form == "loop":
                rec["plan"] = dict(tkey.LAST_LOOP)
            rec[f"{form}_ms"] = cuda_ms(lambda: tkey.blind_rotate_tkey(
                ct, dk.bk_tk, testv, p, form=form), 3)
        rows.append(rec)
        say("forms", f"G={G}: the three forms == twin; persistent "
            f"{rec['loop_ms']:.3f} ms, wgmma {rec['wgmma_ms']:.3f} ms, "
            f"mma.sync {rec['mma_ms']:.3f} ms per blind rotation "
            f"(LOOP_MAX_G {tkey.LOOP_MAX_G} picks {rec['picked']}; "
            f"persistent plan {rec['plan']}) on {smi}")
    t0 = time.time()
    # the ablation and the clock profile (its variant prints the cycles a
    # step of each phase, CTAs 0 and 13, at the end of each launch)
    ablation = br_variants.run_specs(
        {"k1": br_variants.load_spec(K1_ABLATION),
         "k1prof": br_variants.load_spec(K1_PROFILE)}, K1_ABLATION_SIZES,
        ["tkey_loop fat"])
    for r in ablation:
        say("forms", f"K1 persistent form {r['spec']} "
            f"({os.path.relpath(K1_ABLATION, ROOT)}, "
            f"{os.path.relpath(K1_PROFILE, ROOT)}): {r['variant']} "
            f"{r['kernel']} G={r['G']}: {r['ms']:.3f} ms")
    say("forms", f"ablation (build + run) {time.time() - t0:.1f} s; {smi}")
    return rows, worst, ablation


def phase_gates(p, sk, dk, rng, smi):
    """2048 NANDs: linear combination -> bootstrap -> key switch."""
    G = 2048
    a = rng.integers(0, 2, G, dtype=np.uint8)
    b = rng.integers(0, 2, G, dtype=np.uint8)
    A = ops.u32_tensor(host.encrypt_bits(sk, a, rng), "cuda")
    B = ops.u32_tensor(host.encrypt_bits(sk, b, rng), "cuda")
    ca, cb, kk = (torch.full((G,), c, dtype=torch.int32, device="cuda")
                  for c in gates.GATE_LIN[gates.NAND])

    def nand():
        pre = ops.gate_linear(A, B, ca, cb, kk, p)
        lvl1 = ops.gate_bootstrap_tlwe1(pre, dk.bk_tk, p)
        return ops.keyswitch_10(lvl1, dk.ksk_f64, p)

    reset_launches()
    out = host.decrypt_bits(sk, ops.u32_numpy(nand()))
    launches = tkey.FORM_LAUNCHES["wgmma"]
    if launches != 1 or all_launches() != 1:
        raise AssertionError(f"2048 NANDs: {launches} wgmma-form launches, "
                             f"{all_launches()} in all")
    wrong = int((out != (1 - (a & b))).sum())
    if wrong:
        raise AssertionError(f"{wrong}/{G} wrong NANDs")
    ms = cuda_ms(nand, 3)
    rate = G / (ms / 1e3)
    say("gates", f"{G} NANDs, 0 wrong, 1 wgmma-form launch; {ms:.1f} ms per"
        f" batch (3 reps) -> gate_bootstraps_per_sec={rate:.1f} on {smi}")
    return rate, ms, launches


def phase_ntt_gates(p, sk, ek, dk, rng, smi):
    """256 NANDs through the NTT blind-rotation route (one extprod1_ntt
    launch per CMUX step) and through the tkey route, same inputs."""
    G = 256
    a = rng.integers(0, 2, G, dtype=np.uint8)
    b = rng.integers(0, 2, G, dtype=np.uint8)
    A = ops.u32_tensor(host.encrypt_bits(sk, a, rng), "cuda")
    B = ops.u32_tensor(host.encrypt_bits(sk, b, rng), "cuda")
    ca, cb, kk = (torch.full((G,), c, dtype=torch.int32, device="cuda")
                  for c in gates.GATE_LIN[gates.NAND])
    pre = ops.gate_linear(A, B, ca, cb, kk, p)
    with ntt_route():
        nk = ops.DeviceKeys.from_evalkey(ek, "cuda", with_cb=False)
    if nk.bk_tk is not None or nk.bk_ntt is None:
        raise AssertionError("the NTT route did not build the NTT key")

    def nand(bk):
        lvl1 = ops.gate_bootstrap_tlwe1(pre, bk, p)
        return ops.keyswitch_10(lvl1, dk.ksk_f64, p)

    before = extprod.LAUNCHES
    out = host.decrypt_bits(sk, ops.u32_numpy(nand(nk.bk_ntt)))
    if extprod.LAUNCHES - before != p.n:
        raise AssertionError(f"{extprod.LAUNCHES - before} extprod1_ntt "
                             f"launches for {p.n} CMUX steps")
    wrong = int((out != (1 - (a & b))).sum())
    if wrong:
        raise AssertionError(f"{wrong}/{G} wrong NANDs on the NTT route")
    ntt_ms = cuda_ms(lambda: nand(nk.bk_ntt), 2)
    tk_ms = cuda_ms(lambda: nand(dk.bk_tk), 3)
    say("ntt-gates", f"{G} NANDs through the NTT route (bk_ntt "
        f"{tuple(nk.bk_ntt.shape)} int32, {p.n} extprod1_ntt launches), 0 "
        f"wrong; {ntt_ms:.1f} ms per batch vs tkey route {tk_ms:.1f} ms "
        f"(incl. key switch) on {smi}")
    return {"G": G, "ntt_ms": ntt_ms, "tkey_ms": tk_ms}


def timed(fn):
    """(fn(), device ms of that one call)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def max_diff(got, want):
    return int((ops.to_u64(got) - ops.to_u64(want)).abs().max())


def br_keys(ek, p):
    """The run's eval key as the CRT64 plain and 2-bit-unrolled keys on the
    card (DeviceKeys on the v3 route: no tkey slab), each with its K3/K4
    kernel form; prints the time to build the two kernel forms."""
    with knobs(IYOKAN_BR_IMPL="v3", IYOKAN_EP=None):
        dk = ops.DeviceKeys.from_evalkey(ek, "cuda", with_cb=False)
    if dk.bk_tk is not None or dk.bk_ntt_u is None:
        raise AssertionError("the v3 route did not build both NTT keys")
    torch.cuda.synchronize()
    t0 = time.time()
    forms = [br.kernel_key(k, p) for k in (dk.bk_ntt, dk.bk_ntt_u)]
    torch.cuda.synchronize()
    t_key = time.time() - t0
    for k, f in zip((dk.bk_ntt, dk.bk_ntt_u), forms):
        if not torch.equal(br.kernel_key_of(k), f):
            raise AssertionError("DeviceKeys' kernel form != kernel_key")
    say("br-kernels", f"kernel forms of the plain and unrolled NTT keys "
        f"({sum(f.numel() for f in forms) * 4 / 1e6:.1f} MB int32) built on "
        f"the card in {t_key:.3f} s (key set-up, once per DeviceKeys)")
    del forms
    return dk, t_key


def phase_br_kernels(p, sk, dk, rng, smi, sizes):
    """K5, K4 and K3 (M = 1, 3) against their twins, bit for bit, and
    timed at the given batches; the exact unrolled route against its
    twin."""
    testv = torch.full((p.N,), p.mu, dtype=torch.int32, device="cuda")
    cases = [  # name, key, blind rotation, its twin from (rows, acc)
        ("br_ntt_step", dk.bk_ntt, br.blind_rotate_pallas,
         lambda r, a: br.cmux_steps_ref(r, a, dk.bk_ntt, p)),
        ("br_ntt_loop", dk.bk_ntt, br.blind_rotate_pallas2,
         lambda r, a: br.cmux_steps_ref(r, a, dk.bk_ntt, p)),
        ("br3_ntt M=1", dk.bk_ntt, br3.blind_rotate_pallas3,
         lambda r, a: br3.br3_ref(br3.rotation_steps(r, dk.bk_ntt, p), a,
                                  dk.bk_ntt, p)),
        ("br3_ntt M=3", dk.bk_ntt_u, br3.blind_rotate_pallas3,
         lambda r, a: br3.br3_ref(br3.rotation_steps(r, dk.bk_ntt_u, p), a,
                                  dk.bk_ntt_u, p)),
    ]
    per_rotation = {"br_ntt_step": p.n}
    rows_out, worst = [], 0
    calls = count_calls(nvcc.load(br.SOURCE, br._bind), "br_ntt_steps")
    for G in sizes:
        bits = rng.integers(0, 2, G, dtype=np.uint8)
        ct = ops.u32_tensor(host.encrypt_bits(sk, bits, rng), "cuda")
        for name, key, fn, twin in cases:
            reset_launches()
            calls[0] = 0
            got = fn(ct, key, testv, p)
            torch.cuda.synchronize()
            n_launch = (br.STEP_LAUNCHES + br.LOOP_LAUNCHES + br3.LAUNCHES)
            if n_launch != per_rotation.get(name, 1) or calls[0] != (
                    name == "br_ntt_step"):
                raise AssertionError(f"{name}: {n_launch} launches from "
                                     f"{calls[0]} calls of br_ntt_steps for "
                                     "one blind rotation")
            rec = {"kernel": name, "G": G, "launches": n_launch,
                   "host_calls": calls[0] or 1}
            if name in CLUSTER_GRIDS:
                rec["grid"] = check_clusters(name, G)
            rows, acc = tkey._setup(ct, testv, p)
            want, rec["twin_ms"] = timed(lambda: twin(rows, acc))
            err = max_diff(got, want)
            worst = max(worst, err)
            if err:
                raise AssertionError(
                    f"{name} != twin at G={G}: max |diff| {err}")
            rec["max_abs_diff"] = err
            del want, rows, acc
            rec["kernel_ms"] = cuda_ms(lambda: fn(ct, key, testv, p),
                                       2 if G == 2048 else 3)
            rows_out.append(rec)
            say("br-kernels", json.dumps(rec) + f" on {smi}")

    # the exact unrolled route: one extprod1_ntt launch per key-bit pair
    G = 64
    bits = rng.integers(0, 2, G, dtype=np.uint8)
    ct = ops.u32_tensor(host.encrypt_bits(sk, bits, rng), "cuda")
    with knobs(IYOKAN_BR_IMPL="pallas2", IYOKAN_EP=None):
        key = dk.bk_for(G)
        if ops.gate_route(key, p) != "ntt-unrolled":
            raise AssertionError("a 64-row batch missed the unrolled route")
        reset_launches()
        got, k_ms = timed(lambda: ops.blind_rotate(ct, key, testv, p))
        n_launch = extprod.LAUNCHES
    rows, acc = tkey._setup(ct, testv, p)
    want, t_ms = timed(lambda: ops.ntt_route_steps(
        rows, acc, key, p, extprod.extprod1_ref))
    err = max_diff(got, want)
    if err or n_launch != key.shape[0]:
        raise AssertionError(f"ntt-unrolled route: max |diff| {err}, "
                             f"{n_launch} extprod1_ntt launches")
    unrolled = {"G": G, "launches": n_launch, "max_abs_diff": err,
                "route_ms": k_ms, "twin_ms": t_ms}
    say("br-kernels", f"ntt-unrolled route (IYOKAN_BR_IMPL=pallas2, 64 "
        f"rows <= IYOKAN_UNROLL_MAX): {json.dumps(unrolled)} on {smi}")
    return rows_out, worst, unrolled


def count_calls(lib, fn_name):
    """Counts the host's calls of lib.fn_name from here on: returns a list
    whose first item the calls increment (the smoke run resets it)."""
    calls, fn = [0], getattr(lib, fn_name)

    def counted(*args):
        calls[0] += 1
        return fn(*args)

    setattr(lib, fn_name, counted)
    return calls


K5_SPLIT = os.path.join(ROOT, "iyokan_tpu_torch", "tools",
                        "k5_launch_ablation.json")


def phase_k5_split(smi, sizes=(1, 64, 2048)):
    """K5's per-launch split: tools/br_variants.py on K5_SPLIT (each
    variant removes one more per-launch part, in order), K4 beside each;
    a part's ms is the time its removal saved, and what K5 keeps over K4
    once all are removed is the launches' ramp and drain."""
    spec = br_variants.load_spec(K5_SPLIT)
    recs = br_variants.run(spec, sizes, ("br_ntt_step", "br_ntt_loop"))
    ms = {(r["variant"], r["kernel"], r["G"]): r["ms"] for r in recs}
    names = list(spec)
    split = {}
    for G in sizes:
        k5 = [ms[(v, "br_ntt_step", G)] for v in names]
        k4 = ms[(names[0], "br_ntt_loop", G)]
        row = {"K5_ms": k5[0], "K4_ms": k4}
        row.update({names[i]: k5[i - 1] - k5[i] for i in range(1, len(k5))})
        row["ramp and drain"] = k5[-1] - k4
        split[G] = row
        say("br-kernels", f"K5 per-launch split at G={G} (ms a rotation of "
            f"{params.CGGI128.n} launches; each part: the time its removal saved): "
            f"{json.dumps(row)} on {smi}")
    return split


# the cluster kernels: record name prefix -> the launcher's last grid
CLUSTER_GRIDS = {"br_ntt_step": br.last_launch, "br_ntt_loop": br.last_launch,
                 "br3_ntt M=1": br3.last_launch,
                 "br3_ntt M=3": br3.last_launch, "br3_ntt": br3.last_launch}


def check_clusters(name, G):
    """The (CTAs, cluster size, threads a CTA) of the kernel's last launch,
    as its C launcher reports it; raises unless G clusters of br.CLUSTER
    CTAs of one of the plan's thread counts."""
    grid = CLUSTER_GRIDS[name]()
    if grid[:2] != (br.CLUSTER * G, br.CLUSTER) or grid[2] not in (
            br.WIDE_THREADS, br.NARROW_THREADS):
        raise AssertionError(f"{name} at G={G} launched {grid} (CTAs, "
                             f"cluster size, threads), not {G} clusters of "
                             f"{br.CLUSTER}")
    return list(grid)


def phase_br_gates(p, sk, dk, rng, smi, tkey_rate):
    """2048 NANDs through each NTT blind-rotation route of bk_for."""
    G = 2048
    pre, want = nand_inputs(p, sk, rng, G)

    def nand():
        lvl1 = ops.gate_bootstrap_tlwe1(pre, dk.bk_for(G), p)
        return ops.keyswitch_10(lvl1, dk.ksk_f64, p)

    out = {}
    for impl, name, expect in (("pallas", "br_ntt_step", p.n),
                               ("pallas2", "br_ntt_loop", 1),
                               ("v3", "br3_ntt", 1)):
        with knobs(IYOKAN_BR_IMPL=impl, IYOKAN_EP=None):
            if ops.gate_route(dk.bk_for(G), p) != impl:
                raise AssertionError(f"{G} rows missed the {impl} route")
            reset_launches()
            res = nand()
            torch.cuda.synchronize()
            counts = {"br_ntt_step": br.STEP_LAUNCHES,
                      "br_ntt_loop": br.LOOP_LAUNCHES,
                      "br3_ntt": br3.LAUNCHES}
            if counts[name] != expect or sum(counts.values()) != expect:
                raise AssertionError(f"{impl}: launches {counts}")
            if name in CLUSTER_GRIDS:
                check_clusters(name, G)
            wrong = int((host.decrypt_bits(sk, ops.u32_numpy(res))
                         != want).sum())
            if wrong:
                raise AssertionError(f"{wrong}/{G} wrong NANDs on {impl}")
            ms = cuda_ms(nand, 2)
        out[name] = {"route": impl, "launches": counts[name], "ms": ms,
                     "gate_bootstraps_per_sec": G / (ms / 1e3),
                     "max_phase_err_16ths": phase_err_16ths(p, sk, res,
                                                            want)}
        say("br-gates", f"{G} NANDs, IYOKAN_BR_IMPL={impl} ({name}, "
            f"{counts[name]} launches), 0 wrong; max phase error "
            f"{out[name]['max_phase_err_16ths']:.4f}/16 of the torus; "
            f"{ms:.1f} ms per batch -> gate_bootstraps_per_sec="
            f"{out[name]['gate_bootstraps_per_sec']:.1f} vs tkey route "
            f"{tkey_rate:.1f} (phase 4) on {smi}")
    return out


def reset_launches():
    tkey.LAUNCHES = extprod.LAUNCHES = br3.LAUNCHES = br2.LAUNCHES = 0
    br.STEP_LAUNCHES = br.LOOP_LAUNCHES = 0
    for layout in tkey.LAYOUT_LAUNCHES:
        tkey.LAYOUT_LAUNCHES[layout] = 0
    for form in tkey.FORM_LAUNCHES:
        tkey.FORM_LAUNCHES[form] = 0


def all_launches():
    return (tkey.LAUNCHES + extprod.LAUNCHES + br3.LAUNCHES
            + br.STEP_LAUNCHES + br.LOOP_LAUNCHES + br2.LAUNCHES)


def nand_inputs(p, sk, rng, G):
    """G NANDs' pre-bootstrap TLWEs on the card (gate_linear of two
    encrypted random bit vectors) and the bits they must give."""
    a = rng.integers(0, 2, G, dtype=np.uint8)
    b = rng.integers(0, 2, G, dtype=np.uint8)
    A = ops.u32_tensor(host.encrypt_bits(sk, a, rng), "cuda")
    B = ops.u32_tensor(host.encrypt_bits(sk, b, rng), "cuda")
    ca, cb, kk = (torch.full((G,), c, dtype=torch.int32, device="cuda")
                  for c in gates.GATE_LIN[gates.NAND])
    return ops.gate_linear(A, B, ca, cb, kk, p), 1 - (a & b)


def phase_err_16ths(p, sk, res, want):
    """The largest distance of the outputs' phases from +-mu, in units of
    1/16 of the torus (a gate flips at 2/16)."""
    ideal = np.where(want == 1, p.mu, (1 << 32) - p.mu).astype(np.int64)
    ph = host.tlwe0_phase(sk, ops.u32_numpy(res)).astype(np.int64)
    err = np.abs(((ph - ideal + (1 << 31)) % (1 << 32)) - (1 << 31))
    return float(err.max()) / (1 << 28)


# K2's layouts: record name, the knobs that build it, (layout, L, lb) the
# slab must read as, and the batches of the kernel-vs-twin check
TK_LAYOUTS = (
    ("thin", {"IYOKAN_TK_LAYOUT": "thin"}, ("thin", 3, 2), (1, 5, 64, 2048)),
    ("fat2", {"IYOKAN_TK_LAYOUT": "fat2"}, ("fat2", 3, 2), (1, 5, 64, 2048)),
    ("unrolled", {"IYOKAN_TK_UNROLL": "1"}, ("unrolled", 3, 2),
     (1, 5, 64, 256, 2048)),
    ("fat L=4 lb=3", {"IYOKAN_TKEY_LIMBS": "4", "IYOKAN_TK_LB": "3"},
     ("fat", 4, 3), (1, 5, 64, 2048)),
)


def phase_tk_layouts(p, sk, ek, rng, smi, tkey_rate):
    """K2's layouts: kernel vs twin, bit for bit, and 2048 NANDs each."""
    testv = torch.full((p.N,), p.mu, dtype=torch.int32, device="cuda")
    out = {}
    for name, env, want_cfg, sizes in TK_LAYOUTS:
        t0 = time.time()
        with knobs(IYOKAN_BR_IMPL=None, **env):
            dk = ops.DeviceKeys.from_evalkey(ek, "cuda", with_cb=False)
        torch.cuda.synchronize()
        t_slab = time.time() - t0
        key = dk.bk_tk
        cfg = tkey.slab_config(key, p)
        if cfg[:3] != want_cfg:
            raise AssertionError(f"{name}: the knobs {env} built a slab "
                                 f"read as {cfg}")
        say("tk-layouts", f"{name}: slab {tuple(key.shape)} int8 "
            f"({key.numel() / 1e9:.2f} GB) built + moved in {t_slab:.1f} s")
        rows = []
        for G in sizes:
            bits = rng.integers(0, 2, G, dtype=np.uint8)
            ct = ops.u32_tensor(host.encrypt_bits(sk, bits, rng), "cuda")
            form = form_of(G, cfg[0])
            before = tkey.FORM_LAUNCHES[form]
            got = tkey.blind_rotate_tkey(ct, key, testv, p)
            launched = tkey.FORM_LAUNCHES[form] - before
            want, t_ms = timed(
                lambda: tkey.blind_rotate_tkey_ref(ct, key, testv, p))
            err = max_diff(got, want)
            if err:
                raise AssertionError(
                    f"{name} kernel != twin at G={G}: max |diff| {err}")
            del got, want
            k_ms = cuda_ms(lambda: tkey.blind_rotate_tkey(ct, key, testv, p),
                           3)
            if launched != 1:
                raise AssertionError(f"{name} G={G}: {launched} launches "
                                     f"of the {form} form")
            rows.append({"G": G, "form": form, "kernel_ms": k_ms,
                         "twin_ms": t_ms, "max_abs_diff": err})
            say("tk-layouts", f"{name} G={G}: bit-identical to twin; "
                f"{form} form {k_ms:.3f} ms, twin {t_ms:.3f} ms per "
                f"blind rotation on {smi}")

        G = 2048
        pre, want = nand_inputs(p, sk, rng, G)

        def nand():
            lvl1 = ops.gate_bootstrap_tlwe1(pre, dk.bk_for(G), p)
            return ops.keyswitch_10(lvl1, dk.ksk_f64, p)

        reset_launches()
        res = nand()
        torch.cuda.synchronize()
        launches = tkey.LAYOUT_LAUNCHES[cfg[0]]
        if launches != 1 or all_launches() != 1:
            raise AssertionError(f"{name}: {all_launches()} launches, "
                                 f"{launches} of layout {cfg[0]}")
        wrong = int((host.decrypt_bits(sk, ops.u32_numpy(res)) != want).sum())
        if wrong:
            raise AssertionError(f"{wrong}/{G} wrong NANDs on {name}")
        err16 = phase_err_16ths(p, sk, res, want)
        ms = cuda_ms(nand, 2)
        out[name] = {"layout": cfg[0], "L": cfg[1], "lb": cfg[2],
                     "slab_shape": list(key.shape), "slab_s": t_slab,
                     "rotations": rows, "nand_launches": launches,
                     "nand_ms": ms, "gate_bootstraps_per_sec": G / (ms / 1e3),
                     "max_phase_err_16ths": err16}
        say("tk-layouts", f"{G} NANDs on the {name} slab ({launches} "
            f"launch), 0 wrong; max phase error {err16:.4f}/16 of the torus; "
            f"{ms:.1f} ms per batch -> gate_bootstraps_per_sec="
            f"{G / (ms / 1e3):.1f} vs fat L=3 lb=2 {tkey_rate:.1f} (phase 4) "
            f"on {smi}")
        del dk, key, pre, res
        torch.cuda.empty_cache()
    return out


# MAC-16 runs: phase -> (the knobs of its route, the launches the route
# must make; every other kernel launch must be 0)
SLICE_ROUTES = {
    "slice": ({}, lambda: tkey.LAYOUT_LAUNCHES["fat"]),
    "tk-slice": ({"IYOKAN_TK_SMALL": "1"},
                 lambda: tkey.LAYOUT_LAUNCHES["unrolled"]),
    "br-slice": ({"IYOKAN_BR_IMPL": "v3"}, lambda: br3.LAUNCHES),
}


def mac_operands(W, cycles):
    """The MAC-W runs' operands a, b (one a cycle, from SEED) and the
    accumulator they must give."""
    rng = np.random.default_rng(SEED)
    av = [int(x) for x in rng.integers(0, 1 << W, cycles)]
    bv = [int(x) for x in rng.integers(0, 1 << W, cycles)]
    return av, bv, sum(x * y for x, y in zip(av, bv)) % (1 << (2 * W))


def phase_slice(smi, phase="slice"):
    """MAC-16 through the CLIs at cggi128: encrypted == plain == integers.
    "slice" runs the JAX package's default (tkey) route on fresh keys and
    request; the
    others (SLICE_ROUTES) reuse its files.  Returns (launches of the
    route's kernel, s/cycle)."""
    env, route_launches = SLICE_ROUTES[phase]
    W, cycles = 16, SLICE_CYCLES
    bp_path = os.path.join(ROOT, "tests", "data", f"mac{W}.toml")
    av, bv, want = mac_operands(W, cycles)

    def stream(vals):
        bits = np.array([(v >> k) & 1 for v in vals for k in range(W)],
                        np.uint8)
        return (f'name = "{{}}"\nsize = {bits.size}\nbytes = '
                f"{np.packbits(bits, bitorder='little').tolist()}\n")

    os.makedirs(WORK, exist_ok=True)
    f = {k: os.path.join(WORK, k) for k in (
        "sk", "ek", "req.toml", "req.plain", "req.enc", "res.enc",
        "res.plain", "res.ref")}
    t0 = time.time()
    if phase == "slice":
        with open(f["req.toml"], "w") as fh:
            fh.write("[[bits]]\n" + stream(av).format("a")
                     + "\n[[bits]]\n" + stream(bv).format("b"))
        packet_cli.main(["genkey", "--out", f["sk"], "--params", "cggi128",
                         "--seed", str(SEED)])
        packet_cli.main(["genevalkey", "--in", f["sk"], "--out", f["ek"],
                         "--seed", str(SEED + 1)])
        packet_cli.main(["toml2packet", "--in", f["req.toml"],
                         "--out", f["req.plain"]])
        packet_cli.main(["enc", "--key", f["sk"], "--in", f["req.plain"],
                         "--out", f["req.enc"]])
    elif not os.path.exists(f["req.enc"]):
        raise RuntimeError(f"{phase} reuses the slice phase's files")
    t_keys = time.time() - t0

    cycle_us = []

    class CycleTimes(logging.Handler):
        def emit(self, record):
            m = re.match(r"\s*done\. \((\d+) us\)", record.getMessage())
            if m:
                cycle_us.append(int(m.group(1)))

    lg = logging.getLogger("iyokan")
    lg.setLevel(logging.INFO)
    handler = CycleTimes()
    lg.addHandler(handler)
    reset_launches()
    t0 = time.time()
    try:
        # level by level, comparable with earlier runs (phase 14 runs
        # the execution modes)
        with knobs(IYOKAN_FUSE_LEVELS="1", **env):
            iyokan_cli.main(["tfhe", "--blueprint", bp_path, "-i",
                             f["req.enc"], "-o", f["res.enc"], "--evalkey",
                             f["ek"], "-c", str(cycles), "--quiet"])
    finally:
        lg.removeHandler(handler)
    t_run = time.time() - t0
    launches, others = route_launches(), all_launches() - route_launches()
    if launches == 0 or others:
        raise AssertionError(
            f"the encrypted {phase} run launched {launches} of its route's "
            f"kernel and {others} others")
    if phase == "br-slice" and br3.last_launch()[1] != br.CLUSTER:
        raise AssertionError(f"K3's last launch {br3.last_launch()} is not "
                             f"in clusters of {br.CLUSTER}")

    packet_cli.main(["dec", "--key", f["sk"], "--in", f["res.enc"],
                     "--out", f["res.plain"]])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        packet_cli.main(["packet2toml", "--in", f["res.plain"]])
    iyokan_cli.main(["plain", "--blueprint", bp_path, "-i", f["req.plain"],
                     "-o", f["res.ref"], "-c", str(cycles), "--quiet"])
    with contextlib.redirect_stdout(io.StringIO()) as ref_buf:
        packet_cli.main(["packet2toml", "--in", f["res.ref"]])

    def acc_of(toml_text):
        import tomllib

        entry = next(e for e in tomllib.loads(toml_text)["bits"]
                     if e["name"] == "acc")
        return int.from_bytes(bytes(entry["bytes"]), "little") % (
            1 << entry["size"])

    got, plain = acc_of(buf.getvalue()), acc_of(ref_buf.getvalue())
    if not got == plain == want:
        raise AssertionError(
            f"MAC-{W}: encrypted {got} / plain {plain} / integers {want}")

    comp = compile_mod.compile_design(build_design(Blueprint(bp_path)))
    boots = sum(pl_.n_bootstraps for pl_ in comp.levels)
    if len(cycle_us) != cycles:
        raise AssertionError(f"expected {cycles} cycle times, got {cycle_us}")
    s_cycle = sum(cycle_us) / len(cycle_us) / 1e6
    say(phase, f"MAC-{W} x {cycles} cycles at cggi128 ({env or 'defaults'}"
        f"): decrypted acc {got} == plain == a.b; census "
        f"{comp.gate_census()}; {len(comp.levels)} levels, {boots} "
        f"bootstraps/cycle; {s_cycle:.3f} s/cycle (cycles {cycle_us} us), "
        f"tfhe CLI {t_run:.1f} s incl. key load + reset, keys+enc "
        f"{t_keys:.1f} s; {launches} kernel launches; {smi}")
    return launches, s_cycle


def memory_files():
    """memmac request and keys through the CLIs: genkey, genevalkey (with
    the circuit-bootstrapping keys, the default), toml2packet, enc."""
    os.makedirs(WORK, exist_ok=True)
    f = {k: os.path.join(WORK, f"mem.{k}") for k in (
        "sk", "ek", "req.toml", "req.plain", "req.enc", "res.enc",
        "res.plain", "res.ref")}
    rom, rams, streams = gen_mac.memmac_request(MEM_CYCLES, SEED)
    with open(f["req.toml"], "w") as fh:
        fh.write(packet_mod.PlainPacket(rom={"rom": rom}, ram=rams,
                                        bits=streams).to_toml())
    t0 = time.time()
    packet_cli.main(["genkey", "--out", f["sk"], "--params", "cggi128",
                     "--seed", str(SEED + 2)])
    packet_cli.main(["genevalkey", "--in", f["sk"], "--out", f["ek"],
                     "--seed", str(SEED + 3)])
    t_ek = time.time() - t0
    packet_cli.main(["toml2packet", "--in", f["req.toml"],
                     "--out", f["req.plain"]])
    packet_cli.main(["enc", "--key", f["sk"], "--in", f["req.plain"],
                     "--out", f["req.enc"]])
    say("memory", f"keys (with CB) {t_ek:.1f} s, request + enc "
        f"{time.time() - t0 - t_ek:.1f} s; eval key "
        f"{os.path.getsize(f['ek']) / 2**20:.0f} MiB")
    return f, (rom, rams, streams)


EP_SIZES = (1, 8, 63, 64, 1024, 2048)


def phase_extprod(p, files, smi, caps):
    """extprod1_ntt vs its twin at the memory path's shapes (2l rows) and
    the unrolled route's (3*2l), on selectors made by the port's circuit
    bootstrapping; caps: the kernel's narrow cap per RR (the thread-plan
    switch is checked at cap and cap + 1)."""
    sk = host.SecretKey.load(files["sk"])
    ek = host.EvalKey.load(files["ek"])
    t0 = time.time()
    with ntt_route():
        dk = ops.DeviceKeys.from_evalkey(ek, "cuda")
    torch.cuda.synchronize()
    say("extprod", f"CB keys on the card in {time.time() - t0:.1f} s: bk2 "
        f"{tuple(dk.bk2.shape)} int64, pksk 2 x "
        f"{tuple(dk.pksk_f64[0].shape)} float64")
    rng = np.random.default_rng(SEED + 4)
    bits = rng.integers(0, 2, 8, dtype=np.uint8)
    ct = ops.u32_tensor(host.encrypt_bits(sk, bits, rng), "cuda")
    t0 = time.time()
    trgsw = ops.circuit_bootstrap(ct, dk.bk2, dk.pksk_f64, p)
    torch.cuda.synchronize()
    t_cb = time.time() - t0
    # the b-part gadget rows of TRGSW(m) decrypt to m * 2^(32 - Bgbit)
    ph = host.trlwe1_phase(sk, ops.u32_numpy(trgsw[:, p.l]))[:, 0]
    g1 = 1 << (32 - p.Bgbit)
    dec = ((ph.astype(np.int64) + g1 // 2) // g1) & 1
    if not np.array_equal(dec, bits):
        raise AssertionError(f"CB decrypts to {dec}, want {bits}")
    prep = ops.prep_trgsw(torch.stack([trgsw, ops.trgsw_invert(trgsw, p)],
                                      dim=1), p)     # [8, 2, 2l, 2, P, N]
    say("extprod", f"circuit_bootstrap of 8 bits ({p.l * 8} lvl2 rows, "
        f"{dk.bk2.shape[0]} unrolled steps) {t_cb:.3f} s, decrypts right")
    rows, worst = [], 0
    for RR in (2 * p.l, 6 * p.l):
        M = RR // (2 * p.l)
        cap = caps[f"K6 RR={RR}"]
        for G in sorted(set(EP_SIZES) | {cap, cap + 1}):
            c = ops.u32_tensor(rng.integers(0, 1 << 32, (G, M, 2, p.N),
                                            dtype=np.uint32), "cuda")
            d = ops.decompose1(c, p).reshape(G, RR, p.N)
            for K in (1, 2):
                # M CB-made TRGSWs a key (the unrolled route's key-bit pair)
                j = [(G + m) % 8 for m in range(M)]
                keys = prep[j].transpose(0, 1).reshape(
                    2, RR, 2, 2, p.N)[:K].contiguous()
                idx = None
                if K == 2:
                    pol = rng.integers(0, 2, G).astype(np.int32)
                    pol[: min(G, 2)] = [0, 1][: min(G, 2)]
                    idx = torch.from_numpy(pol)        # on the host
                got = extprod.extprod1(d, keys, idx, p)
                grid = extprod.last_launch()
                want = extprod.extprod1_ref(d, keys, idx, p)
                torch.cuda.synchronize()
                err = max_diff(got, want)
                worst = max(worst, err)
                if err:
                    raise AssertionError(f"extprod1_ntt != twin at G={G}, "
                                         f"K={K}, RR={RR}: max |diff| {err}")
                if grid != (br.CLUSTER * G, br.CLUSTER,
                            br.threads_for(G, cap)):
                    raise AssertionError(f"extprod1_ntt at G={G} RR={RR} "
                                         f"launched {grid}")
                k_ms = cuda_ms(lambda: extprod.extprod1(d, keys, idx, p), 10)
                dev_ms = device_ms(lambda: extprod.extprod1(d, keys, idx, p),
                                   "ep_cluster_kernel")
                t_ms = cuda_ms(lambda: extprod.extprod1_ref(d, keys, idx, p),
                               2)
                rows.append({"G": G, "K": K, "RR": RR, "grid": list(grid),
                             "kernel_ms": k_ms, "device_ms": dev_ms,
                             "twin_ms": t_ms})
                say("extprod", f"G={G} K={K} RR={RR}: max |diff| 0; grid "
                    f"{grid} (CTAs, cluster, threads); kernel {k_ms:.4f} "
                    f"ms a call ({dev_ms if dev_ms is None else round(dev_ms, 4)}"
                    f" ms on the device, torch.profiler), twin {t_ms:.4f} ms "
                    f"per call on {smi}")
    del dk
    torch.cuda.empty_cache()
    return rows, worst, t_cb


# K7's batches: one address bit's l rows, the 8-bit phase's 8 x l and
# memmac's 23 address bits x l (its CB batch a cycle); phase 9b adds each
# rows-plan threshold (C, C + 1, 2C + 1, 3C, 3C + 1 at C clusters at once)
K7_SIZES = (1, 3, 24, 69)
# K7's variants (tools/br_variants.py, one parallel build): 512 threads a
# CTA beside its 1024, R_MAX = 1 (one row a cluster) beside R_MAX, and the
# removal sequence of a step's phases
K7_SPECS = {name: os.path.join(ROOT, "iyokan_tpu_torch", "tools",
                               f"k7_{name}.json")
            for name in ("threads", "rows", "ablation")}
K7_VARIANT_SIZES = (3, 24, 69)


def k7_sizes(cap):
    """K7_SIZES and the rows plan's thresholds at `cap` clusters at once:
    the last one-row wave and the first two-row one, the first three-row
    one, the last one-wave batch and the first of two waves."""
    return sorted(set(K7_SIZES) | {cap, cap + 1, 2 * cap + 1, 3 * cap,
                                   3 * cap + 1})


def k7_mulmods(p, M):
    """Mulmods one row's K7 step costs (ntt_mulmods' rule on the 64-bit
    torus, two 32-bit halves): per prime the forward NTTs of the M*2l2
    digit rows and the inverse NTTs of 2 outputs x 2 halves (N2/2 log2 N2
    butterflies each), 2 x 2 x M*2l2 x N2 key products and 4 N2 scalings;
    then 4 N2 Garner products."""
    rr = M * 2 * p.l2
    t = p.N2 // 2 * p.logN2
    return 2 * ((rr + 4) * t + 4 * rr * p.N2 + 4 * p.N2) + 4 * p.N2


def k7_bound(p, G, M, S):
    """(ms, what sets it) of K7's work at G rows over S steps of M
    rotations: 2 multiplies a mulmod at the card's integer rate, or the
    kernel-form key, the amounts and the accumulator in and out once at
    the HBM rate."""
    nbytes = (S * 4 * M * p.l2 * 4 * p.N2 * 4 + S * M * G * 4
              + 2 * G * 2 * p.N2 * 8)
    return bound(2 * S * G * k7_mulmods(p, M), INT32_MULS_PER_S, nbytes)


def phase_br2(p, files, smi, caps):
    """K7 (csrc/br2_ntt.cu) against its twin blind_rotate2_ref at cggi128,
    on the memmac run's CB key in both forms (DeviceKeys, the unrolled key
    by default, the plain key under IYOKAN_NO_UNROLL), at k7_sizes (caps:
    the clusters the card holds at once per M at R_MAX rows a cluster),
    inputs made by blind_rotate2's own set-up from encrypted bits and
    per-row test vectors: max |diff| 0, the grid as launched against the
    rows plan, kernel ms (CUDA events), device ms (torch.profiler), twin
    ms, bound ms; then K7's variants (K7_SPECS)."""
    sk = host.SecretKey.load(files["sk"])
    ek = host.EvalKey.load(files["ek"])
    rng = np.random.default_rng(SEED + 6)
    rows, worst = [], 0
    for form, M, env in (("unrolled", 3, None), ("plain", 1, "1")):
        ops.clear_device_key_cache()
        t0 = time.time()
        with ntt_route(), knobs(IYOKAN_NO_UNROLL=env):
            dk = ops.DeviceKeys.from_evalkey(ek, "cuda")
        torch.cuda.synchronize()
        t_keys = time.time() - t0
        bk2 = dk.bk2
        if bk2.shape[1] != M * 2 * p.l2:
            raise AssertionError(f"{form} CB key {tuple(bk2.shape)}")
        t0 = time.time()
        kk = br2.kernel_key2(bk2, p)
        torch.cuda.synchronize()
        t_kk = time.time() - t0
        if not torch.equal(kk, br2.kernel_key2_of(bk2)):
            raise AssertionError("DeviceKeys' K7 key form != kernel_key2")
        say("br2", f"{form} CB key: DeviceKeys {t_keys:.1f} s; prep2 "
            f"{tuple(bk2.shape)} int64, kernel form {tuple(kk.shape)} "
            f"int32 ({kk.numel() * 4 / 1e6:.1f} MB) built in {t_kk:.3f} s")
        del kk
        cap = caps[f"K7 M={M}"]
        S = bk2.shape[0]
        for G in k7_sizes(cap):
            bits = rng.integers(0, 2, G, dtype=np.uint8)
            tl = ops.u32_tensor(host.encrypt_bits(sk, bits, rng), "cuda")
            testv = ops.u64_tensor(rng.integers(0, 1 << 64, (G, p.N2),
                                                dtype=np.uint64), "cuda")
            steps, acc = ops.blind_rotate2_setup(tl, bk2, testv, p)
            got = br2.br2(steps, acc, bk2, p)
            grid = br2.last_launch()
            want, t_ms = timed(
                lambda: br2.blind_rotate2_ref(steps, acc, bk2, p))
            err = int((got - want).abs().max())
            worst = max(worst, err)
            if err or not torch.equal(got, want):
                raise AssertionError(f"K7 != twin at G={G}, {form} key: "
                                     f"max |diff| {err}")
            R = br2.rows_per_cluster(G, cap, br2.R_MAX)
            n = -(-G // R)
            if grid != (br.CLUSTER * n, br.CLUSTER, br2.THREADS, R):
                raise AssertionError(f"K7 at G={G} launched {grid}, the "
                                     f"plan {n} clusters of {R} rows")
            smem, cap_r, _, _ = br2.cluster_plan(p, M, rows=R)
            waves = -(-n // cap_r)
            k_ms = cuda_ms(lambda: br2.br2(steps, acc, bk2, p), 3)
            dev_ms = device_ms(lambda: br2.br2(steps, acc, bk2, p),
                               "br2_cluster_kernel", reps=3)
            b_ms, b_by = k7_bound(p, G, M, S)
            rows.append({"form": form, "M": M, "G": G, "grid": list(grid),
                         "rows_per_cluster": R, "smem_bytes": smem,
                         "waves": waves, "kernel_ms": k_ms,
                         "device_ms": dev_ms, "twin_ms": t_ms,
                         "bound_ms": b_ms, "bound_by": b_by})
            say("br2", f"{form} key (M={M}, {S} steps) G={G}: == twin, max "
                f"|diff| 0; grid {grid} (CTAs, cluster, threads, rows a "
                f"cluster): {n} clusters of {R} rows, {smem} B a CTA, "
                f"{waves} wave(s) of {cap_r} clusters; kernel {k_ms:.3f} ms "
                f"({dev_ms if dev_ms is None else round(dev_ms, 3)} ms on the "
                f"device, torch.profiler), {k_ms * 1e3 / S / waves:.1f} us a "
                f"step a wave; twin {t_ms:.1f} ms; bound {b_ms:.4f} ms by "
                f"{b_by} ({b_ms / k_ms:.3f} of it); {smi}")
        del dk, bk2
        ops.clear_device_key_cache()
        torch.cuda.empty_cache()
    # the variants, on random keys (tools/br_variants.py; base == twin):
    # the thread count, one row a cluster, and a step's phases removed one
    # after another
    kernels = ("br2_ntt M=3", "br2_ntt M=1")
    recs = br_variants.run_specs(
        {k: br_variants.load_spec(v) for k, v in K7_SPECS.items()},
        K7_VARIANT_SIZES, kernels)
    ms = {(r["spec"], r["variant"], r["kernel"], r["G"]): r["ms"]
          for r in recs}
    for spec in K7_SPECS:
        names = list(br_variants.load_spec(K7_SPECS[spec]))
        for kernel in kernels:
            say("br2", f"{kernel} variants (tools/br_variants.py, "
                f"k7_{spec}.json; ms at G = "
                f"{', '.join(map(str, K7_VARIANT_SIZES))}): " + "; ".join(
                    f"{name} " + " / ".join(
                        f"{ms[spec, name, kernel, G]:.3f}"
                        for G in K7_VARIANT_SIZES) for name in names)
                + f"; {smi}")
    return rows, worst, recs


def phase_memory(files, data, smi):
    """memmac through iyokan tfhe: encrypted == plain == Python integers."""
    rom, rams, streams = data
    f, cycles = files, MEM_CYCLES
    bp_path = os.path.join(ROOT, "tests", "data", "memmac.toml")
    cycle_us = []

    class CycleLog(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            m = re.match(r"\s*done\. \((\d+) us\)", msg)
            if m:
                cycle_us.append(int(m.group(1)))

    lg = logging.getLogger("iyokan")
    lg.setLevel(logging.INFO)           # the driver's per-cycle lines
    lg.propagate = False
    handler = CycleLog()
    lg.addHandler(handler)
    reset_launches()
    t0 = time.time()
    try:
        with knobs(IYOKAN_FUSE_LEVELS="1"):
            iyokan_cli.main(["tfhe", "--blueprint", bp_path, "-i",
                             f["req.enc"], "-o", f["res.enc"], "--evalkey",
                             f["ek"], "-c", str(cycles), "--quiet"])
    finally:
        lg.removeHandler(handler)
        lg.propagate = True
        lg.setLevel(logging.INFO)
    t_run = time.time() - t0
    launches = {"tkey_blind_rotate": tkey.LAUNCHES,
                "extprod1_ntt": extprod.LAUNCHES,
                "br2_ntt": br2.LAUNCHES,
                "tkey loop form": tkey.FORM_LAUNCHES["loop"],
                "tkey wgmma form": tkey.FORM_LAUNCHES["wgmma"],
                "tkey mma form": tkey.FORM_LAUNCHES["mma"]}
    if not (launches["tkey_blind_rotate"] and launches["extprod1_ntt"]
            and launches["br2_ntt"] and launches["tkey loop form"]
            and launches["tkey mma form"]):
        raise AssertionError(f"the encrypted memory run launched {launches}")

    packet_cli.main(["dec", "--key", f["sk"], "--in", f["res.enc"],
                     "--out", f["res.plain"]])
    iyokan_cli.main(["plain", "--blueprint", bp_path, "-i", f["req.plain"],
                     "-o", f["res.ref"], "-c", str(cycles), "--quiet"])
    got = packet_mod.PlainPacket.load(f["res.plain"])
    plain = packet_mod.PlainPacket.load(f["res.ref"])
    want, want_ram = gen_mac.memmac_expected(rom, rams, streams, cycles)

    def word(bits):
        return sum(int(b) << k for k, b in enumerate(bits))

    for name, v in want.items():
        g, pl_ = word(got.bits[name]), word(plain.bits[name])
        if not g == pl_ == v:
            raise AssertionError(f"memmac @{name}: encrypted {g} / plain "
                                 f"{pl_} / integers {v}")
    for name, bits in want_ram.items():
        if not (np.array_equal(got.ram[name], plain.ram[name])
                and np.array_equal(got.ram[name], bits)):
            raise AssertionError(f"memmac RAM {name}: encrypted image != "
                                 "plain / integers")
    if len(cycle_us) != cycles:
        raise AssertionError(f"expected {cycles} cycle times, got "
                             f"{cycle_us}")
    comp = compile_mod.compile_design(build_design(Blueprint(bp_path)))
    s_cycle = sum(cycle_us) / len(cycle_us) / 1e6
    say("memory", f"memmac x {cycles} cycles at cggi128: decrypted {want} "
        f"== plain == integers, RAM images equal; {len(comp.levels)} "
        f"levels, census {comp.gate_census()}; {s_cycle:.3f} s/cycle "
        f"(cycles {cycle_us} us), tfhe CLI {t_run:.1f} "
        f"s incl. key load + reset settle; launches {launches}; {smi}")
    return launches, s_cycle


# Phase 14: the execution modes (engine/tfhe.py) as CUDA graphs.  Each
# route's IYOKAN_FUSE_LEVELS=1 run first (the reference), then its fused
# runs: (label, blueprint, memory design?, route knobs, [mode knobs], the
# launch counts the graphs' replays must raise).  The pallas route takes
# IYOKAN_UNROLL_MAX=0, or its batches of at most 256 rows would take the
# unrolled key (extprod1 per key-bit pair) instead of K5.
FUSE8 = {"IYOKAN_FUSE_LEVELS": "8"}
FUSION_RUNS = (
    ("tkey", "mac16.toml", False, {}, [FUSE8],
     ("tkey.FORM_LAUNCHES.loop", "tkey.FORM_LAUNCHES.mma")),
    ("v3", "mac16.toml", False, {"IYOKAN_BR_IMPL": "v3"}, [FUSE8],
     ("br3.LAUNCHES",)),
    ("pallas", "mac16.toml", False,
     {"IYOKAN_BR_IMPL": "pallas", "IYOKAN_UNROLL_MAX": "0"}, [FUSE8],
     ("br.STEP_LAUNCHES",)),
    ("memmac", "memmac.toml", True, {"IYOKAN_RAM_REFRESH_PERIOD": "2"},
     [FUSE8],
     ("tkey.FORM_LAUNCHES.loop", "tkey.FORM_LAUNCHES.wgmma",
               "extprod.LAUNCHES", "br2.LAUNCHES")),
)


def slab_cache_times(ek):
    """DeviceKeys.from_evalkey twice on an empty slab disk cache, the
    in-process cache cleared before each: the first builds the slab and
    writes it, the second reads it.  Returns (build s, read s, MiB)."""
    d = os.path.join(WORK, "slabs")
    shutil.rmtree(d, ignore_errors=True)
    times, slabs = [], []
    with knobs(IYOKAN_SLAB_CACHE=d):
        for _ in range(2):
            ops.clear_device_key_cache()
            t0 = time.time()
            dk = ops.DeviceKeys.from_evalkey(ek, "cuda", with_cb=False)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            slabs.append(dk.bk_tk)
    files = os.listdir(d)
    if len(files) != 1 or not torch.equal(slabs[0], slabs[1]):
        raise AssertionError(f"slab disk cache: files {files}, read slab "
                             "!= built slab")
    mib = os.path.getsize(os.path.join(d, files[0])) / 2**20
    shutil.rmtree(d, ignore_errors=True)
    return times[0], times[1], mib


def fused_run(bp_path, req, ek, env, cycles):
    """One tfhe run through the Frontend under the knobs env: (result
    packet, the us of each logged cycle, the engine's
    graph records, launches by the wrappers (first uses and anything run
    eagerly) and by the graphs' replays, the engine calls the Frontend
    made (engine_calls))."""
    from iyokan_tpu_torch.engine import tfhe
    from iyokan_tpu_torch.engine.driver import Frontend

    reset_launches()
    tfhe.clear_engine_cache()     # check_replays counts a fresh engine's
    with timing.cycle_log() as lines, knobs(**env), \
            engine_calls() as calls:
        fe = Frontend("tfhe", Blueprint(bp_path), req, eval_key=ek,
                      device="cuda")
        fe.go(cycles)
        res = fe.make_result_packet()
    eng = fe.engine
    out = (res, lines, eng.graph_stats(), tfhe.launch_counts(),
           eng.graph_launches(), calls)
    del fe, eng
    tfhe.clear_engine_cache()
    torch.cuda.empty_cache()
    return out


def phase_fusion(smi, mem_files, mem_data):
    """MAC-16 on tkey, v3 and pallas and memmac on tkey, FUSION_CYCLES
    cycles at cggi128, each route under IYOKAN_FUSE_LEVELS=1 and its fused
    modes: every fused result packet (RAM images included) == the route's
    FUSE=1 packet byte for byte, decrypted == plain == integers, and
    every graph captured at its second use and replayed at each later one
    (check_replays)."""
    from iyokan_tpu_torch.engine.driver import Frontend

    W, cycles = 16, SLICE_CYCLES
    f = {k: os.path.join(WORK, k) for k in ("sk", "ek", "req.enc",
                                            "req.plain")}
    sk, ek = host.SecretKey.load(f["sk"]), host.EvalKey.load(f["ek"])
    t_build, t_read, mib = slab_cache_times(ek)
    say("fusion", f"slab disk cache: DeviceKeys.from_evalkey {t_build:.2f} "
        f"s building and writing the slab ({mib:.0f} MiB .npy), "
        f"{t_read:.2f} s reading it back (in-process cache cleared "
        f"before each); read slab == built slab; {smi}")
    _, _, want_acc = mac_operands(W, cycles)
    rom, rams, streams = mem_data
    want_mem, want_ram = gen_mac.memmac_expected(rom, rams, streams, cycles)
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    out = []
    for label, bp_name, mem, route, modes, must in FUSION_RUNS:
        bp_path = os.path.join(ROOT, "tests", "data", bp_name)
        files = mem_files if mem else f
        r_sk = host.SecretKey.load(files["sk"])
        r_ek = ek if not mem else host.EvalKey.load(files["ek"])
        req = packet_mod.TFHEPacket.load(files["req.enc"])
        plain_fe = Frontend("plain", Blueprint(bp_path),
                            packet_mod.PlainPacket.load(files["req.plain"]),
                            device="cuda")
        plain_fe.go(cycles)
        plain = plain_fe.make_result_packet()
        ref_path = os.path.join(WORK, f"fusion.{label}.1.res")
        for mode in [{"IYOKAN_FUSE_LEVELS": "1"}] + modes:
            env = {**route, **mode}
            res, lines, graphs, eager, replayed, calls = fused_run(
                bp_path, req, r_ek, env, cycles)
            tag = " ".join(f"{k[7:]}={v}" for k, v in mode.items())
            path = os.path.join(WORK, f"fusion.{label}.res")
            res.save(path)
            if mode["IYOKAN_FUSE_LEVELS"] == "1":
                shutil.copy(path, ref_path)
            with open(path, "rb") as a, open(ref_path, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"fusion {label} {tag}: result "
                                         "packet != the FUSE=1 packet")
            dec = res.decrypt(r_sk)
            if mem:
                word = lambda bits: sum(int(b) << k for k, b in  # noqa
                                        enumerate(bits))
                for name, v in want_mem.items():
                    if not word(dec.bits[name]) == word(
                            plain.bits[name]) == v:
                        raise AssertionError(f"fusion {label} {tag}: "
                                             f"@{name} wrong")
                for name, bits in want_ram.items():
                    if not (np.array_equal(dec.ram[name], plain.ram[name])
                            and np.array_equal(dec.ram[name], bits)):
                        raise AssertionError(f"fusion {label} {tag}: RAM "
                                             f"{name} wrong")
            else:
                acc = sum(int(b) << k for k, b in enumerate(dec.bits["acc"]))
                p_acc = sum(int(b) << k
                            for k, b in enumerate(plain.bits["acc"]))
                if not acc == p_acc == want_acc:
                    raise AssertionError(f"fusion {label} {tag}: acc {acc} "
                                         f"/ plain {p_acc} / {want_acc}")
            if mode["IYOKAN_FUSE_LEVELS"] != "1":
                check_replays(label, tag, graphs, calls)
                if not all(replayed.get(k) for k in must):
                    raise AssertionError(f"fusion {label} {tag}: the "
                                         f"replays launched {replayed}, "
                                         f"need {must}")
            row = {"route": label, "mode": mode, "cycles_us": lines,
                   "s_per_cycle": lines[-1] / 1e6,
                   "graphs": len(graphs),
                   "replays": sum(g["replays"] for g in graphs),
                   "capture_s": sum(g["capture_s"] for g in graphs),
                   "instantiate_s": sum(g["instantiate_s"] for g in graphs),
                   "pool_bytes": sum(g["pool_bytes"] for g in graphs),
                   "nodes": [g["nodes"] for g in graphs],
                   "kernel_nodes": [g["kernel_nodes"] for g in graphs],
                   "graph_launches": replayed,
                   "eager_launches": {k: v for k, v in eager.items() if v}}
            out.append(row)
            ref = next(r for r in out if r["route"] == label)
            say("fusion", f"{label} {bp_name} x {cycles} cycles, {tag}: "
                "packet == FUSE=1's byte for byte, decrypts == plain == "
                f"integers; {row['s_per_cycle']:.4f} s/cycle (last "
                f"cycle; FUSE=1 {ref['s_per_cycle']:.4f}); cycles (us) "
                f"{lines}; "
                f"{row['graphs']} graphs captured, {row['replays']} "
                f"replays; capture "
                f"{row['capture_s']:.2f} s, instantiation "
                f"{row['instantiate_s']:.2f} s; pool "
                f"{row['pool_bytes'] / 2**20:.1f} MiB of the card's "
                f"{card_gib:.1f} GiB; launches by replays {replayed}, eager "
                f"(first uses) {row['eager_launches']}; {smi}")
            for g in graphs:
                if not g["name"].startswith("level group"):
                    say("fusion", f"  {label} {tag} {g['name']}: "
                        f"{g['replays']} replays, holds {g['kernels']} "
                        f"wrapper launches, {g['nodes']} nodes "
                        f"({g['kernel_nodes']} kernels), capture "
                        f"{g['capture_s']:.3f} s, instantiation "
                        f"{g['instantiate_s']:.3f} s, pool "
                        f"{g['pool_bytes'] / 2**20:.1f} MiB")
            groups = [g for g in graphs if g["name"].startswith("level")]
            if groups:
                say("fusion", f"  {label} {tag}: {len(groups)} level-group "
                    f"graphs, {sum(g['nodes'] or 0 for g in groups)} nodes "
                    f"({sum(g['kernel_nodes'] or 0 for g in groups)} "
                    f"kernels) in all")
        if mem:
            design = build_design(Blueprint(bp_path))
            G = sum(len(i.addr_nodes) for i in (
                *design.rom_insts.values(), *design.ram_insts.values()))
            eager, replay, kernels, k7 = cb_graph_times(mem_files, G)
            out.append({"route": "cb", "G": G, "eager_s": eager,
                        "replay_s": replay, "kernel_nodes": kernels,
                        "k7_launches": k7})
            say("fusion", f"circuit bootstrapping of memmac's {G} address "
                f"bits ({G * params.CGGI128.l} lvl2 rows): {eager:.4f} s "
                f"eager, {replay:.4f} s as one graph's replay ({kernels} "
                f"kernel nodes, {k7} of them K7), replay == eager == the "
                f"eager twin's TRGSWs; {smi}")
        ops.clear_device_key_cache()
        torch.cuda.empty_cache()
    return out


# Phase 14b: the port's defaults; memmac runs to its first full refresh at
# the default period of 16 (cycle 15)
DEFAULT_MEM_CYCLES = 16
K1_K4_K5 = ("tkey.LAUNCHES", "br.STEP_LAUNCHES", "br.LOOP_LAUNCHES")


def phase_default(smi, mem_files):
    """MAC-16 and memmac through the Frontend at the port's defaults (the
    phase list, 14b): decrypted == plain == integers, K3 launched and no
    K1, K4 or K5, route_counts all v3-unrolled, every graph replayed as
    check_replays counts.  Returns a row a run."""
    from iyokan_tpu_torch.engine import tfhe
    from iyokan_tpu_torch.engine.driver import Frontend

    unset = {k: None for k in (*ops.PREP_KNOBS, "IYOKAN_FUSE_LEVELS",
                               "IYOKAN_RAM_REFRESH_PERIOD")}
    mac = {k: os.path.join(WORK, k) for k in ("sk", "ek", "req.plain",
                                              "req.enc")}
    _, _, want_acc = mac_operands(16, SLICE_CYCLES)
    mem_sk = host.SecretKey.load(mem_files["sk"])
    rom, rams, streams = gen_mac.memmac_request(DEFAULT_MEM_CYCLES, SEED)
    mem_plain = packet_mod.PlainPacket(rom={"rom": rom}, ram=rams,
                                       bits=streams)
    want_mem, want_ram = gen_mac.memmac_expected(rom, rams, streams,
                                                 DEFAULT_MEM_CYCLES)
    runs = (("mac16.toml", host.SecretKey.load(mac["sk"]), mac["ek"],
             packet_mod.PlainPacket.load(mac["req.plain"]),
             packet_mod.TFHEPacket.load(mac["req.enc"]), SLICE_CYCLES),
            ("memmac.toml", mem_sk, mem_files["ek"], mem_plain,
             mem_plain.encrypt(mem_sk, seed=SEED + 6), DEFAULT_MEM_CYCLES))
    out = []
    for bp_name, sk, ek_path, plain_req, req, cycles in runs:
        bp_path = os.path.join(ROOT, "tests", "data", bp_name)
        plain_fe = Frontend("plain", Blueprint(bp_path), plain_req,
                            device="cuda")
        plain_fe.go(cycles)
        plain = plain_fe.make_result_packet()
        ops.clear_device_key_cache()
        tfhe.clear_engine_cache()     # check_replays counts a fresh engine's
        with knobs(**unset):
            ek = host.EvalKey.load(ek_path)
            reset_launches()
            with timing.cycle_log() as lines, engine_calls() as calls:
                fe = Frontend("tfhe", Blueprint(bp_path), req, eval_key=ek,
                              device="cuda")
                fe.go(cycles)
                res = fe.make_result_packet()
            eng = fe.engine
            eager, replayed = tfhe.launch_counts(), eng.graph_launches()
            counts = {flag: tfhe.route_counts(eng, refresh=flag)
                      for flag in ((False, True) if eng.d.ram_insts
                                   else (True,))}
        check_replays("default", bp_name, eng.graph_stats(), calls)
        keys = eng.keys
        if not keys.port_routing or keys.bk_tk is not None:
            raise AssertionError(f"default {bp_name}: keys not on the port's "
                                 "rule, or a slab built")
        dec = res.decrypt(sk)

        def word(bits):
            return sum(int(b) << k for k, b in enumerate(bits))

        want = {"acc": want_acc} if bp_name == "mac16.toml" else want_mem
        for name, v in want.items():
            if not word(dec.bits[name]) == word(plain.bits[name]) == v:
                raise AssertionError(
                    f"default {bp_name} @{name}: encrypted "
                    f"{word(dec.bits[name])} / plain "
                    f"{word(plain.bits[name])} / integers {v}")
        if bp_name == "memmac.toml":
            for name, bits in want_ram.items():
                if not (np.array_equal(dec.ram[name], plain.ram[name])
                        and np.array_equal(dec.ram[name], bits)):
                    raise AssertionError(f"default memmac RAM {name}: "
                                         "encrypted image != plain / "
                                         "integers")
        k3 = eager.get("br3.LAUNCHES", 0) + replayed.get("br3.LAUNCHES", 0)
        others = {k: eager.get(k, 0) + replayed.get(k, 0) for k in K1_K4_K5}
        routes = {r for c in counts.values() for st in c.values() for r in st}
        level_rot = sum(c["rotations"] for c in counts[True].get(
            "levels", {}).values())
        if routes != {"v3-unrolled"} or any(others.values()) or \
                k3 < cycles * level_rot:
            raise AssertionError(
                f"default {bp_name}: routes {routes}, K3 launches {k3} "
                f"(levels alone {level_rot} a cycle x {cycles}), others "
                f"{others}")
        row = {"blueprint": bp_name, "cycles": cycles, "cycles_us": lines,
               "s_per_cycle_last": lines[-1] / 1e6,
               "k3_launches": {"eager": eager.get("br3.LAUNCHES", 0),
                               "replays": replayed.get("br3.LAUNCHES", 0)},
               "route_counts": {("refresh" if f else "no_refresh"): c
                                for f, c in counts.items()},
               "graphs": len(eng.graph_stats())}
        out.append(row)
        say("default", f"{bp_name} x {cycles} cycles at the port's defaults "
            f"(no PREP_KNOBS, FUSE and refresh period unset): decrypted == "
            f"plain == integers; K3 launches {row['k3_launches']}, K1/K4/K5 "
            f"{others}; route_counts a cycle {row['route_counts']}; "
            f"{row['graphs']} graphs; cycles (us) {lines}; {smi}")
        del fe, eng, keys
        ops.clear_device_key_cache()
        tfhe.clear_engine_cache()
        torch.cuda.empty_cache()
    return out


def cb_graph_times(files, G, reps=3):
    """Circuit bootstrapping of G encrypted bits (memmac's address bits a
    cycle) on the card, run eagerly and as the replay of one CUDA graph
    with K7 in it: (eager s, replay s, kernel nodes, K7 launches the
    capture holds); the replay's TRGSWs == the eager ones == those of the
    eager twin (blind_rotate2_ref in K7's place).  Host clock around
    synced eager calls, CUDA events around the replays."""
    from iyokan_tpu_torch.engine import tfhe

    p = params.CGGI128
    sk, ek = host.SecretKey.load(files["sk"]), host.EvalKey.load(files["ek"])
    dk = ops.DeviceKeys.from_evalkey(ek, "cuda")
    rng = np.random.default_rng(SEED + 5)
    ct = ops.u32_tensor(host.encrypt_bits(
        sk, rng.integers(0, 2, G, dtype=np.uint8), rng), "cuda")

    def cb():
        return ops.circuit_bootstrap(ct, dk.bk2, dk.pksk_f64, p)

    with swapped(br2, "br2", lambda st, acc, bk2, p_:
                 br2.blind_rotate2_ref(st, acc, bk2, p_)):
        want = cb()
    got_eager = cb()
    torch.cuda.synchronize()
    if not torch.equal(got_eager, want):
        raise AssertionError("CB on K7 != CB on its twin")
    t0 = time.time()
    for _ in range(reps):
        cb()
    torch.cuda.synchronize()
    eager = (time.time() - t0) / reps
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = br2.LAUNCHES
    with torch.cuda.graph(graph):
        got = cb()
    k7 = br2.LAUNCHES - before
    graph.instantiate()
    replay = timing.timed_ms(graph.replay, reps, "cuda") / 1e3
    torch.cuda.synchronize()
    if k7 != 1 or not torch.equal(got, want):
        raise AssertionError(f"CB replayed from a graph ({k7} K7 launches "
                             "captured) != CB on the twin")
    nodes = tfhe.graph_nodes(graph)
    del graph, got
    torch.cuda.empty_cache()
    return eager, replay, None if nodes is None else nodes[1], k7


@contextlib.contextmanager
def swapped(mod, name, fn):
    """mod.name replaced by fn for a block."""
    real = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, real)


@contextlib.contextmanager
def engine_calls():
    """The settles the Frontend makes in a block, in order: one record a
    settle, with its refresh flag, whether it ran eagerly (a timer, a
    progress callback or IYOKAN_PROFILE), the execution mode, whether the
    engine has RAMs, and its memory levels."""
    from iyokan_tpu_torch.engine.tfhe import TFHEEngine

    calls, settle = [], TFHEEngine.settle

    def on_settle(eng, vals, rams, roms, timer=None, progress=None,
                  ram_refresh=True):
        calls.append({"flag": bool(ram_refresh),
                      "eager": timer is not None or progress is not None
                      or bool(os.environ.get("IYOKAN_PROFILE")),
                      "mode": os.environ.get("IYOKAN_FUSE_LEVELS", "8"),
                      "ram": bool(eng.d.ram_insts),
                      "mems": [lv for lv, m in enumerate(eng._mems)
                               if m is not None]})
        return settle(eng, vals, rams, roms, timer, progress, ram_refresh)

    TFHEEngine.settle = on_settle
    try:
        yield calls
    finally:
        TFHEEngine.settle = settle


def check_replays(label, tag, graphs, calls):
    """Every graph ran eagerly at its first use, was captured at its second
    and replayed at each later one: a graph used k >= 2 times replayed
    k - 1 times, and one used once was not captured.  The uses come from
    the settles (engine_calls): at IYOKAN_FUSE_LEVELS = N > 1 or all each
    level group and memory level once a settle, each RAM write once a
    settle of its refresh flag."""
    uses, settles = {}, 0

    def use(name):
        uses[name] = uses.get(name, 0) + 1

    for c in calls:
        if c["eager"] or c["mode"] == "1":
            continue
        settles += 1
        for lv in c["mems"]:
            use(f"memory level {lv}")
        if c["ram"]:
            use(f"RAM write (refresh={c['flag']})")
    want = {n: k - 1 for n, k in uses.items() if k > 1}
    got = {g["name"]: g["replays"] for g in graphs
           if not g["name"].startswith("level group")}
    grp = [g["replays"] for g in graphs
           if g["name"].startswith("level group")]
    if not graphs or got != want or bool(grp) != (settles > 1) or any(
            n != settles - 1 for n in grp):
        raise AssertionError(f"fusion {label} {tag}: replays {got} and "
                             f"{grp} of the level groups, want {want} and "
                             f"{settles - 1} each, for the settles' refresh "
                             f"flags {[c['flag'] for c in calls]}")


# Phase 15: the gate-batch mesh (iyokan_tpu_torch/parallel) on the one card
MESH_NAND_SHARDS = 4     # 2048 NANDs: 4 shards of 512 rows, K1's wgmma form
MESH_FUSED_SHARDS = 2    # MAC-16 and memmac in groups of 8 levels


def k1_bound(p, G):
    """The bound of K1 (fat slab, the route's default knobs) at G rows:
    (ms, what sets it)."""
    L, _, lb = ops.tkey_default_config(p)
    RT, C = (p.l + lb) * p.N, 2 * L * 128
    io = G * (p.n + 1) * 4 + p.N * 4 + G * 2 * p.N * 4
    return bound(2 * p.n * G * (p.N // 128) * RT * C, INT8_OPS_PER_S,
                 p.n * RT * C + io)


@contextlib.contextmanager
def recorded(mod, name, log, rows_of):
    """mod.name wrapped to append rows_of(args) to log for each call."""
    real = getattr(mod, name)

    def rec(*args):
        log.append(rows_of(*args))
        return real(*args)

    setattr(mod, name, rec)
    try:
        yield
    finally:
        setattr(mod, name, real)


def phase_mesh(smi, mem_files, fusion):
    """The mesh on the card: 2048 NANDs under make_mesh(4) == the unsharded
    batch byte for byte, 0 wrong, K1 launched once a shard at 512 rows;
    MAC-16 (tkey) and memmac x 3 cycles under make_mesh(2) at FUSE=8:
    each packet == phase 14's FUSE=1 packet, memmac's 4096-row refresh
    split; then the error-rate tool at its defaults on the tkey route."""
    from iyokan_tpu_torch.parallel import mesh as mesh_mod
    from iyokan_tpu_torch.tools import measure_error_rate

    p = params.CGGI128
    f = {k: os.path.join(WORK, k) for k in ("sk", "ek", "req.enc")}
    sk, ek = host.SecretKey.load(f["sk"]), host.EvalKey.load(f["ek"])
    dk = ops.DeviceKeys.from_evalkey(ek, "cuda", with_cb=False)
    G, n = 2048, MESH_NAND_SHARDS
    pre, want = nand_inputs(p, sk, np.random.default_rng(SEED + 11), G)

    def nand():
        lvl1 = ops.gate_bootstrap_tlwe1(pre, dk.bk_for(G), p)
        return ops.keyswitch_10(lvl1, dk.ksk_f64, p)

    whole = nand()
    ms_whole = cuda_ms(nand, 3)
    rows = []
    mesh_mod.set_mesh(mesh_mod.make_mesh(n))
    try:
        with recorded(tkey, "blind_rotate_tkey", rows,
                      lambda t, *a: t.shape[0]):
            reset_launches()
            sharded = nand()
            torch.cuda.synchronize()
            counts = (tkey.LAUNCHES, dict(tkey.FORM_LAUNCHES),
                      all_launches())
        ms_mesh = cuda_ms(nand, 3)
    finally:
        mesh_mod.set_mesh(None)
    if counts != (n, {"loop": 0, "wgmma": n, "mma": 0}, n) or \
            rows != [G // n] * n:
        raise AssertionError(f"mesh: 2048 NANDs on {n} shards launched "
                             f"{counts} (K1, by form, all) on rows {rows}")
    if not torch.equal(sharded, whole):
        raise AssertionError("mesh: 2048 NANDs on 4 shards != unsharded")
    wrong = int((host.decrypt_bits(sk, ops.u32_numpy(sharded))
                 != want).sum())
    if wrong:
        raise AssertionError(f"mesh: {wrong}/{G} wrong NANDs")
    rate_whole, rate_mesh = G / (ms_whole / 1e3), G / (ms_mesh / 1e3)
    say("mesh", f"{G} NANDs under make_mesh({n}): == the unsharded batch "
        f"byte for byte, 0 wrong; K1 launched {counts[0]} times ({n} "
        f"wgmma-form, rows {rows}); gate_bootstraps_per_sec "
        f"{rate_mesh:.1f} sharded ({ms_mesh:.2f} ms a batch) vs "
        f"{rate_whole:.1f} whole ({ms_whole:.2f} ms); {smi}")
    # K1 at a shard's rows against its twin
    testv = torch.full((p.N,), p.mu, dtype=torch.int32, device="cuda")
    part = pre[:G // n]
    err = max_diff(tkey.blind_rotate_tkey(part, dk.bk_tk, testv, p),
                   tkey.blind_rotate_tkey_ref(part, dk.bk_tk, testv, p))
    if err:
        raise AssertionError(f"mesh: K1 != twin at G={G // n}: {err}")
    k_ms = cuda_ms(lambda: tkey.blind_rotate_tkey(part, dk.bk_tk, testv, p),
                   3)
    t_ms = cuda_ms(
        lambda: tkey.blind_rotate_tkey_ref(part, dk.bk_tk, testv, p), 1)
    b_ms, b_by = k1_bound(p, G // n)
    k1 = {"name": f"tkey_blind_rotate (mesh phase: {n} shards of "
                  f"{G // n} rows)", "route": "cuda",
          "source": "iyokan_tpu_torch/csrc/tkey_blind_rotate.cu",
          "replaces": "iyokan_tpu/ops/pallas_tk.py:219", "launches": n,
          "max_abs_err": err, "ms": k_ms, "plain_ms": t_ms,
          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
          "at_G": G // n}
    say("mesh", f"K1 at a shard's {G // n} rows: == twin, {k_ms:.3f} ms "
        f"(twin {t_ms:.1f} ms, bound {b_ms:.3f} ms by {b_by})")
    del dk, pre, whole, sharded, part
    ops.clear_device_key_cache()
    torch.cuda.empty_cache()

    out = {"nands": {"shards": n, "rows": rows, "ms_sharded": ms_mesh,
                     "ms_whole": ms_whole, "rate_sharded": rate_mesh,
                     "rate_whole": rate_whole}, "fused": []}
    for label, bp_name, files, route in (
            ("tkey", "mac16.toml", f, {}),
            ("memmac", "memmac.toml", mem_files,
             {"IYOKAN_RAM_REFRESH_PERIOD": "2"})):
        bp_path = os.path.join(ROOT, "tests", "data", bp_name)
        req = packet_mod.TFHEPacket.load(files["req.enc"])
        r_ek = host.EvalKey.load(files["ek"])
        splits = []
        mesh_mod.set_mesh(mesh_mod.make_mesh(MESH_FUSED_SHARDS))
        try:
            with recorded(mesh_mod, "_all_gather", splits,
                          lambda m, t, axis: t.shape[axis]):
                res, lines, graphs, _, replayed, _ = fused_run(
                    bp_path, req, r_ek, {**route, **FUSE8}, SLICE_CYCLES)
        finally:
            mesh_mod.set_mesh(None)
        path = os.path.join(WORK, f"mesh.{label}.res")
        res.save(path)
        with open(path, "rb") as a, open(
                os.path.join(WORK, f"fusion.{label}.1.res"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"mesh {label}: result packet under "
                                     "make_mesh(2) != the FUSE=1 packet")
        if not splits or (label == "memmac" and 4096 not in splits):
            raise AssertionError(f"mesh {label}: batches split {splits}")
        ref = next(r for r in fusion
                   if r["route"] == label and r["mode"] == FUSE8)
        row = {"route": label, "shards": MESH_FUSED_SHARDS,
               "s_per_cycle": lines[-1] / 1e6,
               "no_mesh_s_per_cycle": ref["s_per_cycle"],
               "cycles_us": lines, "split_rows": sorted(set(splits)),
               "nodes": [g["nodes"] for g in graphs],
               "graph_launches": replayed}
        out["fused"].append(row)
        say("mesh", f"{label} {bp_name} x {SLICE_CYCLES} cycles under "
            f"make_mesh({MESH_FUSED_SHARDS}), FUSE=8: packet == "
            f"FUSE=1's byte for byte; {row['s_per_cycle']:.4f} s/cycle "
            f"(no mesh {ref['s_per_cycle']:.4f}); batches split (rows) "
            f"{row['split_rows']}; graph nodes {row['nodes']} (no mesh "
            f"{ref['nodes']}); launches by replays {replayed}; {smi}")
        ops.clear_device_key_cache()
        torch.cuda.empty_cache()

    with knobs(ER_G=None, ER_BATCHES=None, ER_CASCADE=None, ER_PARAMS=None,
               IYOKAN_BR_IMPL="tkey",
               ER_OUT=os.path.join(WORK, "error_rate.tkey.json")):
        rec = measure_error_rate.main()
    ops.clear_device_key_cache()
    torch.cuda.empty_cache()
    out["error_rate"] = rec
    say("mesh", f"error rate (tkey, ER defaults): {rec['gates']} gates, "
        f"{rec['wrong']} wrong; cascade {rec['cascade_gates']} gates, "
        f"{rec['cascade_wrong']} wrong; sigma 2^{rec['sigma_log2']:.3f}, "
        f"margin {rec['margin_sigmas']:.2f} sigma; "
        f"{(rec['gates'] + rec['cascade_gates']) / rec['gate_s']:.1f} "
        f"gates/s; {json.dumps(rec)}")
    return out, k1


# Phase 16: the microbenchmark tools (T1-T3) at their own full shapes
MICRO_STEPS, MICRO_INNER, MICRO_G = 100, 200, 1024
# rounds a timed launch of the elementwise and small-K loops: at 0.06-1.4 us
# a round, the tools' 200 last 12-280 us, short enough for event jitter to
# move the difference method by percents
TIME_INNER = 2000
T1_BG = (512, 2048)
# the Pallas kernel (or, for the elementwise bodies, the body) each record
# replaces
T1_LINES = {"fat": 40, "thin": 50, "pure": 64, "puret": 83}
PK_LINES = {"vpu": 305, "f32": 315, "barrett": 325, "roll": 336,
            "i16": 349, "i32var": 359, "conv": 370, "select": 380}


# round counts off the kernels' unrolling, held against the twins beside
# INNER: alu_kernel (ALU_UNROLL), roll_kernel (ROLL_PERIOD), smallk_kernel
# (two rounds an iteration)
OFF_UNROLL = {"alu": (1, micro.ALU_UNROLL + 1, 2 * micro.ALU_UNROLL + 3),
              "roll": (1, micro.ROLL_PERIOD + 1, 2 * micro.ROLL_PERIOD + 3),
              "smallk": (1, 3)}

# The elementwise bodies' bound: the fewest instructions one round of a
# body issues on an element in an exact form, by the pipe each goes to,
# against the per-SM rates of the CUDA C++ Programming Guide's throughput
# table at compute capability 9.0: 64 a clock on the integer ALU pipe
# (compare, logic, add), 64 IMAD, 128 FFMA / FMUL / FADD, and 4 x 32
# instructions issued.  "either": an add, which issues on the ALU pipe or
# as IMAD; "cvt": I2F, counted only as an issue slot (a lower bound).
PIPE_LANES = {"alu": 64, "imad": 64, "ffma": 128}
DISPATCH_LANES = 128
BODY_MIX = {
    "vpu": dict(imad=5, alu=1),               # 5 x IMAD, LOP3
    "f32": dict(ffma=5, alu=1),               # 5 x FFMA, FMNMX
    # I2F, FMUL, FADD (the round), IMAD (x - q p), add (+ 2^21)
    "barrett": dict(cvt=1, ffma=2, imad=1, either=1),
    "roll": dict(imad=1),                     # r (1 - 2m) + 1
    "i16": dict(imad=5),                      # 5 x IMAD (mod 2^16)
    "i32var": dict(imad=5, alu=5),            # 5 x (IMAD, LOP3)
    "conv": dict(cvt=1, ffma=2, either=1),    # I2F, FMUL, FADD, IADD3
    "select": dict(alu=5, either=5),          # 5 x (compare, guarded add)
}


def issue_bound(mix, n_elems, nbytes):
    """(bound ms, "operations" or "bytes") of n_elems element-rounds of the
    instruction mix `mix` (BODY_MIX) at the pipes' rates on 132 SMs at the
    1.98 GHz boost clock, or of nbytes at the HBM rate."""
    total = sum(mix.values())
    ints = mix.get("alu", 0) + mix.get("imad", 0) + mix.get("either", 0)
    clocks = max([total / DISPATCH_LANES, ints / (PIPE_LANES["alu"]
                                               + PIPE_LANES["imad"])]
                 + [mix.get(p, 0) / n for p, n in PIPE_LANES.items()])
    t_ops = clocks * n_elems / (132 * 1.98e9)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def micro_check(label, kfn, tfn, sets, per=1):
    """kfn(*ins) against tfn(*ins), every output, on each input set; raises
    unless bit-identical.  Returns (the twin's ms on the first set / per,
    the max |diff| over all sets)."""
    twin_ms, err = None, 0.0
    for which, ins in sets:
        got = kfn(*ins)
        torch.cuda.synchronize()
        want, t_ms = timed(lambda: tfn(*ins))
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            d = float((g.double() - w.double()).abs().max())
            if d or not torch.equal(g, w):
                raise AssertionError(f"micro {label} != twin on {which} "
                                     f"inputs: max |diff| {d}")
            err = max(err, d)
        twin_ms = t_ms if twin_ms is None else twin_ms
    return twin_ms / per, err


def int_mm_lib(a_shape, b_shape, bt=False):
    """(ms of one torch._int_mm on random int8 operands, None) or (None,
    why it refused the shape); bt: b made as b_shape and passed
    transposed (column-major)."""
    a = torch.randint(-128, 128, a_shape, dtype=torch.int8, device="cuda")
    b = torch.randint(-128, 128, b_shape, dtype=torch.int8, device="cuda")
    b = b.t() if bt else b
    try:
        return timing.int_mm_ms(a, b, 5), None
    except RuntimeError as e:
        return None, str(e).strip().splitlines()[0][:160]


def marginal_ms(run, inner):
    """ms per round of run(n) by the tools' difference method, after 0.2 s
    of run(inner) (timing.marginal: the card idles while a twin runs)."""
    return timing.marginal(run, inner, "cuda", warm_s=0.2) * 1e3


def rand_i8(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape,
                                         dtype=np.int8)).cuda()


def ones_i8(shape):
    return torch.ones(shape, dtype=torch.int8, device="cuda")


def sass_text(path):
    """cuobjdump -sass of a built library; raises when cuobjdump is
    missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise FileNotFoundError("cuobjdump (CUDA toolkit) not found: the "
                                "smoke run prints the kernels' SASS mix")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


# the int8 product kernels: mangled-name piece -> form; the wgmma forms
# must hold warpgroup MMA instructions
PRODUCT_KERNELS = {"tkey_loop_kernel": "wgmma",
                   "conv_wgmma_kernel": "wgmma", "mm_step_kernel": "wgmma",
                   "conv_kernel": "mma.sync"}


def sass_products(path):
    """{kernel instance: {opcode: count}} over the whole function of each
    int8 product kernel in the built library (instances by their template
    arguments, e.g. conv_wgmma_kernel<3,0>); raises if a wgmma form has no
    GMMA instruction (IGMMA on int8)."""
    out = {}
    for fn in sass_text(path).split("Function : ")[1:]:
        name = fn.split()[0]
        kind = next((k for k in PRODUCT_KERNELS
                     if re.search(rf"\d{k}I", name)), None)
        if kind is None:
            continue
        args = ",".join(re.findall(r"Li(\d+)E", name.split(kind, 1)[1])[:3])
        ops_ = {}
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)[^;]*;", fn):
            ops_[m.group(1)] = ops_.get(m.group(1), 0) + 1
        label = f"{kind}<{args}>"
        out[label] = dict(sorted(ops_.items(), key=lambda kv: -kv[1]))
        if (PRODUCT_KERNELS[kind] == "wgmma"
                and not any("GMMA" in op for op in ops_)):
            raise AssertionError(f"{label} holds no warpgroup MMA (GMMA) "
                                 "instruction: the wgmma form was not built "
                                 "for sm_90a")
    if not any(PRODUCT_KERNELS[k.split("<")[0]] == "wgmma" for k in out):
        raise AssertionError(f"no wgmma product kernel found in {path}")
    return out


def sass_loops(path):
    """{kernel: {opcode: count}} of the main loop of each elementwise and
    small-K kernel in the built library, from cuobjdump -sass: the largest
    innermost loop (from a backward branch's target to the branch, holding
    no other backward branch), which in alu_kernel is ALU_UNROLL rounds of
    its 16 bytes of elements, in roll_kernel ROLL_PERIOD rounds of its
    words and in smallk_kernel the round loop.  Raises if a kernel is
    missing."""
    text = sass_text(path)
    names = {f"alu_kernelILi{i}E": f"alu {b}"
             for b, (i, *_rest) in micro.BODIES.items() if i is not None}
    names.update({"roll_kernel": "roll", "smallk_kernel": "smallk"})
    out = {}
    for fn in text.split("Function : ")[1:]:
        label = next((v for k, v in names.items() if k in fn.split()[0]),
                     None)
        if label is None:
            continue
        seq, loops = [], []     # seq: (address, opcode); loops: (lo, hi)
        for line in fn.splitlines():
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_]*)([^;]*);", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            seq.append((addr, m.group(2)))
            t = re.match(r"\s*(0x[0-9a-f]+)", m.group(3))
            if m.group(2) == "BRA" and t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo <= l2 and h2 < hi for l2, h2 in loops)]
        lo, hi = max(inner, key=lambda lh: lh[1] - lh[0],
                     default=(0, seq[-1][0] if seq else 0))
        ops_ = {}
        for addr, op in seq:
            if lo <= addr <= hi:
                ops_[op] = ops_.get(op, 0) + 1
        out[label] = dict(sorted(ops_.items(), key=lambda kv: -kv[1]))
    missing = sorted(set(names.values()) - set(out))
    if missing:
        raise AssertionError(f"no SASS for {missing} in {path}")
    return out


def ptxas_usage(src, pieces):
    """{piece: ptxas -v's resource line} for each kernel of csrc/<src>
    whose mangled name holds a piece (the build of this run)."""
    out, cur = {}, None
    for ln in nvcc.LOGS.get(src, "").splitlines():
        if "Compiling entry function" in ln:
            cur = next((p for p in pieces if p in ln), None)
        elif cur and ("spill" in ln or "Used" in ln):
            out[cur] = (out.get(cur, "") + " " + ln.split(":", 1)[-1].strip()
                        ).strip()
    return out


def phase_micro(smi):
    """T1-T3 on the card: the tools' entry points as a user runs them (the
    path, launches counted from 0), then every kernel against its twin at
    the tools' full shapes on seeded random and the tools' all-ones inputs
    (max |diff| 0, or it raises), timed beside its bound, its twin and
    torch._int_mm on the same per-step product where that takes it."""
    t_phase = time.time()
    mixes = sass_loops(nvcc.lib_path(micro.SOURCE))
    for label, mix in mixes.items():
        say("micro", f"SASS inner loop of {label}: {json.dumps(mix)}")
    pieces = ["smallk_kernel", "roll_kernel"] + [
        f"alu_kernelILi{i}E" for i, *_ in micro.BODIES.values()
        if i is not None]
    for piece, use in ptxas_usage(micro.SOURCE, pieces).items():
        say("micro", f"ptxas -v, {piece}: {use}")
    micro.LAUNCHES.clear()
    with knobs(BENCH_G=str(MICRO_G), BENCH_INNER=str(MICRO_INNER),
               BENCH_ITERS="20"):
        for BG in T1_BG:
            tk_mm_bench.main([str(BG), str(MICRO_STEPS), "1", "puret",
                              "pure", "fat", "thin"])
        tk_width_bench.main(["512", str(MICRO_STEPS), "1"])
        microbench.main(["mmp"] + [f"pk_{b}" for b in micro.BODIES]
                        + ["pk_mm", "pk_smallk", "pk_bdot"])
    torch.cuda.synchronize()
    path = dict(micro.LAUNCHES)
    say("micro", f"launches on the tools' path: {json.dumps(path)}")
    rng = np.random.default_rng(SEED + 14)
    S, I = MICRO_STEPS, MICRO_INNER
    recs = []

    def record(name, replaces, key, k_ms, checked, n_ops, peak, io, per,
               lib=(None, "no single PyTorch call"), l2=None, tops="TOP/s",
               bnd=None):
        """l2: the L2 bytes a step the kernel's tiling implies
        (micro.l2_bytes_per_step), printed as computed, not measured; bnd:
        the bound (ms, by) where it is not n_ops at peak beside io (the
        elementwise bodies: issue_bound; n_ops then gives only the printed
        rate, in the tool's own count)."""
        if not path.get(key):
            raise AssertionError(f"micro {name}: no launch of {key!r} on the "
                                 "tools' path")
        t_ms, err = checked
        b_ms, b_by = bnd or bound(n_ops, peak, io)
        lib_ms, why = lib
        recs.append({"name": f"micro {name}", "route": "cuda",
                     "source": f"iyokan_tpu_torch/csrc/{micro.SOURCE}",
                     "replaces": replaces, "launches": path[key],
                     "max_abs_err": err, "ms": k_ms, "plain_ms": t_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "per": per})
        say("micro", f"{name}: == twin on random and all-ones inputs; "
            f"{path[key]} launches on the path; "
            f"{k_ms * 1e3:.2f} us/{per}, {n_ops / (k_ms / 1e3) / 1e12:.2f} "
            f"{tops} = {b_ms / k_ms:.3f} of the bound ({b_by}); twin "
            f"{t_ms * 1e3:.1f} us/{per}"
            + (f"; L2 {l2 / 1e6:.2f} MB/{per} computed from the tiling (at "
               f"this time {l2 / (k_ms / 1e3) / 1e12:.2f} TB/s)" if l2
               else "")
            + (f"; torch._int_mm {lib_ms * 1e3:.2f} us" if lib_ms is not None
               else f"; library_ms null: {why}") + f" on {smi}")

    for BG in T1_BG:
        for mode in micro.MODES:
            xs = (BG, 6, 2048) if mode == "thin" else (BG, 12288)
            rs = {"thin": (1024, 768), "puret": (768, 6144)}.get(
                mode, (6144, 768))
            x, rhs = rand_i8(rng, xs), rand_i8(rng, rs)
            checked = micro_check(
                f"tk_loop {mode} BG={BG}",
                lambda a, b: micro.tk_loop(a, b, S, mode),
                lambda a, b: micro.tk_loop_ref(a, b, S, mode),
                [("random", (x, rhs)), ("all-ones", (ones_i8(xs),
                                                     ones_i8(rs)))], S)
            k_ms = cuda_ms(lambda: micro.tk_loop(x, rhs, S, mode), 2) / S
            rows, k = (48 * BG, 1024) if mode == "thin" else (8 * BG, 6144)
            lib = int_mm_lib((rows, k), rs, bt=mode == "puret")
            out_b = x.numel() if mode in ("fat", "thin") else BG * 768 * 4
            record(f"tk_loop {mode} BG={BG}",
                   f"tools/tk_mm_bench.py:{T1_LINES[mode]}",
                   micro.launch_key("tk_loop", mode, BG), k_ms, checked,
                   2 * rows * k * 768, INT8_OPS_PER_S,
                   (x.numel() + rhs.numel() + out_b) / S, "step", lib,
                   micro.l2_bytes_per_step(micro.tk_config(x, rhs, mode)))
    BG = 512
    for short, _, (K, NO, nd) in tk_width_bench.CASES:
        x, rhs = rand_i8(rng, (BG, K + 128 * nd)), rand_i8(rng, (K, NO))
        checked = micro_check(
            f"width_loop {short}",
            lambda a, b: micro.width_loop(a, b, S, nd),
            lambda a, b: micro.width_loop_ref(a, b, S, nd),
            [("random", (x, rhs)),
             ("all-ones", (ones_i8(x.shape), ones_i8(rhs.shape)))], S)
        k_ms = cuda_ms(lambda: micro.width_loop(x, rhs, S, nd), 2) / S
        record(f"width_loop {short} BG={BG}", "tools/tk_width_bench.py:48",
               micro.launch_key("width_loop", K, NO, nd), k_ms, checked,
               2 * nd * BG * K * NO, INT8_OPS_PER_S,
               (x.numel() + rhs.numel() + BG * 128 * 4) / S, "step",
               int_mm_lib((nd * BG, K), (K, NO)),
               micro.l2_bytes_per_step(micro.width_config(x, rhs, nd)))

    # T3a: one launch a step; T3c, T3e: INNER rounds a launch
    M = 6 * MICRO_G
    a, b = rand_i8(rng, (M, 1024)), rand_i8(rng, (1024, 1024))
    checked = micro_check(
        "mm_mask mmp", lambda u, v: micro.mm_mask(u, v, 127, 1),
        lambda u, v: micro.mm_mask_ref(u, v, 127, 1),
        [("random", (a, b)), ("all-ones", (ones_i8(a.shape),
                                           ones_i8(b.shape)))])
    k_ms = cuda_ms(lambda: micro.mm_mask(a, b, 127, 1), 10)
    record("mm_mask mmp", "tools/microbench.py:78",
           micro.launch_key("mm_mask", M, 1024), k_ms, checked,
           2 * M * 1024 * 1024, INT8_OPS_PER_S, 2 * a.numel() + b.numel(),
           "launch", int_mm_lib((M, 1024), (1024, 1024)),
           micro.l2_bytes_per_step(micro.mm_config(a, b, 127)))
    for name, line, ash, bsh, mask, lib in (
            ("pk_mm", 398, (3072, 1024), (1024, 1024), 127,
             int_mm_lib((3072, 1024), (1024, 1024))),
            ("pk_bdot", 472, (8, 768, 128), (8, 128, 128), 63,
             (None, "no PyTorch call takes a batched int8 product with "
                    "int32 sums (torch.bmm has no int8 form on CUDA)"))):
        a, b = rand_i8(rng, ash), rand_i8(rng, bsh)
        checked = micro_check(
            f"mm_mask {name}", lambda u, v: micro.mm_mask(u, v, mask, I),
            lambda u, v: micro.mm_mask_ref(u, v, mask, I),
            [("random", (a, b)), ("all-ones", (ones_i8(ash),
                                               ones_i8(bsh)))], I)
        k_ms = marginal_ms(lambda n: micro.mm_mask(a, b, mask, n), I)
        macs = a.numel() * bsh[-1]
        record(f"mm_mask {name}", f"tools/microbench.py:{line}",
               micro.launch_key("mm_mask", *ash), k_ms, checked, 2 * macs,
               INT8_OPS_PER_S, (2 * a.numel() + b.numel()) / I, "inner", lib,
               micro.l2_bytes_per_step(micro.mm_config(a, b, mask)))
    # T3d: K = 8 on mma.sync, INNER rounds a launch
    w, a = rand_i8(rng, (8, 8)), rand_i8(rng, (8, 3072, 128))
    checked = micro_check(
        "smallk_loop", lambda u, v: micro.smallk_loop(u, v, I),
        lambda u, v: micro.smallk_loop_ref(u, v, I),
        [("random", (w, a)), ("all-ones", (ones_i8(w.shape),
                                           ones_i8(a.shape)))], I)
    for n in OFF_UNROLL["smallk"]:       # round counts off the unrolling
        micro_check(f"smallk_loop inner={n}",
                    lambda u, v: micro.smallk_loop(u, v, n),
                    lambda u, v: micro.smallk_loop_ref(u, v, n),
                    [("random", (w, a)), ("all-ones", (ones_i8(w.shape),
                                                       ones_i8(a.shape)))])
    k_ms = marginal_ms(lambda n: micro.smallk_loop(w, a, n), TIME_INNER)
    Y = a[0].numel()
    record("smallk_loop pk_smallk", "tools/microbench.py:435",
           micro.launch_key("smallk_loop"), k_ms, checked, 2 * 8 * a.numel(),
           INT8_OPS_PER_S, (2 * a.numel() + 64) / I, "inner",
           int_mm_lib((Y, 8), (8, 8)))
    say("micro", f"smallk_loop: the block-diagonal form's own floors a "
        f"round: its {micro.SMALLK_GROUPS}x MACs at the int8 peak "
        f"{2 * 8 * a.numel() * micro.SMALLK_GROUPS / INT8_OPS_PER_S * 1e6:.4f}"
        f" us, its packing (one ALU-pipe instruction a result byte) "
        f"{issue_bound(dict(alu=1), a.numel(), 0)[0] * 1e3:.4f} us; "
        f"measured {k_ms * 1e3:.4f} us on {smi}")
    # T3b: the elementwise bodies
    for body, (_, dtype, per_elem, _) in micro.BODIES.items():
        ins = micro.alu_operands(body, "cuda", rng)
        sets = [("random", ins),
                ("all-ones", micro.alu_operands(body, "cuda"))]
        checked = micro_check(
            f"alu_loop {body}",
            lambda *u: micro.alu_loop(u[0], body, I, *u[1:]),
            lambda *u: micro.alu_loop_ref(u[0], body, I, *u[1:]), sets, I)
        for n in OFF_UNROLL["roll" if body == "roll" else "alu"]:
            micro_check(f"alu_loop {body} inner={n}",
                        lambda *u: micro.alu_loop(u[0], body, n, *u[1:]),
                        lambda *u: micro.alu_loop_ref(u[0], body, n, *u[1:]),
                        sets)
        k_ms = marginal_ms(lambda n: micro.alu_loop(ins[0], body, n,
                                                    *ins[1:]), TIME_INNER)
        io = (2 * ins[0].nbytes + sum(e.nbytes for e in ins[1:])) / I
        record(f"alu_loop {body}", f"tools/microbench.py:{PK_LINES[body]}",
               micro.launch_key("alu_loop", body), k_ms, checked,
               ins[0].numel() * per_elem,
               FP32_OPS_PER_S if dtype == torch.float32 else INT32_OPS_PER_S,
               io, "inner", (None, "no single PyTorch call runs the INNER-"
                                   "round chain (eager torch launches a "
                                   "kernel per op)"),
               tops="Tops/s",
               bnd=issue_bound(BODY_MIX[body], ins[0].numel(), io))
        # the loop's multiply-adds as issued: the main loop's SASS count
        # (ALU_UNROLL rounds of a thread's 16 bytes; roll: ROLL_PERIOD
        # rounds of its ROLL_PERIOD words) over those element-rounds x
        # elements / time a round
        per_iter = (micro.ROLL_PERIOD ** 2 if body == "roll" else
                    micro.ALU_UNROLL * 16 // ins[0].element_size())
        label = "roll" if body == "roll" else f"alu {body}"
        for op, lanes in (("IMAD", INT32_MULS_PER_S),
                          ("FFMA", FP32_OPS_PER_S / 2)):
            n_op = mixes[label].get(op, 0) / per_iter
            if n_op:
                rate = n_op * ins[0].numel() / (k_ms / 1e3)
                say("micro", f"alu_loop {body}: {n_op:.4g} {op} a round an "
                    f"element in SASS -> {rate:.4g} {op}/s = "
                    f"{rate / lanes:.3f} of the {lanes:.4g}/s lane rate")
    say("micro", f"phase {time.time() - t_phase:.1f} s, {len(recs)} records")
    return recs


def kernel_records(p, times, worst, gate_launches, launches, ep_rows,
                   ep_worst, br_rows, br_gates, k3_launches, tk_layouts,
                   tk_small_launches, unrolled, k7_rows, k7_worst):
    """The kernels' JSON records: launches on each kernel's path (the
    2048-NAND run for tkey_blind_rotate's wgmma form, the memmac run for
    its persistent and mma.sync forms and extprod1_ntt at 2l rows, the
    ntt-unrolled route at G = 64 for extprod1_ntt at 3*2l rows, the
    br-gates runs for K5 and K4, the br-slice run for K3, the tk-layouts
    NAND runs for K2's thin, fat2 and L=4 slabs, the tk-slice run for its
    unrolled slab), max |diff| against the twin over every compared shape,
    ms and twin ms at one shape of that path (G = 2048; K1's small-batch
    forms at the largest batch of phase 3 each takes; K3 at M = 3 and G =
    64, the batch its MAC-16 path runs, and a second K3 record at G = 256,
    MAC-16's widest level; K7 on the unrolled key at memmac's 69 lvl2
    rows, the batch of its run), and the bound of that shape's work."""
    i32 = 4
    G = 2048
    recs = [("tkey_blind_rotate", "tkey_blind_rotate.cu",
             "iyokan_tpu/ops/pallas_tk.py:219", gate_launches,
             worst, next(r for r in times if r["G"] == G), k1_bound(p, G))]
    # the persistent form, at the largest batch of phase 3 below the
    # threshold
    row = max((r for r in times if r["form"] == "loop"), key=lambda r: r["G"])
    recs.append(("tkey_blind_rotate tkey_loop_kernel (persistent form)",
                 "tkey_loop.cuh", "iyokan_tpu/ops/pallas_tk.py:219",
                 launches["tkey loop form"], worst, row,
                 k1_bound(p, row["G"])))
    # the mma.sync form, at the largest batch of phase 3 it takes
    row = max((r for r in times if r["form"] == "mma"), key=lambda r: r["G"])
    recs.append(("tkey_blind_rotate conv_kernel (mma.sync form)",
                 "tkey_blind_rotate.cu", "iyokan_tpu/ops/pallas_tk.py:219",
                 launches["tkey mma form"], worst, row,
                 k1_bound(p, row["G"])))
    RR = 2 * p.l
    for name, rr, g, K, n_launch in (
            ("extprod1_ntt", RR, G, 2, launches["extprod1_ntt"]),
            ("extprod1_ntt RR=3*2l", 3 * RR, unrolled["G"], 1,
             unrolled["launches"])):
        recs.append((name, "extprod1_ntt.cu",
                     "iyokan_tpu/ops/pallas_ep.py:91", n_launch, ep_worst,
                     next(r for r in ep_rows if r["G"] == g and r["K"] == K
                          and r["RR"] == rr),
                     bound(2 * g * ntt_mulmods(p, rr), INT32_MULS_PER_S,
                           g * rr * p.N * i32 + K * rr * 4 * p.N * i32
                           + (g * i32 if K > 1 else 0) + g * 2 * p.N * i32)))
    nh = (p.n + 1) // 2
    for name, src, rep, n_launch, case, G, steps, m in (
            ("br_ntt_step", "br_ntt.cu", "iyokan_tpu/ops/pallas_br.py:109",
             br_gates["br_ntt_step"]["launches"], "br_ntt_step", 2048, p.n,
             0),
            ("br_ntt_loop", "br_ntt.cu", "iyokan_tpu/ops/pallas_br2.py:35",
             br_gates["br_ntt_loop"]["launches"], "br_ntt_loop", 2048, p.n,
             0),
            ("br3_ntt", "br3_ntt.cu", "iyokan_tpu/ops/pallas_br3.py:168",
             k3_launches, "br3_ntt M=3", 64, nh, 3),
            ("br3_ntt G=256", "br3_ntt.cu",
             "iyokan_tpu/ops/pallas_br3.py:168", k3_launches, "br3_ntt M=3",
             256, nh, 3)):
        io = G * (p.n + 1) * i32 + p.N * i32 + G * 2 * p.N * i32
        errs = [r["max_abs_diff"] for r in br_rows
                if r["kernel"].split()[0] == name.split()[0]]
        key_bytes = steps * RR * max(m, 1) * 2 * 2 * p.N * i32
        recs.append((name, src, rep, n_launch, max(errs),
                     next(r for r in br_rows
                          if r["kernel"] == case and r["G"] == G),
                     bound(2 * steps * G * ntt_mulmods(p, RR, m),
                           INT32_MULS_PER_S, key_bytes + io)))
    G = 2048
    io = G * (p.n + 1) * i32 + p.N * i32 + G * 2 * p.N * i32
    for name, r in tk_layouts.items():
        M = 3 if r["layout"] == "unrolled" else 1
        steps = nh if M == 3 else p.n
        RT, C = M * (p.l + r["lb"]) * p.N, 2 * r["L"] * 128
        # a fat2 step holds 2*RT rows, but the work needs only RT of them
        recs.append((f"tkey_blind_rotate {name}", "tkey_blind_rotate.cu",
                     "iyokan_tpu/ops/pallas_tk.py:62",
                     tk_small_launches if M == 3 else r["nand_launches"],
                     max(x["max_abs_diff"] for x in r["rotations"]),
                     next(x for x in r["rotations"] if x["G"] == G),
                     bound(2 * steps * G * (p.N // 128) * RT * C,
                           INT8_OPS_PER_S, steps * RT * C + io)))
    row = next(r for r in k7_rows if r["form"] == "unrolled"
               and r["G"] == 69)
    recs.append(("br2_ntt", "br2_ntt.cu",
                 "none: the JAX fori_loop at iyokan_tpu/crypto/ops.py:464-515",
                 launches["br2_ntt"], k7_worst, row,
                 (row["bound_ms"], row["bound_by"])))
    out = []
    for name, src, rep, n_launch, err, row, (b_ms, b_by) in recs:
        out.append({
            "name": name, "route": "cuda",
            "source": f"iyokan_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": n_launch, "max_abs_err": err,
            "ms": row["kernel_ms"], "plain_ms": row["twin_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "at_G": row["G"],
            **{k: row[k] for k in ("rows_per_cluster", "smem_bytes")
               if k in row}})
    return out


def main() -> int:
    t_start = time.time()
    # no slab files outside phase 14's own measurement (the other
    # phases time every slab build)
    os.environ.setdefault("IYOKAN_SLAB_CACHE", "0")
    # the phases name their routes; unnamed, the JAX package's tkey route
    # (the port's own default is K3 on every gate rotation: br-slice, v3)
    os.environ.setdefault("IYOKAN_BR_IMPL", "tkey")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi, name = phase_device()
    p = params.CGGI128
    caps = phase_build(p)

    rng = np.random.default_rng(SEED)
    sk = host.keygen(p, seed=SEED)
    ek = host.genevalkey(sk, seed=SEED + 1, with_cb=False)
    t0 = time.time()
    dk = ops.DeviceKeys.from_evalkey(ek, "cuda")
    say("kernel", f"slab {tuple(dk.bk_tk.shape)} int8 built + moved in "
        f"{time.time() - t0:.1f} s")
    times, worst = phase_kernel(p, sk, dk, rng)
    form_rows, form_worst, k1_ablation = phase_forms(p, sk, dk, rng, smi)
    worst = max(worst, form_worst)
    rate, _, gate_launches = phase_gates(p, sk, dk, rng, smi)
    k1 = next(r for r in times if r["G"] == 2048)
    say("gates", f"K1 (tkey_blind_rotate, {k1['form']} form) at G=2048: "
        f"{k1['kernel_ms']:.3f} ms a blind rotation, "
        f"{k1['kernel_ms'] * 1e3 / p.n:.1f} us a step; 2048 NANDs: "
        f"gate_bootstraps_per_sec={rate:.1f}; card {smi}")
    ntt = phase_ntt_gates(p, sk, ek, dk, rng, smi)
    del dk
    torch.cuda.empty_cache()

    tk_layouts = phase_tk_layouts(p, sk, ek, rng, smi, rate)

    _, s_cycle = phase_slice(smi)
    tk_small_launches, tk_s_cycle = phase_slice(smi, "tk-slice")
    say("tk-slice", f"MAC-16 {tk_s_cycle:.3f} s/cycle with IYOKAN_TK_SMALL=1 "
        f"(unrolled small-batch slab) vs {s_cycle:.3f} on the fat slab")

    files, data = memory_files()
    ep_rows, ep_worst, t_cb = phase_extprod(
        p, files, smi, {k: v for k, v in caps.items() if k.startswith("K6")})
    k7_rows, k7_worst, k7_variants = phase_br2(p, files, smi, caps)
    launches, mem_s_cycle = phase_memory(files, data, smi)

    bdk, t_key = br_keys(ek, p)
    # BR_SIZES and each cluster kernel's thread-plan switch (ops/br.py:
    # threads_for): the largest G at 512 threads a CTA and the next
    br_sizes = sorted(set(BR_SIZES) | {g for k, c in caps.items()
                                       if k.startswith(("K3", "K4"))
                                       for g in (c, c + 1)})
    br_rows, _, unrolled = phase_br_kernels(p, sk, bdk, rng, smi, br_sizes)
    br_gates = phase_br_gates(p, sk, bdk, rng, smi, rate)
    del bdk
    torch.cuda.empty_cache()
    k5_split = phase_k5_split(smi)
    k3_launches, v3_s_cycle = phase_slice(smi, "br-slice")
    fusion = phase_fusion(smi, files, data)
    default = phase_default(smi, files)
    mesh, mesh_k1 = phase_mesh(smi, files, fusion)
    micro_recs = phase_micro(smi)

    say("summary", json.dumps({
        "card": smi, "blind_rotate_ms": times,
        "gate_bootstraps_per_sec": rate, "ntt_gates": ntt,
        "mac16_s_per_cycle": s_cycle, "extprod_ms": ep_rows,
        "cb_8bits_s": t_cb, "k7": k7_rows, "k7_variants": k7_variants,
        "memmac_s_per_cycle": mem_s_cycle,
        "br_kernels": br_rows,
        "br_kernel_key_s": t_key, "k5_launch_split_ms": k5_split,
        "ntt_unrolled_route": unrolled, "br_gates": br_gates,
        "mac16_v3_s_per_cycle": v3_s_cycle, "tk_layouts": tk_layouts,
        "mac16_tk_small_s_per_cycle": tk_s_cycle,
        "tkey_forms": form_rows, "loop_max_g": tkey.LOOP_MAX_G,
        "wgmma_min_g": tkey.WGMMA_MIN_G, "k1_loop_ablation": k1_ablation,
        "fusion": fusion, "default": default, "mesh": mesh}))
    say("summary", f"chip_smoke.py took {time.time() - t_start:.1f} s in "
        "all")
    print(smi)
    print(json.dumps({"kernels": kernel_records(
        p, times, worst, gate_launches, launches, ep_rows, ep_worst, br_rows,
        br_gates, k3_launches, tk_layouts, tk_small_launches, unrolled,
        k7_rows, k7_worst) + [mesh_k1] + micro_recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
