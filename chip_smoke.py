"""Smoke run of the PyTorch/CUDA port (iyokan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each or more:
  1. device     -- nvidia-smi name + power limit, torch.cuda device name;
  2. build      -- both kernels, csrc/tkey_blind_rotate.cu and
                   csrc/extprod1_ntt.cu, one nvcc each, started together
                   (sm_90a), with ptxas's register lines;
  3. kernel     -- blind_rotate_tkey against its plain torch twin on the card
                   at cggi128 with the real [635, 5120, 768] slab, G = 1, 5,
                   64, 2048: bit-identical, kernel ms vs twin ms;
  4. gates      -- 2048 NAND gate bootstraps (linear combination, bootstrap,
                   key switch), 0 wrong after decryption, gate bootstraps/s;
  5. ntt-gates  -- 256 NANDs through the NTT blind-rotation route
                   (IYOKAN_EP=pallas, IYOKAN_BR_IMPL=ntt: 635 extprod1_ntt
                   launches), 0 wrong, ms per batch beside the tkey route's;
  6. slice      -- MAC-16 (tests/data/mac16.toml) at cggi128 through the CLIs
                   in-process: genkey, genevalkey, toml2packet, enc,
                   iyokan tfhe -c 3, dec, packet2toml; the result equals the
                   plain-mode run and the integer arithmetic, and the tkey
                   kernel's launch count grew during the encrypted run;
  7. extprod    -- extprod1_ntt against its plain twin on the card at cggi128,
                   on TRGSWs made by the port's circuit bootstrapping (its
                   time is printed): G = 1, 8, 1024, 2048, K = 1 and K = 2
                   with mixed indices, max |diff| 0, kernel ms vs twin ms;
  8. memory     -- tests/data/memmac.toml (MAC-4 between a 128 x 32 CMUX ROM
                   and two 256 x 8 CMUX RAMs) at cggi128 through the CLIs
                   in-process: genkey, genevalkey (with circuit-bootstrapping
                   keys), toml2packet, enc, iyokan tfhe -c 3, dec; cycle 0
                   writes both RAMs and cycle 2 reads them back; the
                   decrypted @acc / @rdataA / @rdataB and both RAM images
                   equal the plain-mode run and the Python-integer model
                   (tests/data/gen_mac.py); both kernels' launch counts grew
                   during the encrypted run; s/cycle and one synced cycle's
                   seconds per stage.
The line before the last is the kernels' JSON record, the last line the
device record.  Any failure raises (non-zero exit, no result line).  Needs no
JAX: the expected values come from the port's plain engine and Python
integers.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import re
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
from iyokan_tpu_torch.ops import extprod, nvcc, tkey  # noqa: E402

WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 20261016
MEM_CYCLES = 3


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps runs (after one warm-up)."""
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


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


def phase_build():
    t0 = time.time()
    paths = nvcc.build(tkey.SOURCE, extprod.SOURCE)
    dt = time.time() - t0
    for src, path in zip((tkey.SOURCE, extprod.SOURCE), paths):
        regs = [ln.split(":", 1)[1].strip()
                for ln in nvcc.LOGS.get(src, "").splitlines()
                if "Used" in ln and "registers" in ln]
        say("build", f"{os.path.relpath(path, ROOT)} (both nvcc in parallel:"
            f" {dt:.2f} s); ptxas per kernel: {regs}")


@contextlib.contextmanager
def ntt_route():
    """DeviceKeys on the NTT route (the JAX package's knobs): the gate key
    is the CRT64-prepared bk instead of the 2.5 GB tkey slab."""
    saved = {k: os.environ.get(k) for k in ("IYOKAN_EP", "IYOKAN_BR_IMPL")}
    os.environ.update(IYOKAN_EP="pallas", IYOKAN_BR_IMPL="ntt")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_kernel(p, sk, dk, rng):
    """Kernel vs twin, bit for bit, at the real slab."""
    testv = torch.full((p.N,), p.mu, dtype=torch.int32, device="cuda")
    rows, worst = [], 0
    for G in (1, 5, 64, 2048):
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
        rows.append({"G": G, "kernel_ms": k_ms, "twin_ms": t_ms})
        say("kernel", f"G={G}: bit-identical to twin; kernel {k_ms:.3f} ms, "
            f"twin {t_ms:.3f} ms per blind rotation")
    return rows, worst


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

    out = host.decrypt_bits(sk, ops.u32_numpy(nand()))
    wrong = int((out != (1 - (a & b))).sum())
    if wrong:
        raise AssertionError(f"{wrong}/{G} wrong NANDs")
    ms = cuda_ms(nand, 3)
    rate = G / (ms / 1e3)
    say("gates", f"{G} NANDs, 0 wrong; {ms:.1f} ms per batch (3 reps) -> "
        f"gate_bootstraps_per_sec={rate:.1f} on {smi}")
    return rate, ms


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
    out = host.decrypt_bits(sk, ops.u32_numpy(nand(nk.bk_for())))
    if extprod.LAUNCHES - before != p.n:
        raise AssertionError(f"{extprod.LAUNCHES - before} extprod1_ntt "
                             f"launches for {p.n} CMUX steps")
    wrong = int((out != (1 - (a & b))).sum())
    if wrong:
        raise AssertionError(f"{wrong}/{G} wrong NANDs on the NTT route")
    ntt_ms = cuda_ms(lambda: nand(nk.bk_for()), 2)
    tk_ms = cuda_ms(lambda: nand(dk.bk_tk), 3)
    say("ntt-gates", f"{G} NANDs through the NTT route (bk_ntt "
        f"{tuple(nk.bk_ntt.shape)} int32, {p.n} extprod1_ntt launches), 0 "
        f"wrong; {ntt_ms:.1f} ms per batch vs tkey route {tk_ms:.1f} ms "
        f"(incl. key switch) on {smi}")
    return {"G": G, "ntt_ms": ntt_ms, "tkey_ms": tk_ms}


def phase_slice(smi):
    """MAC-16 through the CLIs at cggi128: encrypted == plain == integers."""
    W, cycles = 16, 3
    bp_path = os.path.join(ROOT, "tests", "data", f"mac{W}.toml")
    rng = np.random.default_rng(SEED)
    av = [int(x) for x in rng.integers(0, 1 << W, cycles)]
    bv = [int(x) for x in rng.integers(0, 1 << W, cycles)]
    want = sum(x * y for x, y in zip(av, bv)) % (1 << (2 * W))

    def stream(vals):
        bits = np.array([(v >> k) & 1 for v in vals for k in range(W)],
                        np.uint8)
        return (f'name = "{{}}"\nsize = {bits.size}\nbytes = '
                f"{np.packbits(bits, bitorder='little').tolist()}\n")

    os.makedirs(WORK, exist_ok=True)
    f = {k: os.path.join(WORK, k) for k in (
        "sk", "ek", "req.toml", "req.plain", "req.enc", "res.enc",
        "res.plain", "res.ref")}
    with open(f["req.toml"], "w") as fh:
        fh.write("[[bits]]\n" + stream(av).format("a")
                 + "\n[[bits]]\n" + stream(bv).format("b"))

    t0 = time.time()
    packet_cli.main(["genkey", "--out", f["sk"], "--params", "cggi128",
                     "--seed", str(SEED)])
    packet_cli.main(["genevalkey", "--in", f["sk"], "--out", f["ek"],
                     "--seed", str(SEED + 1)])
    packet_cli.main(["toml2packet", "--in", f["req.toml"],
                     "--out", f["req.plain"]])
    packet_cli.main(["enc", "--key", f["sk"], "--in", f["req.plain"],
                     "--out", f["req.enc"]])
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
    tkey.LAUNCHES = extprod.LAUNCHES = 0
    t0 = time.time()
    try:
        iyokan_cli.main(["tfhe", "--blueprint", bp_path, "-i", f["req.enc"],
                         "-o", f["res.enc"], "--evalkey", f["ek"],
                         "-c", str(cycles), "--quiet"])
    finally:
        lg.removeHandler(handler)
    t_run = time.time() - t0
    launches = tkey.LAUNCHES
    if launches == 0:
        raise AssertionError("the encrypted run launched no tkey kernel")

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
    say("slice", f"MAC-{W} x {cycles} cycles at cggi128: decrypted acc "
        f"{got} == plain == a.b; census {comp.gate_census()}; "
        f"{len(comp.levels)} levels, {boots} bootstraps/cycle; "
        f"{s_cycle:.3f} s/cycle (cycles {cycle_us} us), tfhe CLI "
        f"{t_run:.1f} s incl. key load + reset, keys+enc {t_keys:.1f} s; "
        f"{launches} kernel launches; {smi}")
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


def phase_extprod(p, files, smi):
    """extprod1_ntt vs its twin at the memory path's shapes, on selectors
    made by the port's circuit bootstrapping."""
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
    for G in (1, 8, 1024, 2048):
        c = ops.u32_tensor(rng.integers(0, 1 << 32, (G, 2, p.N),
                                        dtype=np.uint32), "cuda")
        d = ops.decompose1(c, p)
        for K in (1, 2):
            j = G % 8
            if K == 1:
                keys, idx = prep[j, 0][None].contiguous(), None
            else:
                keys = prep[j].contiguous()
                pol = rng.integers(0, 2, G).astype(np.int32)
                pol[: min(G, 2)] = [0, 1][: min(G, 2)]
                idx = torch.from_numpy(pol).cuda()
            got = extprod.extprod1(d, keys, idx, p)
            want = extprod.extprod1_ref(d, keys, idx, p)
            torch.cuda.synchronize()
            err = int((ops.to_u64(got) - ops.to_u64(want)).abs().max())
            worst = max(worst, err)
            if err:
                raise AssertionError(
                    f"extprod1_ntt != twin at G={G}, K={K}: max |diff| {err}")
            k_ms = cuda_ms(lambda: extprod.extprod1(d, keys, idx, p), 10)
            t_ms = cuda_ms(lambda: extprod.extprod1_ref(d, keys, idx, p), 2)
            rows.append({"G": G, "K": K, "kernel_ms": k_ms, "twin_ms": t_ms})
            say("extprod", f"G={G} K={K}: max |diff| 0; kernel {k_ms:.4f} "
                f"ms, twin {t_ms:.4f} ms per call on {smi}")
    del dk
    torch.cuda.empty_cache()
    return rows, worst, t_cb


def phase_memory(files, data, smi):
    """memmac through iyokan tfhe: encrypted == plain == Python integers."""
    rom, rams, streams = data
    f, cycles = files, MEM_CYCLES
    bp_path = os.path.join(ROOT, "tests", "data", "memmac.toml")
    cycle_us, stage_lines = [], []

    class CycleLog(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            m = re.match(r"\s*done\. \((\d+) us\)", msg)
            if m:
                cycle_us.append(int(m.group(1)))
            elif msg.strip().startswith("stages:"):
                stage_lines.append(msg.strip())

    lg = logging.getLogger("iyokan")
    lg.setLevel(logging.DEBUG)          # the driver logs per-stage seconds
    lg.propagate = False
    handler = CycleLog()
    lg.addHandler(handler)
    tkey.LAUNCHES = extprod.LAUNCHES = 0
    t0 = time.time()
    try:
        iyokan_cli.main(["tfhe", "--blueprint", bp_path, "-i", f["req.enc"],
                         "-o", f["res.enc"], "--evalkey", f["ek"],
                         "-c", str(cycles), "--quiet"])
    finally:
        lg.removeHandler(handler)
        lg.propagate = True
        lg.setLevel(logging.INFO)
    t_run = time.time() - t0
    launches = {"tkey_blind_rotate": tkey.LAUNCHES,
                "extprod1_ntt": extprod.LAUNCHES}
    if not all(launches.values()):
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
    if len(cycle_us) != cycles or len(stage_lines) != cycles:
        raise AssertionError(f"expected {cycles} cycle times and stage "
                             f"lines, got {cycle_us}, {stage_lines}")
    comp = compile_mod.compile_design(build_design(Blueprint(bp_path)))
    s_cycle = sum(cycle_us) / len(cycle_us) / 1e6
    stages = dict(kv.split("=") for kv in stage_lines[-1].split()[1:])
    stages = {k: float(v) for k, v in stages.items()}
    say("memory", f"memmac x {cycles} cycles at cggi128: decrypted {want} "
        f"== plain == integers, RAM images equal; {len(comp.levels)} "
        f"levels, census {comp.gate_census()}; {s_cycle:.3f} s/cycle "
        f"(cycles {cycle_us} us, every stage synced), tfhe CLI {t_run:.1f} "
        f"s incl. key load + reset settle; launches {launches}; {smi}")
    say("memory", "last cycle, seconds per stage: " + json.dumps(stages))
    return launches, s_cycle, stages


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi, name = phase_device()
    phase_build()

    p = params.CGGI128
    rng = np.random.default_rng(SEED)
    sk = host.keygen(p, seed=SEED)
    ek = host.genevalkey(sk, seed=SEED + 1, with_cb=False)
    t0 = time.time()
    dk = ops.DeviceKeys.from_evalkey(ek, "cuda")
    say("kernel", f"slab {tuple(dk.bk_tk.shape)} int8 built + moved in "
        f"{time.time() - t0:.1f} s")
    times, worst = phase_kernel(p, sk, dk, rng)
    rate, _ = phase_gates(p, sk, dk, rng, smi)
    ntt = phase_ntt_gates(p, sk, ek, dk, rng, smi)
    del dk
    torch.cuda.empty_cache()

    _, s_cycle = phase_slice(smi)

    files, data = memory_files()
    ep_rows, ep_worst, t_cb = phase_extprod(p, files, smi)
    launches, mem_s_cycle, stages = phase_memory(files, data, smi)

    say("summary", json.dumps({
        "card": smi, "blind_rotate_ms": times,
        "gate_bootstraps_per_sec": rate, "ntt_gates": ntt,
        "mac16_s_per_cycle": s_cycle, "extprod_ms": ep_rows,
        "cb_8bits_s": t_cb, "memmac_s_per_cycle": mem_s_cycle,
        "memmac_stage_s": stages}))
    big = next(r for r in times if r["G"] == 2048)
    ep = next(r for r in ep_rows if r["G"] == 2048 and r["K"] == 2)
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "tkey_blind_rotate",
        "route": "cuda",
        "source": "iyokan_tpu_torch/csrc/tkey_blind_rotate.cu",
        "replaces": "iyokan_tpu/ops/pallas_tk.py:219",
        "launches": launches["tkey_blind_rotate"],
        "max_abs_err": worst,
        "ms": big["kernel_ms"],
        "plain_ms": big["twin_ms"],
    }, {
        "name": "extprod1_ntt",
        "route": "cuda",
        "source": "iyokan_tpu_torch/csrc/extprod1_ntt.cu",
        "replaces": "iyokan_tpu/ops/pallas_ep.py:91",
        "launches": launches["extprod1_ntt"],
        "max_abs_err": ep_worst,
        "ms": ep["kernel_ms"],
        "plain_ms": ep["twin_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
