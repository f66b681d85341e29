"""Smoke run of the PyTorch/CUDA port (iyokan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each:
  1. device  -- nvidia-smi name + power limit, torch.cuda device name;
  2. build   -- nvcc build of csrc/tkey_blind_rotate.cu (sm_90a);
  3. kernel  -- blind_rotate_tkey against its plain torch twin on the card at
                cggi128 with the real [635, 5120, 768] slab, G = 1, 5, 64,
                2048: bit-identical, kernel ms vs twin ms;
  4. gates   -- 2048 NAND gate bootstraps (linear combination, bootstrap,
                key switch), 0 wrong after decryption, gate bootstraps/s;
  5. slice   -- MAC-16 (tests/data/mac16.toml) at cggi128 through the CLIs
                in-process: genkey, genevalkey, toml2packet, enc,
                iyokan tfhe -c 3, dec, packet2toml; the result equals the
                plain-mode run and the integer arithmetic, and the kernel's
                launch count grew during the encrypted run.
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

from iyokan_tpu_torch import gates, params  # noqa: E402
from iyokan_tpu_torch.circuit import compile as compile_mod  # noqa: E402
from iyokan_tpu_torch.circuit.blueprint import Blueprint  # noqa: E402
from iyokan_tpu_torch.cli import iyokan_cli, packet_cli  # noqa: E402
from iyokan_tpu_torch.crypto import host, ops  # noqa: E402
from iyokan_tpu_torch.engine.driver import build_design  # noqa: E402
from iyokan_tpu_torch.ops import tkey  # noqa: E402

WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 20261016


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
    path = tkey.build()
    regs = [ln.split(":", 1)[1].strip()
            for ln in tkey.BUILD_LOG.get("log", "").splitlines()
            if "Used" in ln and "registers" in ln]
    say("build", f"{os.path.relpath(path, ROOT)} in {time.time() - t0:.2f} s"
        f"; ptxas per kernel: {regs}")


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
    tkey.LAUNCHES = 0
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
    del dk
    torch.cuda.empty_cache()

    launches, s_cycle = phase_slice(smi)

    say("summary", json.dumps({"card": smi, "blind_rotate_ms": times,
                               "gate_bootstraps_per_sec": rate,
                               "mac16_s_per_cycle": s_cycle}))
    big = next(r for r in times if r["G"] == 2048)
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "tkey_blind_rotate",
        "route": "cuda",
        "source": "iyokan_tpu_torch/csrc/tkey_blind_rotate.cu",
        "replaces": "iyokan_tpu/ops/pallas_tk.py:219",
        "launches": launches,
        "max_abs_err": worst,
        "ms": big["kernel_ms"],
        "plain_ms": big["twin_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
