"""TFHE levelized executor (torch), gate path.

Encrypted counterpart of engine.plain: node values are TLWE lvl0 samples
(i32 bit patterns [num_nodes + 1, n+1]; the extra row keeps snapshots
interchangeable with the JAX package), and each level becomes

  gather -> linear combine -> ONE batched blind rotation over all 2-input
  gates and both MUX half-gates -> sample extract -> (MUX pair combine at
  lvl1) -> one batched key switch -> scatter,

as in iyokan_tpu/engine/tfhe.py.  NOT gates are free torus negations;
copies are gathers.  The value array is updated in place.

Not ported yet: the CMUX ROM/RAM memories (circuit bootstrapping, private
key switch, CMUX trees) -- a design that has them raises
NotImplementedError -- and level fusion into one dispatch per group or
cycle (results are the same either way; the port runs level by level).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import gates as G
from ..circuit.compile import Compiled
from ..crypto import host, ops

# Level batches bootstrap in chunks of at most this many rows: bounds the
# kernel's digit scratch (rows x (l+lb)*N int8) and the twin's float64
# temporaries on very wide levels.
BOOT_CHUNK = 2048


class TFHEEngine:
    def __init__(self, compiled: Compiled, eval_key: host.EvalKey, device):
        self.c = compiled
        self.d = compiled.design
        self.p = eval_key.params
        if self.d.rom_insts or self.d.ram_insts:
            raise NotImplementedError(
                "iyokan_tpu_torch runs gate-only circuits: CMUX ROM/RAM "
                f"builtins ({sorted(self.d.rom_insts)} ROM, "
                f"{sorted(self.d.ram_insts)} RAM) need circuit "
                "bootstrapping, the private key switch and the CMUX trees, "
                "which are not ported yet (ROADMAP.md, Queue 1). Use the "
                "JAX package (iyokan_tpu) or mux-rom/mux-ram builtins.")
        self.device = ops.check_device(device)
        self.keys = ops.DeviceKeys.from_evalkey(eval_key, self.device)
        self._plans = [self._pad_plan(pl_) for pl_ in compiled.levels]
        self._tick_dst = self._idx(compiled.tick_dst)
        self._tick_src = self._idx(compiled.tick_src)

    # ------------------------------------------------------------------ #
    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _pad_plan(self, plan):
        """A level's gather/scatter arrays and gate coefficients as device
        tensors.  (The JAX engine pads them to power-of-two buckets for
        XLA's compile cache; eager torch needs no padding.)"""
        t = self._idx
        return {
            "nb": len(plan.bin_out), "nm": len(plan.mux_out),
            "bin_a": t(plan.bin_a), "bin_b": t(plan.bin_b),
            "ca": t([G.GATE_LIN[k][0] for k in plan.bin_kind]),
            "cb": t([G.GATE_LIN[k][1] for k in plan.bin_kind]),
            "kk": t([G.GATE_LIN[k][2] for k in plan.bin_kind]),
            "bin_out": t(plan.bin_out),
            "mux_a": t(plan.mux_a), "mux_b": t(plan.mux_b),
            "mux_s": t(plan.mux_s), "mux_out": t(plan.mux_out),
            "not_src": t(plan.not_src), "not_out": t(plan.not_out),
            "copy_src": t(plan.copy_src), "copy_out": t(plan.copy_out),
        }

    def _chunked_bootstrap(self, keys, batch):
        """Bootstrap a level batch in chunks of at most BOOT_CHUNK rows."""
        p = self.p
        outs = [ops.gate_bootstrap_tlwe1(batch[i: i + BOOT_CHUNK],
                                         keys.bk_tk, p)
                for i in range(0, batch.shape[0], BOOT_CHUNK)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _level_body(self, keys, vals, pp):
        """One level's gather -> batched bootstrap -> scatter."""
        p = self.p
        nb, nm = pp["nb"], pp["nm"]
        pres = []
        if nb:
            pres.append(ops.gate_linear(vals[pp["bin_a"]], vals[pp["bin_b"]],
                                        pp["ca"], pp["cb"], pp["kk"], p))
        if nm:
            Av = ops.to_u64(vals[pp["mux_a"]])
            Bv = ops.to_u64(vals[pp["mux_b"]])
            S = ops.to_u64(vals[pp["mux_s"]])
            pre1, pre2 = S + Bv, Av - S
            pre1[:, p.n] -= p.mu
            pre2[:, p.n] -= p.mu
            pres.extend([ops.from_u64(pre1), ops.from_u64(pre2)])
        t1 = self._chunked_bootstrap(keys, torch.cat(pres))
        rows = []
        if nb:
            rows.append(t1[:nb])
        if nm:
            comb = ops.to_u64(t1[nb: nb + nm]) + ops.to_u64(t1[nb + nm:])
            comb[:, p.N] += p.mu
            rows.append(ops.from_u64(comb))
        out = ops.keyswitch_10(torch.cat(rows), keys.ksk_f64, p)
        vals[torch.cat([pp["bin_out"], pp["mux_out"]])] = out
        return vals

    def _simple(self, vals, pp):
        """NOT gates (torus negation) and copies of a level."""
        if len(pp["not_out"]):
            vals[pp["not_out"]] = ops.hom_not(vals[pp["not_src"]])
        if len(pp["copy_out"]):
            vals[pp["copy_out"]] = vals[pp["copy_src"]]
        return vals

    # ------------------------------------------------------------------ #
    # state constructors / accessors
    # ------------------------------------------------------------------ #
    def init_vals(self) -> torch.Tensor:
        # everything starts as trivial 0 (reference DFF/const init,
        # src/iyokan_tfhepp.hpp:18-58); constants get their trivial value
        p = self.p
        vals = ops.u32_tensor(
            host.trivial_tlwe0(p, np.zeros(self.c.num_nodes + 1, np.uint8)),
            self.device)
        if len(self.c.const_nodes):
            vals = self.set_nodes(
                vals, self.c.const_nodes,
                host.trivial_tlwe0(p, self.c.const_vals.astype(np.uint8)))
        return vals

    def load_vals(self, arr: np.ndarray) -> torch.Tensor:
        """Snapshot value array (numpy u32) -> device state."""
        return ops.u32_tensor(arr, self.device)

    def vals_numpy(self, vals) -> np.ndarray:
        return ops.u32_numpy(vals)

    def set_nodes(self, vals, nodes, cts) -> torch.Tensor:
        """Scatter externally supplied ciphertexts into node slots."""
        vals[self._idx(nodes)] = ops.u32_tensor(cts, self.device)
        return vals

    def set_const_bits(self, vals, nodes, bits) -> torch.Tensor:
        ct = host.trivial_tlwe0(self.p, np.asarray(bits, np.uint8))
        return self.set_nodes(vals, nodes, ct)

    def read_nodes(self, vals, nodes) -> np.ndarray:
        idx = [0 if n is None else n for n in nodes]
        out = ops.u32_numpy(vals[self._idx(idx)]).copy()
        missing = np.array([n is None for n in nodes], bool)
        if missing.any():
            out[missing] = host.trivial_tlwe0(self.p, np.zeros(1, np.uint8))[0]
        return out

    def block_until_ready(self, vals):
        if vals.is_cuda:
            torch.cuda.synchronize(vals.device)

    def tick(self, vals):
        if len(self.c.tick_dst):
            vals[self._tick_dst] = vals[self._tick_src]
        return vals

    # ------------------------------------------------------------------ #
    def settle(self, vals, rams, roms, timer=None, progress=None):
        """The per-cycle combinational sweep, one level at a time.

        timer: optional list collecting per-level wall-clock seconds (forces
        a device sync per level).  progress: optional callable(n_gates_done).
        rams/roms are always empty here (no CMUX memories); the same
        signature as the JAX engine keeps the frontend shared.
        """
        keys = self.keys
        for plan, pp in zip(self.c.levels, self._plans):
            t0 = time.time()
            if pp["nb"] or pp["nm"]:
                vals = self._level_body(keys, vals, pp)
            vals = self._simple(vals, pp)
            if timer is not None:
                self.block_until_ready(vals)
                timer.append(time.time() - t0)
            if progress is not None:
                progress(plan.n_gates)
        return vals, {}
