"""TFHE levelized executor (torch).

Encrypted counterpart of engine.plain: node values are TLWE lvl0 samples
(i32 bit patterns [num_nodes + 1, n+1]; the extra row keeps snapshots
interchangeable with the JAX package), and each level becomes

  gather -> linear combine -> ONE batched blind rotation over all 2-input
  gates and both MUX half-gates -> sample extract -> (MUX pair combine at
  lvl1) -> one batched key switch -> scatter,

as in iyokan_tpu/engine/tfhe.py.  NOT gates are free torus negations;
copies are gathers.  The value array is updated in place.

Built-in CMUX memories follow the reference dataflow as the JAX engine
does (reference src/iyokan_tfhepp.hpp:675-889), bit for bit:
  CB:        one circuit-bootstrap batch over every address bit a level
             reads (ops.circuit_bootstrap, the lvl2 CRT64 product) ->
             normal + inverted TRGSW selectors, NTT-prepared;
  ROM read:  inter-word CMUX tree (inverted selectors) -> intra-word
             rotate ladder (normal selectors) -> per-bit sample extract ->
             KS;
  RAM read:  CMUX tree over 2^a words per bit -> SEI(0) -> KS;
  RAM write: MUXwoSE(wren ? wdata : rdata) (gate blind rotation) -> per-
             address CMUX chain (a K=2 key stack: each address row picks
             the normal or inverted selector of its bit) -> SEI(0) + KS +
             refresh blind rotation of all words (ram_refresh=True), or of
             the W written rows only (periodic-refresh cycles).
Every lvl1 external product runs ops/extprod.extprod1 (the extprod1_ntt
kernel on the card, its CRT64 twin on the CPU).  On the CPU the memory
tests (tests/test_torch_memory.py) hold all of it against the JAX engine
at toy parameters; on the card chip_smoke.py's memory phase runs
tests/data/memmac.toml at cggi128.  Level fusion into one dispatch per
group or cycle and the multi-cycle scan are not ported (results are the
same either way; the port runs level by level).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import gates as G
from ..circuit.compile import Compiled
from ..crypto import host, ops

# Level batches bootstrap in chunks of at most this many rows: bounds the
# kernel's digit scratch (rows x RT int8, RT up to 3*(l+lb)*N) and the
# twin's float64 temporaries on very wide levels.
BOOT_CHUNK = 2048


def _bucket(n: int) -> int:
    """The JAX engine's batch bucket: 0, or the power of two >= max(n, 16)."""
    if n == 0:
        return 0
    b = 16
    while b < n:
        b *= 2
    return b


def jax_chunk_sizes(nb: int, nm: int, cap: int) -> np.ndarray:
    """For each row of a level's unpadded batch (nb gate rows, then the nm
    first and the nm second MUX half-gate rows), the size of the chunk the
    JAX engine bootstraps it in, int64 [nb + 2*nm].

    The JAX engine pads the level to _bucket(nb) + 2*_bucket(nm) rows and
    splits that into power-of-two chunks of at most cap rows (cap <= 0 or a
    batch of at most 16 rows: one chunk), each asking bk_for(chunk size)
    for its key (iyokan_tpu/engine/tfhe.py:_pad_plan, _chunked_bootstrap).
    Rows of one level can thus take different keys."""
    nbb, nmb = _bucket(nb), _bucket(nm)
    total = nbb + 2 * nmb
    size = np.full(total, total, np.int64)
    if cap > 0 and total > 16:
        i = 0
        while i < total:
            c = 1 << (min(cap, total - i).bit_length() - 1)
            size[i: i + c] = c
            i += c
    pos = np.concatenate([np.arange(nb), nbb + np.arange(nm),
                          nbb + nmb + np.arange(nm)])
    return size[pos]


class TFHEEngine:
    def __init__(self, compiled: Compiled, eval_key: host.EvalKey, device):
        self.c = compiled
        self.d = compiled.design
        self.p = eval_key.params
        needs_cb = bool(self.d.rom_insts or self.d.ram_insts)
        if needs_cb and eval_key.bk2.shape[0] == 0:
            # reference: CMUX memories require the circuit(-bootstrapping)
            # key (needsCircuitKey, src/iyokan.hpp:1897-1906)
            raise ValueError(
                "blueprint uses CMUX ROM/RAM but the eval key has no "
                "circuit-bootstrapping material (generate with with_cb=True)"
            )
        self.device = ops.check_device(device)
        self.keys = ops.DeviceKeys.from_evalkey(eval_key, self.device,
                                                with_cb=needs_cb)
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

    def _blind_rotate(self, bk, batch, testv):
        """Blind-rotate a batch against one key in slices of at most
        BOOT_CHUNK rows (rows are independent: the slicing changes no
        result)."""
        outs = [ops.blind_rotate(batch[i: i + BOOT_CHUNK], bk, testv, self.p)
                for i in range(0, batch.shape[0], BOOT_CHUNK)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _testv(self):
        return torch.full((self.p.N,), self.p.mu, dtype=torch.int32,
                          device=self.device)

    def _chunked_bootstrap(self, keys, batch, nb, nm):
        """Gate-bootstrap a level batch (lvl0 -> TLWE lvl1 +-mu), each row
        against the key the JAX engine's chunk of that row takes
        (jax_chunk_sizes; IYOKAN_BOOT_CHUNK as there, default 2048)."""
        cap = int(os.environ.get("IYOKAN_BOOT_CHUNK", "2048"))
        sizes = jax_chunk_sizes(nb, nm, cap)
        groups = {}                             # id(key) -> (key, sizes)
        for s in np.unique(sizes):
            bk = keys.bk_for(int(s))
            groups.setdefault(id(bk), (bk, []))[1].append(s)
        testv = self._testv()
        if len(groups) == 1:
            acc = self._blind_rotate(next(iter(groups.values()))[0], batch,
                                     testv)
        else:
            acc = torch.empty((batch.shape[0], 2, self.p.N),
                              dtype=torch.int32, device=batch.device)
            for bk, ss in groups.values():
                rows = self._idx(np.flatnonzero(np.isin(sizes, ss)))
                acc[rows] = self._blind_rotate(bk, batch[rows], testv)
        return ops.sample_extract(acc, 0)

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
        t1 = self._chunked_bootstrap(keys, torch.cat(pres), nb, nm)
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

    def make_rom_store(self, name, addr_width, data_width, data):
        """TRLWE words i32 [ceil(2^a * w / N), 2, N]: the ROM's bits packed
        coefficient-wise (host.encrypt_rom); all bits 0 when absent."""
        p = self.p
        if data_width & (data_width - 1):
            raise ValueError("CMUX ROM data width must be a power of two")
        n_tr = max(1, -(-((1 << addr_width) * data_width) // p.N))
        if data is None:
            store = np.zeros((n_tr, 2, p.N), np.uint32)
            store[:, 1, :] = (~(np.uint32(p.mu)) + np.uint32(1))
        else:
            store = np.asarray(data, np.uint32)
            if store.shape[0] != n_tr:
                raise ValueError("invalid request packet: wrong length of ROM")
        return ops.u32_tensor(store, self.device)

    def make_ram_store(self, name, addr_width, data_width, data):
        """One TRLWE per bit, i32 [2^a, w, 2, N], value in coefficient 0
        (host.encrypt_ram); all bits 0 when absent."""
        p = self.p
        if data is None:
            store = np.zeros(((1 << addr_width), data_width, 2, p.N),
                             np.uint32)
            store[..., 1, 0] = (~(np.uint32(p.mu)) + np.uint32(1))
        else:
            data = np.asarray(data, np.uint32)
            if data.shape[0] != (1 << addr_width) * data_width:
                raise ValueError("invalid request packet: wrong length of RAM")
            store = data.reshape((1 << addr_width), data_width, 2, p.N)
        return ops.u32_tensor(store, self.device)

    def read_ram_store(self, store) -> np.ndarray:
        a, w = store.shape[0], store.shape[1]
        return ops.u32_numpy(store).reshape(a * w, 2, store.shape[-1])

    def block_until_ready(self, vals):
        if vals.is_cuda:
            torch.cuda.synchronize(vals.device)

    def tick(self, vals):
        if len(self.c.tick_dst):
            vals[self._tick_dst] = vals[self._tick_src]
        return vals

    # ------------------------------------------------------------------ #
    # CMUX memories
    # ------------------------------------------------------------------ #
    def _cb_pairs(self, keys, vals, addr_nodes):
        """CBWithInv of address wires -> prepared TRGSW selectors
        int32 [a, 2 (normal/inverted), 2l, 2, P, N]."""
        p = self.p
        trgsw = ops.circuit_bootstrap(vals[self._idx(addr_nodes)],
                                      keys.bk2, keys.pksk_f64, p)
        both = torch.stack([trgsw, ops.trgsw_invert(trgsw, p)], dim=1)
        return ops.prep_trgsw(both, p)

    def _mem_level(self, keys, vals, rams, roms, plan, ram_sel, mark):
        """All ROM/RAM reads of one level: ONE circuit-bootstrap batch over
        every instance's address bits (the n-step lvl2 rotation is
        latency-bound at these widths), then the per-instance trees.
        Returns (vals, seconds marked)."""
        mems = ([("rom", nm) for nm in plan.rom_reads]
                + [("ram", nm) for nm in plan.ram_reads])
        nodes, spans = [], []
        for kind, nm in mems:
            inst = (self.d.rom_insts if kind == "rom"
                    else self.d.ram_insts)[nm]
            spans.append((kind, nm, len(nodes),
                          len(nodes) + len(inst.addr_nodes)))
            nodes.extend(inst.addr_nodes)
        gn_all = self._cb_pairs(keys, vals, nodes)
        t = mark("cb")
        for kind, nm, lo, hi in spans:
            gn = gn_all[lo:hi]
            if kind == "rom":
                vals = self._rom_read(keys, vals, roms[nm], gn, nm)
                t += mark("rom_read")
            else:
                vals = self._ram_read(keys, vals, rams[nm], gn, nm)
                ram_sel[nm] = gn
                t += mark("ram_read")
        return vals, t

    def _rom_read(self, keys, vals, rom_store, gn, name):
        """Reference TaskTFHEppROMUX: UROMUX inter-word CMUX tree then LROMUX
        intra-word rotate ladder (src/iyokan_tfhepp.hpp:238-338)."""
        p = self.p
        inst = self.d.rom_insts[name]
        a, w = inst.addr_width, inst.data_width
        log2wpt = p.logN - (w.bit_length() - 1)      # words per TRLWE
        n_inter = max(0, a - log2wpt)

        words = rom_store                            # [2^n_inter, 2, N]
        for b in range(n_inter):
            g = gn[log2wpt + b, 1]                   # inverted: bit==0 -> even
            words = ops.cmux(g, words[0::2], words[1::2], p)
        acc = ops.to_u64(words[0])                   # [2, N]

        for bit in range(1, log2wpt + 1):
            if log2wpt - bit >= a:
                continue
            shift = torch.full((2,), (2 * p.N) - (p.N >> bit),
                               device=self.device)
            rot = ops.to_u64(ops.rot_poly(ops.from_u64(acc), shift, p.N))
            g = gn[log2wpt - bit, 0]                 # normal
            acc = acc + ops.to_u64(ops.extprod_term(g, rot - acc, p))
        acc = ops.from_u64(acc)

        lvl1 = torch.stack([ops.sample_extract(acc, b) for b in range(w)])
        vals[self._idx(inst.read_nodes)] = ops.keyswitch_10(
            lvl1, keys.ksk_f64, p)
        return vals

    def _ram_read(self, keys, vals, ram_store, gn, name):
        """Reference TaskTFHEppRAMUX (src/iyokan_tfhepp.hpp:409-498): CMUX
        tree over 2^a words per data bit, inverted selectors."""
        p = self.p
        inst = self.d.ram_insts[name]
        words = ram_store                            # [2^a, w, 2, N]
        for b in range(inst.addr_width):
            words = ops.cmux(gn[b, 1], words[0::2], words[1::2], p)
        lvl1 = ops.sample_extract(words[0], 0)       # [w, N+1]
        vals[self._idx(inst.read_nodes)] = ops.keyswitch_10(
            lvl1, keys.ksk_f64, p)
        return vals

    def _refresh(self, keys, lvl1, testv):
        """Key-switch + blind-rotate TLWE lvl1 rows, BOOT_CHUNK at a time,
        all against the key of one JAX call over every row
        (bk_for(lvl1.shape[0]))."""
        bk = keys.bk_for(lvl1.shape[0])
        outs = [self._blind_rotate(
                    bk, ops.keyswitch_10(lvl1[i: i + BOOT_CHUNK],
                                         keys.ksk_f64, self.p), testv)
                for i in range(0, lvl1.shape[0], BOOT_CHUNK)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _ram_write_all(self, names, keys, vals, stores, gns, refresh=True):
        """All RAM instances' write paths: one MUXwoSE blind rotation,
        per-instance CMUX chains, then (refresh=True) one SEI -> KS ->
        refresh blind rotation over the concatenated 2^a * w words of
        every instance.

        refresh=False (periodic-refresh cycles, IYOKAN_RAM_REFRESH_PERIOD):
        the CMUX-tree output is kept as the store and only the W freshly
        written rows are refreshed (their noise is the sum of two rotation
        outputs); per skipped cycle a word gains only the write tree's
        a * var_extprod ~= 2^-24.2 (iyokan_tpu/engine/tfhe.py has the
        budget)."""
        p = self.p
        testv = self._testv()
        insts = [self.d.ram_insts[nm] for nm in names]
        pres1, pres2 = [], []
        for inst in insts:
            wren = ops.to_u64(vals[inst.wren_node])[None]     # [1, n+1]
            pre1 = wren + ops.to_u64(vals[self._idx(inst.wdata_nodes)])
            pre2 = ops.to_u64(vals[self._idx(inst.rdata_out_nodes)]) - wren
            pre1[:, p.n] -= p.mu
            pre2[:, p.n] -= p.mu
            pres1.append(ops.from_u64(pre1))
            pres2.append(ops.from_u64(pre2))
        W = sum(inst.data_width for inst in insts)
        tr = ops.to_u64(self._blind_rotate(keys.bk_for(2 * W),
                                           torch.cat(pres1 + pres2), testv))
        written_all = tr[:W] + tr[W:]
        written_all[:, 1, 0] += p.mu
        written_all = ops.from_u64(written_all)              # [W, 2, N]
        if not refresh:
            written_all = self._refresh(
                keys, ops.sample_extract(written_all, 0), testv)

        outs, off = [], 0
        for inst, store, gn in zip(insts, stores, gns):
            A, w = 1 << inst.addr_width, inst.data_width
            acc = written_all[off:off + w][None].expand(A, w, 2, p.N)
            off += w
            addrs = np.arange(A)
            for j in range(inst.addr_width):
                # address bit 1 -> the normal selector (key 0), else the
                # inverted one (key 1), for all w bits of the word
                pol = np.where((addrs >> j) & 1 == 1, 0, 1)
                # on the host: the wrapper checks and copies it, no sync
                idx = torch.as_tensor(pol, dtype=torch.int32)[:, None]
                acc = ops.cmux(gn[j], acc, store, p, idx=idx)
            outs.append(acc)
        if not refresh:
            return tuple(outs)
        flat = torch.cat([ops.sample_extract(acc, 0).reshape(-1, p.N + 1)
                          for acc in outs])
        fresh = self._refresh(keys, flat, testv)
        res, off = [], 0
        for acc in outs:
            n_rows = acc.shape[0] * acc.shape[1]
            res.append(fresh[off:off + n_rows].reshape(acc.shape))
            off += n_rows
        return tuple(res)

    # ------------------------------------------------------------------ #
    def settle(self, vals, rams, roms, timer=None, progress=None,
               stages=None, ram_refresh=True):
        """The per-cycle combinational sweep, one level at a time: each
        level's gates, NOT/copies, then its memory reads; the RAM writes
        after the last level.

        timer: optional list collecting per-level wall-clock seconds.
        progress: optional callable(n_gates_done).  stages: optional dict
        accumulating wall-clock seconds per stage category (gates / simple
        / cb / rom_read / ram_read / ram_write).  timer and stages force a
        device sync per stage.  ram_refresh=False keeps the CMUX-tree
        output as the RAM stores (periodic refresh, see driver.py).
        """
        keys = self.keys
        sync = timer is not None or stages is not None
        last = [time.time()]

        def mark(cat):
            if not sync:
                return 0.0
            self.block_until_ready(vals)
            now = time.time()
            dt, last[0] = now - last[0], now
            if stages is not None:
                stages[cat] = stages.get(cat, 0.0) + dt
            return dt

        ram_sel = {}
        for plan, pp in zip(self.c.levels, self._plans):
            lv_t = 0.0
            if pp["nb"] or pp["nm"]:
                vals = self._level_body(keys, vals, pp)
                lv_t += mark("gates")
            if len(pp["not_out"]) or len(pp["copy_out"]):
                vals = self._simple(vals, pp)
                lv_t += mark("simple")
            if plan.rom_reads or plan.ram_reads:
                vals, t = self._mem_level(keys, vals, rams, roms, plan,
                                          ram_sel, mark)
                lv_t += t
            if timer is not None:
                timer.append(lv_t)
            if progress is not None:
                progress(plan.n_gates)

        new_rams = {}
        if rams:
            names = tuple(sorted(rams))
            outs = self._ram_write_all(
                names, keys, vals, [rams[n] for n in names],
                [ram_sel[n] for n in names], refresh=bool(ram_refresh))
            new_rams = dict(zip(names, outs))
            mark("ram_write")
        return vals, new_rams
