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
             reads (ops.circuit_bootstrap: the lvl2 blind rotation on K7,
             ops/br2.py, on the card) ->
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
tests/data/memmac.toml at cggi128.

Execution modes (the JAX engine's, read from the same knobs; every mode
gives the same ciphertexts bit for bit):
  IYOKAN_FUSE_LEVELS=1    level by level, each op launched as it comes;
  N > 1 (default 8)       each group of up to N gate-only levels
                          (_group_plans) one CUDA graph, memory levels and
                          the RAM write launched as they come;
  all                     the whole sweep plus the RAM write one CUDA graph
                          per refresh flag (JAX's _cycle_fn), and the
                          Frontend's multi-cycle scan (run_cycles): one graph
                          of tick + input scatter, then the cycle's graph,
                          per cycle.
timer, progress or IYOKAN_PROFILE force the first in every mode.  Under a
torch.profiler the gate groups or levels, the memory levels' stages, the
RAM write and each graph capture are spans (spans.py); they neither sync
nor change the mode.
A graph is captured at its first use after one eager warm-up on a side
stream (the kernels' first-use set-up: nvcc loads, shared-memory
attributes, occupancy queries, cached tables; the counterpart of JAX's
compile at first call), on the state the warm-up restored, and replayed
from then on: the value array, the RAM and ROM stores and the scan's input
rows are static buffers the graphs read and write in place, and every
index and constant a cycle needs is a tensor built here beforehand.  A
failed capture or replay raises, naming the graph; nothing falls back to
eager execution.  On the CPU, which has no graphs, the same group, cycle
and span functions run eagerly.

Under a mesh (parallel/mesh.py: set_mesh) the level batches' rotations and
the RAM write's refresh rows are sharded where the JAX engine shards them
(shard_batch: each shard's rows run one after another, the results come
back whole), and the tkey and K3 routes shard any rotation (crypto/ops.py:
blind_rotate); keys and rows' routes are chosen from the whole batch.  A
mesh of shards on one card is captured like any other launch sequence;
across processes the all-gathers are NCCL collectives inside the capture
(gloo's, on the CPU, run eagerly as everything there does).
"""

from __future__ import annotations

import ctypes
import os
import time

import numpy as np
import torch

from .. import gates as G
from ..circuit.compile import Compiled
from ..crypto import host, ops
from ..parallel.mesh import replicated, shard_batch
from .spans import span

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


# --------------------------------------------------------------------------- #
# kernel launch counts and CUDA graphs
# --------------------------------------------------------------------------- #


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, flat: "module.NAME" (or
    "module.NAME.key" for a per-layout or per-form dict) -> int."""
    from ..ops import br, br2, br3, extprod, tkey

    out = {}
    for mod, name in ((tkey, "LAUNCHES"), (tkey, "LAYOUT_LAUNCHES"),
                      (tkey, "FORM_LAUNCHES"), (br, "STEP_LAUNCHES"),
                      (br, "LOOP_LAUNCHES"), (br3, "LAUNCHES"),
                      (extprod, "LAUNCHES"), (br2, "LAUNCHES")):
        v = getattr(mod, name)
        stem = f"{mod.__name__.rsplit('.', 1)[1]}.{name}"
        if isinstance(v, dict):
            out.update({f"{stem}.{k}": n for k, n in v.items()})
        else:
            out[stem] = v
    return out


def _set_launch_counts(counts: dict) -> None:
    """Put the counts launch_counts() returned back into the wrappers."""
    from ..ops import br, br2, br3, extprod, tkey

    mods = {"tkey": tkey, "br": br, "br2": br2, "br3": br3,
            "extprod": extprod}
    for key, n in counts.items():
        parts = key.split(".")
        if len(parts) == 2:
            setattr(mods[parts[0]], parts[1], n)
        else:
            getattr(mods[parts[0]], parts[1])[parts[2]] = n


def route_counts(engine: "TFHEEngine", refresh: bool = True) -> dict:
    """The gate blind rotations of one cycle of `engine`, read from its
    plans (graph replays bypass Python, so nothing is counted as they run):
    {stage: {route: {"rows": r, "rotations": k}}}, stage "levels" (every
    gate level's batch, each row on the key of its _boot_plan),
    "ram_write" (the 2W MUXwoSE rows) or "refresh" (every RAM bit on a
    refresh cycle, else the W written rows); route as ops.gate_route names
    it; a rotation is one ops.blind_rotate call of at most BOOT_CHUNK rows,
    as on one device with no mesh (a mesh splits them further)."""
    out = {}

    def add(stage, bk, rows):
        c = out.setdefault(stage, {}).setdefault(
            ops.gate_route(bk, engine.p), {"rows": 0, "rotations": 0})
        c["rows"] += rows
        c["rotations"] += -(-rows // BOOT_CHUNK)

    for pp in engine._plans:
        for bk, rows in pp["boot"] or ():
            add("levels", bk, pp["nb"] + 2 * pp["nm"] if rows is None
                else len(rows))
    insts = engine.d.ram_insts.values()
    if insts:
        W = sum(inst.data_width for inst in insts)
        n = (sum((1 << inst.addr_width) * inst.data_width for inst in insts)
             if refresh else W)
        add("ram_write", engine.keys.bk_for(2 * W), 2 * W)
        add("refresh", engine.keys.bk_for(n), n)
    return out


def graph_nodes(graph):
    """(nodes, kernel nodes) of a graph captured with keep_graph=True, read
    through the CUDA driver API (cuGraphGetNodes, cuGraphNodeGetType), or
    None where they cannot be."""
    try:
        raw = ctypes.c_void_p(graph.raw_cuda_graph())
        lib = ctypes.CDLL("libcuda.so.1")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.cuGraphGetNodes.restype = lib.cuGraphNodeGetType.restype = ci
        lib.cuGraphGetNodes.argtypes = [vp, vp,
                                        ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ci)]
        n = ctypes.c_size_t(0)
        if lib.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
            return None
        nodes = (ctypes.c_void_p * n.value)()
        if lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
            return None
        kind, kernels = ctypes.c_int(), 0
        for nd in nodes:
            # CU_GRAPH_NODE_TYPE_KERNEL = 0
            if lib.cuGraphNodeGetType(nd, ctypes.byref(kind)) == 0 \
                    and kind.value == 0:
                kernels += 1
        return n.value, kernels
    except (OSError, AttributeError, RuntimeError):
        return None


def graph_name(key) -> str:
    kind = key[0]
    if kind == "group":
        return f"level group {key[2]} (levels {key[3][0]}-{key[3][-1]})"
    if kind == "cycle":
        return f"cycle (refresh={key[1]})"
    return f"scan prologue of cycle slot {key[2]}"


class TFHEEngine:
    """The encrypted levelized engine on one device (module docstring).
    Execution mode by IYOKAN_FUSE_LEVELS: 1 = level by level; N > 1
    (default 8) = a CUDA graph per group of N gate levels; all = a graph
    per cycle (and the Frontend's multi-cycle scan)."""

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
        # every index a cycle reads, on the device once (a cycle copies
        # nothing from the host)
        self._plans = [self._pad_plan(pl_) for pl_ in compiled.levels]
        self._mems = [self._mem_plan(pl_) for pl_ in compiled.levels]
        self._tick_dst = self._idx(compiled.tick_dst)
        self._tick_src = self._idx(compiled.tick_src)
        self._rom_nodes = {nm: self._idx(inst.read_nodes)
                           for nm, inst in self.d.rom_insts.items()}
        self._ram_nodes = {nm: self._ram_plan(inst)
                           for nm, inst in self.d.ram_insts.items()}
        self._node_idx = {}    # tuple of nodes -> device index
        self._groups = {}      # max_group -> _group_plans(max_group)
        # static buffers of the graphs (_adopt) and the graphs themselves
        self._vals = None
        self._ram_bufs = {}
        self._rom_bufs = {}
        self._stage = None     # the scan's input rows [k, n_in, n+1]
        self._graphs = {}      # key -> record (_capture)
        self._pool = None

    # ------------------------------------------------------------------ #
    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _nodes_index(self, nodes) -> torch.Tensor:
        """The device index of a node list, built at its first use and
        kept (the Frontend's input and output nodes are the same list every
        cycle)."""
        key = tuple(int(n) for n in nodes)
        if key not in self._node_idx:
            self._node_idx[key] = self._idx(key)
        return self._node_idx[key]

    def _pad_plan(self, plan):
        """A level's gather/scatter arrays and gate coefficients as device
        tensors, and its rows' keys ("boot": _boot_plan).  (The JAX engine
        pads them to power-of-two buckets for XLA's compile cache; torch
        needs no padding, and a graph is keyed by its group, not its
        shape.)"""
        t = self._idx
        nb, nm = len(plan.bin_out), len(plan.mux_out)
        return {
            "nb": nb, "nm": nm,
            "bin_a": t(plan.bin_a), "bin_b": t(plan.bin_b),
            "ca": t([G.GATE_LIN[k][0] for k in plan.bin_kind]),
            "cb": t([G.GATE_LIN[k][1] for k in plan.bin_kind]),
            "kk": t([G.GATE_LIN[k][2] for k in plan.bin_kind]),
            "out": t(np.concatenate([plan.bin_out, plan.mux_out])),
            "mux_a": t(plan.mux_a), "mux_b": t(plan.mux_b),
            "mux_s": t(plan.mux_s),
            "not_src": t(plan.not_src), "not_out": t(plan.not_out),
            "copy_src": t(plan.copy_src), "copy_out": t(plan.copy_out),
            "boot": self._boot_plan(nb, nm) if nb or nm else None,
        }

    def _boot_plan(self, nb, nm):
        """[(key, rows)] of a level's batch: each row against the key the
        JAX engine's chunk of that row takes (jax_chunk_sizes;
        IYOKAN_BOOT_CHUNK as there, default 2048), rows a device index, or
        None where one key takes the whole batch."""
        cap = int(os.environ.get("IYOKAN_BOOT_CHUNK", "2048"))
        sizes = jax_chunk_sizes(nb, nm, cap)
        groups = {}                             # id(key) -> (key, sizes)
        for s in np.unique(sizes):
            bk = self.keys.bk_for(int(s))
            groups.setdefault(id(bk), (bk, []))[1].append(s)
        if len(groups) == 1:
            return [(next(iter(groups.values()))[0], None)]
        return [(bk, self._idx(np.flatnonzero(np.isin(sizes, ss))))
                for bk, ss in groups.values()]

    def _mem_plan(self, plan):
        """A memory level's CB address index and its instances' spans of
        it: (addr, [(kind, name, lo, hi)]), or None."""
        if not (plan.rom_reads or plan.ram_reads):
            return None
        mems = ([("rom", nm) for nm in plan.rom_reads]
                + [("ram", nm) for nm in plan.ram_reads])
        nodes, spans = [], []
        for kind, nm in mems:
            inst = (self.d.rom_insts if kind == "rom"
                    else self.d.ram_insts)[nm]
            spans.append((kind, nm, len(nodes),
                          len(nodes) + len(inst.addr_nodes)))
            nodes.extend(inst.addr_nodes)
        return self._idx(nodes), spans

    def _ram_plan(self, inst):
        """A RAM's read, wdata and rdata node indices, and the write tree's
        key index per address bit j: int32 [2^a, 1], row r taking the
        normal selector (key 0) where bit j of r is 1, else the inverted
        one (key 1); checked on the host here, kept on the device."""
        addrs = np.arange(1 << inst.addr_width)
        pols = []
        for j in range(inst.addr_width):
            pol = np.where((addrs >> j) & 1 == 1, 0, 1).astype(np.int32)
            if pol.min() < 0 or pol.max() > 1:
                raise ValueError("RAM write key index out of range [0, 2)")
            pols.append(torch.from_numpy(pol[:, None]).to(self.device))
        return {"read": self._idx(inst.read_nodes),
                "wdata": self._idx(inst.wdata_nodes),
                "rdata": self._idx(inst.rdata_out_nodes), "pol": pols}

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

    def _chunked_bootstrap(self, boot, batch):
        """Gate-bootstrap a level batch (lvl0 -> TLWE lvl1 +-mu), each row
        against its key of the level's _boot_plan.  Under a mesh each key's
        rows are sharded on their own (the key was chosen from the whole
        level, as the JAX engine chooses it before any split)."""
        testv = self._testv()

        def rotate(bk, x):
            return shard_batch(x, lambda t: self._blind_rotate(bk, t, testv))

        if len(boot) == 1:
            acc = rotate(boot[0][0], batch)
        else:
            acc = torch.empty((batch.shape[0], 2, self.p.N),
                              dtype=torch.int32, device=batch.device)
            for bk, rows in boot:
                acc[rows] = rotate(bk, batch[rows])
        return ops.sample_extract(acc, 0)

    def _level_body(self, keys, vals, pp):
        """One level's gather -> batched bootstrap -> scatter."""
        p = self.p
        nb, nm = pp["nb"], pp["nm"]
        vals = replicated(vals)
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
        # the batch is sharded for its rotation only: t1 comes back whole,
        # so the MUX pairs (rows i and nm + i, on different shards) combine
        # and the key switch runs on the whole batch
        t1 = self._chunked_bootstrap(pp["boot"], torch.cat(pres))
        rows = []
        if nb:
            rows.append(t1[:nb])
        if nm:
            comb = ops.to_u64(t1[nb: nb + nm]) + ops.to_u64(t1[nb + nm:])
            comb[:, p.N] += p.mu
            rows.append(ops.from_u64(comb))
        out = ops.keyswitch_10(torch.cat(rows), keys.ksk_f64, p)
        vals[pp["out"]] = out
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
        vals[self._nodes_index(nodes)] = ops.u32_tensor(cts, self.device)
        return vals

    def set_const_bits(self, vals, nodes, bits) -> torch.Tensor:
        ct = host.trivial_tlwe0(self.p, np.asarray(bits, np.uint8))
        return self.set_nodes(vals, nodes, ct)

    def read_nodes(self, vals, nodes) -> np.ndarray:
        idx = [0 if n is None else n for n in nodes]
        out = ops.u32_numpy(vals[self._nodes_index(idx)]).copy()
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
    def _cb_pairs(self, keys, vals, addr):
        """CBWithInv of the address wires (device index addr) -> prepared
        TRGSW selectors int32 [a, 2 (normal/inverted), 2l, 2, P, N]."""
        p = self.p
        trgsw = ops.circuit_bootstrap(vals[addr], keys.bk2, keys.pksk_f64, p)
        both = torch.stack([trgsw, ops.trgsw_invert(trgsw, p)], dim=1)
        return ops.prep_trgsw(both, p)

    def _mem_level(self, keys, vals, rams, roms, lv, ram_sel, mark):
        """All ROM/RAM reads of level lv: ONE circuit-bootstrap batch over
        every instance's address bits (the n-step lvl2 rotation is
        latency-bound at these widths), then the per-instance trees.
        Returns (vals, seconds marked)."""
        addr, spans = self._mems[lv]
        with span("mem.cb"):
            gn_all = self._cb_pairs(keys, vals, addr)
            t = mark()
        for kind, nm, lo, hi in spans:
            gn = gn_all[lo:hi]
            if kind == "rom":
                with span("mem.rom_read"):
                    vals = self._rom_read(keys, vals, roms[nm], gn, nm)
                    t += mark()
            else:
                with span("mem.ram_read"):
                    vals = self._ram_read(keys, vals, rams[nm], gn, nm)
                    t += mark()
                ram_sel[nm] = gn
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
        vals[self._rom_nodes[name]] = ops.keyswitch_10(lvl1, keys.ksk_f64, p)
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
        vals[self._ram_nodes[name]["read"]] = ops.keyswitch_10(
            lvl1, keys.ksk_f64, p)
        return vals

    def _refresh(self, keys, lvl1, testv):
        """Key-switch + blind-rotate TLWE lvl1 rows, BOOT_CHUNK at a time,
        all against the key of one JAX call over every row
        (bk_for(lvl1.shape[0])); under a mesh the rows are sharded, each
        shard key-switching and rotating its own."""
        bk = keys.bk_for(lvl1.shape[0])

        def refresh(rows):
            outs = [self._blind_rotate(
                        bk, ops.keyswitch_10(rows[i: i + BOOT_CHUNK],
                                             keys.ksk_f64, self.p), testv)
                    for i in range(0, rows.shape[0], BOOT_CHUNK)]
            return outs[0] if len(outs) == 1 else torch.cat(outs)

        return shard_batch(lvl1, refresh)

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
        for nm, inst in zip(names, insts):
            idx = self._ram_nodes[nm]
            wren = ops.to_u64(vals[inst.wren_node])[None]     # [1, n+1]
            pre1 = wren + ops.to_u64(vals[idx["wdata"]])
            pre2 = ops.to_u64(vals[idx["rdata"]]) - wren
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
        for nm, inst, store, gn in zip(names, insts, stores, gns):
            A, w = 1 << inst.addr_width, inst.data_width
            acc = written_all[off:off + w][None].expand(A, w, 2, p.N)
            off += w
            for j, idx in enumerate(self._ram_nodes[nm]["pol"]):
                # address bit 1 -> the normal selector (key 0), else the
                # inverted one (key 1), for all w bits of the word
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
    # execution modes
    # ------------------------------------------------------------------ #
    def _group_plans(self, max_group: int):
        """The JAX engine's partition of the sweep (cached per max_group):
        ("group", levels, n_gates) for up to max_group consecutive levels
        with gates, NOT gates or copies, and ("mem", level) for a level
        that reads a ROM or RAM, which ends the group before it (its own
        gates close that group)."""
        if max_group in self._groups:
            return self._groups[max_group]
        groups, cur, gates = [], [], 0

        def flush():
            nonlocal cur, gates
            if cur:
                groups.append(("group", tuple(cur), gates))
            cur, gates = [], 0

        for lv, (plan, pp) in enumerate(zip(self.c.levels, self._plans)):
            if (pp["nb"] or pp["nm"] or len(pp["not_out"])
                    or len(pp["copy_out"])):
                cur.append(lv)
                gates += plan.n_gates
            if plan.rom_reads or plan.ram_reads:
                flush()
                groups.append(("mem", lv))
            elif len(cur) >= max_group:
                flush()
        flush()
        self._groups[max_group] = groups
        return groups

    def _gate_levels(self, levels):
        """Gates, NOT gates and copies of the given levels, in place on the
        static value array."""
        for lv in levels:
            pp = self._plans[lv]
            if pp["nb"] or pp["nm"]:
                self._level_body(self.keys, self._vals, pp)
            self._simple(self._vals, pp)

    def _cycle(self, refresh: bool):
        """The whole sweep plus the RAM write on the static buffers: every
        level's gates and memory reads, then the RAM write, whose new
        stores are copied into the RAM buffers."""
        keys, vals, ram_sel = self.keys, self._vals, {}
        for lv in range(len(self.c.levels)):
            self._gate_levels((lv,))
            if self._mems[lv] is not None:
                self._mem_level(keys, vals, self._ram_bufs, self._rom_bufs,
                                lv, ram_sel, lambda: 0.0)
        if self._ram_bufs:
            names = tuple(sorted(self._ram_bufs))
            with span("ram_write"):
                outs = self._ram_write_all(
                    names, keys, vals, [self._ram_bufs[n] for n in names],
                    [ram_sel[n] for n in names], refresh=refresh)
            for n, out in zip(names, outs):
                self._ram_bufs[n].copy_(out)

    def _prologue(self, nodes: tuple, slot: int):
        """A scanned cycle's tick and input scatter (row `slot` of the
        staged input rows)."""
        self.tick(self._vals)
        if nodes:
            self._vals[self._nodes_index(nodes)] = self._stage[slot]

    @staticmethod
    def _into(buf, t):
        if buf is None:   # its own copy: the caller's may share memory
            return t.clone(memory_format=torch.contiguous_format)
        if t is not buf:
            buf.copy_(t)
        return buf

    def _adopt(self, vals, rams=None, roms=None):
        """Make vals (and the RAM and ROM stores) the static buffers the
        graphs were or will be captured on: copies of the first tensors
        given (on the CPU a store may share a request packet's memory),
        into which later ones are copied."""
        self._vals = self._into(self._vals, vals)
        for bufs, stores in ((self._ram_bufs, rams), (self._rom_bufs, roms)):
            for n, s in (stores or {}).items():
                bufs[n] = self._into(bufs.get(n), s)

    def _state(self):
        """The buffers a graph writes: the value array and the RAM stores."""
        return [self._vals] + list(self._ram_bufs.values())

    def _run(self, key, fn):
        """fn() on the card as the replay of its CUDA graph (captured at its
        first use); on the CPU, fn() itself."""
        if self.device.type != "cuda":
            fn()
            return
        rec = self._graphs.get(key)
        if rec is None:
            with span("graph.capture"):
                rec = self._graphs[key] = self._capture(key, fn)
        try:
            rec["graph"].replay()
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph replay of {graph_name(key)} failed: {e}") from e
        rec["replays"] += 1

    def _capture(self, key, fn):
        """Capture fn() as a CUDA graph: one eager warm-up on a side stream
        (every first-use set-up happens there), the state it wrote put
        back, then the capture into the engine's graph pool.  Records the
        kernel launches it holds (the wrappers' counts during the capture,
        which are taken back: a capture launches nothing), the warm-up,
        capture and instantiation seconds, the pool bytes it added and
        its nodes (the three times split its graph.capture span).  Raises,
        naming the graph, where anything fails."""
        dev = self.device
        before = None
        try:
            state = self._state()
            saved = [t.clone() for t in state]
            t0 = time.time()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream(dev).wait_stream(side)
            for t, s in zip(state, saved):
                t.copy_(s)
            del saved
            torch.cuda.synchronize(dev)
            t_warm = time.time() - t0
            before = launch_counts()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            # torch.cuda.graph empties the cache first: so do we, so that
            # the reserved bytes grow by the pool's alone
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_reserved(dev)
            # kept, to count its nodes; instantiated here, to time it
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.time()
            with torch.cuda.graph(graph, pool=self._pool):
                fn()
            t_cap = time.time() - t0
            after = launch_counts()
            t0 = time.time()
            graph.instantiate()
            torch.cuda.synchronize(dev)
            t_inst = time.time() - t0
        except Exception as e:
            if before is not None:
                _set_launch_counts(before)
            raise RuntimeError(
                f"CUDA graph capture of {graph_name(key)} failed: {e}") from e
        _set_launch_counts(before)
        nodes = graph_nodes(graph)
        return {"graph": graph, "name": graph_name(key), "replays": 0,
                "kernels": {k: after[k] - before[k] for k in after
                            if after[k] != before[k]},
                "warmup_s": t_warm, "capture_s": t_cap,
                "instantiate_s": t_inst,
                "pool_bytes": torch.cuda.memory_reserved(dev) - mem0,
                "nodes": None if nodes is None else nodes[0],
                "kernel_nodes": None if nodes is None else nodes[1]}

    def graph_stats(self) -> list:
        """One record per captured graph: name, replays, the wrappers'
        launch counts it holds ("kernels"), warm-up / capture /
        instantiation seconds, the pool bytes its capture added, and its
        nodes and kernel nodes (None where not read)."""
        return [{k: v for k, v in rec.items() if k != "graph"}
                for rec in self._graphs.values()]

    def graph_launches(self) -> dict:
        """The kernel launches the graphs' replays made, by wrapper count:
        each graph's captured counts times its replays."""
        out = {}
        for rec in self._graphs.values():
            for k, n in rec["kernels"].items():
                out[k] = out.get(k, 0) + n * rec["replays"]
        return out

    def _fused_cycle(self, refresh: bool):
        """One cycle's sweep and RAM write as its graph of this refresh
        flag (one flag where there is no RAM)."""
        flag = bool(refresh) if self._ram_bufs else True
        self._run(("cycle", flag), lambda: self._cycle(flag))

    def run_cycles(self, vals, rams, roms, in_nodes, in_rows,
                   refresh_flags=None):
        """Run k = len(in_rows) full cycles (tick -> input scatter ->
        combinational sweep -> RAM write): the JAX engine's lax.scan span.
        The input rows go to the device in one copy; each cycle replays
        the graph of its tick and input scatter, then the cycle graph of
        its refresh flag (chosen here from the schedule, where JAX takes
        lax.cond); nothing syncs inside the span.

        in_nodes: node ids receiving circular inputs each cycle;
        in_rows: u32 [k, len(in_nodes), n+1] ciphertext rows;
        refresh_flags: optional bool [k], the Frontend's periodic RAM
        refresh schedule (None = refresh every cycle).
        Returns (vals, rams), the static buffers."""
        self._adopt(vals, rams, roms)
        k = len(in_rows)
        flags = ([True] * k if refresh_flags is None
                 else [bool(f) for f in refresh_flags])
        nodes = tuple(int(n) for n in in_nodes)
        if nodes:
            rows = np.ascontiguousarray(np.asarray(in_rows, np.uint32))
            if (self._stage is None or self._stage.shape[0] < k
                    or tuple(self._stage.shape[1:]) != rows.shape[1:]):
                # a new staging buffer: the prologue graphs read the old
                self._graphs = {key: rec for key, rec in self._graphs.items()
                                if key[0] != "prologue"}
                self._stage = torch.empty(rows.shape, dtype=torch.int32,
                                          device=self.device)
            self._stage[:k].copy_(torch.from_numpy(rows.view(np.int32)))
        for c in range(k):
            self._run(("prologue", nodes, c),
                      lambda c=c: self._prologue(nodes, c))
            self._fused_cycle(flags[c])
        return self._vals, dict(self._ram_bufs)

    def settle(self, vals, rams, roms, timer=None, progress=None,
               ram_refresh=True):
        """The per-cycle combinational sweep and RAM write, in the mode
        IYOKAN_FUSE_LEVELS names (module docstring; as the JAX engine's
        settle dispatches).

        timer: optional list collecting per-level wall-clock seconds.
        progress: optional callable(n_gates_done).  timer and
        IYOKAN_PROFILE force a device sync per stage; they and progress
        force the level-by-level path.  ram_refresh=False keeps the
        CMUX-tree output as the RAM stores (periodic refresh, see
        driver.py).
        """
        keys = self.keys
        sync = bool(os.environ.get("IYOKAN_PROFILE")) or timer is not None
        fuse_env = os.environ.get("IYOKAN_FUSE_LEVELS", "8")
        if fuse_env == "all" and not sync and progress is None:
            self._adopt(vals, rams, roms)
            self._fused_cycle(ram_refresh)
            return self._vals, dict(self._ram_bufs)
        fuse = 8 if fuse_env == "all" else int(fuse_env)
        last = [time.time()]

        def mark():
            if not sync:
                return 0.0
            self.block_until_ready(vals)
            now = time.time()
            dt, last[0] = now - last[0], now
            return dt

        ram_sel = {}
        if not sync and progress is None and fuse > 1:
            # one graph per group of gate levels; memory levels as they are
            self._adopt(vals)
            vals = self._vals
            for i, entry in enumerate(self._group_plans(fuse)):
                if entry[0] == "group":
                    with span("gates"):
                        self._run(("group", fuse, i, entry[1]),
                                  lambda lvs=entry[1]: self._gate_levels(lvs))
                else:
                    vals, _ = self._mem_level(keys, vals, rams, roms,
                                              entry[1], ram_sel, mark)
        else:
            for lv, (plan, pp) in enumerate(zip(self.c.levels,
                                                self._plans)):
                lv_t = 0.0
                if (pp["nb"] or pp["nm"] or len(pp["not_out"])
                        or len(pp["copy_out"])):
                    with span("gates"):
                        if pp["nb"] or pp["nm"]:
                            vals = self._level_body(keys, vals, pp)
                        vals = self._simple(vals, pp)
                        lv_t += mark()
                if self._mems[lv] is not None:
                    vals, t = self._mem_level(keys, vals, rams, roms, lv,
                                              ram_sel, mark)
                    lv_t += t
                if timer is not None:
                    timer.append(lv_t)
                if progress is not None:
                    progress(plan.n_gates)

        new_rams = {}
        if rams:
            names = tuple(sorted(rams))
            with span("ram_write"):
                outs = self._ram_write_all(
                    names, keys, vals, [rams[n] for n in names],
                    [ram_sel[n] for n in names], refresh=bool(ram_refresh))
                mark()
            new_rams = dict(zip(names, outs))
        return vals, new_rams
