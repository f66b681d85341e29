"""Plain-bit levelized executor (torch).

The functional-reference backend: identical circuit semantics to the TFHE
engine, computed on raw bits (the role of the reference's plain backend,
src/iyokan_plain.hpp; counterpart of iyokan_tpu/engine/plain.py).  State is
a uint8 value tensor indexed by node id plus one store per built-in CMUX
memory; each cycle sweeps the precompiled levels eagerly.  The value tensor
and RAM stores are updated in place.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..circuit.compile import Compiled
from ..crypto import ops


class PlainEngine:
    def __init__(self, compiled: Compiled, device):
        self.c = compiled
        self.d = compiled.design
        self.device = ops.check_device(device)
        self._weights = {}

    # ------------------------------------------------------------------ #
    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _bits(self, bits) -> torch.Tensor:
        return torch.as_tensor(np.asarray(bits).astype(np.uint8),
                               device=self.device)

    def _addr(self, vals, addr_nodes) -> torch.Tensor:
        """Little-endian address word of a memory port (0-d tensor)."""
        bits = vals[self._idx(addr_nodes)].to(torch.int64)
        w = self._idx(1 << np.arange(len(addr_nodes)))
        return (bits * w).sum()

    def init_vals(self) -> torch.Tensor:
        vals = torch.zeros(self.c.num_nodes, dtype=torch.uint8,
                           device=self.device)
        if len(self.c.const_nodes):
            vals[self._idx(self.c.const_nodes)] = self._bits(
                self.c.const_vals)
        return vals

    def load_vals(self, arr: np.ndarray) -> torch.Tensor:
        return self._bits(arr)

    def vals_numpy(self, vals) -> np.ndarray:
        return vals.cpu().numpy()

    def set_nodes(self, vals, nodes, bits) -> torch.Tensor:
        vals[self._idx(nodes)] = self._bits(bits)
        return vals

    # plain engine: "constant bits" and external values are the same thing
    set_const_bits = set_nodes

    def read_nodes(self, vals, nodes) -> np.ndarray:
        idx = [0 if n is None else n for n in nodes]
        out = vals[self._idx(idx)].cpu().numpy()
        out[np.array([n is None for n in nodes], bool)] = 0
        return out

    def make_rom_store(self, name, addr_width, data_width, data):
        shape = (1 << addr_width, data_width)
        if data is None:
            return torch.zeros(shape, dtype=torch.uint8, device=self.device)
        data = np.asarray(data, np.uint8)
        if data.size != shape[0] * shape[1]:
            raise ValueError("invalid request packet: wrong length of ROM")
        return self._bits(data.reshape(shape))

    def make_ram_store(self, name, addr_width, data_width, data):
        shape = (1 << addr_width, data_width)
        if data is None:
            return torch.zeros(shape, dtype=torch.uint8, device=self.device)
        data = np.asarray(data, np.uint8)
        if data.size != shape[0] * shape[1]:
            raise ValueError("invalid request packet: wrong length of RAM")
        return self._bits(data.reshape(shape))

    def read_ram_store(self, store) -> np.ndarray:
        return store.cpu().numpy().reshape(-1)

    def block_until_ready(self, vals):
        if vals.is_cuda:
            torch.cuda.synchronize(vals.device)

    def tick(self, vals):
        """All DFFs latch input -> output simultaneously
        (reference TaskDFF::tick, src/iyokan.hpp:1395-1402)."""
        if len(self.c.tick_dst):
            vals[self._idx(self.c.tick_dst)] = vals[self._idx(self.c.tick_src)]
        return vals

    # ------------------------------------------------------------------ #
    def _level(self, vals, rams, roms, plan):
        outs, ids = [], []
        if len(plan.bin_out):
            a = vals[self._idx(plan.bin_a)]
            b = vals[self._idx(plan.bin_b)]
            stack = torch.stack([
                a & b, 1 - (a & b), a & (1 - b), a | b,
                1 - (a | b), a | (1 - b), a ^ b, 1 - (a ^ b),
            ])
            outs.append(stack.gather(0, self._idx(plan.bin_kind)[None])[0])
            ids.append(plan.bin_out)
        if len(plan.mux_out):
            a = vals[self._idx(plan.mux_a)]
            b = vals[self._idx(plan.mux_b)]
            s = vals[self._idx(plan.mux_s)]
            outs.append(torch.where(s == 0, a, b))
            ids.append(plan.mux_out)
        if len(plan.not_out):
            outs.append(1 - vals[self._idx(plan.not_src)])
            ids.append(plan.not_out)
        if len(plan.copy_out):
            outs.append(vals[self._idx(plan.copy_src)])
            ids.append(plan.copy_out)
        for name in plan.rom_reads:
            inst = self.d.rom_insts[name]
            outs.append(roms[name][self._addr(vals, inst.addr_nodes)])
            ids.append(inst.read_nodes)
        for name in plan.ram_reads:
            inst = self.d.ram_insts[name]
            outs.append(rams[name][self._addr(vals, inst.addr_nodes)])
            ids.append(inst.read_nodes)
        if outs:
            vals[self._idx(np.concatenate(ids))] = torch.cat(outs)
        return vals

    def _ram_writes(self, vals, rams):
        # end-of-settle RAM writes (read-before-write by construction)
        for name, inst in self.d.ram_insts.items():
            ram = rams[name]
            addr = self._addr(vals, inst.addr_nodes)
            wdata = vals[self._idx(inst.wdata_nodes)]
            ram[addr] = torch.where(vals[inst.wren_node] != 0, wdata,
                                    ram[addr])
        return rams

    def settle(self, vals, rams, roms, timer=None, progress=None):
        """timer: list collecting per-level seconds (syncs per level).
        progress: callable(n_done)."""
        for plan in self.c.levels:
            t0 = time.time()
            vals = self._level(vals, rams, roms, plan)
            if timer is not None:
                self.block_until_ready(vals)
                timer.append(time.time() - t0)
            if progress is not None:
                progress(plan.n_gates)
        return vals, self._ram_writes(vals, rams)
