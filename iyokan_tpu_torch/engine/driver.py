"""Frontend: blueprint + request packet -> levelized run.

Implements the reference's per-cycle protocol exactly
(reference src/iyokan_plain.cpp:453-555, src/iyokan_tfhepp.cpp:475-560):

  0. if @reset exists (and not --skip-reset): set reset=1, settle the
     combinational network once (not counted as a cycle);
  1. per cycle: tick (DFFs latch), on the first cycle negate reset *after*
     the tick, set initial RAM / SDFF values (cycle 0 only, after the tick),
     feed circular @inputs (index = width*cycle + bit mod stream length),
     settle;
  2. plain mode only: cycles = -1 runs until @finflag reads 1;
  3. result packet: @output port values + RAM contents.

One frontend runs both engines; only the value domain differs (bits vs
TLWE ciphertexts).  Counterpart of iyokan_tpu/engine/driver.py: engine state
(node values and CMUX ROM/RAM stores) is torch tensors on the frontend's
device, converted to numpy at the packet and snapshot boundaries, so
--snapshot/--resume and --dump-prefix carry the RAM stores too.  tfhe mode
runs the JAX package's periodic CMUX-RAM refresh schedule
(IYOKAN_RAM_REFRESH_PERIOD, default 16).  Under a torch.profiler the build,
the reset settle, each cycle and its inputs, and the result packet are
spans (engine/spans.py).  The execution mode is the JAX
package's (IYOKAN_FUSE_LEVELS, default 8; engine/tfhe.py), logged in the
same words at go() start; under IYOKAN_FUSE_LEVELS=all with no per-cycle
observation, every cycle past the first runs in spans of IYOKAN_SCAN_CHUNK
cycles (default 4, or "max") through engine.run_cycles, the counterpart of
the JAX package's lax.scan.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np

from .. import packet as packet_mod
from ..circuit import blueprint as bp_mod
from ..circuit import compile as compile_mod
from ..circuit import iyokanl1, romram, yosys
from ..circuit.netlist import Design
from ..crypto import host, ops
from .spans import span

log = logging.getLogger("iyokan")


def build_design(bp: bp_mod.Blueprint) -> Design:
    """Instantiate all [[file]] circuits and [[builtin]] memories and apply
    [connect] (the reference frontend constructor shape,
    src/iyokan_plain.cpp:299-446)."""
    design = Design()

    for file in bp.files:
        with design.instance(file.name):
            with open(file.path, "r") as f:
                if file.type == "yosys-json":
                    yosys.read(design, f)
                else:
                    iyokanl1.read(design, f)

    for ram in bp.builtin_rams:
        if ram.type == "cmux":
            if ram.in_wdata_width != ram.out_rdata_width:
                raise ValueError(
                    "RAM with different wdata/rdata widths is not implemented"
                )
            design.add_cmux_ram(ram.name, ram.in_addr_width, ram.in_wdata_width)
        else:
            romram.make_mux_ram(
                design, ram.name, ram.in_addr_width, ram.out_rdata_width
            )

    for rom in bp.builtin_roms:
        if rom.type == "cmux":
            design.add_cmux_rom(rom.name, rom.in_addr_width, rom.out_rdata_width)
        else:
            romram.make_mux_rom(
                design, rom.name, rom.in_addr_width, rom.out_rdata_width
            )

    # check @ports exist, then wire the inter-instance edges
    for (name, bit), port in bp.at_ports.items():
        _resolve(design, port)
    for src, dst in bp.edges:
        s = _resolve(design, src)
        d = _resolve(design, dst)
        design.connect(s, d)

    return design


def _resolve(design: Design, port: bp_mod.Port) -> int:
    node = design.maybe_get(port.node_name, port.kind, port.port_name,
                            port.port_bit)
    if node is None:
        raise ValueError(
            f"invalid network; not found: {port.node_name}/{port.port_name}"
            f"[{port.port_bit}] ({port.kind})"
        )
    return node


class Frontend:
    """mode: 'plain' or 'tfhe'; device: where the engine state lives
    (default: ops.default_device(), the card or what IYOKAN_TORCH_DEVICE
    names; without either it raises)."""

    def __init__(self, mode: str, bp: bp_mod.Blueprint, req_packet,
                 eval_key: Optional[host.EvalKey] = None,
                 snapshot_state: Optional[dict] = None, device=None):
        with span("frontend.build"):
            self.mode = mode
            self.device = ops.check_device(
                ops.default_device() if device is None else device)
            self.bp = bp
            self.req = req_packet
            self.design = build_design(bp)
            self.compiled = compile_mod.compile_design(self.design)
            self.current_cycle = 0
            self._reset_negated = False

            census = self.compiled.gate_census()
            log.debug("gate census: %s", census)
            nboots = sum(p.n_bootstraps for p in self.compiled.levels)
            log.info(
                "design: %d nodes, %d levels, %d bootstraps/cycle",
                self.compiled.num_nodes, len(self.compiled.levels), nboots,
            )

            if mode == "plain":
                from .plain import PlainEngine

                self.engine = PlainEngine(self.compiled, self.device)
                self.params = None
            else:
                from .tfhe import TFHEEngine

                assert eval_key is not None, "tfhe mode requires an eval key"
                self.params = eval_key.params
                self.engine = TFHEEngine(self.compiled, eval_key, self.device)

            self._init_state(snapshot_state)

    # ------------------------------------------------------------------ #
    def _init_state(self, snapshot_state):
        eng = self.engine
        if snapshot_state is not None:
            self.vals = eng.load_vals(snapshot_state["vals"])
            self.rams = {k: eng.load_vals(v)
                         for k, v in snapshot_state["rams"].items()}
            self.roms = {k: eng.load_vals(v)
                         for k, v in snapshot_state["roms"].items()}
            self.current_cycle = int(snapshot_state["cycle"])
            self._reset_negated = True
            return

        self.vals = eng.init_vals()
        self.rams = {}
        self.roms = {}

        # built-in CMUX memory stores + ROM data, and MUX-ROM cell data
        for rom in self.bp.builtin_roms:
            if rom.type == "cmux":
                self.roms[rom.name] = eng.make_rom_store(
                    rom.name, rom.in_addr_width, rom.out_rdata_width,
                    self._rom_payload(rom.name),
                )
            else:
                data = self._rom_payload_mux(rom.name)
                if data is not None:
                    nodes = [
                        self.design.get(rom.name, "rom", "romdata", i)
                        for i in range(
                            (1 << rom.in_addr_width) * rom.out_rdata_width
                        )
                    ]
                    self.vals = eng.set_nodes(self.vals, nodes, data)
        for ram in self.bp.builtin_rams:
            if ram.type == "cmux":
                self.rams[ram.name] = eng.make_ram_store(
                    ram.name, ram.in_addr_width, ram.in_wdata_width, None
                )

    def _rom_payload(self, name):
        # plain bits and the TRLWE encoding share the .rom slot
        return self.req.rom.get(name)

    def _rom_payload_mux(self, name):
        if self.mode == "plain":
            return self.req.rom.get(name)
        return self.req.rom_tlwe.get(name)  # TLWE encoding for MUX memory

    # ------------------------------------------------------------------ #
    def _set_initial_ram(self):
        """Cycle-0 RAM initialization, after the first tick
        (reference src/iyokan_plain.cpp:226-268, :507-509)."""
        eng = self.engine
        for ram in self.bp.builtin_rams:
            if ram.type == "cmux":
                data = self.req.ram.get(ram.name)
                if data is not None:
                    self.rams[ram.name] = eng.make_ram_store(
                        ram.name, ram.in_addr_width, ram.in_wdata_width, data
                    )
            else:
                data = (self.req.ram.get(ram.name) if self.mode == "plain"
                        else self.req.ram_tlwe.get(ram.name))
                if data is not None:
                    size = (1 << ram.in_addr_width) * ram.out_rdata_width
                    if len(data) != size:
                        raise ValueError(
                            "invalid request packet: wrong length of RAM"
                        )
                    nodes = [
                        self.design.get(ram.name, "ram", "ramdata", i)
                        for i in range(size)
                    ]
                    self.vals = eng.set_nodes(self.vals, nodes, data)

    def _circular_input_ports(self):
        """(node, stream, width, bit) for every @input port fed from the
        request packet (reference src/iyokan_plain.cpp:270-292)."""
        streams = self.req.bits
        ports = []
        for (name, bit), port in self.bp.at_ports.items():
            if port.kind != "input" or name not in streams:
                continue
            if name == "reset":
                raise ValueError("@reset cannot be set by user's input")
            ports.append((_resolve(self.design, port), streams[name],
                          self.bp.at_port_widths[name], bit))
        return ports

    def _set_circular_inputs(self, cycle: int):
        """Feed one cycle's circular inputs as one batched scatter (a
        set_nodes per bit would pay the fixed dispatch cost once per
        input wire per cycle)."""
        ports = self._circular_input_ports()
        if ports:
            rows = [stream[(width * cycle + bit) % len(stream)]
                    for _, stream, width, bit in ports]
            self.vals = self.engine.set_nodes(
                self.vals, [pt[0] for pt in ports], np.asarray(rows)
            )

    def _circular_input_rows(self, start: int, k: int):
        """Input nodes + their next k cycles of circular stream rows
        (u32 [k, n_in, n+1]), for the multi-cycle scan path."""
        ports = self._circular_input_ports()
        nodes = [pt[0] for pt in ports]
        width1 = self.vals.shape[1]
        rows = np.zeros((k, len(ports), width1), np.uint32)
        for j, (_, stream, width, bit) in enumerate(ports):
            for c in range(k):
                rows[c, j] = stream[(width * (start + c) + bit) % len(stream)]
        return nodes, rows

    def _reset_node(self) -> Optional[int]:
        port = self.bp.at("reset")
        if port is None or port.kind != "input":
            return None
        return _resolve(self.design, port)

    # ------------------------------------------------------------------ #
    def _log_execution_mode(self, can_scan, chunk_env, dump_prefix,
                            stdout_csv, dump_time_csv_prefix,
                            show_combinational_progress, on_cycle) -> None:
        """One line at go() start naming the execution mode actually
        chosen, in the JAX package's words (dump/CSV/progress flags force
        the per-cycle path)."""
        if self.mode != "tfhe":
            log.info("execution mode: plain (per-level batched eval)")
            return
        fuse_env = os.environ.get("IYOKAN_FUSE_LEVELS", "8")
        if can_scan:
            log.info("execution mode: whole-cycle fusion + multi-cycle "
                     "lax.scan (chunk=%s)", chunk_env)
            return
        if fuse_env == "all":
            forced_by = [name for name, on in (
                ("IYOKAN_PROFILE", os.environ.get("IYOKAN_PROFILE")),
                ("--dump-prefix", dump_prefix is not None),
                ("--stdout-csv", stdout_csv),
                ("--dump-time-csv-prefix", dump_time_csv_prefix is not None),
                ("--show-combinational-progress",
                 show_combinational_progress),
                ("on_cycle callback", on_cycle is not None),
            ) if on]
            log.info("execution mode: whole-cycle fusion, per-cycle dispatch"
                     " (multi-cycle scan disabled by: %s)",
                     ", ".join(forced_by) or "unknown")
            return
        log.info("execution mode: per-level dispatch, gate levels fused in "
                 "groups of %s (IYOKAN_FUSE_LEVELS)", fuse_env)

    def go(self, num_cycles: Optional[int], skip_reset: bool = False,
           dump_prefix: Optional[str] = None,
           dump_sk: Optional[host.SecretKey] = None,
           stdout_csv: bool = False,
           dump_time_csv_prefix: Optional[str] = None,
           dump_graph_json_prefix: Optional[str] = None,
           dump_graph_dot_prefix: Optional[str] = None,
           show_combinational_progress: bool = False,
           on_cycle=None) -> None:
        eng = self.engine
        if num_cycles is None:
            num_cycles = -1
        if self.mode == "tfhe" and num_cycles < 0:
            raise ValueError("tfhe mode requires an explicit cycle count")

        reset = self._reset_node()
        should_negate = False
        if self.current_cycle == 0 and not skip_reset and reset is not None:
            with span("reset"):
                self.vals = eng.set_const_bits(self.vals, [reset], [1])
                self.vals, self.rams = eng.settle(self.vals, self.rams,
                                                  self.roms)
            should_negate = True

        # Periodic RAM refresh (tfhe CMUX RAM only): the full-store refresh
        # bootstrap runs every P-th cycle instead of every cycle; skipped
        # cycles keep the CMUX tree output as the store and refresh only
        # the freshly written rows (engine._ram_write_all).  The schedule
        # keys off the ABSOLUTE cycle number, so snapshot/resume reproduces
        # it exactly.
        period = 1
        if self.mode == "tfhe" and self.bp.builtin_rams:
            raw = os.environ.get("IYOKAN_RAM_REFRESH_PERIOD", "16")
            try:
                period = max(1, int(raw))
            except ValueError:
                log.warning("invalid IYOKAN_RAM_REFRESH_PERIOD=%r (want a "
                            "positive int); using 16", raw)
                period = 16

        def refresh_at(cycle_idx: int) -> bool:
            return period == 1 or (cycle_idx + 1) % period == 0

        finflag_port = self.bp.at("finflag")
        # multi-cycle scan: with whole-cycle fusion on and no per-cycle
        # observation requested, every cycle past the first runs inside
        # one span of engine.run_cycles
        can_scan = (
            self.mode == "tfhe"
            and os.environ.get("IYOKAN_FUSE_LEVELS") == "all"
            and not os.environ.get("IYOKAN_PROFILE")
            and dump_prefix is None
            and not stdout_csv
            and dump_time_csv_prefix is None
            and not show_combinational_progress
            and on_cycle is None
        )
        # scan chunk: cycles run in spans of this many; "max" runs the
        # whole remainder as one span
        chunk_env = os.environ.get("IYOKAN_SCAN_CHUNK", "4")
        if chunk_env != "max":
            try:
                if int(chunk_env) < 1:
                    raise ValueError(chunk_env)
            except ValueError:
                log.warning(
                    "invalid IYOKAN_SCAN_CHUNK=%r (want a positive int or "
                    "'max'); using the default of 4", chunk_env)
                chunk_env = "4"
        self._log_execution_mode(can_scan, chunk_env, dump_prefix,
                                 stdout_csv, dump_time_csv_prefix,
                                 show_combinational_progress, on_cycle)
        i = 0
        while num_cycles < 0 or i < num_cycles:
            remaining = num_cycles - i
            if can_scan:
                chunk = remaining if chunk_env == "max" else int(chunk_env)
                n_span = min(chunk, remaining)
            else:
                chunk = n_span = 0
            if can_scan and n_span > 1 and remaining >= chunk \
                    and self.current_cycle != 0:
                log.info("#%d..#%d (scanned)", self.current_cycle + 1,
                         self.current_cycle + n_span)
                t0 = time.time()
                with span("scan"):
                    nodes, rows = self._circular_input_rows(
                        self.current_cycle, n_span)
                    flags = [refresh_at(self.current_cycle + j)
                             for j in range(n_span)]
                    self.vals, self.rams = eng.run_cycles(
                        self.vals, self.rams, self.roms, nodes, rows,
                        refresh_flags=flags)
                    eng.block_until_ready(self.vals)
                log.info("\tdone. (%d us)", int((time.time() - t0) * 1e6))
                for c in range(self.current_cycle,
                               self.current_cycle + n_span):
                    self._dump_graph_files(dump_graph_json_prefix,
                                           dump_graph_dot_prefix, c)
                i += n_span
                self.current_cycle += n_span
                continue
            log.info("#%d", self.current_cycle + 1)
            if stdout_csv:
                print(f"{time.time()},start,{self.current_cycle + 1}",
                      flush=True)
            if dump_prefix is not None:
                self._dump(dump_prefix, dump_sk)
            t0 = time.time()

            level_times = [] if dump_time_csv_prefix else None
            progress_cb = None
            if show_combinational_progress:
                total = sum(p.n_gates for p in self.compiled.levels)
                state = {"done": 0, "next": 1000}
                cyc = self.current_cycle + 1

                def progress_cb(n, state=state, total=total, cyc=cyc):
                    # reference prints every 1000 finished gates
                    # (src/iyokan_plain.cpp:42-46)
                    state["done"] += n
                    if state["done"] >= state["next"] or state["done"] == total:
                        log.info("\tcycle %d: %d / %d gates evaluated",
                                 cyc, state["done"], total)
                        state["next"] = state["done"] + 1000

            settle_kw = {}
            if self.mode == "tfhe":
                settle_kw["ram_refresh"] = refresh_at(self.current_cycle)
            with span("cycle"):
                with span("inputs"):
                    self.vals = eng.tick(self.vals)
                    if i == 0 and should_negate:
                        self.vals = eng.set_const_bits(self.vals, [reset], [0])
                    if self.current_cycle == 0:
                        self._set_initial_ram()
                        if len(self.compiled.sdff_nodes):
                            self.vals = eng.set_const_bits(
                                self.vals, self.compiled.sdff_nodes,
                                self.compiled.sdff_vals,
                            )
                    self._set_circular_inputs(self.current_cycle)
                self.vals, self.rams = eng.settle(
                    self.vals, self.rams, self.roms,
                    timer=level_times, progress=progress_cb, **settle_kw,
                )
                eng.block_until_ready(self.vals)

            dt = time.time() - t0
            log.info("\tdone. (%d us)", int(dt * 1e6))
            if dump_time_csv_prefix:
                from . import progress

                with open(f"{dump_time_csv_prefix}-{self.current_cycle}.csv",
                          "w") as f:
                    progress.dump_time_csv(self.compiled, self.current_cycle,
                                           level_times, dt, f)
            self._dump_graph_files(dump_graph_json_prefix,
                                   dump_graph_dot_prefix, self.current_cycle)
            if stdout_csv:
                print(f"{time.time()},end,{self.current_cycle + 1}",
                      flush=True)
            if on_cycle is not None:
                on_cycle(self)

            i += 1
            self.current_cycle += 1
            if (
                num_cycles < 0
                and self.mode == "plain"
                and finflag_port is not None
                and finflag_port.kind == "output"
            ):
                node = _resolve(self.design, finflag_port)
                if int(self.vals[node]) == 1:
                    log.info("break.")
                    break

    def _dump_graph_files(self, json_prefix, dot_prefix, cycle: int):
        """--dump-graph-json-prefix / --dump-graph-dot-prefix: the
        circuit graph's file of one cycle."""
        from . import progress

        if json_prefix:
            with open(f"{json_prefix}-{cycle}.json", "w") as f:
                progress.dump_graph_json(self.compiled, f)
        if dot_prefix:
            with open(f"{dot_prefix}-{cycle}.dot", "w") as f:
                progress.dump_graph_dot(self.compiled, f)

    # ------------------------------------------------------------------ #
    def make_result_packet(self):
        """@output port values + RAM contents
        (reference makeResPacket, src/iyokan_plain.cpp:174-224)."""
        with span("result_packet"):
            eng = self.engine
            if self.mode == "plain":
                res = packet_mod.PlainPacket(num_cycles=self.current_cycle)
            else:
                res = packet_mod.TFHEPacket(
                    params=self.params.name, num_cycles=self.current_cycle
                )

            widths: Dict[str, int] = {}
            nodes_by_port: Dict[str, dict] = {}
            for (name, bit), port in self.bp.at_ports.items():
                if port.kind != "output":
                    continue
                widths[name] = max(widths.get(name, 0), bit + 1)
                nodes_by_port.setdefault(name, {})[bit] = _resolve(
                    self.design, port
                )
            for name, w in widths.items():
                nodes = [nodes_by_port[name].get(b) for b in range(w)]
                res.bits[name] = eng.read_nodes(self.vals, nodes)

            for ram in self.bp.builtin_rams:
                if ram.type == "cmux":
                    res.ram[ram.name] = eng.read_ram_store(self.rams[ram.name])
                else:
                    size = (1 << ram.in_addr_width) * ram.out_rdata_width
                    nodes = [
                        self.design.get(ram.name, "ram", "ramdata", i)
                        for i in range(size)
                    ]
                    if self.mode == "plain":
                        res.ram[ram.name] = eng.read_nodes(self.vals, nodes)
                    else:
                        res.ram_tlwe[ram.name] = eng.read_nodes(self.vals,
                                                                nodes)
            return res

    def _dump(self, prefix: str, dump_sk):
        """--dump-prefix: per-cycle result packet (decrypted when a secret
        key is supplied in TFHE mode, reference src/iyokan_tfhepp.cpp:298-305).
        """
        res = self.make_result_packet()
        res.num_cycles = self.current_cycle
        path = f"{prefix}-{self.current_cycle}"
        if self.mode == "tfhe":
            if dump_sk is None:
                return
            res = res.decrypt(dump_sk)
        res.save(path)

    # ------------------------------------------------------------------ #
    def snapshot_state(self) -> dict:
        return {
            "vals": self.engine.vals_numpy(self.vals),
            "rams": {k: self.engine.vals_numpy(v)
                     for k, v in self.rams.items()},
            "roms": {k: self.engine.vals_numpy(v)
                     for k, v in self.roms.items()},
            "cycle": self.current_cycle,
        }
