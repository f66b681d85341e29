"""Blueprint TOML: the circuit composition language.

Same schema as the reference's NetworkBlueprint
(reference src/iyokan.hpp:1671-1953):

  [[file]]     type = "yosys-json" | "iyokanl1-json", path, name
  [[builtin]]  type = "rom" | "mux-rom" (in_addr_width, out_rdata_width)
               type = "ram" | "mux-ram" (in_addr_width, in_wdata_width,
                                         out_rdata_width)
  [connect]    "dst" = "src" port pairs, either side may be a top-level
               "@name"; bit ranges "node/port[hi:lo]"; special key TOGND
               declares unused @outputs (width tracking only).

Port strings match the reference regex
``^@?(?:([^/]+)/)?([^[]+)(?:\\[([0-9]+):([0-9]+)\\])?$``
(reference src/iyokan.hpp:1697-1699); relative [[file]] paths resolve against
the blueprint's directory (reference :1759-1760).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import tomllib
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

_PORT_RE = re.compile(r"^@?(?:([^/]+)/)?([^[]+)(?:\[([0-9]+):([0-9]+)\])?$")


@dataclasses.dataclass(frozen=True)
class Port:
    node_name: str  # instance name; "" for @ports
    kind: str       # "input" | "output"
    port_name: str
    port_bit: int


@dataclasses.dataclass
class File:
    type: str  # "yosys-json" | "iyokanl1-json"
    path: str
    name: str


@dataclasses.dataclass
class BuiltinROM:
    type: str  # "cmux" | "mux"
    name: str
    in_addr_width: int
    out_rdata_width: int


@dataclasses.dataclass
class BuiltinRAM:
    type: str  # "cmux" | "mux"
    name: str
    in_addr_width: int
    in_wdata_width: int
    out_rdata_width: int


def _parse_ports(src: str, kind: str) -> List[Port]:
    m = _PORT_RE.match(src)
    if not m:
        raise ValueError(f"invalid port string: {src}")
    node = m.group(1) or ""
    port = m.group(2)
    if m.group(3) is None:
        lo = hi = 0
    else:
        lo, hi = int(m.group(3)), int(m.group(4))
    return [Port(node, kind, port, i) for i in range(lo, hi + 1)]


class Blueprint:
    def __init__(self, path: str) -> None:
        self.source_file = path
        with open(path, "rb") as f:
            src = tomllib.load(f)
        wd = os.path.dirname(os.path.abspath(path))

        self.files: List[File] = []
        for file in src.get("file", []):
            t = file["type"]
            if t not in ("yosys-json", "iyokanl1-json"):
                raise ValueError(f"invalid file type: {t}")
            p = file["path"]
            if not os.path.isabs(p):
                p = os.path.join(wd, p)
            self.files.append(File(t, p, file["name"]))

        self.builtin_roms: List[BuiltinROM] = []
        self.builtin_rams: List[BuiltinRAM] = []
        for b in src.get("builtin", []):
            t, name = b["type"], b["name"]
            if t in ("rom", "mux-rom"):
                self.builtin_roms.append(
                    BuiltinROM(
                        "cmux" if t == "rom" else "mux", name,
                        int(b["in_addr_width"]), int(b["out_rdata_width"]),
                    )
                )
            elif t in ("ram", "mux-ram"):
                self.builtin_rams.append(
                    BuiltinRAM(
                        "cmux" if t == "ram" else "mux", name,
                        int(b["in_addr_width"]), int(b["in_wdata_width"]),
                        int(b["out_rdata_width"]),
                    )
                )
            else:
                raise ValueError(f"invalid builtin type: {t}")

        # edges: (from output Port, to input Port); @-ports: (name,bit) -> Port
        self.edges: List[Tuple[Port, Port]] = []
        self.at_ports: Dict[Tuple[str, int], Port] = {}
        self.at_port_widths: Dict[str, int] = {}

        for dst_str, src_val in src.get("connect", {}).items():
            if dst_str == "TOGND":
                # TOGND = ["@...", ...]: only records @port widths
                # (reference src/iyokan.hpp:1809-1825)
                for port_str in src_val:
                    if not port_str.startswith("@"):
                        raise ValueError(f"invalid TOGND port: {port_str}")
                    for port in _parse_ports(port_str, "output"):
                        self._track_width(port.port_name, port.port_bit)
                continue

            src_str = src_val
            if not dst_str or not src_str or (
                dst_str.startswith("@") and src_str.startswith("@")
            ):
                raise ValueError(f"invalid connect: {dst_str} = {src_str}")
            dsts = _parse_ports(dst_str, "input")
            srcs = _parse_ports(src_str, "output")
            if len(dsts) != len(srcs):
                raise ValueError(
                    f"invalid connect (width mismatch): {dst_str} = {src_str}"
                )
            for dst, s in zip(dsts, srcs):
                if dst_str.startswith("@"):
                    if dst.node_name or not s.node_name:
                        raise ValueError(f"invalid connect: {dst_str}={src_str}")
                    key = (dst.port_name, dst.port_bit)
                    if key in self.at_ports:
                        # reference parity incl. the limitation: an @port
                        # used twice keeps only its first binding
                        # (src/iyokan.hpp:1857-1864 "Only the first one is
                        # effective")
                        log.warning("%s is used multiple times. Only the "
                                    "first one is effective.", dst_str)
                    self.at_ports.setdefault(key, s)
                    self._track_width(dst.port_name, dst.port_bit)
                elif src_str.startswith("@"):
                    if s.node_name or not dst.node_name:
                        raise ValueError(f"invalid connect: {dst_str}={src_str}")
                    key = (s.port_name, s.port_bit)
                    if key in self.at_ports:
                        # reference src/iyokan.hpp:1877-1884 (FIXME there
                        # too): fanning one @input to several sinks keeps
                        # only the first -- declare separate @ports and
                        # feed them the same packet stream instead
                        log.warning("%s is used multiple times. Only the "
                                    "first one is effective.", src_str)
                    self.at_ports.setdefault(key, dst)
                    self._track_width(s.port_name, s.port_bit)
                else:
                    self.edges.append((s, dst))

    def _track_width(self, name: str, bit: int) -> None:
        self.at_port_widths[name] = max(
            self.at_port_widths.get(name, 0), bit + 1
        )

    def at(self, port_name: str, port_bit: int = 0) -> Optional[Port]:
        return self.at_ports.get((port_name, port_bit))

    def needs_circuit_key(self) -> bool:
        """True iff any CMUX-memory builtin exists
        (reference src/iyokan.hpp:1897-1906)."""
        return any(r.type == "cmux" for r in self.builtin_roms) or any(
            r.type == "cmux" for r in self.builtin_rams
        )
