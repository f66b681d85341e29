"""Request/result packets and their TOML interop.

Mirrors the reference's packet layer (src/packet.hpp:193-285 and the TOML
schema of iyokan-packet, src/iyokan-packet.cpp:99-142,191-234):

  PlainPacket: named bit vectors for ram / rom / bits + cycles.
  TFHEPacket:  ram/rom in *two* encodings each -- TRLWE words for the CMUX
               memories and per-bit TLWE for the MUX memories (the reference
               always produces both on encrypt, src/packet.hpp:225-259) --
               plus TLWE bit streams.

On-disk format is numpy .npz (the reference uses cereal portable binary;
TOML is the interop boundary either way).  TOML schema:
  cycles = N
  [[ram]] / [[rom]] / [[bits]] entries of {name, size, bytes} with bits
  packed LSB-first into bytes.
"""

from __future__ import annotations

import dataclasses
import io
import tomllib
from typing import Dict, Optional

import numpy as np

from .crypto import host


def bits_from_bytes(byts, size: int) -> np.ndarray:
    """LSB-first unpack, zero-extended/truncated to `size` bits
    (reference doToml2Packet, src/iyokan-packet.cpp:210-225)."""
    arr = np.frombuffer(bytes(bytearray(byts)), np.uint8)
    bits = np.unpackbits(arr, bitorder="little")
    out = np.zeros(size, np.uint8)
    n = min(size, bits.size)
    out[:n] = bits[:n]
    return out


def bytes_from_bits(bits: np.ndarray) -> list:
    """LSB-first pack (reference printPlainPacket bits2bytes,
    src/iyokan-packet.cpp:108-121)."""
    arr = (np.asarray(bits).astype(np.uint8) & 1)
    return np.packbits(arr, bitorder="little").tolist()


@dataclasses.dataclass
class PlainPacket:
    ram: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    rom: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    bits: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    num_cycles: Optional[int] = None

    # ------------------------------- io ------------------------------- #
    def save(self, path: str) -> None:
        data = {"kind": "plain-packet",
                "cycles": np.int64(-1 if self.num_cycles is None
                                   else self.num_cycles)}
        for pfx, d in (("ram", self.ram), ("rom", self.rom),
                       ("bits", self.bits)):
            for name, v in d.items():
                data[f"{pfx}/{name}"] = np.asarray(v, np.uint8)
        with open(path, "wb") as f:
            np.savez_compressed(f, **data)

    @staticmethod
    def load(path: str) -> "PlainPacket":
        z = np.load(path, allow_pickle=False)
        if "kind" not in z.files or str(z["kind"]) != "plain-packet":
            raise ValueError(f"{path!r} is not a plain packet")
        pkt = PlainPacket(num_cycles=int(z["cycles"]))
        for key in z.files:
            if "/" in key:
                pfx, name = key.split("/", 1)
                getattr(pkt, pfx)[name] = z[key]
        return pkt

    # ------------------------------ toml ------------------------------ #
    @staticmethod
    def from_toml(text: str) -> "PlainPacket":
        root = tomllib.loads(text)
        pkt = PlainPacket(num_cycles=int(root.get("cycles", -1)))
        for entry_name, target in (("ram", pkt.ram), ("rom", pkt.rom),
                                   ("bits", pkt.bits)):
            for table in root.get(entry_name, []):
                target[table["name"]] = bits_from_bytes(
                    table["bytes"], int(table["size"])
                )
        return pkt

    @staticmethod
    def from_toml_file(path: str) -> "PlainPacket":
        with open(path, "r") as f:
            return PlainPacket.from_toml(f.read())

    def to_toml(self) -> str:
        out = io.StringIO()
        out.write(
            f"cycles = {self.num_cycles if self.num_cycles is not None else -1}\n"
        )
        for entry_name, d in (("ram", self.ram), ("rom", self.rom),
                              ("bits", self.bits)):
            for name in sorted(d):
                bits = d[name]
                byts = bytes_from_bits(bits)
                out.write(f"\n[[{entry_name}]]\n")
                out.write(f'name = "{name}"\n')
                out.write(f"size = {len(bits)}\n")
                out.write(f"bytes = {list(byts)}\n")
        return out.getvalue()

    # ---------------------------- encrypt ----------------------------- #
    def encrypt(self, sk: host.SecretKey, seed: Optional[int] = None
                ) -> "TFHEPacket":
        rng = np.random.default_rng(seed)
        t = TFHEPacket(params=sk.params.name, num_cycles=self.num_cycles)
        for name, bits in self.ram.items():
            t.ram[name] = host.encrypt_ram(sk, bits, rng)
            t.ram_tlwe[name] = host.encrypt_bits(sk, bits, rng)
        for name, bits in self.rom.items():
            t.rom[name] = host.encrypt_rom(sk, bits, rng)
            t.rom_tlwe[name] = host.encrypt_bits(sk, bits, rng)
        for name, bits in self.bits.items():
            t.bits[name] = host.encrypt_bits(sk, bits, rng)
        return t


@dataclasses.dataclass
class TFHEPacket:
    params: str = "cggi128"
    ram: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    ram_tlwe: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    rom: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    rom_tlwe: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    bits: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    num_cycles: Optional[int] = None

    _FIELDS = ("ram", "ram_tlwe", "rom", "rom_tlwe", "bits")

    def save(self, path: str) -> None:
        data = {"kind": "tfhe-packet", "params": self.params,
                "cycles": np.int64(-1 if self.num_cycles is None
                                   else self.num_cycles)}
        for pfx in self._FIELDS:
            for name, v in getattr(self, pfx).items():
                data[f"{pfx}/{name}"] = v
        with open(path, "wb") as f:
            np.savez(f, **data)

    @staticmethod
    def load(path: str) -> "TFHEPacket":
        z = np.load(path, allow_pickle=False)
        if "kind" not in z.files or str(z["kind"]) != "tfhe-packet":
            raise ValueError(f"{path!r} is not a TFHE packet")
        pkt = TFHEPacket(params=str(z["params"]), num_cycles=int(z["cycles"]))
        for key in z.files:
            if "/" in key:
                pfx, name = key.split("/", 1)
                getattr(pkt, pfx)[name] = z[key]
        return pkt

    def decrypt(self, sk: host.SecretKey) -> PlainPacket:
        """Reference TFHEPacket::decrypt (src/packet.hpp:261-285): TRLWE
        entries win for CMUX memories, TLWE entries for MUX memories."""
        pkt = PlainPacket(num_cycles=self.num_cycles)
        for name, ct in self.ram.items():
            pkt.ram[name] = host.decrypt_ram(sk, ct)
        for name, ct in self.ram_tlwe.items():
            pkt.ram.setdefault(name, host.decrypt_bits(sk, ct))
        for name, ct in self.rom.items():
            pkt.rom[name] = host.decrypt_rom(sk, ct)
        for name, ct in self.rom_tlwe.items():
            pkt.rom.setdefault(name, host.decrypt_bits(sk, ct))
        for name, ct in self.bits.items():
            pkt.bits[name] = host.decrypt_bits(sk, ct)
        return pkt


def load_any(path: str):
    """Sniff packet type (the reference sniffs cereal archives by try-parse,
    src/packet.hpp:346-360)."""
    z = np.load(path, allow_pickle=False)
    kind = str(z["kind"])
    if kind == "plain-packet":
        return PlainPacket.load(path)
    if kind == "tfhe-packet":
        return TFHEPacket.load(path)
    raise ValueError(f"unknown packet kind {kind!r} in {path}")
