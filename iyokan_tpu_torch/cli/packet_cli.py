"""`iyokan-packet` equivalent CLI (python -m iyokan_tpu_torch.cli.packet_cli).

Keys and packets are the same files as the JAX package's
(iyokan_tpu/cli/packet_cli.py): numpy from the same seeds.

Subcommands and semantics follow the reference tool
(reference src/iyokan-packet.cpp:328-485):

  genkey      --type tfhepp --out FILE [--params NAME] [--seed N]
  genevalkey  --in secret.key --out eval.key [--seed N]
  enc         --key secret.key --in packet.plain --out packet.enc
  dec         --key secret.key --in packet.enc --out packet.plain
  pack        --out packet.plain [--rom name:file]... [--ram ...] [--bits ...]
  packet2toml --in packet.plain            (prints TOML to stdout)
  toml2packet --in packet.toml --out packet.plain
  convert / convert-plain --in NAME FILE ... --out FILE RULES...
              rules: "(ram|rom|bits).dst = src.field"
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np

from .. import packet as packet_mod
from ..crypto import host
from ..params import by_name


def _read_bin_bits(path: str) -> np.ndarray:
    """Binary file -> LSB-first bit vector (reference readAsBitVec,
    src/iyokan-packet.cpp:44-57)."""
    with open(path, "rb") as f:
        data = f.read()
    return np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")


def _parse_kv(items):
    out = []
    for item in items or []:
        if ":" not in item:
            raise SystemExit(f"invalid NAME:FILE option: {item}")
        name, path = item.split(":", 1)
        out.append((name, path))
    return out


_RULE_RE = re.compile(
    r"(ram|rom|bits)\.([a-zA-Z0-9]+)\s*=\s*([a-zA-Z0-9]+)\.([a-zA-Z0-9]+)"
)


def _apply_convert(out_pkt, name2pkt, rules, fields):
    for rule in rules:
        m = _RULE_RE.fullmatch(rule)
        if not m:
            raise SystemExit(f"invalid assignment: {rule}")
        sec, dst, src_pkt, src_field = m.groups()
        src = name2pkt[src_pkt]
        for attr in fields[sec]:
            getattr(out_pkt, attr)[dst] = getattr(src, attr)[src_field]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="iyokan-packet", description="A toolset for iyokan packets"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("genkey")
    g.add_argument("--type", default="tfhepp", choices=["tfhepp"])
    g.add_argument("-o", "--out", required=True)
    g.add_argument("--params", default="cggi128")
    g.add_argument("--seed", type=int, default=None)

    g = sub.add_parser("genevalkey")
    g.add_argument("-i", "--in", dest="inp", required=True)
    g.add_argument("-o", "--out", required=True)
    g.add_argument("--seed", type=int, default=None)

    for name in ("enc", "dec"):
        g = sub.add_parser(name)
        g.add_argument("--key", required=True)
        g.add_argument("-i", "--in", dest="inp", required=True)
        g.add_argument("-o", "--out", required=True)

    g = sub.add_parser("pack")
    g.add_argument("-o", "--out", required=True)
    g.add_argument("--rom", action="append")
    g.add_argument("--ram", action="append")
    g.add_argument("--bits", action="append")

    g = sub.add_parser("packet2toml")
    g.add_argument("-i", "--in", dest="inp", required=True)

    g = sub.add_parser("toml2packet")
    g.add_argument("-i", "--in", dest="inp", required=True)
    g.add_argument("-o", "--out", required=True)

    for name in ("convert", "convert-plain"):
        g = sub.add_parser(name)
        g.add_argument("-i", "--in", dest="ins", nargs=2, action="append",
                       metavar=("NAME", "FILE"), required=True)
        g.add_argument("-o", "--out", required=True)
        g.add_argument("rules", nargs="*")

    args = ap.parse_args(argv)

    if args.cmd == "genkey":
        sk = host.keygen(by_name(args.params), seed=args.seed)
        sk.save(args.out)
    elif args.cmd == "genevalkey":
        sk = host.SecretKey.load(args.inp)
        host.genevalkey(sk, seed=args.seed).save(args.out)
    elif args.cmd == "enc":
        sk = host.SecretKey.load(args.key)
        pkt = packet_mod.PlainPacket.load(args.inp)
        pkt.encrypt(sk).save(args.out)
    elif args.cmd == "dec":
        sk = host.SecretKey.load(args.key)
        pkt = packet_mod.TFHEPacket.load(args.inp)
        pkt.decrypt(sk).save(args.out)
    elif args.cmd == "pack":
        pkt = packet_mod.PlainPacket()
        for name, path in _parse_kv(args.rom):
            pkt.rom[name] = _read_bin_bits(path)
        for name, path in _parse_kv(args.ram):
            pkt.ram[name] = _read_bin_bits(path)
        for name, path in _parse_kv(args.bits):
            pkt.bits[name] = _read_bin_bits(path)
        pkt.save(args.out)
    elif args.cmd == "packet2toml":
        pkt = packet_mod.PlainPacket.load(args.inp)
        sys.stdout.write(pkt.to_toml())
    elif args.cmd == "toml2packet":
        packet_mod.PlainPacket.from_toml_file(args.inp).save(args.out)
    elif args.cmd == "convert-plain":
        name2pkt = {
            n: packet_mod.PlainPacket.load(p) for n, p in args.ins
        }
        out = packet_mod.PlainPacket()
        _apply_convert(out, name2pkt, args.rules,
                       {"ram": ["ram"], "rom": ["rom"], "bits": ["bits"]})
        out.save(args.out)
    elif args.cmd == "convert":
        name2pkt = {n: packet_mod.TFHEPacket.load(p) for n, p in args.ins}
        any_pkt = next(iter(name2pkt.values()))
        out = packet_mod.TFHEPacket(params=any_pkt.params)
        _apply_convert(
            out, name2pkt, args.rules,
            {"ram": ["ram", "ram_tlwe"], "rom": ["rom", "rom_tlwe"],
             "bits": ["bits"]},
        )
        out.save(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
