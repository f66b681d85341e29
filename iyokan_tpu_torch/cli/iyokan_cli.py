"""`iyokan` equivalent CLI: plain / tfhe subcommands (torch port).

    python -m iyokan_tpu_torch.cli.iyokan_cli tfhe --blueprint B -i REQ \
        -o RES --evalkey EK -c N

The engine runs on the card.  IYOKAN_TORCH_DEVICE=cpu runs it on the CPU
(the kernels' plain twins), as JAX_PLATFORMS=cpu steers the JAX CLI; with
no card and the variable unset the CLI raises.  Counterpart of
iyokan_tpu/cli/iyokan_cli.py with the same options.

Option surface mirrors the reference (reference src/main.cpp:41-277):
  --blueprint -i -o -c --evalkey --secret-key --dump-prefix --snapshot
  --resume --stdout-csv --quiet --verbose --skip-reset
plus --params for the parameter set.  (--cpu/--gpu/--num-gpu worker counts
have no meaning here: parallelism is the batch axis; --sched is accepted and
ignored for compatibility -- scheduling collapsed into levelization.)

Resume semantics match the reference (src/main.cpp:242-260 + overwriteParams):
the snapshot stores run parameters and the complete engine state (wire
ciphertexts, RAM stores, cycle counter); CLI options given alongside --resume
override the saved parameters.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from .. import packet as packet_mod
from ..circuit.blueprint import Blueprint
from ..crypto import host
from ..engine.driver import Frontend

log = logging.getLogger("iyokan")


def _common_args(g):
    g.add_argument("--blueprint")
    g.add_argument("-i", "--in", dest="inp")
    g.add_argument("-o", "--out")
    g.add_argument("-c", dest="cycles", type=int, default=None)
    g.add_argument("--dump-prefix")
    g.add_argument("--snapshot")
    g.add_argument("--resume")
    g.add_argument("--stdout-csv", action="store_true")
    g.add_argument("--quiet", action="store_true")
    g.add_argument("--verbose", action="store_true")
    g.add_argument("--skip-reset", action="store_true")
    g.add_argument("--dump-time-csv-prefix")
    g.add_argument("--dump-graph-json-prefix")
    g.add_argument("--dump-graph-dot-prefix")
    g.add_argument("--sched", choices=["topo", "ranku"], default=None,
                   help="accepted for compatibility; levelization replaces "
                        "runtime scheduling")
    g.add_argument("--cpu", type=int, default=None,
                   help="accepted for compatibility (unused)")
    g.add_argument("--show-combinational-progress", action="store_true")


def _blueprint_hash(path) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _evalkey_fingerprint(ek) -> str:
    """Cheap stable eval-key fingerprint: hash of a ksk prefix (key material
    is high-entropy, so a prefix distinguishes keys)."""
    import hashlib

    h = hashlib.sha256()
    h.update(ek.params.name.encode())
    h.update(np.ascontiguousarray(ek.ksk.reshape(-1)[:65536]).tobytes())
    return h.hexdigest()


def _save_snapshot(path, mode, args, fe, ek=None):
    """The reference serializes the whole frontend (params + networks +
    state, src/iyokan_plain.cpp:557-561); the levelized equivalent is the
    small state dict plus identity guards (blueprint hash, params name,
    eval-key fingerprint) so resuming against different inputs fails fast
    instead of producing silent garbage."""
    state = fe.snapshot_state()
    data = {
        "kind": "iyokan-snapshot",
        "mode": mode,
        "blueprint": fe.bp.source_file,
        "blueprint_hash": _blueprint_hash(fe.bp.source_file),
        "params": fe.params.name if fe.params is not None else "",
        "evalkey_fp": _evalkey_fingerprint(ek) if ek is not None else "",
        "cycle": np.int64(state["cycle"]),
        "cycles_opt": np.int64(-1 if args.cycles is None else args.cycles),
        "input": args.inp or "",
        "output": args.out or "",
        "vals": state["vals"],
    }
    for k, v in state["rams"].items():
        data[f"ram/{k}"] = v
    for k, v in state["roms"].items():
        data[f"rom/{k}"] = v
    with open(path, "wb") as f:
        np.savez(f, **data)


def _load_snapshot(path):
    z = np.load(path, allow_pickle=False)
    if "kind" not in z.files or str(z["kind"]) != "iyokan-snapshot":
        raise SystemExit(f"invalid resume file: {path}")
    state = {
        "vals": z["vals"],
        "rams": {}, "roms": {},
        "cycle": int(z["cycle"]),
    }
    for key in z.files:
        if key.startswith("ram/"):
            state["rams"][key[4:]] = z[key]
        elif key.startswith("rom/"):
            state["roms"][key[4:]] = z[key]
    meta = {
        "mode": str(z["mode"]),
        "blueprint": str(z["blueprint"]),
        "blueprint_hash": str(z["blueprint_hash"])
        if "blueprint_hash" in z.files else "",
        "params": str(z["params"]) if "params" in z.files else "",
        "evalkey_fp": str(z["evalkey_fp"]) if "evalkey_fp" in z.files else "",
        "cycles_opt": int(z["cycles_opt"]),
        "input": str(z["input"]),
        "output": str(z["output"]),
    }
    return meta, state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="iyokan",
        description="FHE circuit evaluation engine (PyTorch/CUDA)"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("plain")
    _common_args(g)

    g = sub.add_parser("tfhe")
    _common_args(g)
    g.add_argument("--evalkey")
    g.add_argument("--secret-key", dest="secret_key")
    g.add_argument("--enable-gpu", action="store_true",
                   help="accepted for compatibility: the engine runs on "
                        "the card unless IYOKAN_TORCH_DEVICE names another "
                        "device")
    g.add_argument("--gpu", type=int, default=None,
                   help="accepted for compatibility (unused)")
    g.add_argument("--num-gpu", type=int, default=None,
                   help="accepted for compatibility (unused)")

    args = ap.parse_args(argv)
    level = logging.ERROR if args.quiet else (
        logging.DEBUG if args.verbose else logging.INFO
    )
    logging.basicConfig(level=level, format="[%(levelname)s] %(message)s")
    mode = args.cmd

    snapshot_state = None
    if args.resume:
        meta, snapshot_state = _load_snapshot(args.resume)
        if meta["mode"] != mode:
            raise SystemExit(
                f"invalid resume file: saved mode {meta['mode']!r}"
            )
        # CLI options overwrite saved parameters (reference overwriteParams)
        args.blueprint = args.blueprint or meta["blueprint"]
        args.inp = args.inp or meta["input"]
        args.out = args.out or meta["output"]
        if args.cycles is None and meta["cycles_opt"] >= 0:
            args.cycles = meta["cycles_opt"]
    if not args.blueprint or not args.inp or not args.out:
        raise SystemExit("--blueprint, -i and -o are required (or --resume)")

    bp = Blueprint(args.blueprint)
    if snapshot_state is not None and meta["blueprint_hash"]:
        cur = _blueprint_hash(args.blueprint)
        if cur != meta["blueprint_hash"]:
            raise SystemExit(
                "invalid resume file: blueprint has changed since the "
                "snapshot was taken (resuming would produce garbage)"
            )
    dump_sk = None
    ek = None
    if mode == "plain":
        req = packet_mod.PlainPacket.load(args.inp)
        fe = Frontend("plain", bp, req, snapshot_state=snapshot_state)
    else:
        if not args.evalkey:
            raise SystemExit("tfhe mode requires --evalkey")
        ek = host.EvalKey.load(args.evalkey)
        req = packet_mod.TFHEPacket.load(args.inp)
        if req.params != ek.params.name:
            raise SystemExit(
                f"packet params {req.params!r} != key params {ek.params.name!r}"
            )
        if snapshot_state is not None:
            if meta["params"] and meta["params"] != ek.params.name:
                raise SystemExit(
                    f"invalid resume file: snapshot params {meta['params']!r}"
                    f" != key params {ek.params.name!r}"
                )
            fp = _evalkey_fingerprint(ek)
            if meta["evalkey_fp"] and meta["evalkey_fp"] != fp:
                raise SystemExit(
                    "invalid resume file: eval key differs from the one the "
                    "snapshot was taken with"
                )
        if getattr(args, "secret_key", None):
            dump_sk = host.SecretKey.load(args.secret_key)
        fe = Frontend("tfhe", bp, req, eval_key=ek,
                      snapshot_state=snapshot_state)

    fe.go(
        args.cycles,
        skip_reset=args.skip_reset,
        dump_prefix=args.dump_prefix,
        dump_sk=dump_sk,
        stdout_csv=args.stdout_csv,
        dump_time_csv_prefix=args.dump_time_csv_prefix,
        dump_graph_json_prefix=args.dump_graph_json_prefix,
        dump_graph_dot_prefix=args.dump_graph_dot_prefix,
        show_combinational_progress=args.show_combinational_progress,
    )
    res = fe.make_result_packet()
    res.save(args.out)
    if args.snapshot:
        _save_snapshot(args.snapshot, mode, args, fe, ek=ek)
    return 0


if __name__ == "__main__":
    sys.exit(main())
