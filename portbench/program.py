"""The system under test, driven as its command-line tools drive it.

The only module of the benchmark that imports the program
(iyokan_tpu_torch): the client tool's key and packet calls
(cli/packet_cli.py: genevalkey; packet.PlainPacket.encrypt), and the
calls of `iyokan_cli tfhe`: Frontend("tfhe", blueprint, request,
eval_key=...), go(cycles, on_cycle=...), make_result_packet().  Besides
those it reads the engine's output rows after each cycle
(engine.read_nodes) and the kernel wrappers' launch counters.
"""

from __future__ import annotations

import os
import sys


class Program:
    def __init__(self, root: str, device: str):
        if root not in sys.path:
            sys.path.insert(0, root)
        import torch
        from iyokan_tpu_torch import packet
        from iyokan_tpu_torch.circuit.blueprint import Blueprint
        from iyokan_tpu_torch.cli import packet_cli
        from iyokan_tpu_torch.crypto import host
        from iyokan_tpu_torch.engine import driver, tfhe

        self.torch, self.packet, self.host = torch, packet, host
        self.Blueprint, self.packet_cli = Blueprint, packet_cli
        self.driver, self.tfhe = driver, tfhe
        self.device = device

    # ---------------------------------------------------------------- #
    def make_eval_key(self, sk_path: str, ek_path: str, seed: int) -> None:
        """The client's eval key from its secret key file (packet_cli
        genevalkey), written under a temporary name and moved in place."""
        tmp = f"{ek_path}.tmp{os.getpid()}"
        self.packet_cli.main(["genevalkey", "--in", sk_path, "--out", tmp,
                              "--seed", str(seed)])
        os.replace(tmp, ek_path)

    def load(self, sk_path: str, ek_path: str, blueprint: str) -> None:
        self.sk = self.host.SecretKey.load(sk_path)
        self.ek = self.host.EvalKey.load(ek_path)
        self.bp = self.Blueprint(blueprint)

    def params(self) -> dict:
        p = self.ek.params
        return {"name": p.name, "n": p.n, "N": p.N, "l": p.l,
                "Bgbit": p.Bgbit, "N2": p.N2, "l2": p.l2}

    def encrypt(self, rom, ram, streams, seed: int):
        plain = self.packet.PlainPacket(rom=dict(rom), ram=dict(ram),
                                        bits=dict(streams))
        return plain.encrypt(self.sk, seed=seed)

    def frontend(self, request):
        return self.driver.Frontend("tfhe", self.bp, request,
                                    eval_key=self.ek, device=self.device)

    def output_nodes(self, fe) -> dict:
        """{@output: [node per bit, None where unconnected]}, as
        make_result_packet resolves them."""
        nodes = {}
        for (name, bit), port in self.bp.at_ports.items():
            if port.kind == "output":
                nodes.setdefault(name, {})[bit] = fe.design.get(
                    port.node_name, port.kind, port.port_name, port.port_bit)
        return {name: [d.get(b) for b in range(max(d) + 1)]
                for name, d in nodes.items()}

    @staticmethod
    def read_outputs(fe, nodes: dict) -> dict:
        return {name: fe.engine.read_nodes(fe.vals, ns)
                for name, ns in nodes.items()}

    @staticmethod
    def result(fe) -> dict:
        """The result packet's ciphertexts: {"bits": {@output: TLWE rows},
        "ram": {name: TRLWE rows}}."""
        res = fe.make_result_packet()
        return {"bits": dict(res.bits), "ram": dict(res.ram)}

    def launches(self) -> int:
        """Kernel launches the wrappers made outside graph replays."""
        return sum(v for k, v in self.tfhe.launch_counts().items()
                   if k.count(".") == 1)

    @staticmethod
    def graphs(fe) -> int:
        return len(fe.engine.graph_stats())

    @staticmethod
    def replayed_kernel_nodes(fe) -> int:
        """Kernel nodes the Frontend's graph replays have run so far."""
        return sum(g["replays"] * (g["kernel_nodes"] or 0)
                   for g in fe.engine.graph_stats())

    def footprint(self, fe) -> dict:
        """Device bytes of the key set, the engine state and the graph
        pools of one Frontend (each storage counted once)."""
        k = fe.engine.keys

        def storages(t):
            if t is None:
                return {}
            if isinstance(t, (tuple, list)):
                out = {}
                for x in t:
                    out.update(storages(x))
                return out
            st = t.untyped_storage()
            out = {st.data_ptr(): st.nbytes()}
            form = getattr(t, "kernel_key", None)    # a key's kernel form
            if form is not None and form is not t:
                out.update(storages(form))
            return out

        def nbytes(*ts):
            return sum(storages(list(ts)).values())

        return {
            "slab": nbytes(k.bk_tk, k.bk_tk_small),
            "cb_keys": nbytes(k.bk2, k.pksk_f64),
            "ks_keys": nbytes(k.ksk_mat, k.ksk_f64),
            "engine_state": nbytes(fe.vals, *fe.rams.values(),
                                   *fe.roms.values()),
            "graph_pools": sum(int(g["pool_bytes"] or 0)
                               for g in fe.engine.graph_stats()),
        }
