"""What BENCHMARK.json names, found by name under the benchmark's folder:

  configs/<config>.json      a configuration (its "file" entry)
  traffic/<traffic>.json     a traffic mix's parameters (traffic.py)
  metrics/<metric>.py        a metric's reader: read(view) -> number or
                             None where it finds nothing to read
  metrics/layers/<l>.json    a layer's kernel-name table
  controls/<name>.json       a control run's program settings (--control)

A cell reports the end-to-end metrics whose "workloads" list it, or that
list none; under --trace 1 its per-layer metrics, chosen the same way.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, root: str):
        self.root = root
        self.bench = os.path.join(root, os.path.basename(HERE))
        self.data = _load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, workload: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == workload:
                return w
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                cfg = _load_json(os.path.join(self.root, c["file"]))
                cfg["_dir"] = os.path.dirname(os.path.join(self.root,
                                                           c["file"]))
                return cfg
        raise SystemExit(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load_json(os.path.join(self.bench, "traffic", f"{name}.json"))

    def control(self, name: str) -> dict:
        return _load_json(os.path.join(self.bench, "controls",
                                       f"{name}.json"))

    def metrics(self, workload: str, trace: bool) -> list:
        """The cell's metric entries: end-to-end ones, or per-layer ones
        under trace."""
        return [m for m in self.data["per_layer" if trace else "end_to_end"]
                if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        path = os.path.join(self.bench, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def peaks(self) -> dict:
        return _load_json(os.path.join(self.bench, "metrics", "peaks.json"))

    def layer(self, name: str) -> dict:
        return _load_json(os.path.join(self.bench, "metrics", "layers",
                                       f"{name}.json"))
