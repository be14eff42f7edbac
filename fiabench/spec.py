"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric is a file of its own, found by name:

- a configuration: the ``file`` of its ``configs`` entry;
- a traffic mix: ``traffic/<traffic>.json``;
- a cell's correctness limits: ``checks/<workload>.json``;
- a per-layer metric: ``metrics/<name>.py``, whose ``read(ctx)`` returns
  the value or ``None`` where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    def __init__(self, path: str = os.path.join(ROOT, "BENCHMARK.json")):
        self.doc = _json(path)
        self.root = os.path.dirname(os.path.abspath(path))

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(HERE, "traffic", f"{name}.json"))

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of ``workload`` reports: its end-to-end
        metrics untraced, its per-layer metrics traced."""
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "fiabench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
