"""Finds what a cell is made of, by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics; everything else is a file of its own under ``benchmark/``:

* ``configs/<config>.json``: the scene module and its arguments, the
  camera (``camera``, or ``cameras`` by traffic mode), ``source``,
  ``reduced`` and ``assumed``;
* ``scenes/<scene>.py``: ``build(**args)`` returns the scene's arrays
  (:class:`benchmark.scenedata.SceneData`);
* ``traffic/<traffic>.json``: the mode (``batch`` or ``progressive``) and
  its parameters;
* ``limits/<cell>.json``: the limit of each number the output comparison
  computes;
* ``metrics/<metric>.py``: ``read(run)`` returns the metric's value from
  the run's record (:mod:`benchmark.harness`), or None where the run has
  nothing to read.

A later cell, configuration, traffic mix or metric is a new file and a new
entry, and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        path = self.dir / kind / f"{name}.json"
        if not path.exists():
            raise FileNotFoundError(f"no {kind} file {path}")
        return json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def scene_builder(self, config: dict):
        module = _load_module(self.dir / "scenes" / f"{config['scene']}.py",
                              f"benchmark_scene_{config['scene']}")
        return module.build

    def reader(self, metric: str):
        module = _load_module(self.dir / "metrics" / f"{metric}.py",
                              "benchmark_metric_" + metric.replace(".", "_"))
        return module.read

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
