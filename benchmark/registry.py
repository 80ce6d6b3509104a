"""Find a cell's files by the names in ``BENCHMARK.json``.

A configuration is ``benchmark/configs/<config>.json`` (the file its entry
names), a traffic mix ``benchmark/traffic/<traffic>.json``, a cell's limits
``benchmark/limits/<cell>.json``, a job kind ``benchmark/jobs/<kind>.py``, a
per-layer metric ``benchmark/layer_metrics/<metric>.py`` and a kernel count
``benchmark/counts/<name>.py``.  Adding any of them adds files and entries
and edits none.

A configuration whose ``target`` the benchmark has not seen adds:

* its file under ``configs/`` and its raw data under ``data/``;
* its float64 reference, ``reference/targets/<target>.py``: ``raw(config)``
  and ``potential(x, config)`` (``reference/potentials.py``);
* its count of one potential evaluation,
  ``counts/targets/<target>.py``'s ``POTENTIAL_OPS``;
* a traffic mix for each cell (its ``kernel`` names the sampler, its
  ``accept_target`` the acceptance that sampler adapts to), a limits file
  for each cell, and the ``configs``, ``workloads`` and metrics'
  ``workloads`` entries in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module (a metric's name may hold
    dots, so files are loaded by path, not imported by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Registry:
    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / "benchmark"

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                # where the raw data the file names lie
                cfg["data_dir"] = str(self.bench / "data")
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.bench / "limits" / f"{cell}.json")
                          .read_text())

    def job_module(self, kind: str):
        return load_module(self.bench / "jobs" / f"{kind}.py",
                           f"benchmark_job_{kind}")

    def layer_metric(self, name: str):
        return load_module(self.bench / "layer_metrics" / f"{name}.py",
                           f"benchmark_metric_{name}")

    def counts(self, name: str):
        return load_module(self.bench / "counts" / f"{name}.py",
                           f"benchmark_counts_{name}")

    def _applies(self, metric: dict, cell: str, e2e_names=()) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        if "moves" in metric:
            return metric["moves"] in e2e_names
        return True

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.spec["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics the cell reports with ``--trace 1``."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if self._applies(m, cell, e2e)]
