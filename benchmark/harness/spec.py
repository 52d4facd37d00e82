"""The benchmark's data, found by name: `BENCHMARK.json` at the root of the
checkout, and under the benchmark's folder one file per cell
(`workloads/<cell>.json`), configuration (its `file` in BENCHMARK.json),
traffic mix (`traffic/<traffic>.json`), driver (`drivers/<driver>.py`)
and per-layer metric (`metrics/<metric>.py`, or, where that file is
absent, `metrics/<metric up to its first dot>.py`: one reader serves
`idle_share.train` and `idle_share.serve`)."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

FOLDER = "benchmark"


class Spec:

  def __init__(self, root: str):
    self.root = root
    self.folder = os.path.join(root, FOLDER)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
      self.bench = json.load(f)

  def _load(self, *parts) -> Dict:
    with open(os.path.join(self.folder, *parts)) as f:
      return json.load(f)

  def workload(self, name: str) -> Dict:
    entries = [w for w in self.bench["workloads"] if w["name"] == name]
    if not entries:
      raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    cell = self._load("workloads", name + ".json")
    for key in ("config", "traffic"):
      if cell[key] != entry[key]:
        raise ValueError(f"workloads/{name}.json names {key} "
                         f"{cell[key]!r}, BENCHMARK.json {entry[key]!r}")
    return dict(entry, **cell)

  def config(self, name: str) -> Dict:
    entry = [c for c in self.bench["configs"] if c["name"] == name][0]
    with open(os.path.join(self.root, entry["file"])) as f:
      return json.load(f)

  def traffic(self, name: str) -> Dict:
    return self._load("traffic", name + ".json")

  def metrics(self, kind: str, cell: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports."""
    return [m for m in self.bench[kind]
            if cell in m.get("workloads", [cell])]

  def module(self, kind: str, name: str):
    """drivers/<name>.py or metrics/<name>.py (a metric's reader falls
    back to the file named by its name's first part), loaded from its
    path."""
    path = os.path.join(self.folder, kind, name + ".py")
    if kind == "metrics" and not os.path.exists(path):
      path = os.path.join(self.folder, kind, name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        f"{FOLDER}_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
