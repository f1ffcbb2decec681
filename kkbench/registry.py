"""Finds a cell's parts by name, so that a configuration, a traffic mix, a
matrix builder, a driver, a per-layer metric or a cell's limits is added as
a new file and never by editing one.

- ``configs/<config>.json`` names its matrix builder, ``matrices/<builder>.py``;
- ``mixes/<traffic>.json`` names its driver, ``drivers/<driver>.py``;
- ``metrics/<metric>.py`` reads one per-layer metric (``read(ctx)``);
- ``limits/<workload>.json`` holds the limit of each number ``correct``
  compares.

Each lookup searches ``roots`` in order (the benchmark's folder first; tests
add a folder of their own).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Registry:
    def __init__(self, roots=(), bench_file: Path | None = None):
        self._args = ([Path(r) for r in roots], bench_file)
        self.roots = self._args[0] + [HERE]
        self.bench = json.loads(Path(bench_file or ROOT / "BENCHMARK.json").read_text())
        self._modules: dict = {}

    def __reduce__(self):
        # a rank process opens the same registry anew (modules do not pickle)
        return type(self), self._args

    def _find(self, sub: str, name: str, ext: str) -> Path:
        for r in self.roots:
            p = r / sub / f"{name}{ext}"
            if p.is_file():
                return p
        raise KeyError(f"kkbench: no {sub}/{name}{ext} under {[str(r) for r in self.roots]}")

    def _json(self, sub: str, name: str) -> dict:
        return json.loads(self._find(sub, name, ".json").read_text())

    def module(self, sub: str, name: str):
        key = (sub, name)
        if key not in self._modules:
            path = self._find(sub, name, ".py")
            spec = importlib.util.spec_from_file_location(
                f"kkbench_{sub}_{name.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"kkbench: no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def mix(self, name: str) -> dict:
        return self._json("mixes", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def builder(self, cfg: dict):
        return self.module("matrices", cfg["builder"])

    def driver(self, mix: dict):
        return self.module("drivers", mix["driver"])

    @staticmethod
    def reference(name: str):
        """``reference/<name>.py``: the plain solver of a driver, or the plain
        preconditioner ``prec_<kind>``."""
        return importlib.import_module(f"kkbench.reference.{name}")

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        return [m for m in self.bench["per_layer"]
                if workload in m.get("workloads", [workload])]

    def metric_reader(self, name: str):
        return self.module("metrics", name)
