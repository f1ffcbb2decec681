"""Performance regression archive — counterpart of
``tpukk/common/perf_archive.py`` (test_common/Kokkos_Performance.hpp:32-161:
a machine-keyed archive of named metrics, run then compare with tolerances;
JSON in place of the reference's YAML).

Each entry also records the device its numbers were taken on:
``controls.device_description()``, the card's name and power limit as
``nvidia-smi`` gives them, or "cpu".
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import time
from typing import Dict, Optional

from .controls import device_description

__all__ = ["PerfArchive", "MetricResult"]


@dataclasses.dataclass
class MetricResult:
    name: str
    value: float
    status: str        # "new" | "pass" | "fail" | "improved"
    reference: Optional[float] = None
    change: Optional[float] = None


class PerfArchive:
    """run_and_compare semantics of Kokkos_Performance.hpp:117-161:
    first run records; later runs compare within `tolerance` (relative);
    lower-is-better metrics flagged when they regress beyond tolerance.
    ``device`` (default: ``device_description()``) is stored with each
    entry and its history."""

    def __init__(self, path, machine: str = None, tolerance: float = 0.1, device: str = None):
        self.path = str(path)
        self.machine = machine or platform.node() or "unknown"
        self.tolerance = float(tolerance)
        self.device = device or device_description()
        self._db = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                self._db = json.load(f)

    def _key(self, config: str) -> str:
        return f"{self.machine}::{config}"

    def run_and_compare(self, config: str, metrics: Dict[str, float],
                        lower_is_better: bool = True) -> Dict[str, MetricResult]:
        key = self._key(config)
        entry = self._db.setdefault(key, {"metrics": {}, "history": []})
        entry["device"] = self.device
        results = {}
        for name, value in metrics.items():
            ref = entry["metrics"].get(name)
            if ref is None:
                status, change = "new", None
                entry["metrics"][name] = value
            else:
                change = (value - ref) / ref if ref else 0.0
                worse = change > self.tolerance if lower_is_better else change < -self.tolerance
                better = change < -self.tolerance if lower_is_better else change > self.tolerance
                status = "fail" if worse else ("improved" if better else "pass")
                if better:  # archive the improvement as the new reference
                    entry["metrics"][name] = value
            results[name] = MetricResult(name, value, status, ref, change)
        entry["history"].append({"ts": time.time(), "device": self.device, "metrics": metrics})
        self._save()
        return results

    def _save(self):
        with open(self.path, "w") as f:
            json.dump(self._db, f, indent=1, sort_keys=True)

    def passed(self, results: Dict[str, MetricResult]) -> bool:
        return all(r.status != "fail" for r in results.values())
