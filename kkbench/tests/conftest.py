"""A registry of tiny cells on the CPU: a 27-point grid of 120 rows under
each mix of the benchmark, found by name beside the benchmark's own files."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

MIXES = ("symgs_pcg", "jacobi_pcg", "ilu_gmres")
_GAPS = {"relres": 1e-8, "spmv_gap": 1e-12, "prec_gap": 1e-12}
LIMITS = {"symgs_pcg": dict(_GAPS, color_conflicts=0), "jacobi_pcg": dict(_GAPS),
          "ilu_gmres": dict(_GAPS, iters_gap=0.25, ilu_gap=1e-12)}


def write_root(root: Path, cfg: dict, mixes=MIXES, extra_metrics=(), limits=None,
               chips: int = 1) -> Path:
    """A folder holding a BENCHMARK.json of cells ``<cfg>.<mix>`` on
    ``chips`` chips, the configuration and each cell's limits."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "limits").mkdir(exist_ok=True)
    (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    bench["configs"] = [{"name": cfg["name"], "source": "test", "file": "configs/x.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": f"{cfg['name']}.{m}", "config": cfg["name"], "traffic": m,
                           "chips": chips, "why": "test"} for m in mixes]
    for m in bench["end_to_end"]:
        m.pop("workloads", None)
    bench["per_layer"] += list(extra_metrics)
    for w in bench["workloads"]:
        lim = (limits or LIMITS)[w["traffic"]]
        (root / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


TINY = {"name": "tiny27", "builder": "stencil27", "nx": 6, "ny": 5, "nz": 4, "diagonal": 26.0,
        "offdiagonal": -1.0, "dtype": "float64", "rtol": 1e-8}


@pytest.fixture
def tiny_reg(tmp_path):
    from kkbench.registry import Registry

    root = write_root(tmp_path, TINY)
    return Registry(roots=[root], bench_file=root / "BENCHMARK.json")
