"""BENCHMARK.json in its required form, and the benchmark's files
against it: names, units, parts found by name, limits for every cell."""
from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KKB = ROOT / "kkbench"


def _names():
    out = [("config", c["name"]) for c in BENCH["configs"]]
    out += [("workload", w["name"]) for w in BENCH["workloads"]]
    out += [("traffic", w["traffic"]) for w in BENCH["workloads"]]
    out += [("metric", m["name"]) for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    out += [("reduced", k) for c in BENCH["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("kind,name", _names())
def test_names(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert "\n" not in metric["layer"]
        assert (KKB / "metrics" / f"{metric['name']}.py").is_file()


def test_top_level_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kkbench"] and BENCH["command"] == ["python3", "kkbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in BENCH["end_to_end"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_parts_found_by_name(w):
    cfg = json.loads((KKB / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((KKB / "mixes" / f"{w['traffic']}.json").read_text())
    assert (KKB / "matrices" / f"{cfg['builder']}.py").is_file()
    assert (KKB / "drivers" / f"{mix['driver']}.py").is_file()
    assert (KKB / "reference" / f"{mix['driver']}.py").is_file()
    assert (KKB / "reference" / f"prec_{mix['prec']}.py").is_file()
    limits = json.loads((KKB / "limits" / f"{w['name']}.json").read_text())
    assert {"relres", "spmv_gap", "prec_gap"} <= set(limits)
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert any(c["name"] == w["config"] for c in BENCH["configs"])


def test_four_chip_cells_are_few():
    """At most a quarter of the cells, rounded down, ask for four chips; one
    always may."""
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("kkbench/") and (ROOT / c["file"]).is_file()
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and sorted(cfg["reduced"]) == sorted(c["reduced"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
