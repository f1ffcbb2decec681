"""The span metrics' arithmetic on a synthetic recording and synthetic
device intervals, and the tiny CPU cells: the coloring's gauges read there,
the span metrics (which need the card) do not."""
from __future__ import annotations

import json

import pytest

from conftest import TINY, write_root
from kkbench import harness, spans
from kkbench.registry import Registry

SEED = 2**31 + 2**30 + 5
NEW = ("solver.issue_us_per_iter", "solver.wait_us_per_iter", "solver.idle_own_pct",
       "graph.colors", "graph.color_s")

# one PCG solve of two blocks, in ns: (name, start, end, parent)
SOLVE = [
    ("tpukk::pcg", 0, 1000, None),                  # 0
    ("tpukk::pcg_initial_state", 10, 60, 0),        # 1
    ("tpukk::pcg.block", 100, 500, 0),              # 2
    ("tpukk::spmv<N,DIA>", 110, 150, 2),            # 3
    ("tpukk::gauss_seidel_apply", 160, 260, 2),     # 4
    ("tpukk::pcg.check", 300, 500, 2),              # 5
    ("tpukk::pcg.block", 520, 980, 0),              # 6
    ("tpukk::pcg.check", 700, 980, 6),              # 7
]


def test_issue_and_wait():
    got = spans.issue_wait([r[:3] for r in SOLVE], iters=20)
    # blocks 400 + 460 ns, checks 200 + 280 ns
    assert got["issue_us"] == pytest.approx((860 - 480) / 20 * 1e-3)
    assert got["wait_us"] == pytest.approx(480 / 20 * 1e-3)
    assert got["solve_s"] == pytest.approx(1000e-9)


def test_idle_gaps_and_their_spans():
    dev = [(0, 120), (115, 130), (200, 310), (600, 690), (990, 2000)]
    assert spans.idle_gaps(dev, 0, 1000) == [(130, 200), (310, 600), (690, 990)]
    assert spans.idle_gaps([], 5, 9) == [(5, 9)]
    starts = [r[1] for r in SOLVE]
    assert spans.innermost(SOLVE, starts, 120) == 3
    assert spans.innermost(SOLVE, starts, 270) == 2   # past GS, inside the block
    assert spans.innermost(SOLVE, starts, 510) == 0   # between the blocks
    assert spans.innermost(SOLVE, starts, 800) == 7
    assert spans.innermost(SOLVE, starts, 1500) is None
    assert spans.innermost(SOLVE, starts, -1) is None
    # gaps (130, 200) under GS, (310, 600) and (690, 950) under the checks,
    # (1000, 1200) past the solve
    idle = spans.idle_by_span(SOLVE, dev[:4] + [(950, 1000)], 0, 1200)
    assert idle == {"tpukk::gauss_seidel_apply": 70, "tpukk::pcg.check": 290 + 260, None: 200}
    assert spans.own_idle_pct(idle) == pytest.approx(100 * 550 / 820)
    assert spans.own_idle_pct({}) is None


@pytest.fixture
def new_metrics_reg(tmp_path):
    """The tiny cells with the new metrics reported in them too."""
    root = write_root(tmp_path, TINY)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m.pop("workloads")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(roots=[root], bench_file=root / "BENCHMARK.json")


def test_tiny_cells_read_the_gauges_not_the_spans(new_metrics_reg):
    from tpukk_torch.common import tracing

    r = harness.run("tiny27.symgs_pcg", SEED, 0.2, True, reg=new_metrics_reg, device="cpu")
    assert r["correct"]
    got = r["metrics"]
    # the 27-point grid's greedy coloring: 8 colors, as K6's fused sweep's steps
    assert got["graph.colors"] == {"value": 8, "unit": "colors"}
    assert 0 < got["graph.color_s"]["value"] <= got["prep_s"]["value"]
    assert not {"solver.issue_us_per_iter", "solver.wait_us_per_iter",
                "solver.idle_own_pct"} & set(got)
    # a later cell whose preconditioner does not color reads no gauge a
    # coloring left in the process
    assert tracing.counters()["graph.colors"] == 8
    r = harness.run("tiny27.jacobi_pcg", SEED, 0.2, True, reg=new_metrics_reg, device="cpu")
    assert r["correct"] and not set(NEW) & set(r["metrics"])


def test_without_the_recorder_nothing_is_read(new_metrics_reg, monkeypatch):
    """A port without the recorder and the registry (as before them): every
    new metric is left out, and the run still ends."""
    monkeypatch.setattr(spans, "port_tracing", lambda: None)
    r = harness.run("tiny27.symgs_pcg", SEED, 0.2, True, reg=new_metrics_reg, device="cpu")
    assert r["correct"] and not set(NEW) & set(r["metrics"])
