"""The cell ``hpcg104x4.dist_symgs_pcg`` at a tiny size on the CPU: four
gloo ranks, HPCG's 2 × 2 × 1 process grid of 6 × 5 × 4 boxes, the
benchmark's own mix and driver (``drivers/dist_symgs_pcg.py``: PCG with the
distributed multicolor symmetric Gauss-Seidel through ``tpukk_torch.dist``)
through ``harness.run``.  A sound run is correct and reads the new
per-layer metrics; a change to one rank's rows of x is judged incorrect."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from conftest import TINY, write_root
from kkbench import dist_spans, harness, spans
from kkbench.registry import Registry

HERE = Path(__file__).resolve().parent
KKB = HERE.parent
SEED = 2**31 + 4093
MIX = "dist_symgs_pcg"
CFG = dict(TINY, name="tiny27x4", process_grid=[2, 2, 1])  # 6 × 5 × 4 = 120 rows a rank
LIMITS = {"relres": 1e-8, "spmv_gap": 1e-12, "prec_gap": 1e-12, "color_conflicts": 0}
NEW = ("dist.exchanges_per_iter", "dist.issue_us_per_iter", "dist.wait_us_per_iter",
       "dist.halo_idle_pct")
# the wrapper driver of the planted fault: rank 1's rows of every x altered
FAULT = '''from kkbench.drivers import dist_symgs_pcg as _real
from kkbench.drivers.dist_symgs_pcg import build, load, make_prec, make_spmv, prepare
import torch.distributed as dist


def solve(state, b):
    x, its, ok = _real.solve(state, b)
    if dist.get_rank() == 1:
        x = x.clone()
        x[0] += 1.0
    return x, its, ok
'''


def _reg(root: Path, mixes=(MIX,)) -> Registry:
    """The tiny cells of ``mixes`` on four ranks, the new metrics reported in
    them."""
    write_root(root, CFG, mixes=mixes, chips=4, limits={m: LIMITS for m in mixes})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] = [w["name"] for w in bench["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(roots=[root, HERE], bench_file=root / "BENCHMARK.json")


def _colors() -> int:
    """Colors of the whole tiny matrix's SERIAL greedy coloring."""
    from kkbench.matrices import stencil27
    from tpukk_torch.containers import CsrMatrix
    from tpukk_torch.graph import ColoringAlgorithm, graph_color

    whole = harness.concat_parts([stencil27.build_part(CFG, "cpu", r, 4) for r in range(4)])
    A = CsrMatrix.from_arrays(whole["row_map"].numpy(), whole["entries"].numpy(),
                              whole["values"].numpy(), nrows=whole["nrows"],
                              ncols=whole["ncols"], device="cpu")
    return int(graph_color(A, ColoringAlgorithm.SERIAL).max())


def test_the_cells_parts_are_the_benchmarks(tmp_path):
    reg = _reg(tmp_path)
    mix = reg.mix(MIX)
    assert reg.driver(mix).__file__ == str(KKB / "drivers" / f"{MIX}.py")
    assert mix["check_every"] == 10 and mix["coloring"] == "SERIAL" and mix["prec"] == "symgs"
    assert reg.reference(mix["driver"]).solve is reg.reference("pcg").solve


def test_traced_run_is_correct_and_reads_the_dist_metrics(tmp_path):
    """Every rank solves in step; the result is correct, and the new
    per-layer metrics read numbers (the idle share needs the card's trace,
    and is left out here as the other device readings are)."""
    r = harness.run(f"tiny27x4.{MIX}", SEED, 0.3, True, reg=_reg(tmp_path), device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r
    assert set(r["checks"]) == set(LIMITS) and r["checks"]["color_conflicts"]["value"] == 0
    got = r["metrics"]
    assert set(got) == {"solver.iters", "prep_s", "dist.exchanges_per_iter",
                        "dist.issue_us_per_iter", "dist.wait_us_per_iter"}
    assert got["solver.iters"]["value"] % 10 == 0
    # 2 × colors + 1 an iteration, and one apply (2 × colors) a solve of at
    # least 10 iterations
    c = _colors()
    ex = got["dist.exchanges_per_iter"]["value"]
    assert 2 * c + 1 < ex <= 2 * c + 1 + 2 * c / 10
    assert got["dist.issue_us_per_iter"]["value"] > 0
    assert got["dist.wait_us_per_iter"]["value"] >= 0
    assert r["device"]["count"] == 4 and len(r["device"]["memory_peak_bytes_by_rank"]) == 4


def test_untraced_run_reports_the_end_to_end_metrics(tmp_path):
    r = harness.run(f"tiny27x4.{MIX}", SEED + 1, 0.2, False, reg=_reg(tmp_path), device="cpu")
    assert r["correct"], r
    assert {"solve_ms", "setup_s"} <= set(r["metrics"]) <= {"solve_ms", "solve_p90_ms", "setup_s"}


def test_one_ranks_change_to_x_is_not_correct(tmp_path):
    (tmp_path / "drivers").mkdir(parents=True)
    (tmp_path / "drivers" / f"{MIX}_x.py").write_text(FAULT)
    (tmp_path / "mixes").mkdir()
    mix = json.loads((KKB / "mixes" / f"{MIX}.json").read_text())
    (tmp_path / "mixes" / f"{MIX}_x.json").write_text(json.dumps(dict(mix, driver=f"{MIX}_x")))
    reg = _reg(tmp_path, mixes=(f"{MIX}_x",))
    r = harness.run(f"tiny27x4.{MIX}_x", SEED, 0.05, False, reg=reg, device="cpu")
    assert not r["correct"]
    assert r["checks"]["relres"]["value"] > r["checks"]["relres"]["limit"]
    # the probes and the coloring are the program's own: only x was altered
    assert r["checks"]["prec_gap"]["value"] <= LIMITS["prec_gap"]


# one dist_pcg solve of one block, in ns: (name, start, end, parent)
SOLVE = [
    ("tpukk::dist_pcg", 0, 1000, None),                 # 0
    ("tpukk::dist.gs_apply", 10, 90, 0),                # 1
    ("tpukk::dist.halo_exchange", 20, 40, 1),           # 2
    ("tpukk::dist_pcg.block", 100, 900, 0),             # 3
    ("tpukk::dist.dist_spmv_gt", 110, 200, 3),          # 4
    ("tpukk::dist.halo_exchange", 120, 170, 4),         # 5
    ("tpukk::dist_pcg.check", 600, 900, 3),             # 6
]


def test_issue_wait_and_halo_idle_arithmetic():
    got = dist_spans.issue_wait([r[:3] for r in SOLVE], iters=10)
    assert got["issue_us"] == pytest.approx((800 - 300) / 10 * 1e-3)
    assert got["wait_us"] == pytest.approx(300 / 10 * 1e-3)
    # gaps (0, 45) under the first exchange, (150, 160) under the second,
    # (300, 700) in the block, (800, 1000) under the check
    dev = [(45, 150), (160, 300), (700, 800)]
    idle = spans.idle_by_span(SOLVE, dev, 0, 1000)
    assert idle == {"tpukk::dist.halo_exchange": 55, "tpukk::dist_pcg.block": 400,
                    "tpukk::dist_pcg.check": 200}
    assert dist_spans.halo_idle_pct(idle) == pytest.approx(100 * 55 / 655)
    assert dist_spans.halo_idle_pct({}) is None


def test_colors_read_lets_the_graphs_go():
    """The driver's table ``colors``, read once after the run's last solve,
    empties the state's cache of CUDA graphs, so that none is left when the
    ranks leave their NCCL group (a traced run's context keeps the state)."""
    from types import SimpleNamespace

    import numpy as np

    from kkbench.drivers import dist_symgs_pcg

    colors = np.array([1, 2, 1, 0], np.int32)
    state = SimpleNamespace(prec=SimpleNamespace(colors=lambda: colors), graphs={"block": 1})
    assert dist_symgs_pcg._colors(state) is colors and state.graphs == {}
