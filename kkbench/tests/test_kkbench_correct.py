"""``correct`` on the CPU at a tiny size: a sound run passes, and the
control (the plain reference in float32 in the program's place) and each
fault a solver cell can have fail.  The harness's look for a card is
skipped (``device="cpu"``); the rest of a run is driven as on the card."""
from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

import tpukk_torch.sparse as port_sparse
from conftest import LIMITS, MIXES, ROOT, TINY, write_root
from kkbench import control, harness
from kkbench.registry import Registry

SEED = 2**33 + 17


def _run(reg, mix, trace=False, seconds=0.3):
    return harness.run(f"tiny27.{mix}", SEED, seconds, trace, reg=reg, device="cpu")


@pytest.mark.parametrize("mix", MIXES)
def test_sound_run_is_correct(tiny_reg, mix):
    r = _run(tiny_reg, mix)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) >= {"solve_ms", "solve_p90_ms", "setup_s"}
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(LIMITS[mix])


@pytest.mark.parametrize("mix", MIXES)
def test_traced_run_is_correct(tiny_reg, mix):
    r = _run(tiny_reg, mix, trace=True)
    assert r["correct"]
    # off the card the device readers return nothing
    assert set(r["metrics"]) == {"solver.iters", "prep_s"}


@pytest.mark.parametrize("mix", MIXES)
def test_control_is_not_correct(tmp_path, mix):
    root = write_root(tmp_path, TINY)
    m = json.loads((ROOT / "kkbench" / "mixes" / f"{mix}.json").read_text())
    if "max_restarts" in m:  # float32 GMRES never reaches 1e-8: bound its restarts here
        m["max_restarts"] = 10
        (root / "mixes").mkdir()
        (root / "mixes" / f"{mix}.json").write_text(json.dumps(m))
    reg = Registry(roots=[root], bench_file=root / "BENCHMARK.json")
    r = control.control(f"tiny27.{mix}", SEED, reg=reg, device="cpu")
    assert r["control_fails"], r
    assert {"relres", "spmv_gap", "prec_gap"} <= set(r["fails"])


def _state_unchanged(monkeypatch, driver):
    if driver == "pcg":
        monkeypatch.setattr(sys.modules["tpukk_torch.sparse.pcg"], "pcg_iteration",
                            lambda Ah, prec, state: state)
    else:
        monkeypatch.setattr(sys.modules["tpukk_torch.sparse.gmres"], "_arnoldi_cycle",
                            lambda Ah, prec, b, x0, m, ortho, reduce=None: x0)


def _answer_altered(monkeypatch, driver):
    orig = getattr(port_sparse, driver)

    def altered(*a, **k):
        x, st = orig(*a, **k)
        x = x.clone()
        x[0] += 1.0
        return x, st

    monkeypatch.setattr(port_sparse, driver, altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered],
                         ids=["state_unchanged", "answer_altered"])
@pytest.mark.parametrize("mix", MIXES)
def test_fault_is_not_correct(tiny_reg, monkeypatch, mix, fault):
    driver = json.loads((ROOT / "kkbench" / "mixes" / f"{mix}.json").read_text())["driver"]
    fault(monkeypatch, driver)
    r = _run(tiny_reg, mix, seconds=0.05)
    assert not r["correct"]
    assert r["checks"]["relres"]["value"] > r["checks"]["relres"]["limit"]


def test_coloring_fault_is_not_correct(tiny_reg, monkeypatch):
    """A coloring that puts neighbours in one color reads as conflicts."""
    gs = sys.modules["tpukk_torch.sparse.gauss_seidel"]
    monkeypatch.setattr(gs, "graph_color", lambda A, algorithm: np.ones(A.nrows, np.int32))
    r = _run(tiny_reg, "symgs_pcg", seconds=0.05)
    assert not r["correct"] and r["checks"]["color_conflicts"]["value"] > 0


def test_new_config_mix_and_metric_by_name(tmp_path):
    """A configuration, a mix and a per-layer metric added as new files run
    without an edit to any file of the harness."""
    cfg = dict(TINY, name="tiny_ext", nx=5, ny=5, nz=5)
    metric = {"name": "solver.solves", "unit": "solves", "better": "higher",
              "source": "program_counter", "layer": "solvers", "moves": "solve_ms"}
    root = write_root(tmp_path, cfg, mixes=("jacobi_pcg_b",), extra_metrics=[metric],
                      limits={"jacobi_pcg_b": LIMITS["jacobi_pcg"]})
    mix = json.loads((ROOT / "kkbench" / "mixes" / "jacobi_pcg.json").read_text())
    (root / "mixes").mkdir()
    (root / "mixes" / "jacobi_pcg_b.json").write_text(json.dumps(dict(mix, check_every=5)))
    (root / "metrics").mkdir()
    (root / "metrics" / "solver.solves.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window))\n")
    reg = Registry(roots=[root], bench_file=root / "BENCHMARK.json")
    r = harness.run("tiny_ext.jacobi_pcg_b", SEED, 0.2, True, reg=reg, device="cpu")
    assert r["correct"]
    assert r["metrics"]["solver.solves"]["value"] == r["attempted"]
    assert r["metrics"]["solver.iters"]["value"] % 5 == 0


def test_seed_fixes_the_inputs(tiny_reg):
    """The mix fixes the pool of systems; the seed, their order and the probes."""
    cfg, mix = tiny_reg.config("tiny27"), tiny_reg.mix("symgs_pcg")
    a, b, c = (harness.Inputs(tiny_reg, cfg, mix, s, torch.device("cpu"))
               for s in (SEED, SEED, SEED + 1))
    n = 3 * mix["rhs_pool"]
    assert torch.equal(a.B, c.B) and a.B.shape[0] == mix["rhs_pool"]
    assert [a.rhs_index(i) for i in range(n)] == [b.rhs_index(i) for i in range(n)]
    assert [a.rhs_index(i) for i in range(n)] != [c.rhs_index(i) for i in range(n)]
    assert torch.equal(a.x_probe, b.x_probe) and not torch.equal(a.x_probe, c.x_probe)
    # every round solves each system of the pool once
    P = mix["rhs_pool"]
    assert all(sorted(c.rhs_index(r * P + j) for j in range(P)) == list(range(P))
               for r in range(3))


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from kkbench import run

    assert run.main(["--workload", "hpcg104.symgs_pcg", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_tiny_cells_on_the_card(tiny_reg):
    """The tiny cells through the card's kernels (on the GPU host:
    python -m pytest kkbench/tests -m cuda)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for mix in MIXES:
        r = harness.run(f"tiny27.{mix}", SEED, 0.3, True, reg=tiny_reg)
        assert r["correct"] and r["device"]["platform"] == "gpu", r
