"""A cell over several ranks on the CPU: gloo ranks, one process each, a
tiny 27-point grid split into HPCG's boxes, and the test-only driver
``drivers/dist_pcg.py`` over ``tpukk_torch.dist`` (Jacobi ``dist_pcg`` on
the distributed K3 plan).  A sound run is correct; a fault in one rank's
answer is not; a rank that raises, or is killed, or holds a forbidden
module ends the run without a result and leaves no process behind.

On the GPU host, the same cell at 104³ rows a rank on four cards (NCCL):
python -m pytest kkbench/tests/test_kkbench_ranks.py -m cuda
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from conftest import ROOT, TINY, write_root
from kkbench import harness, ranks
from kkbench.matrices import stencil27
from kkbench.registry import Registry

HERE = Path(__file__).resolve().parent
SEED = 2**32 + 977
LIMITS = {"relres": 1e-8, "spmv_gap": 1e-12, "prec_gap": 1e-12}
GRIDS = {2: [2, 1, 1], 4: [2, 2, 1]}


def _cfg(chips: int, n: int = 4) -> dict:
    # 4 × 4 × 3 = 48 rows a rank: the plan's row blocks of 8 are the parts
    return dict(TINY, name=f"tiny27x{chips}", nx=n, ny=n, nz=3, process_grid=GRIDS[chips])


def _reg(root: Path, chips: int, cfg=None) -> Registry:
    cfg = cfg or _cfg(chips)
    write_root(root, cfg, mixes=("dist_pcg",), chips=chips, limits={"dist_pcg": LIMITS})
    return Registry(roots=[root, HERE], bench_file=root / "BENCHMARK.json")


def _run(reg, chips, trace=False, seconds=0.3):
    return harness.run(f"tiny27x{chips}.dist_pcg", SEED, seconds, trace, reg=reg, device="cpu")


@pytest.mark.parametrize("chips", [2, 4])
def test_sound_run_is_correct(tmp_path, chips):
    r = _run(_reg(tmp_path, chips), chips)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r
    assert set(r["metrics"]) == {"solve_ms", "solve_p90_ms", "setup_s"}
    assert r["device"]["count"] == chips and len(r["device"]["memory_peak_bytes_by_rank"]) == chips
    assert list(r)[-1] == "checks" and set(r["checks"]) == set(LIMITS)


def test_traced_run_is_correct(tmp_path):
    """Every reader runs on every rank; off the card the rooflines and the
    device's readings are left out, as on one card."""
    r = _run(_reg(tmp_path, 2), 2, trace=True)
    assert r["correct"], r
    assert set(r["metrics"]) == {"solver.iters", "prep_s"}
    assert "busy_s" not in r["device"]


def test_one_ranks_fault_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setenv("KKBENCH_TEST_FAULT", "x:1")
    r = _run(_reg(tmp_path, 2), 2, seconds=0.05)
    assert not r["correct"]
    assert r["checks"]["relres"]["value"] > r["checks"]["relres"]["limit"]


_CLI = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from kkbench import run
from kkbench.registry import Registry
if __name__ == "__main__":
    reg = Registry(roots=[Path({cell!r}), Path({here!r})], bench_file=Path({cell!r}) / "BENCHMARK.json")
    sys.exit(run.main(["--workload", "tiny27x2.dist_pcg", "--seed", "5", "--seconds", "1"], reg,
                      "cpu"))
"""


def _cli(tmp_path, fault: str):
    """run.py's main on the two-rank cell in a process of its own, with a
    fault planted on rank 1; (process, seconds, the ranks' pids)."""
    _reg(tmp_path, 2)
    env = dict(os.environ, KKBENCH_TEST_FAULT=f"{fault}:1")
    code = _CLI.format(root=str(ROOT), cell=str(tmp_path), here=str(HERE))
    t = time.monotonic()
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=ranks.TIMEOUT_S + 60)
    pids = [int(w) for line in p.stderr.splitlines() if line.startswith("kkbench: ranks ")
            for w in line.replace(",", " ").split()[4::3]]
    return p, time.monotonic() - t, pids


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


@pytest.mark.parametrize("fault", ["raise", "kill"])
def test_failing_rank_ends_the_run(tmp_path, fault):
    p, seconds, pids = _cli(tmp_path, fault)
    assert p.returncode != 0, p.stderr[-3000:]
    assert p.stdout.strip() == "" and "rank 1 ended with exit code" in p.stderr
    assert seconds < ranks.TIMEOUT_S
    assert len(pids) == 1 and all(_gone(pid) for pid in pids)


def test_forbidden_module_on_a_rank_gives_no_result(tmp_path):
    p, _, pids = _cli(tmp_path, "forbidden")
    assert p.returncode == 3 and p.stdout.strip() == "", p.stderr[-3000:]
    assert "{1: ['jax']}" in p.stderr
    assert all(_gone(pid) for pid in pids)


def _natural_to_ranks(cfg: dict, size: int) -> np.ndarray:
    """Each point's rank-major row, by its natural row in the global grid."""
    px, py, pz = cfg["process_grid"]
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    gz, gy, gx = np.meshgrid(np.arange(pz * nz), np.arange(py * ny), np.arange(px * nx),
                             indexing="ij")
    rank = gx // nx + px * (gy // ny + py * (gz // nz))
    local = gx % nx + nx * (gy % ny + ny * (gz % nz))
    return (rank * nx * ny * nz + local).ravel()


@pytest.mark.parametrize("chips,n", [(2, 4), (4, 4), (4, 3)])
def test_parts_make_the_whole(tmp_path, chips, n):
    """The parts concatenated are the one-process build of the global grid,
    renumbered rank by rank; each rank's rows of b and of the probes are
    the whole's, bit for bit, and every rank solves in the same order."""
    cfg = _cfg(chips, n)
    cpu = torch.device("cpu")
    parts = [stencil27.build_part(cfg, cpu, r, chips) for r in range(chips)]
    whole = harness.concat_parts(parts)
    A = sps.csr_matrix((whole["values"].numpy(), whole["entries"].numpy(),
                        whole["row_map"].numpy()), shape=(whole["nrows"], whole["ncols"]))
    px, py, pz = cfg["process_grid"]
    g = stencil27.build(dict(cfg, nx=px * n, ny=py * n, nz=pz * 3), cpu)
    G = sps.csr_matrix((g["values"].numpy(), g["entries"].numpy(), g["row_map"].numpy()),
                       shape=(g["nrows"], g["ncols"]))
    perm = _natural_to_ranks(cfg, chips)
    P = sps.csr_matrix((np.ones(perm.size), (perm, np.arange(perm.size))), shape=G.shape)
    ref = (P @ G @ P.T).tocsr()
    ref.sort_indices()
    assert A.has_sorted_indices and [p["row0"] for p in parts] == [r * n * n * 3
                                                                   for r in range(chips)]
    assert np.array_equal(A.indptr, ref.indptr) and np.array_equal(A.indices, ref.indices)
    assert np.array_equal(A.data, ref.data)

    reg = _reg(tmp_path, chips, cfg)
    mix = reg.mix("dist_pcg")
    full = harness.Inputs(reg, cfg, mix, SEED, cpu, (None, chips))
    assert abs(full.A - A).nnz == 0
    for r in range(chips):
        part = harness.Inputs(reg, cfg, mix, SEED, cpu, (r, chips))
        rows = slice(part.host["row0"], part.host["row0"] + part.n)
        assert torch.equal(part.B, full.B[:, rows])
        assert torch.equal(part.x_probe, full.x_probe[rows])
        assert torch.equal(part.r_probe, full.r_probe[rows])
        assert [part.rhs_index(i) for i in range(12)] == [full.rhs_index(i) for i in range(12)]
    # b is A·x̂ over the whole
    gen = torch.Generator(device=cpu)
    gen.manual_seed(int(mix["rhs_seed"]))
    xhat = torch.randn((A.shape[0], mix["rhs_pool"]), generator=gen, dtype=torch.float64)
    assert np.allclose(full.B.T.numpy(), A @ xhat.numpy(), rtol=0, atol=1e-12)


def test_one_rank_part_is_the_one_card_build():
    cpu = torch.device("cpu")
    a, b = stencil27.build_part(TINY, cpu, 0, 1), stencil27.build(TINY, cpu)
    assert all(torch.equal(a[k], b[k]) for k in ("row_map", "entries", "values"))
    with pytest.raises(ValueError):
        stencil27.build_part(TINY, cpu, 0, 2)


class _Team:
    rank, size = 0, 4


def test_multi_chip_roofline_is_none_off_the_card():
    ctx = harness.Context([], {}, None, None, None, None, {"prec": "jacobi"}, {},
                          torch.device("cpu"), team=_Team())
    assert ctx.roofline_pct("spmv") is None and ctx.roofline_pct("prec") is None
    one = harness.Context([], {}, None, None, None, None, {"prec": "jacobi"}, {},
                          torch.device("cpu"))
    assert one.roofline_pct("spmv") is None


HPCG4 = dict(TINY, name="hpcg104x4", nx=104, ny=104, nz=104, process_grid=[2, 2, 1])


def _procs_of(pid: int) -> list:
    """The live processes whose parent is ``pid``."""
    out = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(stat[1]) == pid and stat[0] != "Z":
                out.append(int(d.name))
    return out


@pytest.mark.cuda
def test_four_cards(tmp_path):
    """HPCG's 104³ a rank on four cards under NCCL, through run.py's main in
    a process of its own: a sound run (traced and not) is correct, its
    rooflines read at most 100 %; a rank killed in the window ends the run
    without a result and leaves no process."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    # a limit with room for 4.5M rows: the test holds the harness, not the port
    write_root(tmp_path, HPCG4, mixes=("dist_pcg",), chips=4,
               limits={"dist_pcg": dict(LIMITS, relres=1e-7)})
    out = {"device_count": torch.cuda.device_count(), "nccl": torch.cuda.nccl.version(),
           "names": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}
    code = _CLI.format(root=str(ROOT), cell=str(tmp_path), here=str(HERE)).replace(
        "tiny27x2", "hpcg104x4").replace('"--seconds", "1"', '"--seconds", sys.argv[1], '
                                         '"--trace", sys.argv[2]').replace('"cpu"', "None")
    dest = ROOT / "build" / "kkbench" / "four_cards"
    dest.mkdir(parents=True, exist_ok=True)
    for k, (trace, fault) in enumerate((("0", ""), ("1", ""), ("0", "kill:2"))):
        env = dict(os.environ, KKBENCH_TEST_FAULT=fault)
        out_f, err_f = dest / f"run{k}.out", dest / f"run{k}.err"
        t = time.monotonic()
        with open(out_f, "w") as so, open(err_f, "w") as se:
            p = subprocess.Popen([sys.executable, "-c", code, "10", trace], env=env,
                                 stdout=so, stderr=se)
            children = set()
            while p.poll() is None:
                children |= set(_procs_of(p.pid))
                time.sleep(0.5)
        stdout = out_f.read_text().strip()
        run = {"trace": trace, "fault": fault, "rc": p.returncode,
               "seconds": time.monotonic() - t, "children": sorted(children),
               "left": [c for c in children if not _gone(c)],
               "result": json.loads(stdout.splitlines()[-1]) if stdout else None}
        out.setdefault("runs", []).append(run)
        (dest / "summary.json").write_text(json.dumps(out, indent=1))
    for run in out["runs"]:
        r = run["result"]
        if run["fault"]:
            assert run["rc"] != 0 and r is None and not run["left"], run
            continue
        assert run["rc"] == 0 and r["correct"] and r["device"]["count"] == 4, run
        if run["trace"] == "1":
            for m in ("spmv_roofline", "prec_roofline"):
                assert 0 < r["metrics"][m]["value"] <= 100, r["metrics"]
