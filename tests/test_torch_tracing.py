"""The port's tracing (``tpukk_torch.common.tracing``) on the CPU: regions
that cost a flag check while nothing records, the in-memory recorder's spans
(nesting, solve ids, the solvers' block and check spans, the profiler's
clock), and the counter registry behind ``launch_counts()`` and the
coloring's gauges."""
from __future__ import annotations

import contextlib
import statistics
import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import tpukk_torch.containers as tkc
from tpukk_torch.common import permute, probe_cuda, tracing
from tpukk_torch.graph import ColoringAlgorithm, graph_color
from tpukk_torch.sparse import (GmresHandle, GsHandle, GsPrec, SpmvHandle, gauss_seidel_numeric,
                                gauss_seidel_symbolic, gmres, gs_cuda, pcg, spgemm_cuda,
                                spmv_cuda, sptrsv_cuda)

CPU = "cpu"


@pytest.fixture
def lap():
    return tkc.generate_structured_laplacian(24, 24, dtype=np.float64, device=CPU)


@pytest.fixture
def gs_prec(lap):
    h = GsHandle()
    gauss_seidel_symbolic(h, lap)
    gauss_seidel_numeric(h, lap)
    return GsPrec(h, lap)


class _Calls:
    """A stand-in for record_function or an NVTX call that counts its calls."""

    def __init__(self):
        self.n = 0

    def __call__(self, *a, **k):
        self.n += 1
        return contextlib.nullcontext()


@pytest.fixture
def spies(monkeypatch):
    """record_function and NVTX replaced by counters, NVTX as if a CUDA
    device were present."""
    rf, push, pop = _Calls(), _Calls(), _Calls()
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", push)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", pop)
    monkeypatch.setattr(tracing, "_nvtx_on", lambda: True)
    return rf, push, pop


def _solve(lap, gs_prec):
    b = torch.ones(lap.nrows, dtype=torch.float64)
    return pcg(SpmvHandle(lap), b, prec=gs_prec, check_every=5)


def test_idle_region_enters_no_record_function_and_no_nvtx(spies, lap, gs_prec):
    rf, push, pop = spies
    with tracing.profile_region("tpukk::probe"):
        pass
    tracing.annotate("probe")(lambda: None)()
    _, st = _solve(lap, gs_prec)
    assert st.converged and (rf.n, push.n, pop.n) == (0, 0, 0)


def test_recording_pushes_nvtx_without_a_profiler(spies, lap, gs_prec):
    rf, push, pop = spies
    with tracing.recording() as rec:
        _solve(lap, gs_prec)
    assert rf.n == 0 and push.n == pop.n == len(rec.spans) > 0


def _profiled_names(fn) -> list:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU and e.name().startswith("tpukk::")]


def test_profiler_sees_the_region_names(lap, gs_prec):
    names = set(_profiled_names(lambda: _solve(lap, gs_prec)))
    assert {"tpukk::pcg", "tpukk::pcg_initial_state", "tpukk::pcg.block", "tpukk::pcg.check",
            "tpukk::spmv<N,DIA>", "tpukk::gauss_seidel_apply"} <= names
    with tracing.recording() as rec:
        names_rec = _profiled_names(lambda: _solve(lap, gs_prec))
    assert sorted(names_rec) == sorted(s.name for s in rec.spans)


def test_spans_nest_with_one_solve_id_a_solve(lap, gs_prec):
    with tracing.recording() as rec:
        with tracing.profile_region("tpukk::outside"):
            pass
        _solve(lap, gs_prec)
        _solve(lap, gs_prec)
        gmres(GmresHandle(m=10, reorder="none"), SpmvHandle(lap),
              torch.ones(lap.nrows, dtype=torch.float64))
    spans = rec.spans
    roots = [i for i, s in enumerate(spans) if s.name in tracing.SOLVE_ROOTS]
    assert [spans[i].solve for i in roots] == [1, 2, 3]
    assert spans[0].solve is None and spans[0].parent is None
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert i in roots or s.name == "tpukk::outside"
            continue
        p = spans[s.parent]
        assert s.parent < i and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert s.solve is not None
        if s.name not in tracing.SOLVE_ROOTS:
            assert s.solve == p.solve


def test_pcg_blocks_and_checks(lap, gs_prec):
    with tracing.recording() as rec:
        _, st = _solve(lap, gs_prec)
    blocks = [i for i, s in enumerate(rec.spans) if s.name == "tpukk::pcg.block"]
    checks = [s for s in rec.spans if s.name == "tpukk::pcg.check"]
    assert len(blocks) == st.num_iters // 5 and len(checks) == len(blocks)
    assert sorted(s.parent for s in checks) == blocks
    # the residual read enters no region
    assert not any(s.parent is not None and rec.spans[s.parent].name == "tpukk::pcg.check"
                   for s in rec.spans)


def test_gmres_cycles_and_checks(lap):
    m = 12
    with tracing.recording() as rec:
        _, st = gmres(GmresHandle(m=m, reorder="none"), SpmvHandle(lap),
                      torch.ones(lap.nrows, dtype=torch.float64))
    blocks = [i for i, s in enumerate(rec.spans) if s.name == "tpukk::gmres.block"]
    checks = [s for s in rec.spans if s.name == "tpukk::gmres.check"]
    assert st.converged and len(blocks) == st.num_iters // m > 1
    # a cycle's two host reads: H for the least-squares solve, the residual
    assert sorted(s.parent for s in checks) == sorted(blocks * 2)


def test_self_time():
    rec = tracing.Recorder()
    rec.spans = [tracing.Span("a", 0, 100, None, None), tracing.Span("b", 10, 30, 0, None),
                 tracing.Span("c", 12, 20, 1, None), tracing.Span("b", 50, 90, 0, None)]
    assert rec.self_s("a") == pytest.approx(40e-9)
    assert rec.self_s("b") == pytest.approx(52e-9)
    assert rec.self_s("c") == pytest.approx(8e-9)
    assert rec.self_s("none") == 0


def test_one_recorder_at_a_time_and_only_its_thread():
    with tracing.recording() as rec:
        with pytest.raises(RuntimeError, match="already"):
            with tracing.recording():
                pass
        t = threading.Thread(target=lambda: tracing.profile_region("tpukk::other").__enter__())
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with tracing.profile_region("tpukk::mine"):
            pass
    assert [s.name for s in rec.spans] == ["tpukk::mine"]
    with tracing.recording():
        pass  # off again after the block


def test_span_agrees_with_the_profiler_event(lap, gs_prec):
    """The recorder's clock is the profiler's: after a warm call, each
    recorded span lies within 100 µs of the profiler's event of the same
    region (median over the spans of a solve's blocks and checks)."""
    _solve(lap, gs_prec)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            _solve(lap, gs_prec)
    for name in ("tpukk::pcg.block", "tpukk::pcg.check", "tpukk::gauss_seidel_apply"):
        evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name() == name and e.device_type() == DeviceType.CPU)
        sp = [(s.start_ns, s.end_ns) for s in rec.spans if s.name == name]
        assert len(evs) == len(sp) > 0
        d_start = statistics.median(abs(a[0] - b[0]) for a, b in zip(evs, sp))
        d_end = statistics.median(abs(a[1] - b[1]) for a, b in zip(evs, sp))
        assert d_start <= 100_000 and d_end <= 100_000, (name, d_start, d_end)


def test_counters_count_set_and_reset():
    tracing.reset_counters("test.")
    tracing.count("test.a")
    tracing.count("test.a", 4)
    tracing.set("test.g", 2.5)
    tracing.set("test.g", 1.5)
    c = tracing.counters()
    assert c["test.a"] == 5 and c["test.g"] == 1.5
    c["test.a"] = 0  # a copy
    assert tracing.counters()["test.a"] == 5
    tracing.reset_counters("test.")
    assert not any(k.startswith("test.") for k in tracing.counters())


@pytest.mark.parametrize("mod,names", [
    (spmv_cuda, ["dia_spmv", "dia_spmm", "csr_spmv", "csr_spmm"]),
    (gs_cuda, ["gs_color_step", "gs_sweep", "gs_sweep_dia"]),
    (sptrsv_cuda, ["sptrsv_levels", "permute_gather"]),
    (spgemm_cuda, ["spgemm_rows"]),
    (probe_cuda, ["probe_gather_acc"]),
], ids=["spmv", "gs", "sptrsv", "spgemm", "probe"])
def test_launch_counts_are_views_of_the_registry(mod, names):
    assert list(mod.launch_counts()) == names
    mod.reset_launch_counts()
    assert mod.launch_counts() == dict.fromkeys(names, 0)
    for i, name in enumerate(names):
        tracing.count(f"launches.{name}", i + 1)
    assert mod.launch_counts() == {name: i + 1 for i, name in enumerate(names)}
    assert all(tracing.counters()[f"launches.{n}"] == i + 1 for i, n in enumerate(names))
    mod.reset_launch_counts()
    assert mod.launch_counts() == dict.fromkeys(names, 0)
    # the per-module copies are gone
    assert not any(hasattr(k, "launches") for k in mod.KERNELS)
    assert not hasattr(permute.permute_gather, "launches")


@pytest.mark.parametrize("alg", [ColoringAlgorithm.SERIAL, ColoringAlgorithm.VB,
                                 ColoringAlgorithm.VBD, ColoringAlgorithm.EB],
                         ids=lambda a: a.name)
@pytest.mark.parametrize("shape", [(24, 24), (70, 70)], ids=["576", "4900"])
def test_graph_colors_gauge(alg, shape):
    A = tkc.generate_structured_laplacian(*shape, dtype=np.float64, device=CPU)
    tracing.reset_counters("graph.")
    colors = graph_color(A, alg)
    c = tracing.counters()
    assert c["graph.colors"] == np.unique(colors).size
    assert isinstance(c["graph.color_s"], float) and c["graph.color_s"] > 0


def test_gs_symbolic_sets_the_gauges_and_plan_spans(lap):
    tracing.reset_counters("graph.")
    h = GsHandle(coloring=ColoringAlgorithm.SERIAL)
    with tracing.recording() as rec:
        gauss_seidel_symbolic(h, lap)
        gauss_seidel_numeric(h, lap)
        SpmvHandle(lap)(torch.ones(lap.ncols, dtype=torch.float64))
    assert tracing.counters()["graph.colors"] == np.unique(h.colors).size == 2
    names = [s.name for s in rec.spans]
    assert "tpukk::gs_sweep_plan" in names and "tpukk::spmv_plan<DIA>" in names
    assert names.index("tpukk::graph_color") < names.index("tpukk::gs_sweep_plan")
