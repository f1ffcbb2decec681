"""PCG's blocks as CUDA graphs (``tpukk_torch.sparse.pcg``), on the CPU.

The capture is replaced by the stand-in of tests/cuda_graph_stand_in.py,
which lets the CPU in as a device the blocks are graphed on.  The card's own
graphs are held to the eager solves in tests/test_torch_cuda.py.
"""
from __future__ import annotations

import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

import tpukk_torch.containers as tkc
from cuda_graph_stand_in import stand_in
from tpukk_torch.common import tracing
from tpukk_torch.sparse import (GsAlgorithm, GsHandle, GsPrec, IdentityPrec, JacobiPrec,
                                SpmvHandle, gauss_seidel_numeric, gauss_seidel_symbolic, pcg)

pcg_mod = sys.modules["tpukk_torch.sparse.pcg"]

GRAPH_COUNTERS = ("pcg.blocks", "pcg.graph_replays", "pcg.graph_captures", "pcg.graph_fallbacks")


class CountingJacobi(JacobiPrec):
    """Jacobi whose apply counts itself as a kernel's launch would."""

    def apply(self, x):
        tracing.count("launches.test_jacobi")
        return super().apply(x)


@pytest.fixture
def captures():
    """The stand-in capture on the CPU; ``captures.n`` counts its calls and
    ``captures.fail`` makes the next ones fail."""
    with stand_in() as calls:
        yield calls


def _lap(n=20):
    return tkc.generate_structured_laplacian(n, n, dtype=np.float64, device="cpu")


def _gs_prec(A):
    h = GsHandle(GsAlgorithm.POINT)
    gauss_seidel_symbolic(h, A)
    gauss_seidel_numeric(h, A)
    return GsPrec(h, A)


def _bs(A, k=3, dtype=torch.float64):
    rng = np.random.default_rng(5)
    return [torch.from_numpy(rng.standard_normal(A.nrows)).to(dtype) for _ in range(k)]


def _counted(fn):
    """fn()'s result and the counters it added (numbers that moved)."""
    before = tracing.counters()
    out = fn()
    after = tracing.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if isinstance(v, (int, float)) and v != before.get(k, 0)}


def _without(counts, prefix="pcg."):
    return {k: v for k, v in counts.items() if not k.startswith(prefix)}


class ApplyOnly:
    """A preconditioner by its ``apply`` alone, as ``CholmodSolve`` is."""

    def __init__(self, A):
        self.inv_diag = JacobiPrec(A).inv_diag

    def apply(self, x):
        return self.inv_diag * x


PRECS = {"identity": lambda A: None, "jacobi": CountingJacobi, "gsprec": _gs_prec,
         "apply_only": ApplyOnly}


@pytest.mark.parametrize("prec", list(PRECS))
def test_replayed_solves_equal_eager_ones_bit_for_bit(captures, prec):
    """Solves through a held handle (the first block eager, the rest
    replays) give the eager solves' x and iterations bit for bit, count the
    eager solves' launches, and count their blocks, replays and one capture."""
    A = _lap()
    P = PRECS[prec](A)
    bs = _bs(A)
    eager, eager_counts = _counted(lambda: [pcg(A, b, prec=P) for b in bs])
    Ah = SpmvHandle(A)
    graphed, counts = _counted(lambda: [pcg(Ah, b, prec=P) for b in bs])
    for (xe, se), (xg, sg) in zip(eager, graphed):
        assert torch.equal(xe, xg) and se == sg and sg.converged
    assert _without(counts) == _without(eager_counts)
    if prec == "jacobi":
        assert counts["launches.test_jacobi"] == sum(s.num_iters + 1 for _, s in graphed)
    blocks = sum(s.num_iters for _, s in graphed) // 10
    assert eager_counts["pcg.blocks"] == blocks and "pcg.graph_replays" not in eager_counts
    assert {k: counts.get(k, 0) for k in GRAPH_COUNTERS} == {
        "pcg.blocks": blocks, "pcg.graph_replays": blocks - 1, "pcg.graph_captures": 1,
        "pcg.graph_fallbacks": 0}
    assert captures.n == 1


def test_returned_x_is_the_solves_own(captures):
    """x belongs to the caller: a later solve leaves it as it was."""
    A = _lap()
    Ah, P = SpmvHandle(A), JacobiPrec(A)
    b1, b2 = _bs(A, 2)
    x1, _ = pcg(Ah, b1, prec=P)
    kept = x1.clone()
    pcg(Ah, b2, prec=P)
    assert torch.equal(x1, kept)


def test_failed_capture_runs_eagerly_and_is_not_tried_again(captures):
    A = _lap()
    Ah, P = SpmvHandle(A), CountingJacobi(A)
    bs = _bs(A)
    eager, eager_counts = _counted(lambda: [pcg(A, b, prec=P) for b in bs])
    captures.fail = True
    graphed, counts = _counted(lambda: [pcg(Ah, b, prec=P) for b in bs])
    for (xe, se), (xg, sg) in zip(eager, graphed):
        assert torch.equal(xe, xg) and se == sg
    assert captures.n == 1
    assert counts["pcg.graph_fallbacks"] == 1
    assert "pcg.graph_replays" not in counts and "pcg.graph_captures" not in counts
    assert _without(counts) == _without(eager_counts)


def test_a_csr_matrix_never_captures(captures):
    A = _lap()
    entries = len(pcg_mod._graphs)
    _, counts = _counted(lambda: [pcg(A, b, prec=JacobiPrec(A)) for b in _bs(A, 2)])
    assert captures.n == 0 and len(pcg_mod._graphs) == entries
    assert set(counts) & set(GRAPH_COUNTERS) == {"pcg.blocks"}


def test_the_cpu_never_captures():
    """Without the stand-in the CPU runs every block as it is."""
    A = _lap()
    Ah = SpmvHandle(A)
    _, counts = _counted(lambda: [pcg(Ah, b, prec=JacobiPrec(A)) for b in _bs(A, 2)])
    assert not pcg_mod._graphs.get(Ah)
    assert set(counts) & set(GRAPH_COUNTERS) == {"pcg.blocks"}


def _patched_iteration(monkeypatch):
    real = pcg_mod.pcg_iteration
    monkeypatch.setattr(pcg_mod, "pcg_iteration", lambda Ah, prec, state: real(Ah, prec, state))


CHANGES = {
    "prec": lambda A, P, b, mp: dict(prec=JacobiPrec(A)),
    "check_every": lambda A, P, b, mp: dict(prec=P, check_every=5),
    "dtype": lambda A, P, b, mp: dict(prec=P, b=b.float()),
    "shape": lambda A, P, b, mp: dict(prec=P, b=b[:, None]),
    "pcg_iteration": lambda A, P, b, mp: (_patched_iteration(mp), dict(prec=P))[1],
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_new_key_captures_anew(captures, monkeypatch, change):
    """A different preconditioner, check_every, dtype or shape of b, or a
    patched ``pcg_iteration``, captures a graph of its own; the first key's
    graph still replays."""
    A = _lap()
    Ah, P = SpmvHandle(A), JacobiPrec(A)
    b = _bs(A, 1)[0]
    pcg(Ah, b, prec=P)
    kw = dict(b=b)
    kw.update(CHANGES[change](A, P, b, monkeypatch))
    _, counts = _counted(lambda: pcg(Ah, **kw))
    assert counts["pcg.graph_captures"] == 1 and captures.n == 2
    _, counts = _counted(lambda: pcg(Ah, b, prec=P))
    assert "pcg.graph_captures" not in counts and counts["pcg.graph_replays"] > 0


def test_another_thread_has_an_entry_of_its_own(captures):
    """A solve from another thread on the same handle and prec captures a
    graph and buffers of its own, so that neither overwrites the other's
    state; the first thread's graph still replays."""
    A = _lap()
    Ah, P = SpmvHandle(A), JacobiPrec(A)
    b1, b2 = _bs(A, 2)
    pcg(Ah, b1, prec=P)
    out = {}
    t = threading.Thread(target=lambda: out.update(solve=_counted(lambda: pcg(Ah, b2, prec=P))))
    t.start()
    t.join()
    (x2, s2), counts = out["solve"]
    assert counts["pcg.graph_captures"] == 1 and captures.n == 2
    assert len(pcg_mod._graphs[Ah]) == 2
    xe, se = pcg(A, b2, prec=P)
    assert torch.equal(x2, xe) and s2 == se
    _, counts = _counted(lambda: pcg(Ah, b1, prec=P))
    assert "pcg.graph_captures" not in counts and counts["pcg.graph_replays"] > 0


def test_operands_are_what_the_apply_reads():
    """A preconditioner's operands are its attributes; GsPrec's add its
    handle's, which a numeric phase replaces."""
    A = _lap()
    P = JacobiPrec(A)
    (operand,) = P.operands()
    assert operand is P.inv_diag
    G = _gs_prec(A)
    before = G.operands()
    assert any(o is G._h._plans for o in before)
    gauss_seidel_numeric(G._h, A)
    after = G.operands()
    assert len(after) == len(before) and not all(a is b for a, b in zip(after, before))


def test_a_new_numeric_phase_captures_anew(captures):
    """A new numeric phase of the GsHandle (new values, same pattern) is a
    new plan: the next solve captures anew, and its x is the eager solve's
    with the new values, bit for bit."""
    A = _lap()
    P = _gs_prec(A)
    Ah = SpmvHandle(A)
    b = _bs(A, 1)[0]
    pcg(Ah, b, prec=P)
    pcg(Ah, b, prec=P)
    assert captures.n == 1
    sp = A.to_scipy()
    sp.setdiag(sp.diagonal() * 1.5)
    gauss_seidel_numeric(P._h, tkc.CsrMatrix.from_scipy(sp, device="cpu"))
    (xg, sg), counts = _counted(lambda: pcg(Ah, b, prec=P))
    assert counts["pcg.graph_captures"] == 1 and captures.n == 2
    xe, se = pcg(A, b, prec=P)
    assert torch.equal(xg, xe) and sg == se


def test_a_replaced_operand_captures_anew(captures):
    """A tensor the apply reads, replaced on the preconditioner, is read by
    no replay: the next solve captures anew."""
    A = _lap()
    Ah, P = SpmvHandle(A), JacobiPrec(A)
    b = _bs(A, 1)[0]
    pcg(Ah, b, prec=P)
    P.inv_diag = P.inv_diag * 0.5
    (xg, _), counts = _counted(lambda: pcg(Ah, b, prec=P))
    assert counts["pcg.graph_captures"] == 1
    assert torch.equal(xg, pcg(A, b, prec=P)[0])


def test_the_entry_goes_with_the_handle_and_the_preconditioner(captures):
    """An entry goes once its handle or its preconditioner is gone.  The
    stand-in's replay would hold both (it runs the block's closure, where a
    graph's replay holds neither), so its captures fail here: an entry of a
    failed capture is kept by the same rules."""
    captures.fail = True
    A = _lap()
    Ah, P = SpmvHandle(A), JacobiPrec(A)
    b = _bs(A, 1)[0]
    pcg(Ah, b, prec=P)
    (first,) = pcg_mod._graphs[Ah].values()
    x_of = weakref.ref(first.x)
    del P, first
    gc.collect()
    pcg(Ah, b, prec=IdentityPrec())
    assert len(pcg_mod._graphs[Ah]) == 1 and x_of() is None  # the dead prec's entry went
    (entry,) = pcg_mod._graphs[Ah].values()
    handle, x_of = weakref.ref(Ah), weakref.ref(entry.x)
    del Ah, entry
    gc.collect()
    assert handle() is None and x_of() is None


def test_spans_nest_as_before_under_replays(captures):
    """``tpukk::pcg.block`` and ``.check`` wrap every block and residual
    read, replayed or not; the regions inside a block are entered in the
    first solve's eager block and its capture only."""
    A = _lap()
    Ah, P = SpmvHandle(A), _gs_prec(A)
    b = _bs(A, 1)[0]
    with tracing.recording() as rec:
        stats = [pcg(Ah, b, prec=P)[1] for _ in range(2)]
    spans = rec.spans
    for solve, st in zip((1, 2), stats):
        root = [i for i, s in enumerate(spans) if s.name == "tpukk::pcg" and s.solve == solve]
        assert len(root) == 1
        blocks = [i for i, s in enumerate(spans)
                  if s.name == "tpukk::pcg.block" and s.solve == solve]
        checks = [s for s in spans if s.name == "tpukk::pcg.check" and s.solve == solve]
        assert len(blocks) == len(checks) == st.num_iters // 10
        assert all(spans[i].parent == root[0] for i in blocks)
        assert [s.parent for s in checks] == blocks
        inner = [s for s in spans if s.parent in blocks and s.name != "tpukk::pcg.check"]
        # solve 1: the eager block's iterations, then the capture's; solve 2: none
        assert ({s.parent for s in inner} == {blocks[0]}) if solve == 1 else not inner
        if solve == 1:
            applies = [s for s in inner if s.name == "tpukk::gauss_seidel_apply"]
            assert len(applies) == 2 * 10
