"""A stand-in for the solvers' CUDA graph capture
(``tpukk_torch.common.cuda_graph.capture``) off the card: the CPU tests of
``pcg`` (tests/test_torch_pcg_graph.py) and the ranks of ``dist_pcg``
(tests/torch_dist_jobs.py) put it in the one capture point.

While it is in, the CPU is a device whose blocks are graphed.  Its capture
runs the block's host code on copies of the entry's buffers (so that none of
its work lands, as none of a captured graph's does), and its replay runs the
block on the buffers with the recorder off and takes back the counters that
adds, as a graph's replay enters no region and adds no counter itself.  A
capture that fails is stood in for by what the real one then returns, None.
The ranks import this module, so it imports torch and tpukk_torch alone (no
JAX)."""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch

from tpukk_torch.common import cuda_graph, tracing


class StandIn:
    """The capture: ``n`` counts its calls; while ``fail`` is set they fail."""

    def __init__(self, fail: bool = False):
        self.n, self.fail = 0, fail

    def __call__(self, block, st, device):
        self.n += 1
        block(SimpleNamespace(**{k: v.clone() if isinstance(v, torch.Tensor) else v
                                 for k, v in vars(st).items()}))
        if self.fail:
            return None

        def replay():
            before = tracing.counters()
            recorder, tracing._recorder = tracing._recorder, None
            try:
                block(st)
            finally:
                tracing._recorder = recorder
            for n, v in tracing.counters().items():
                tracing.count(n, before.get(n, 0) - v)
        return replay


@contextlib.contextmanager
def stand_in(fail: bool = False):
    """The stand-in (``StandIn(fail)``, yielded) as the capture, with the
    CPU among the graphed devices, inside the ``with``."""
    calls = StandIn(fail)
    real = cuda_graph.capture, cuda_graph.GRAPH_DEVICES
    cuda_graph.capture, cuda_graph.GRAPH_DEVICES = calls, ("cpu",)
    try:
        yield calls
    finally:
        cuda_graph.capture, cuda_graph.GRAPH_DEVICES = real
