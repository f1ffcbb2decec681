"""kkbench: the benchmark of tpukk_torch, the PyTorch and CUDA port.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) through ``python3 kkbench/run.py``.  Configurations, mixes,
matrix builders, drivers, per-layer metrics and limits are files found by
name (``registry.py``); the yardstick (byte counts, peaks, the slope timer,
the trace reader, the plain reference) lives in this folder, so a change to
the port cannot move it.  Nothing here imports JAX or ``tpukk``, and
``reference/`` imports nothing of ``tpukk_torch``.
"""
