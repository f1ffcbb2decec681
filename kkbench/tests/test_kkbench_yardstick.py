"""The compulsory-byte rule: values once, vectors once, no indices."""
from __future__ import annotations

import scipy.sparse as sps
import numpy as np

from kkbench import yardstick


def _A(dtype):
    # 4×4: a full diagonal, 3 entries below it and 2 above
    rows = [0, 1, 2, 3, 1, 2, 3, 0, 1]
    cols = [0, 1, 2, 3, 0, 0, 2, 2, 3]
    return sps.csr_matrix((np.arange(1, 10, dtype=dtype), (rows, cols)), shape=(4, 4))


def test_bytes_f64_and_f32():
    for dt, w in ((np.float64, 8), (np.float32, 4)):
        A = _A(dt)
        assert yardstick.spmv_bytes(A) == (9 + 4 + 4) * w
        assert yardstick.symgs_bytes(A) == (9 + 2 * 4) * w
        assert yardstick.jacobi_bytes(A) == 3 * 4 * w
        assert yardstick.ilu0_bytes(A) == (3 + 2 + 4 + 2 * 4) * w


def test_bytes_ignore_the_route():
    """The same values in DIA-friendly and scattered patterns count alike."""
    band = sps.diags([1.0, 2.0, 3.0], [-1, 0, 1], shape=(50, 50)).tocsr()
    p = np.random.default_rng(0).permutation(50)
    scattered = band[p][:, p].tocsr()
    for f in (yardstick.spmv_bytes, yardstick.symgs_bytes, yardstick.jacobi_bytes):
        assert f(band) == f(scattered)


def test_ring_and_peak():
    assert yardstick.ring_size(400 * 2**20) == 1
    assert yardstick.ring_size(2 * 2**20) == 75
    assert yardstick.ring_size(1) == yardstick.MAX_RING
    assert yardstick.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert yardstick.peak_bytes_per_s("cpu") is None
