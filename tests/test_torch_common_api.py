"""Public names of tpukk_torch that tpukk has: the top-level re-exports, the
CsrMatrix value updates, the common helpers (errors, utils, tracing, timing)
and SpmvHandle.matvec_f64, each against tpukk on the same inputs, on the CPU.

Tolerances: values exactly where both packages do the same arithmetic
(offsets, value updates, the f32 fetch); SpMV in f64 1e-14 relative to
max|y| (the same products summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukk
import tpukk.common as jcommon
import tpukk.containers as jkc
import tpukk_torch
import tpukk_torch.common as tcommon
import tpukk_torch.containers as tkc
from tpukk_torch.common import TpuKKError

CPU = "cpu"


def _pair(dtype=np.float64, seed=5):
    Aj = jkc.generate_random_csr(40, 30, 4, seed=seed, dtype=dtype)
    At = tkc.CsrMatrix.from_scipy(Aj.to_scipy(), device=CPU)
    return Aj, At


@pytest.mark.parametrize("name", ["CsrMatrix", "SpmvAlgorithm", "SpmvHandle", "spmv", "spmm"])
def test_top_level_reexports(name):
    assert name in tpukk_torch.__all__
    assert getattr(tpukk_torch, name) is getattr(
        tpukk_torch.containers if name == "CsrMatrix" else tpukk_torch.sparse, name)
    assert hasattr(tpukk, name)


def test_top_level_spmv_matches_tpukk(rng):
    Aj, At = _pair()
    x = rng.standard_normal(At.ncols)
    X = rng.standard_normal((At.ncols, 3))
    y = tpukk_torch.spmv(At, torch.from_numpy(x)).numpy()
    Y = tpukk_torch.spmm(At, torch.from_numpy(X)).numpy()
    yj = np.asarray(tpukk.spmv(Aj, jnp.asarray(x)))
    Yj = np.asarray(tpukk.spmm(Aj, jnp.asarray(X)))
    assert np.abs(y - yj).max() <= 1e-14 * np.abs(yj).max()
    assert np.abs(Y - Yj).max() <= 1e-14 * np.abs(Yj).max()
    h = tpukk_torch.SpmvHandle(At, tpukk_torch.SpmvAlgorithm.AUTO)
    assert np.abs(h(torch.from_numpy(x)).numpy() - yj).max() <= 1e-14 * np.abs(yj).max()


def _coords(S, seed):
    """Six (row, col) pairs, every other one present in S."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, S.shape[0], 6)
    cols = np.empty_like(rows)
    for i, r in enumerate(rows):
        seg = S.indices[S.indptr[r]:S.indptr[r + 1]]
        if i % 2 == 0 and len(seg):
            cols[i] = seg[i % len(seg)]
        else:
            cols[i] = next(c for c in range(S.shape[1]) if c not in seg)
    return rows, cols


@pytest.mark.parametrize("is_sorted", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("method", ["replace_values", "sum_into_values"])
def test_value_updates_match_tpukk(method, is_sorted):
    Aj, At = _pair()
    rows, cols = _coords(Aj.to_scipy(), 3)
    vals = np.arange(1.0, len(rows) + 1)
    Bj = getattr(Aj, method)(rows, cols, vals, is_sorted=is_sorted)
    Bt = getattr(At, method)(rows, cols, vals, is_sorted=is_sorted)
    assert isinstance(Bt, tkc.CsrMatrix) and Bt.device == At.device and Bt.dtype == At.dtype
    np.testing.assert_array_equal(Bt.host_entries(), Aj.host_entries())
    np.testing.assert_array_equal(Bt.values.numpy(), np.asarray(Bj.values))
    # the input matrix is unchanged
    np.testing.assert_array_equal(At.values.numpy(), np.asarray(Aj.values))


def test_value_updates_on_unsorted_rows_and_empty_matrix():
    """Rows stored out of column order: the unsorted search still finds each
    entry; an empty matrix ignores every coordinate."""
    sp = jkc.generate_random_csr(20, 20, 3, seed=8, dtype=np.float64).to_scipy()
    rm, ent, val = sp.indptr, sp.indices.copy(), sp.data.copy()
    for r in range(20):  # reverse each row
        ent[rm[r]:rm[r + 1]] = ent[rm[r]:rm[r + 1]][::-1]
        val[rm[r]:rm[r + 1]] = val[rm[r]:rm[r + 1]][::-1]
    Aj = jkc.CsrMatrix.from_arrays(rm, ent, val, nrows=20, ncols=20)
    At = tkc.CsrMatrix.from_arrays(rm, ent, val, nrows=20, ncols=20, device=CPU)
    rows, cols = _coords(sp, 4)
    vals = np.full(len(rows), 2.5)
    for method in ("replace_values", "sum_into_values"):
        ref = np.asarray(getattr(Aj, method)(rows, cols, vals, is_sorted=False).values)
        got = getattr(At, method)(rows, cols, vals, is_sorted=False).values.numpy()
        np.testing.assert_array_equal(got, ref)
    E = tkc.CsrMatrix.from_arrays([0, 0, 0], [], np.zeros(0), ncols=4, device=CPU)
    assert E.sum_into_values([0, 1], [2, 3], [1.0, 2.0]).nnz == 0


@pytest.mark.parametrize("rank,shape", [(1, (5,)), (2, (5,)), (2, (3, 4))])
def test_check_rank_matches_tpukk(rank, shape):
    a = np.zeros(shape)
    raised = []
    for mod, arr in ((jcommon, a), (tcommon, torch.from_numpy(a))):
        try:
            mod.check_rank(arr, rank, "x")
            raised.append(None)
        except Exception as e:  # both raise their own TpuKKError
            raised.append(str(e))
    assert raised[0] == raised[1]
    assert (raised[1] is None) == (len(shape) == rank)


@pytest.mark.parametrize("dtypes", [("float32", "float32"), ("float32", "float64")])
def test_check_same_dtype_matches_tpukk(dtypes):
    arrs = [np.zeros(2, dt) for dt in dtypes]
    jcommon.check_same_dtype("f", *arrs[:1])
    if dtypes[0] == dtypes[1]:
        jcommon.check_same_dtype("f", *arrs)
        tcommon.check_same_dtype("f", *[torch.from_numpy(a) for a in arrs])
        tcommon.check_same_dtype("f", *arrs)
        return
    with pytest.raises(jcommon.TpuKKError) as ej:
        jcommon.check_same_dtype("f", *arrs)
    with pytest.raises(TpuKKError) as et:
        tcommon.check_same_dtype("f", *arrs)
    assert str(ej.value) == str(et.value)
    with pytest.raises(TpuKKError, match="mismatched dtypes"):
        tcommon.check_same_dtype("f", *[torch.from_numpy(a) for a in arrs])


@pytest.mark.parametrize("sizes", [[2, 0, 3], [], [7], np.array([1, 1, 4], np.int32)])
def test_segment_offsets_match_tpukk(sizes):
    got = tcommon.segment_offsets_from_sizes(sizes)
    ref = jcommon.segment_offsets_from_sizes(sizes)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(tcommon.sizes_from_offsets(got),
                                  jcommon.sizes_from_offsets(ref))


def test_trace_writes_a_trace(tmp_path):
    """Both packages write a profile artifact under log_dir; the port's is
    a Chrome trace that names the regions it saw."""
    import json
    import os

    for mod, d in ((jcommon, tmp_path / "jax"), (tcommon, tmp_path / "torch")):
        with mod.trace(str(d)):
            if mod is tcommon:
                with tcommon.profile_region("tpukk::probe_region"):
                    torch.ones(64).sum()
            else:
                jnp.zeros((8, 128)).block_until_ready()
        files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
        assert files, f"no trace written by {mod.__name__}"
    (path,) = files
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "tpukk::probe_region" in names


@pytest.mark.parametrize("value", [1.0 / 3.0, -2.5, 7.0])
def test_sync_fetch_matches_tpukk(value):
    x = np.array([value, 9.0])
    ref = jcommon.sync_fetch((jnp.asarray(x), jnp.zeros(2)))
    for y in (torch.from_numpy(x), (torch.from_numpy(x), torch.zeros(2)),
              {"a": torch.from_numpy(x), "b": torch.zeros(2)}):
        got = tcommon.sync_fetch(y)
        assert isinstance(got, float) and got == ref


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_matvec_f64_matches_tpukk(dtype, rng):
    """Host f64 in and out; tpukk on the CPU takes the exact host product,
    the port the handle's own product with f64 operands."""
    Aj = jkc.generate_random_csr(300, 200, 6, seed=4, dtype=dtype)
    At = tkc.CsrMatrix.from_scipy(Aj.to_scipy(), device=CPU)
    x = rng.standard_normal(200)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # tpukk's host-route notice
        ref = np.asarray(tpukk.SpmvHandle(Aj).matvec_f64(x))
    got = tpukk_torch.SpmvHandle(At).matvec_f64(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64 and got.shape == (300,)
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
