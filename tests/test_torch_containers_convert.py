"""tpukk_torch's COO, CCS and BSR containers, the format conversions, the CRS
transforms (sort, merge, zero removal, diagonal blocks, row-size order,
symmetrisation), the MatrixMarket and .npz IO and generate_random_bsr,
against tpukk on the same seeded inputs, with device="cpu".  Mirrors
tests/test_containers.py (test_conversions_roundtrip, test_bsr_roundtrip,
test_sort_and_zeros, test_io_roundtrip, test_extract_diagonal_blocks,
test_sort_by_row_size, test_symmetrize_pattern, TestDetectBlockSize,
test_generate_random_bsr).

Tolerance: exact (the same host scipy/numpy work in both packages; the
arrays must be equal element for element).
"""
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk
import tpukk.containers as jkc
import tpukk_torch
import tpukk_torch.containers as tkc
from tpukk_torch.common import TpuKKError

CPU = "cpu"


def random_scipy(m, n, density=0.05, seed=0):
    A = sps.random(m, n, density=density, random_state=np.random.RandomState(seed), format="csr")
    A.sort_indices()
    return A


def _arrays(obj, *fields):
    out = []
    for f in fields:
        a = getattr(obj, f)
        out.append(a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
    return out


def _same(jobj, tobj, *fields):
    assert tobj.shape == jobj.shape
    for f, a, b in zip(fields, _arrays(jobj, *fields), _arrays(tobj, *fields)):
        np.testing.assert_array_equal(b, a, err_msg=f)
        if f in ("row", "col", "row_map", "col_map", "entries"):
            assert getattr(tobj, f).dtype == torch.int32, f


CSR = ("row_map", "entries", "values")


def _pair(sp):
    return jkc.CsrMatrix.from_scipy(sp), tkc.CsrMatrix.from_scipy(sp, device=CPU)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_conversions_match_tpukk(dtype):
    sp = random_scipy(50, 50, 0.08).astype(dtype)
    Aj, At = _pair(sp)
    cj, ct = jkc.crs2coo(Aj), tkc.crs2coo(At)
    _same(cj, ct, "row", "col", "data")
    assert ct.nnz == cj.nnz and ct.dtype == At.dtype and ct.device == At.device
    _same(jkc.coo2crs(cj), tkc.coo2crs(ct), *CSR)
    # duplicates merged, or kept
    dup = sps.coo_matrix((np.r_[sp.tocoo().data, 1.5], (np.r_[sp.tocoo().row, 3],
                                                          np.r_[sp.tocoo().col, 7])),
                         shape=sp.shape)
    for merge in (True, False):
        _same(jkc.coo2crs(jkc.CooMatrix.from_scipy(dup), merge),
              tkc.coo2crs(tkc.CooMatrix.from_scipy(dup, device=CPU), merge), *CSR)
    sj, st = jkc.crs2ccs(Aj), tkc.crs2ccs(At)
    _same(sj, st, "col_map", "entries", "values")
    assert st.nnz == sj.nnz
    _same(jkc.ccs2crs(sj), tkc.ccs2crs(st), *CSR)
    assert (tkc.ccs2crs(st).to_scipy() != sp).nnz == 0
    assert (tkc.coo2crs(ct).to_scipy() != sp).nnz == 0
    np.testing.assert_array_equal(tkc.expand_row_indices(At.row_map),
                                  jkc.expand_row_indices(Aj.host_row_map()))
    np.testing.assert_array_equal(tkc.expand_row_indices(At.host_row_map()),
                                  jkc.expand_row_indices(Aj.host_row_map()))


@pytest.mark.parametrize("case,b", [("lap1d", 4), ("lap1d", 2), ("lap2d", 2), ("random", 3)])
def test_bsr_round_trip_matches_tpukk(case, b):
    if case == "lap1d":
        sp = jkc.generate_structured_laplacian(64).to_scipy()
    elif case == "lap2d":
        sp = jkc.generate_structured_laplacian(8, 8, dtype=np.float64).to_scipy()
    else:
        sp = random_scipy(60, 45, 0.1, seed=4)
    Aj, At = _pair(sp)
    Bj, Bt = jkc.crs2bsr(Aj, b), tkc.crs2bsr(At, b)
    _same(Bj, Bt, *CSR)
    assert (Bt.block_size, Bt.nnz_blocks, Bt.nnz, Bt.n_block_rows, Bt.n_block_cols) == \
        (Bj.block_size, Bj.nnz_blocks, Bj.nnz, Bj.n_block_rows, Bj.n_block_cols)
    assert Bt.values.shape == (Bt.nnz_blocks, b, b) and Bt.dtype == At.dtype
    np.testing.assert_array_equal(Bt.host_values(), np.asarray(Bj.host_values()))
    for prune in (False, True):
        _same(jkc.bsr2crs(Bj, prune_zeros=prune), tkc.bsr2crs(Bt, prune_zeros=prune), *CSR)
    assert (tkc.bsr2crs(Bt, prune_zeros=True).to_scipy() != At.to_scipy()).nnz == 0
    Bt2 = Bt.with_values(2 * Bt.host_values())
    np.testing.assert_array_equal(Bt2.values.numpy(), 2 * Bt.values.numpy())
    assert Bt2.row_map is Bt.row_map
    with pytest.raises(TpuKKError):
        tkc.crs2bsr(At, 7)


class TestDetectBlockSize:
    """detect_block_size against tpukk on tests/test_containers.py's cases."""

    @staticmethod
    def _both(sp):
        Aj, At = _pair(sp.astype(np.float32))
        return jkc.detect_block_size(Aj), tkc.detect_block_size(At)

    def test_truly_blocked(self):
        pat = sps.random(10, 10, 0.4, random_state=1, format="csr")
        pat.data[:] = 1.0
        assert self._both(sps.kron(pat, np.ones((4, 4))).tocsr()) == (4, 4)

    def test_non_blocked_even_dims_returns_1(self):
        A = sps.random(64, 64, 0.05, random_state=2, format="csr")
        A.setdiag(1.0)
        assert self._both(A.tocsr()) == (1, 1)

    def test_multiple_factor(self):
        pat = sps.random(6, 6, 0.5, random_state=3, format="csr")
        pat.data[:] = 1.0
        assert self._both(sps.kron(pat, np.ones((6, 6))).tocsr()) == (6, 6)

    def test_empty(self):
        assert self._both(sps.csr_matrix((8, 8))) == (1, 1)


def test_sort_merge_and_zeros_match_tpukk():
    col = np.array([2, 0, 1, 0, 2, 0])
    val = np.array([1.0, 2.0, 0.0, 3.0, 4.0, 5.0])
    rm = np.array([0, 2, 6])  # row 1 holds column 0 twice
    Aj = jkc.CsrMatrix.from_arrays(rm, col, val, ncols=3)
    At = tkc.CsrMatrix.from_arrays(rm, col, val, ncols=3, device=CPU)
    assert not tkc.is_sorted(At) and not jkc.is_sorted(Aj)
    for fn in ("sort_crs", "sort_and_merge_crs", "remove_zeros"):
        got = getattr(tkc, fn)(At)
        _same(getattr(jkc, fn)(Aj), got, *CSR)
        assert got.device == At.device and got.dtype == At.dtype
    assert tkc.is_sorted(tkc.sort_crs(At)) and tkc.remove_zeros(At).nnz == 5
    assert tkc.sort_and_merge_crs(At).nnz == 5  # (1, 0) merged


def test_sort_crs_keeps_bf16():
    sp = random_scipy(20, 20, 0.2, seed=3).astype(np.float32)
    At = tkc.CsrMatrix.from_scipy(sp, device=CPU).astype(torch.bfloat16)
    assert tkc.sort_crs(At).dtype == torch.bfloat16
    assert tkc.symmetrize_pattern(At).dtype == torch.bfloat16


def test_extract_diagonal_blocks_matches_tpukk():
    Aj = jkc.generate_diag_dominant_csr(90, 4, dtype=np.float64, seed=3)
    At = tkc.generate_diag_dominant_csr(90, 4, dtype=np.float64, seed=3, device=CPU)
    bj, bt = jkc.extract_diagonal_blocks(Aj, 4), tkc.extract_diagonal_blocks(At, 4)
    assert [b.nrows for b in bt] == [b.nrows for b in bj] == [22, 22, 22, 24]
    for x, y in zip(bj, bt):
        _same(x, y, *CSR)
    for bad in (0, 91):
        with pytest.raises(ValueError):
            tkc.extract_diagonal_blocks(At, bad)
    with pytest.raises(ValueError):
        tkc.extract_diagonal_blocks(tkc.CsrMatrix.from_scipy(random_scipy(4, 5), device=CPU), 2)


@pytest.mark.parametrize("ascending", [False, True])
def test_sort_by_row_size_matches_tpukk(ascending):
    D = np.zeros((4, 4))
    D[0, :3] = 1
    D[1, 0] = 1
    D[2, :] = 1
    D[3, :2] = 1
    sp = sps.csr_matrix(D)
    Aj, At = _pair(sp)
    got = tkc.sort_by_row_size(At, ascending=ascending)
    np.testing.assert_array_equal(got, jkc.sort_by_row_size(Aj, ascending=ascending))
    assert list(got) == ([1, 3, 0, 2] if ascending else [2, 0, 3, 1])
    big = jkc.generate_random_csr(300, 300, 6, seed=8)
    np.testing.assert_array_equal(
        tkc.sort_by_row_size(tkc.CsrMatrix.from_scipy(big.to_scipy(), device=CPU), ascending),
        jkc.sort_by_row_size(big, ascending))


def test_symmetrize_pattern_matches_tpukk():
    Aj = jkc.generate_random_csr(50, 50, 3, dtype=np.float64, seed=5)
    At = tkc.generate_random_csr(50, 50, 3, dtype=np.float64, seed=5, device=CPU)
    St = tkc.symmetrize_pattern(At)
    _same(jkc.symmetrize_pattern(Aj), St, *CSR)
    np.testing.assert_array_equal(St.to_scipy().toarray(), St.to_scipy().T.toarray())


def test_io_round_trips_with_tpukk(tmp_path):
    Aj = jkc.generate_random_csr(20, 20, 3, seed=1)
    At = tkc.generate_random_csr(20, 20, 3, seed=1, device=CPU)
    tkc.write_mtx(tmp_path / "port.mtx", At)
    jkc.write_mtx(tmp_path / "tpukk.mtx", Aj)
    assert (tmp_path / "port.mtx").read_text() == (tmp_path / "tpukk.mtx").read_text()
    _same(jkc.read_mtx(tmp_path / "port.mtx", value_dtype=np.float32),
          tkc.read_mtx(tmp_path / "tpukk.mtx", value_dtype=np.float32, device=CPU), *CSR)
    # the port's .npz is tpukk's, and the other way round
    tkc.save_csr_npz(tmp_path / "port.npz", At)
    jkc.save_csr_npz(tmp_path / "tpukk.npz", Aj)
    _same(jkc.load_csr_npz(tmp_path / "port.npz"),
          tkc.load_csr_npz(tmp_path / "tpukk.npz", device=CPU), *CSR)
    _same(Aj, tkc.load_csr_npz(tmp_path / "port.npz", device=CPU), *CSR)


@pytest.mark.parametrize("args", [(12, 10, 3, 4, np.float32, 5), (7, 9, 2, 12, np.float64, 1),
                                  (0, 4, 2, 2, np.float32, 2)])
def test_generate_random_bsr_matches_tpukk(args):
    *shape, dtype, seed = args
    Bj = jkc.generate_random_bsr(*shape, dtype=dtype, seed=seed)
    Bt = tkc.generate_random_bsr(*shape, dtype=dtype, seed=seed, device=CPU)
    _same(Bj, Bt, *CSR)
    assert Bt.block_size == Bj.block_size and Bt.values.shape == tuple(Bj.values.shape)
    np.testing.assert_array_equal(Bt.to_scipy().toarray(), Bj.to_scipy().toarray())


def test_containers_refuse_to_guess_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sp = random_scipy(8, 8, 0.3)
    for call in (lambda: tkc.CooMatrix.from_scipy(sp), lambda: tkc.CcsMatrix.from_scipy(sp),
                 lambda: tkc.BsrMatrix.from_scipy_bsr(sp.tobsr(blocksize=(2, 2))),
                 lambda: tkc.generate_random_bsr(2, 2, 2, 1)):
        with pytest.raises(TpuKKError, match="device='cpu'"):
            call()
    with pytest.raises(TpuKKError):
        tkc.CooMatrix.from_scipy(sp, ordinal_dtype=np.int64, device=CPU)
    with pytest.raises(TpuKKError):
        tkc.CcsMatrix.from_scipy(sp, offset_dtype=torch.int64, device=CPU)


@pytest.mark.parametrize("name", ["BsrMatrix", "CcsMatrix", "CooMatrix"])
def test_top_level_containers(name):
    assert name in tpukk_torch.__all__ and hasattr(tpukk, name)
    assert getattr(tpukk_torch, name) is getattr(tkc, name)


def test_every_tpukk_container_name_is_ported():
    missing = [n for n in dir(jkc) if not n.startswith("_") and not hasattr(tkc, n)]
    assert not missing, missing
