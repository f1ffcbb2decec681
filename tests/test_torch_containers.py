"""tpukk_torch containers against tpukk: the generators and read_mtx give the
same arrays for the same arguments and seed, the CsrMatrix API round-trips,
constructors refuse to guess a device, and the port imports neither JAX nor
tpukk and builds nothing at import."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import tpukk.containers as jkc
import tpukk_torch.containers as tkc
from tpukk_torch.common import TpuKKError
from tpukk_torch.interop import csr_from_numpy

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"

GENERATORS = [
    ("lap1d", "generate_structured_laplacian", (50,), {}),
    ("lap2d", "generate_structured_laplacian", (40, 40), {}),
    ("lap3d", "generate_structured_laplacian", (12, 12, 12), {}),
    ("random", "generate_random_csr", (2000, 1800, 8), {"seed": 3}),
    ("random_unsorted", "generate_random_csr", (300, 300, 5), {"seed": 4, "sorted_cols": False}),
    ("diag_dominant", "generate_diag_dominant_csr", (500, 6), {"seed": 5}),
    ("banded", "generate_banded_csr", (300, 3), {"seed": 6}),
]


def _same_arrays(Aj, At):
    assert (At.nrows, At.ncols) == (Aj.nrows, Aj.ncols)
    np.testing.assert_array_equal(At.host_row_map(), Aj.host_row_map())
    np.testing.assert_array_equal(At.host_entries(), Aj.host_entries())
    np.testing.assert_array_equal(At.host_values(), Aj.host_values_full())
    assert At.row_map.dtype == torch.int32 and At.entries.dtype == torch.int32
    np.testing.assert_array_equal(At.values.numpy(), np.asarray(Aj.values))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generators_give_identical_arrays(case, dtype):
    _, fn, args, kw = case
    Aj = getattr(jkc, fn)(*args, dtype=dtype, **kw)
    At = getattr(tkc, fn)(*args, dtype=dtype, device=CPU, **kw)
    assert At.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
    _same_arrays(Aj, At)


@pytest.mark.parametrize("value_dtype", [None, np.float32])
def test_read_mtx_identical(value_dtype):
    path = ROOT / "data" / "fem2d_small.mtx.gz"
    _same_arrays(jkc.read_mtx(path, value_dtype=value_dtype),
                 tkc.read_mtx(path, value_dtype=value_dtype, device=CPU))


def test_csr_api_round_trips(rng):
    d = rng.standard_normal((7, 5)) * (rng.random((7, 5)) < 0.4)
    d[3] = 0.0  # an empty row
    A = tkc.CsrMatrix.from_dense(d, device=CPU)
    assert A.shape == (7, 5) and A.nnz == int((d != 0).sum()) and A.dtype == torch.float64
    np.testing.assert_array_equal(A.to_dense().numpy(), d)
    np.testing.assert_array_equal(A.to_scipy().toarray(), d)
    np.testing.assert_array_equal(A.row_lengths(), (d != 0).sum(axis=1))
    B = tkc.CsrMatrix.from_scipy(sps.csr_matrix(d), device=CPU)
    np.testing.assert_array_equal(B.to_dense().numpy(), d)
    C = A.with_values(2.0 * A.host_values())
    np.testing.assert_array_equal(C.to_dense().numpy(), 2.0 * d)
    assert C.row_map is A.row_map  # same sparsity, shared
    F = A.astype(np.float32)
    assert F.dtype == torch.float32 and F.host_values().dtype == np.float32
    assert A.astype(torch.bfloat16).host_values().dtype == np.float32  # widened mirror
    g = A.graph
    assert (g.nrows, g.ncols, g.nnz) == (7, 5, A.nnz)
    np.testing.assert_array_equal(g.host_row_map(), A.host_row_map())
    # from_arrays copies: editing the caller's array leaves the matrix alone
    vals = A.host_values().copy()
    E = tkc.CsrMatrix.from_arrays(A.host_row_map(), A.host_entries(), vals, ncols=5, device=CPU)
    vals[:] = 0
    np.testing.assert_array_equal(E.to_dense().numpy(), d)
    with pytest.raises(TpuKKError):
        tkc.CsrMatrix.from_arrays([0, 1], [0], [1.0, 2.0], ncols=2, device=CPU)


@pytest.mark.parametrize("spelling", [torch.int32, np.int32, "int32", np.dtype("int32")],
                         ids=["torch", "numpy", "str", "np.dtype"])
@pytest.mark.parametrize("keyword", ["ordinal_dtype", "offset_dtype"])
def test_index_dtype_keywords_take_int32(keyword, spelling):
    """``tpukk``'s ``ordinal_dtype``/``offset_dtype`` keywords: int32 in any
    spelling gives the same matrix as tpukk's; int64 raises TpuKKError."""
    sp = sps.random(30, 20, density=0.2, random_state=7, format="csr")
    dense = sp.toarray()
    for At, Aj in ((tkc.CsrMatrix.from_scipy(sp, **{keyword: spelling}, device=CPU),
                    jkc.CsrMatrix.from_scipy(sp, **{keyword: np.int32})),
                   (tkc.CsrMatrix.from_dense(dense, **{keyword: spelling}, device=CPU),
                    jkc.CsrMatrix.from_dense(dense, **{keyword: np.int32}))):
        _same_arrays(Aj, At)
    for bad in (torch.int64, np.int64, "int64", "not a dtype"):
        with pytest.raises(TpuKKError, match="int32 indices"):
            tkc.CsrMatrix.from_scipy(sp, **{keyword: bad}, device=CPU)
        with pytest.raises(TpuKKError, match="int32 indices"):
            tkc.CsrMatrix.from_dense(dense, **{keyword: bad}, device=CPU)


def test_transpose_and_is_sorted_match_tpukk():
    from tpukk.containers import is_sorted as j_is_sorted
    from tpukk.containers import transpose as j_transpose

    Aj = jkc.generate_random_csr(120, 90, 5, seed=3, dtype=np.float64)
    At = tkc.generate_random_csr(120, 90, 5, seed=3, dtype=np.float64, device=CPU)
    assert tkc.is_sorted(At) and j_is_sorted(Aj)
    _same_arrays(j_transpose(Aj), tkc.transpose(At))
    # row 1 descends; row 0 -> row 1 and the empty row 2 are fine
    rm, ent, val = [0, 2, 4, 4, 5], [0, 3, 2, 1, 0], np.arange(5.0)
    Uj = jkc.CsrMatrix.from_arrays(rm, ent, val, ncols=4)
    Ut = tkc.CsrMatrix.from_arrays(rm, ent, val, ncols=4, device=CPU)
    assert tkc.is_sorted(Ut) == j_is_sorted(Uj) == False  # noqa: E712
    _same_arrays(j_transpose(Uj), tkc.transpose(Ut))


def test_interop_hands_tpukk_arrays_over():
    Aj = jkc.generate_random_csr(200, 150, 6, seed=9, dtype=np.float64)
    At = csr_from_numpy(Aj.host_row_map(), Aj.host_entries(), Aj.host_values_full(),
                        nrows=Aj.nrows, ncols=Aj.ncols, device=CPU)
    _same_arrays(Aj, At)


def test_constructors_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tkc.generate_structured_laplacian(8, 8),
        lambda: tkc.generate_random_csr(20, 20, 3),
        lambda: tkc.read_mtx(ROOT / "data" / "fem2d_small.mtx.gz"),
        lambda: tkc.CsrMatrix.from_dense(np.eye(3)),
    ]
    for call in calls:
        with pytest.raises(TpuKKError, match="device='cpu'"):
            call()


def _port_sources():
    return sorted((ROOT / "tpukk_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_tpukk():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "tpukk")]
    assert not bad, bad
    assert len(_port_sources()) > 10


def test_import_builds_nothing():
    code = (
        "import sys, pkgutil, importlib, tpukk_torch\n"
        "for m in pkgutil.walk_packages(tpukk_torch.__path__, 'tpukk_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from tpukk_torch import _kernels\n"
        "assert not _kernels._libs, _kernels._libs\n"
        "assert not any(k.split('.')[0] in ('jax', 'tpukk') for k in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
