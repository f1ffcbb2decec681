"""CSR sparse matrix container — counterpart of ``tpukk/containers/csr.py``
(``CrsMatrix``, sparse/src/KokkosSparse_CrsMatrix.hpp:96, and
``StaticCrsGraph``, sparse/src/KokkosSparse_StaticCrsGraph.hpp:61-123).

Three torch tensors on one device (int32 ``row_map`` and ``entries``, f32/f64/
bf16 ``values``) plus the static shape.  Host numpy mirrors of the arrays are
kept for plan construction, which stays on the host as in ``tpukk``
(SURVEY.md §7.3); constructors that start from host arrays fill the mirrors so
plan building never reads the device back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common import check, default_device

__all__ = ["StaticCrsGraph", "CsrMatrix", "torch_dtype", "expand_row_ids"]

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (``np.float32`` -> ``torch.float32``)."""
    if isinstance(dt, torch.dtype):
        return dt
    return _NP_TO_TORCH[np.dtype(dt)]


def expand_row_ids(row_map: torch.Tensor, nnz: int) -> torch.Tensor:
    """(nnz,) int64 row id of every stored entry, on row_map's device."""
    return torch.repeat_interleave(torch.arange(row_map.shape[0] - 1, device=row_map.device),
                                   torch.diff(row_map.long()), output_size=nnz)


def _host_index(a, name: str) -> np.ndarray:
    """Host int32 copy of an index array (the public ordinal/offset type)."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.size:
        check(int(a.max()) < 2**31 and int(a.min()) >= -2**31,
              f"CsrMatrix: {name} does not fit int32")
    return np.array(a, dtype=np.int32)  # a copy: never aliases the caller's array


def _host_values(v: torch.Tensor) -> np.ndarray:
    """numpy has no bf16: its host mirror is the exact f32 widening."""
    v = v.detach().cpu()
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.numpy()


class _HostMirrors:
    """Cached host copies of a container's device arrays."""

    def _mirror(self, field: str) -> np.ndarray:
        cache = self.__dict__.setdefault("_hcache", {})
        if field not in cache:
            t = getattr(self, field)
            cache[field] = _host_values(t) if field == "values" else t.cpu().numpy()
        return cache[field]

    def _prefill(self, **arrays) -> None:
        cache = self.__dict__.setdefault("_hcache", {})
        cache.update({k: v for k, v in arrays.items() if v is not None})

    def host_row_map(self) -> np.ndarray:
        return self._mirror("row_map")

    def host_entries(self) -> np.ndarray:
        return self._mirror("entries")


@dataclasses.dataclass(eq=False)
class StaticCrsGraph(_HostMirrors):
    """row_map (n+1 offsets) + entries (column ids); cf. StaticCrsGraph.hpp:61."""

    row_map: torch.Tensor  # (nrows+1,) int32
    entries: torch.Tensor  # (nnz,) int32
    nrows: int
    ncols: int

    @property
    def nnz(self) -> int:
        return int(self.entries.shape[0])

    @classmethod
    def from_arrays(cls, row_map, entries, nrows: int, ncols: int,
                    device=None) -> "StaticCrsGraph":
        """From host (numpy) index arrays, with the host mirrors filled."""
        dev = default_device(device)
        rm = _host_index(row_map, "row_map")
        en = _host_index(entries, "entries")
        check(rm.shape[0] == nrows + 1, "StaticCrsGraph: row_map must have nrows+1 entries")
        check(en.shape[0] == (int(rm[-1]) if rm.size else 0),
              "StaticCrsGraph: entries length differs from row_map[-1]")
        g = cls(torch.from_numpy(rm).to(dev), torch.from_numpy(en).to(dev), int(nrows),
                int(ncols))
        g._prefill(row_map=rm, entries=en)
        return g


@dataclasses.dataclass(eq=False)
class CsrMatrix(_HostMirrors):
    """CSR matrix: graph + values (cf. KokkosSparse_CrsMatrix.hpp:96,215).

    Identity-hashed (``eq=False``) so handles can be cached per matrix."""

    row_map: torch.Tensor
    entries: torch.Tensor
    values: torch.Tensor
    nrows: int
    ncols: int

    # ---- constructors -------------------------------------------------
    @classmethod
    def from_arrays(cls, row_map, entries, values, nrows=None, ncols=None,
                    device=None) -> "CsrMatrix":
        """From host (numpy) or torch arrays; ``values`` may be a bf16 tensor."""
        dev = default_device(device)
        rm = _host_index(row_map, "row_map")
        en = _host_index(entries, "entries")
        if nrows is None:
            nrows = rm.shape[0] - 1
        check(ncols is not None, "CsrMatrix.from_arrays: ncols is required")
        check(rm.shape[0] == nrows + 1, "CsrMatrix: row_map must have nrows+1 entries")
        if isinstance(values, torch.Tensor):
            vals_h = None
            vals = values.to(dev)
        else:
            vals_h = np.array(values)  # a copy, as jnp.asarray makes one
            vals = torch.from_numpy(vals_h).to(dev)
        check(en.shape == tuple(vals.shape[:1]), "CsrMatrix: entries/values length mismatch")
        obj = cls(torch.from_numpy(rm).to(dev), torch.from_numpy(en).to(dev),
                  vals, int(nrows), int(ncols))
        obj._prefill(row_map=rm, entries=en, values=vals_h)
        return obj

    @classmethod
    def from_graph(cls, graph: StaticCrsGraph, values: torch.Tensor) -> "CsrMatrix":
        """Values on a graph's pattern, sharing its arrays and host mirrors
        (the output of a numeric phase whose symbolic phase made the graph)."""
        check(values.shape == (graph.nnz,) and values.device == graph.row_map.device,
              "CsrMatrix.from_graph: values must be (nnz,) on the graph's device")
        obj = cls(graph.row_map, graph.entries, values, graph.nrows, graph.ncols)
        cache = graph.__dict__.get("_hcache", {})
        obj._prefill(row_map=cache.get("row_map"), entries=cache.get("entries"))
        return obj

    @classmethod
    def from_scipy(cls, sp, value_dtype=None, device=None) -> "CsrMatrix":
        csr = sp.tocsr()
        vals = csr.data if value_dtype is None else csr.data.astype(value_dtype)
        return cls.from_arrays(csr.indptr, csr.indices, vals,
                               nrows=csr.shape[0], ncols=csr.shape[1], device=device)

    @classmethod
    def from_dense(cls, dense, device=None) -> "CsrMatrix":
        dense = dense.cpu().numpy() if isinstance(dense, torch.Tensor) else np.asarray(dense)
        nz = dense != 0
        row_map = np.zeros(dense.shape[0] + 1, dtype=np.int64)
        np.cumsum(nz.sum(axis=1), out=row_map[1:])
        rows, cols = np.nonzero(nz)
        return cls.from_arrays(row_map, cols, dense[rows, cols],
                               nrows=dense.shape[0], ncols=dense.shape[1], device=device)

    # ---- views / exports ---------------------------------------------
    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz(self) -> int:
        return int(self.entries.shape[0])

    @property
    def graph(self) -> StaticCrsGraph:
        g = StaticCrsGraph(self.row_map, self.entries, self.nrows, self.ncols)
        cache = self.__dict__.get("_hcache", {})
        g._prefill(row_map=cache.get("row_map"), entries=cache.get("entries"))
        return g

    def to_scipy(self):
        import scipy.sparse as sps

        # copies: the host mirrors are shared caches and scipy may mutate
        return sps.csr_matrix(
            (self.host_values_full().copy(), self.host_entries().copy(),
             self.host_row_map().copy()), shape=self.shape)

    def to_dense(self) -> torch.Tensor:
        """Dense (nrows, ncols) tensor on the matrix's device, values' dtype."""
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((expand_row_ids(self.row_map, self.nnz), self.entries.long()),
                              self.values, accumulate=True)

    def with_values(self, values) -> "CsrMatrix":
        """Same sparsity, new values (the numeric-phase reuse idiom)."""
        vals_h = None
        if not isinstance(values, torch.Tensor):
            vals_h = np.array(values)
            values = torch.from_numpy(vals_h)
        obj = CsrMatrix(self.row_map, self.entries, values.to(self.device),
                        self.nrows, self.ncols)
        cache = self.__dict__.get("_hcache", {})
        obj._prefill(row_map=cache.get("row_map"), entries=cache.get("entries"),
                     values=vals_h)
        return obj

    def astype(self, dtype) -> "CsrMatrix":
        return self.with_values(self.values.to(torch_dtype(dtype)))

    # ---- replace/sumInto (KokkosSparse_CrsMatrix.hpp:305-319) ----------
    def _find_positions(self, rows, cols, is_sorted: bool) -> np.ndarray:
        """Value-array position of each (row, col), or -1 where absent: a
        binary search over row·(ncols+1)+col keys on the host mirrors (the
        keys sorted first unless the rows are sorted); a row that holds a
        column twice answers with its first."""
        rm, ent = self.host_row_map(), self.host_entries()
        q = np.asarray(rows, np.int64) * (self.ncols + 1) + np.asarray(cols, np.int64)
        if self.nnz == 0:
            return np.full(q.shape, -1, np.int64)
        key = np.repeat(np.arange(self.nrows, dtype=np.int64), np.diff(rm)) * (self.ncols + 1) + ent
        order = np.arange(self.nnz) if is_sorted else np.argsort(key, kind="stable")
        skey = key[order]
        p = np.minimum(np.searchsorted(skey, q), self.nnz - 1)
        return np.where(skey[p] == q, order[p], -1)

    def _update_values(self, rows, cols, vals, is_sorted: bool, add: bool) -> "CsrMatrix":
        pos = self._find_positions(rows, cols, is_sorted)
        vals = torch.as_tensor(np.asarray(vals)).to(self.device, self.dtype).reshape(-1)
        hit = torch.from_numpy(pos >= 0).to(self.device)
        idx = torch.from_numpy(pos[pos >= 0]).to(self.device)
        new = self.values.clone()
        if add:
            new.index_add_(0, idx, vals[hit])
        else:
            new[idx] = vals[hit]
        return self.with_values(new)

    def replace_values(self, rows, cols, vals, is_sorted: bool = True) -> "CsrMatrix":
        """Functional replaceValues: A[row, col] = val for present entries;
        absent coordinates are ignored.  A new matrix on the same device."""
        return self._update_values(rows, cols, vals, is_sorted, add=False)

    def sum_into_values(self, rows, cols, vals, is_sorted: bool = True) -> "CsrMatrix":
        """Functional sumIntoValues: A[row, col] += val for present entries;
        absent coordinates are ignored (CrsMatrix.hpp:305).  A new matrix on
        the same device."""
        return self._update_values(rows, cols, vals, is_sorted, add=True)

    # host mirrors for plan construction
    def host_values(self) -> np.ndarray:
        return self._mirror("values")

    def host_values_full(self) -> np.ndarray:
        """Full-precision host values.  Device f64 is native here, so this is
        ``host_values()``; kept for ``tpukk`` API parity."""
        return self.host_values()

    def row_lengths(self) -> np.ndarray:
        rm = self.host_row_map()
        return rm[1:] - rm[:-1]
