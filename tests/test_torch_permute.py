"""K5's wrapper (tpukk_torch.common.permute.permute_gather) on the CPU against
tpukk on the same seeded numpy permutations, its checks, and the function
that picks its vector width and lanes a row (permute_geometry).  Mirrors
tests/test_common.py's test_static_permute_interpret (tpukk's routed
permutation, its Pallas row-permute kernels in interpret mode, f32 vectors)
and test_static_permute_fallback_sort (tpukk.common.utils.permute_via_sort,
here at k = 1, 3 and 8 in f32 and f64).

Tolerance: exact (a gather copies values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukk.common.permute as jperm
from tpukk.common.utils import inverse_permutation, permute_via_sort
from tpukk_torch import _kernels
from tpukk_torch.common import TpuKKError
from tpukk_torch.common import permute as tperm
from tpukk_torch.common import tracing


def _launches(kernel) -> int:
    """The registry's launch counter of a kernel function."""
    return tracing.launch_counts([kernel])[kernel.__name__]


FILL = tperm.FILL_THREADS


def _src(n, seed):
    return np.random.default_rng(seed).permutation(n)


@pytest.mark.parametrize("n", [5000, 131_072 + 777], ids=["5000", "131849"])
def test_matches_tpukk_routed_permute_interpret(n):
    src = _src(n, 4)
    x = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    plan = jperm.build_permute_plan(src, _force=True)
    # without tpukk's native router there is no plan: its sort fallback then
    ref = (np.asarray(jperm.static_permute(plan, x, interpret=True)) if plan is not None else
           np.asarray(permute_via_sort(jnp.asarray(x), jnp.asarray(inverse_permutation(src)))))
    got = tperm.permute_gather(torch.from_numpy(src.astype(np.int32)), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    tplan = tperm.build_permute_plan(src, "cpu")
    np.testing.assert_array_equal(tperm.static_permute(tplan, torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_matches_tpukk_permute_via_sort(k, dtype):
    n = 2_001
    src = _src(n, 6 + k)
    x = np.random.default_rng(7).standard_normal((n, k) if k > 1 else n).astype(dtype)
    ref = np.asarray(permute_via_sort(jnp.asarray(x), jnp.asarray(inverse_permutation(src))))
    got = tperm.permute_gather(torch.from_numpy(src.astype(np.int32)), torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_views_and_the_empty_case():
    src = torch.from_numpy(_src(300, 8).astype(np.int32))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((301, 3)))
    # src one entry past a 16-byte boundary, x one value past it
    s1 = torch.cat([src[:1], src])[1:]
    x1 = torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].view(301, 3)
    np.testing.assert_array_equal(tperm.permute_gather(s1, x1[:300]).numpy(),
                                  x1.numpy()[src.numpy()])
    assert tperm.permute_gather(src[:0], x).shape == (0, 3)
    assert tperm.permute_gather(src[:0], x[:, 0].contiguous()).shape == (0,)


def test_wrapper_checks(monkeypatch):
    src = torch.arange(4, dtype=torch.int32)
    x = torch.zeros(4)
    with pytest.raises(TpuKKError, match="rank 1 or 2"):
        tperm.permute_gather(src, torch.zeros(4, 2, 2))
    with pytest.raises(TpuKKError, match="int32"):
        tperm.permute_gather(src.long(), x)
    with pytest.raises(TpuKKError, match="int32"):
        tperm.permute_gather(src.reshape(2, 2), x)
    with pytest.raises(TpuKKError, match="src on meta"):
        tperm.permute_gather(src.to("meta"), x)
    with pytest.raises(TpuKKError, match="unsupported device"):
        tperm.permute_gather(src.to("meta"), x.to("meta"))
    # the checks of the kernel's path, reached as a CUDA tensor reaches them
    # (each raises before anything is built or launched)
    monkeypatch.setattr(_kernels, "on_cuda", lambda t, name: True)
    monkeypatch.setattr(_kernels, "library", lambda name: pytest.fail("launched"))
    with pytest.raises(TpuKKError, match="not f32/f64"):
        tperm.permute_gather(src, x.to(torch.bfloat16))
    with pytest.raises(TpuKKError, match="contiguous"):
        tperm.permute_gather(src, torch.zeros(4, 2).t().contiguous().t())
    with pytest.raises(TpuKKError, match="contiguous"):
        tperm.permute_gather(torch.arange(8, dtype=torch.int32)[::2], x)
    n0 = _launches(tperm.permute_gather)
    assert tperm.permute_gather(src[:0], x).shape == (0,)
    assert tperm.permute_gather(src, torch.zeros(4, 0)).shape == (4, 0)
    assert _launches(tperm.permute_gather) == n0


M = 1_000_000  # enough rows that 16 bytes a thread still fill the card
GEOMETRY = [  # (n, k, itemsize, src, x, out offsets) -> (vec, lanes)
    ((M, 1, 4, 0, 0, 0), (4, 1)),    # 16 B of out and of src a thread
    ((M, 1, 8, 0, 0, 0), (2, 1)),
    ((M, 1, 4, 8, 0, 0), (2, 1)),    # src on an 8-byte boundary
    ((M, 1, 4, 4, 0, 0), (1, 1)),    # src off 8 bytes: one value a thread
    ((M, 1, 8, 4, 0, 0), (1, 1)),
    ((M, 1, 4, 0, 0, 8), (2, 1)),    # out on an 8-byte boundary
    ((M, 1, 8, 0, 0, 8), (1, 1)),
    ((M, 1, 4, 0, 4, 0), (4, 1)),    # x's alignment does not matter at k = 1
    ((300_000, 1, 4, 0, 0, 0), (2, 1)),  # 75,000 threads of 4 would not fill half the card
    ((2 * FILL, 1, 8, 0, 0, 0), (2, 1)),  # the edge: FILL threads of 2
    ((2 * FILL - 1, 1, 8, 0, 0, 0), (1, 1)),
    ((173_001, 1, 8, 0, 0, 0), (1, 1)),  # the ILU(1) refresh's invL on fem2d_30k
    ((30_000, 1, 4, 0, 0, 0), (1, 1)),   # the paths' 30,000-row permutations
    ((1, 1, 4, 0, 0, 0), (1, 1)),
    ((30, 2, 4, 0, 0, 0), (2, 1)),    # a row is one 8-byte chunk (n does not matter at k > 1)
    ((30, 2, 8, 0, 0, 0), (2, 1)),    # one 16-byte chunk
    ((30, 3, 4, 0, 0, 0), (1, 4)),    # odd k: one value a chunk, lanes cover 3
    ((30, 3, 8, 0, 0, 0), (1, 4)),
    ((30, 6, 4, 0, 0, 0), (2, 4)),    # 6 % 4 != 0: 8-byte chunks
    ((M, 8, 4, 0, 0, 0), (4, 2)),
    ((M, 8, 8, 0, 0, 0), (2, 4)),
    ((M, 8, 4, 0, 8, 0), (2, 4)),     # x's rows off 16 bytes
    ((M, 8, 4, 0, 0, 4), (1, 8)),     # out off 8 bytes
    ((M, 8, 4, 12, 0, 0), (4, 2)),    # src's alignment does not matter at k > 1
    ((30, 16, 4, 0, 0, 0), (4, 4)),
    ((30, 16, 8, 0, 0, 0), (2, 8)),
    ((30, 64, 8, 0, 0, 0), (2, 32)),
    ((30, 100, 4, 0, 0, 0), (4, 32)),  # 25 chunks: 32 lanes, some idle
    ((30, 200, 4, 0, 0, 0), (4, 32)),  # 50 chunks: a lane takes two
]


@pytest.mark.parametrize("args,want", GEOMETRY, ids=[str(a) for a, _ in GEOMETRY])
def test_permute_geometry(args, want):
    vec, lanes = tperm.permute_geometry(*args)
    assert (vec, lanes) == want
    n, k, itemsize, so, xo, oo = args
    assert vec * itemsize <= 16
    if k == 1:
        assert so % (4 * vec) == 0 and oo % (vec * itemsize) == 0
        assert vec == 1 or n >= vec * FILL
    else:
        assert k % vec == 0 and (xo | oo) % (vec * itemsize) == 0
        assert lanes in (1, 2, 4, 8, 16, 32)


def test_permute_geometry_refuses():
    with pytest.raises(TpuKKError):
        tperm.permute_geometry(10, 0, 4)
    with pytest.raises(TpuKKError):
        tperm.permute_geometry(10, 4, 2)


@pytest.mark.parametrize("k", [1, 4])
def test_static_permute_without_plan_sorts_by_keys(k):
    """static_permute(None, x, keys) falls back to permute_via_sort, as in
    tpukk: the same values in tpukk's order, exactly."""
    rng = np.random.default_rng(61)
    src = _src(777, 62)
    x = rng.standard_normal((777, k) if k > 1 else 777)
    keys = inverse_permutation(src).astype(np.int32)
    ref = np.asarray(jperm.static_permute(None, jnp.asarray(x), jnp.asarray(keys)))
    got = tperm.static_permute(None, torch.from_numpy(x), torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), x[src])
