"""K9's plain version (``tpukk_torch/common/probe_cuda.py``) against the
gather-table probe's Pallas kernels on the CPU.

``scripts/probe_ss_cost.py`` is loaded by path with ``pl.pallas_call``
shimmed to interpret mode (the script itself is unchanged), and each of its
three kernels (``make_base``, ``make_packed_opt``, ``make_mt4``) runs on the
plan that ``scripts/probe_ss_cost_torch.py`` builds from the probe's own
draws.  With more super-steps than output blocks, every block is written
and then accumulated into.  Tolerance: 1e-5 absolute on values below 0.05
(the same products and sums; XLA may fuse a multiply and an add where the
plain version rounds twice).

K9's chunk lists (``lane_ptr``, ``lane_rec``) are walked here as the kernel
walks them (``_lane_walk``: a lane's y from +0, each record's products added
in order, the step's sum added to y where a record ends its step), and held
to the Pallas kernels within the same tolerance and to the plain version bit
for bit, also on plans with blocks that have no step, mt4 sub-tiles that no
chunk hits, and several first steps a block.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukk_torch.common import TpuKKError, tracing
from tpukk_torch.common import probe_cuda as kp


def _launches(kernel) -> int:
    """The registry's launch counter of a kernel function."""
    return tracing.launch_counts([kernel])[kernel.__name__]


SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probes():
    jp = _load("probe_ss_cost")
    pl = jp.pl

    class _Interpret:
        """``pl`` with every pallas_call in interpret mode."""

        def __getattr__(self, name):
            return getattr(pl, name)

        @staticmethod
        def pallas_call(*args, **kw):
            return pl.pallas_call(*args, interpret=True, **kw)

    jp.pl = _Interpret()
    return jp, _load("probe_ss_cost_torch")


def _lane_walk(plan, x):
    """K9's walk over the plan's chunk lists, in numpy f32 with every product
    and sum rounded on its own: lane L's y (its rows L·8 .. L·8 + 7) starts
    at +0, each record adds v ⊙ xg to the step's sum, and a record that ends
    its step adds that sum to y."""
    xh = x.numpy()
    idx = plan.gt.numpy().reshape(-1, 8, 128)
    lo = None if plan.packed else plan.lo.numpy().reshape(-1, 8, 128)
    v = plan.v.numpy().reshape(-1, 8, 128)
    ptr, rec = plan.lane_ptr.numpy(), plan.lane_rec.numpy()
    y = np.zeros((ptr.shape[0] - 1, 8, 128), np.float32)
    for L in range(ptr.shape[0] - 1):
        acc = np.zeros((8, 128), np.float32)
        for chunk, word in rec[ptr[L]:ptr[L + 1]]:
            own = idx[chunk]
            if plan.packed:
                l = own & 1023
                w = np.take_along_axis(own, l, axis=1)
                gi = 8 * (w >> 16) + ((w >> 13) & 7)
            else:
                l = lo[chunk]
                gi = np.take_along_axis(own, l, axis=1)
            acc = acc + v[chunk] * xh[(word >> 1) * kp.SRC_ROWS + gi, l]
            if word & 1:
                y[L] = y[L] + acc
                acc = np.zeros((8, 128), np.float32)
    return y.reshape(-1, 128)


def _pallas(probes, plan, x, n_ss, B):
    jp, _ = probes
    args = [jnp.asarray(a) for a in (x.numpy(), plan.dst.astype(np.int32), plan.src.numpy(),
                                     plan.first.numpy(), plan.gt.numpy())]
    if plan.variant == "base":
        args.append(jnp.asarray(plan.lo.numpy()))
    make = {"base": jp.make_base, "packed_opt": jp.make_packed_opt,
            "mt4": jp.make_mt4}[plan.variant]
    return np.asarray(make(n_ss, B)(*args, jnp.asarray(plan.v.numpy())))


@pytest.mark.parametrize("n_ss,B", [(72, 2), (20, 3)])
@pytest.mark.parametrize("variant", ["base", "packed_opt", "mt4"])
def test_lane_lists_match_pallas_interpret(probes, variant, n_ss, B):
    """K9's chunk lists on the probe's plans: each lane lists exactly the
    chunks that land in it, and walking them gives the Pallas kernels'
    output (1e-5) and the plain version's bits."""
    _, tp = probes
    plan, x = tp.make_plan(variant, n_ss, B, "cpu")
    rec, ptr = plan.lane_rec.numpy(), plan.lane_ptr.numpy()
    assert ptr.shape == (plan.n_blocks * plan.tiles + 1,) and ptr[-1] == n_ss * B
    assert np.array_equal(np.sort(rec[:, 0]), np.arange(n_ss * B))  # each chunk once
    src = plan.src.numpy()[rec[:, 0]]
    lane = np.repeat(np.arange(ptr.shape[0] - 1), np.diff(ptr))
    sub = src & 3 if variant == "mt4" else 0
    assert np.array_equal(lane, plan.dst[rec[:, 0] // B] * plan.tiles + sub)
    assert np.array_equal(rec[:, 1] >> 1, src >> 2 if variant == "mt4" else src)
    y = _lane_walk(plan, x)
    assert np.array_equal(y, kp.probe_plain(plan, x).numpy())
    ref = _pallas(probes, plan, x, n_ss, B)
    seen = np.repeat(np.isin(np.arange(plan.n_blocks), plan.dst), 8 * plan.tiles)
    assert np.abs(y[seen] - ref[seen]).max() <= 1e-5


@pytest.mark.parametrize("variant", ["base", "packed_opt", "mt4"])
def test_lane_lists_on_uneven_plans(variant):
    """Blocks with no step, mt4 sub-tiles that no chunk hits, blocks with
    several first steps (and non-first steps before them), and B = 1 and 3:
    the walk equals the plain version bit for bit, and no chunk of a step
    that a later first step overwrites is listed."""
    rng = np.random.default_rng(5)
    tiles = kp.VARIANTS[variant]
    for n_ss, B, n_blocks in ((40, 3, 6), (25, 1, 9)):
        dst = rng.integers(0, n_blocks - 2, n_ss)      # the last two blocks get no step
        first = (rng.random(n_ss) < 0.3).astype(np.int32)
        S = n_ss * B
        gt = rng.integers(0, 32, (S * 8, 128), dtype=np.int32)
        lo = rng.integers(0, 128, (S * 8, 128), dtype=np.int32)
        v = rng.standard_normal((S * 8, 128)).astype(np.float32)
        src = rng.integers(0, 5, S)
        kw = dict(n_blocks=n_blocks, n_src=5, device="cpu")
        if variant == "mt4":
            sub = rng.choice([0, 1, 3], S)              # sub-tile 2 is never hit
            plan = kp.build_probe_plan("mt4", dst, (src << 2) | sub, first, v,
                                       pk=(gt << 13) | lo, **kw)
        elif variant == "base":
            plan = kp.build_probe_plan("base", dst, src, first, v, gt=gt, lo=lo, **kw)
        else:
            plan = kp.build_probe_plan("packed_opt", dst, src, first, v, pk=(gt << 13) | lo,
                                       **kw)
        x = torch.from_numpy(rng.standard_normal((5 * 32, 128)).astype(np.float32))
        ptr, rec = plan.lane_ptr.numpy(), plan.lane_rec.numpy()
        counts = np.diff(ptr).reshape(n_blocks, tiles)
        assert (counts[-2:] == 0).all()
        if variant == "mt4":
            assert (counts[:, 2] == 0).all()
        g = rec[:, 0] // B
        last_first = {d: max(np.flatnonzero((dst == d) & (first != 0)), default=-1)
                      for d in range(n_blocks)}
        assert all(gg >= last_first[dst[gg]] for gg in g)
        y = _lane_walk(plan, x)
        assert np.array_equal(y, kp.probe_plain(plan, x).numpy())


@pytest.mark.parametrize("n_ss,B", [(72, 2), (20, 3)])
@pytest.mark.parametrize("variant", ["base", "packed_opt", "mt4"])
def test_plain_matches_pallas_interpret(probes, variant, n_ss, B):
    jp, tp = probes
    plan, x = tp.make_plan(variant, n_ss, B, "cpu")
    assert plan.tiles == (4 if variant == "mt4" else 1)
    n0 = _launches(kp.probe_gather_acc)
    y = kp.probe_gather_acc(plan, x).numpy()
    assert _launches(kp.probe_gather_acc) == n0 and y.shape == (512, 128)
    args = [jnp.asarray(a) for a in (x.numpy(), plan.dst.astype(np.int32), plan.src.numpy(),
                                     plan.first.numpy(), plan.gt.numpy())]
    if variant == "base":
        args.append(jnp.asarray(plan.lo.numpy()))
    make = {"base": jp.make_base, "packed_opt": jp.make_packed_opt, "mt4": jp.make_mt4}[variant]
    ref = np.asarray(make(n_ss, B)(*args, jnp.asarray(plan.v.numpy())))
    # rows of the blocks some step wrote (Pallas leaves the others unwritten)
    rows_per_block = 8 * plan.tiles
    seen = np.zeros(plan.n_blocks, bool)
    seen[plan.dst] = True
    rows = np.repeat(seen, rows_per_block)
    assert rows.sum() == (512 if n_ss > plan.n_blocks else n_ss * rows_per_block)
    assert np.abs(y[rows] - ref[rows]).max() <= 1e-5
    assert np.abs(ref[rows]).max() > 1e-3       # a real signal, not zeros
    assert (y[~rows] == 0).all()


def test_plan_checks_and_packed_decode():
    rng = np.random.default_rng(1)
    n_ss, B = 4, 2
    shape = (8 * B * n_ss, 128)
    gt = rng.integers(0, 32, shape, dtype=np.int32)
    lo = rng.integers(0, 128, shape, dtype=np.int32)
    v = rng.standard_normal(shape).astype(np.float32)
    dst, first, src = np.arange(n_ss) % 2, np.arange(n_ss) < 2, rng.integers(0, 3, n_ss * B)
    kw = dict(n_blocks=2, n_src=3, device="cpu")
    base = kp.build_probe_plan("base", dst, src, first, v, gt=gt, lo=lo, **kw)
    packed = kp.build_probe_plan("packed_opt", dst, src, first, v, pk=(gt << 13) | lo, **kw)
    x = torch.from_numpy(rng.standard_normal((96, 128)).astype(np.float32))
    assert torch.equal(kp.probe_plain(base, x), kp.probe_plain(packed, x))
    assert base.stream_bytes() == 3 * 4 * v.size and packed.stream_bytes() == 2 * 4 * v.size
    # block 0 takes steps 0 and 2 (chunks 0, 1, 4, 5), block 1 steps 1 and 3
    np.testing.assert_array_equal(base.lane_ptr.numpy(), [0, 4, 8])
    np.testing.assert_array_equal(base.lane_rec.numpy()[:, 0], [0, 1, 4, 5, 2, 3, 6, 7])
    np.testing.assert_array_equal(base.lane_rec.numpy()[:, 1] & 1, [0, 1] * 4)
    np.testing.assert_array_equal(base.lane_rec.numpy()[:, 1] >> 1,
                                  src[[0, 1, 4, 5, 2, 3, 6, 7]])
    with pytest.raises(TpuKKError, match="gt must lie"):
        kp.build_probe_plan("base", dst, src, first, v, gt=gt + 32, lo=lo, **kw)
    with pytest.raises(TpuKKError, match="src outside"):
        kp.build_probe_plan("base", dst, src + 3, first, v, gt=gt, lo=lo, **kw)
    with pytest.raises(TpuKKError, match="takes pk"):
        kp.build_probe_plan("mt4", dst, src, first, v, gt=gt, lo=lo, **kw)
    with pytest.raises(TpuKKError, match="x must be"):
        kp.probe_gather_acc(base, x[:64])
    with pytest.raises(TpuKKError, match="dtype"):
        kp.probe_gather_acc(base, x.double())
