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
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukk_torch.common import TpuKKError
from tpukk_torch.common import probe_cuda as kp

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


@pytest.mark.parametrize("n_ss,B", [(72, 2), (20, 3)])
@pytest.mark.parametrize("variant", ["base", "packed_opt", "mt4"])
def test_plain_matches_pallas_interpret(probes, variant, n_ss, B):
    jp, tp = probes
    plan, x = tp.make_plan(variant, n_ss, B, "cpu")
    assert plan.tiles == (4 if variant == "mt4" else 1)
    n0 = kp.probe_gather_acc.launches
    y = kp.probe_gather_acc(plan, x).numpy()
    assert kp.probe_gather_acc.launches == n0 and y.shape == (512, 128)
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
    np.testing.assert_array_equal(base.step_ids.numpy(), [0, 2, 1, 3])
    np.testing.assert_array_equal(base.step_ptr.numpy(), [0, 2, 4])
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
