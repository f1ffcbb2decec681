"""tpukk_torch.ode against tpukk.ode on the CPU (mirrors tests/test_ode.py
test by test).

Each test runs tpukk's solver and the port's on the same problem (the
right-hand sides written once in jax.numpy and once in torch) and holds the
port to tpukk: the same status, step counts (``num_steps``, the adaptive
BDF's accepted steps) and Newton iterations, y within 1e-9 of max|y| in f64;
and to the analytic or scipy oracle of tests/test_ode.py.  The batched forms
(``rk_solve_batched``, ``bdf_solve_adaptive_batched``) are held to
``jax.vmap`` of tpukk's function, system by system, and to the port's
single-system solver.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukk.ode as jo
import tpukk_torch.ode as to
from tpukk_torch.ode import RKType

CPU = "cpu"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_y(got, ref, rel=1e-9):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-300)


def T(a):
    return torch.tensor(a, dtype=torch.float64)


# right-hand sides in both languages
def exp_decay_j(t, y):
    return -y


def exp_decay_t(t, y):
    return -y


def harmonic_j(t, y):
    return jnp.stack([y[1], -y[0]])


def harmonic_t(t, y):
    return torch.stack([y[1], -y[0]])


def stiff_j(t, y):
    return -50.0 * (y - jnp.cos(t))


def stiff_t(t, y):
    return -50.0 * (y - torch.cos(t))


def rob_j(t, y):
    return jnp.array([-0.04 * y[0] + 1e4 * y[1] * y[2],
                      0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                      3e7 * y[1] ** 2])


def rob_t(t, y):
    return torch.stack([-0.04 * y[0] + 1e4 * y[1] * y[2],
                        0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                        3e7 * y[1] ** 2])


ALL_RK = list(jo.RKType)


def test_tableaus_are_tpukks():
    import dataclasses

    for kind in ALL_RK:
        assert (dataclasses.astuple(to.tableau(RKType[kind.name]))
                == dataclasses.astuple(jo.tableau(kind)))


@pytest.mark.parametrize("kind", ALL_RK, ids=[k.name for k in ALL_RK])
def test_rk_exp_decay(kind):
    res = to.rk_solve(exp_decay_t, T([1.0]), 0.0, 1.0, kind=RKType[kind.name], num_steps=200)
    ref = jo.rk_solve(exp_decay_j, jnp.array([1.0]), 0.0, 1.0, kind=kind, num_steps=200)
    _same_y(res.y, ref.y)
    assert int(res.num_steps) == int(ref.num_steps) == 200
    tol = 1e-2 if kind in (jo.RKType.RKFE, jo.RKType.RKEH, jo.RKType.RKF12) else 1e-6
    assert abs(float(res.y[0]) - np.exp(-1.0)) < tol


@pytest.mark.parametrize("kind", ["RKBS", "RKF45", "RKCK", "RKDP", "VER56"])
def test_rk_adaptive_harmonic(kind):
    res = to.rk_solve(harmonic_t, T([1.0, 0.0]), 0.0, 2 * np.pi, kind=RKType[kind],
                      rel_tol=1e-8, abs_tol=1e-10)
    ref = jo.rk_solve(harmonic_j, jnp.array([1.0, 0.0]), 0.0, 2 * np.pi, kind=jo.RKType[kind],
                      rel_tol=1e-8, abs_tol=1e-10)
    assert int(res.status) == int(ref.status) == 0
    assert int(res.num_steps) == int(ref.num_steps)
    _same_y(res.y, ref.y)
    np.testing.assert_allclose(_np(res.y), [1.0, 0.0], atol=1e-5)


def test_rk_counts_adaptive_fewer_steps_when_loose():
    counts = []
    for rtol, atol in ((1e-10, 1e-12), (1e-3, 1e-5)):
        r = to.rk_solve(exp_decay_t, T([1.0]), 0.0, 1.0, kind=RKType.RKDP, rel_tol=rtol,
                        abs_tol=atol)
        j = jo.rk_solve(exp_decay_j, jnp.array([1.0]), 0.0, 1.0, kind=jo.RKType.RKDP,
                        rel_tol=rtol, abs_tol=atol)
        assert int(r.num_steps) == int(j.num_steps)
        counts.append(int(r.num_steps))
    assert counts[1] <= counts[0]
    # the step cap: MAX_STEPS, as tpukk reports it
    r = to.rk_solve(exp_decay_t, T([1.0]), 0.0, 1.0, rel_tol=1e-12, abs_tol=1e-14, max_steps=5)
    j = jo.rk_solve(exp_decay_j, jnp.array([1.0]), 0.0, 1.0, rel_tol=1e-12, abs_tol=1e-14,
                    max_steps=5)
    assert int(r.status) == int(j.status) == to.ODESolverStatus.MAX_STEPS.value
    assert int(r.num_steps) == int(j.num_steps) == 5


def test_rk_vmapped_batch():
    y0s = np.linspace(0.5, 2.0, 8)[:, None]
    ys = to.rk_solve_batched(exp_decay_t, torch.from_numpy(y0s), 0.0, 1.0, kind=RKType.RK4,
                             num_steps=100).y
    ref = jax.vmap(lambda y0: jo.rk_solve(exp_decay_j, y0, 0.0, 1.0, kind=jo.RKType.RK4,
                                          num_steps=100).y)(jnp.asarray(y0s))
    _same_y(ys, ref)
    np.testing.assert_allclose(_np(ys)[:, 0], y0s[:, 0] * np.exp(-1.0), rtol=1e-6)


def test_rk_batched_adaptive_equals_vmap_and_single():
    """Adaptive RKDP on decays with their own rates: each system takes
    exactly tpukk's steps under jax.vmap, and the port's own single-system
    steps."""
    rates = np.linspace(1.0, 900.0, 6)
    y0 = np.ones((6, 1))
    res = to.rk_solve_batched(lambda t, y, k: -k * y, torch.from_numpy(y0), 0.0, 1.0,
                              args=(torch.from_numpy(rates),))
    ref = jax.vmap(lambda y, k: jo.rk_solve(lambda t, v, kk: -kk * v, y, 0.0, 1.0,
                                            args=(k,)))(jnp.asarray(y0), jnp.asarray(rates))
    np.testing.assert_array_equal(_np(res.num_steps), np.asarray(ref.num_steps))
    np.testing.assert_array_equal(_np(res.status), np.asarray(ref.status))
    _same_y(res.y, ref.y)
    for i, k in enumerate(rates):
        one = to.rk_solve(lambda t, y: -k * y, T([1.0]), 0.0, 1.0)
        assert int(one.num_steps) == int(res.num_steps[i])
        assert torch.equal(one.y, res.y[i])
    assert np.abs(_np(res.y)[:, 0] - np.exp(-rates)).max() < 1e-6


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6])
def test_bdf_exp_decay(order):
    res = to.bdf_solve(exp_decay_t, T([1.0]), 0.0, 1.0, num_steps=200, order=order)
    ref = jo.bdf_solve(exp_decay_j, jnp.array([1.0]), 0.0, 1.0, num_steps=200, order=order)
    assert bool(res.converged) and bool(ref.converged)
    _same_y(res.y, ref.y)
    tol = 5e-3 if order == 1 else 1e-4
    assert abs(float(res.y[0]) - np.exp(-1.0)) < tol


def test_bdf_stiff():
    res = to.bdf_solve(stiff_t, T([0.0]), 0.0, 2.0, num_steps=100, order=2)
    ref = jo.bdf_solve(stiff_j, jnp.array([0.0]), 0.0, 2.0, num_steps=100, order=2)
    assert bool(res.converged) and bool(ref.converged)
    _same_y(res.y, ref.y)
    assert abs(float(res.y[0]) - np.cos(2.0)) < 0.05


def test_newton_scalar_system():
    res = to.newton_solve(lambda x: torch.stack([x[0] ** 2 + x[1] ** 2 - 4.0, x[0] - x[1]]),
                          T([1.0, 0.5]))
    ref = jo.newton_solve(lambda x: jnp.stack([x[0] ** 2 + x[1] ** 2 - 4.0, x[0] - x[1]]),
                          jnp.array([1.0, 0.5]))
    assert bool(res.converged) and bool(ref.converged)
    assert int(res.num_iters) == int(ref.num_iters)
    _same_y(res.x, ref.x)
    np.testing.assert_allclose(_np(res.x), [np.sqrt(2), np.sqrt(2)], rtol=1e-8)


def test_newton_with_explicit_jacobian():
    res = to.newton_solve(lambda x, a: torch.stack([x[0] ** 3 - a]), T([1.0]),
                          jac=lambda x, a: torch.stack([torch.stack([3 * x[0] ** 2])]),
                          args=(8.0,))
    ref = jo.newton_solve(lambda x, a: jnp.array([x[0] ** 3 - a]), jnp.array([1.0]),
                          jac=lambda x, a: jnp.array([[3 * x[0] ** 2]]), args=(8.0,))
    assert bool(res.converged) and int(res.num_iters) == int(ref.num_iters)
    np.testing.assert_allclose(float(res.x[0]), 2.0, rtol=1e-10)
    _same_y(res.x, ref.x)


class TestBDFAdaptive:
    """Adaptive order and step BDF against tpukk's (status, accepted steps,
    y) and scipy's BDF."""

    def test_exp_decay(self):
        r = to.bdf_solve_adaptive(lambda t, y: -y, T([1.0]), 0.0, 2.0, rtol=1e-8, atol=1e-10)
        j = jo.bdf_solve_adaptive(lambda t, y: -y, jnp.array([1.0]), 0.0, 2.0, rtol=1e-8,
                                  atol=1e-10)
        assert int(r.status) == int(j.status) == 0
        assert int(r.num_steps) == int(j.num_steps) < 200
        _same_y(r.y, j.y)
        assert abs(float(r.y[0]) - np.exp(-2.0)) < 1e-6

    def test_stiff_linear(self):
        from scipy.integrate import solve_ivp

        r = to.bdf_solve_adaptive(lambda t, y: -1000.0 * (y - torch.cos(t)), T([0.0]), 0.0, 1.0,
                                  rtol=1e-7, atol=1e-10)
        j = jo.bdf_solve_adaptive(lambda t, y: -1000.0 * (y - jnp.cos(t)), jnp.array([0.0]),
                                  0.0, 1.0, rtol=1e-7, atol=1e-10)
        ref = solve_ivp(lambda t, y: -1000 * (y - np.cos(t)), (0, 1), [0.0], method="BDF",
                        rtol=1e-10, atol=1e-12)
        assert int(r.status) == int(j.status) == 0
        assert int(r.num_steps) == int(j.num_steps)
        _same_y(r.y, j.y)
        assert abs(float(r.y[0]) - ref.y[0, -1]) < 1e-6

    def test_robertson(self):
        from scipy.integrate import solve_ivp

        r = to.bdf_solve_adaptive(rob_t, T([1.0, 0.0, 0.0]), 0.0, 100.0, rtol=1e-7, atol=1e-10,
                                  max_steps=20000)
        j = jo.bdf_solve_adaptive(rob_j, jnp.array([1.0, 0.0, 0.0]), 0.0, 100.0, rtol=1e-7,
                                  atol=1e-10, max_steps=20000)
        ref = solve_ivp(
            lambda t, y: [-0.04 * y[0] + 1e4 * y[1] * y[2],
                          0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                          3e7 * y[1] ** 2],
            (0, 100), [1.0, 0, 0], method="BDF", rtol=1e-10, atol=1e-13)
        assert int(r.status) == int(j.status) == 0
        assert int(r.num_steps) == int(j.num_steps)
        _same_y(r.y, j.y, 1e-7)
        np.testing.assert_allclose(_np(r.y), ref.y[:, -1], rtol=1e-4, atol=1e-9)

    def test_vmap_batched(self):
        from scipy.integrate import solve_ivp

        rates = np.linspace(1.0, 900.0, 8)
        r = to.bdf_solve_adaptive_batched(lambda t, y, k: -k * (y - torch.cos(t)),
                                          torch.zeros((8, 1), dtype=torch.float64), 0.0, 1.0,
                                          rtol=1e-6, atol=1e-9, args=(torch.from_numpy(rates),))

        def solve_one(rate):
            return jo.bdf_solve_adaptive(lambda t, y: -rate * (y - jnp.cos(t)),
                                         jnp.array([0.0]), 0.0, 1.0, rtol=1e-6, atol=1e-9)

        j = jax.vmap(solve_one)(jnp.asarray(rates))
        np.testing.assert_array_equal(_np(r.status), np.asarray(j.status))
        np.testing.assert_array_equal(_np(r.num_steps), np.asarray(j.num_steps))
        _same_y(r.y, j.y)
        assert int(_np(r.status).max()) == 0
        for i, k in enumerate(rates):
            ref = solve_ivp(lambda t, y: -k * (y - np.cos(t)), (0, 1), [0.0], method="BDF",
                            rtol=1e-9, atol=1e-12)
            assert abs(float(r.y[i, 0]) - ref.y[0, -1]) < 1e-4
            one = to.bdf_solve_adaptive(lambda t, y: -k * (y - torch.cos(t)), T([0.0]), 0.0, 1.0,
                                        rtol=1e-6, atol=1e-9)
            assert int(one.num_steps) == int(r.num_steps[i])
            _same_y(one.y, r.y[i], 1e-12)


def test_ode_exports_match_tpukk():
    """tpukk_torch.ode exports every public name of tpukk.ode."""
    names = {n for n in dir(jo) if not n.startswith("_")}
    assert not {n for n in names if not hasattr(to, n)}


# ---- Python numbers and lists enter as f64, and any state shape ------------

def test_newton_python_list_is_f64():
    """A Python list x0 is f64, as jnp.asarray makes it under x64: Newton on
    x² − 2 from [1.0] converges in tpukk's 4 iterations."""
    ref = jo.newton_solve(lambda x: x * x - 2.0, [1.0])
    got = to.newton_solve(lambda x: x * x - 2.0, [1.0], device=CPU)
    assert got.x.dtype == torch.float64
    assert bool(got.converged) and bool(ref.converged)
    assert int(got.num_iters) == int(ref.num_iters) == 4
    _same_y(got.x, ref.x, 1e-15)


def test_rk_python_list_is_f64():
    """rk_solve of y' = −2y from [1.0, 2.0] takes tpukk's 11 f64 steps."""
    ref = jo.rk_solve(lambda t, y: -2.0 * y, [1.0, 2.0], 0.0, 1.0)
    got = to.rk_solve(lambda t, y: -2.0 * y, [1.0, 2.0], 0.0, 1.0, device=CPU)
    assert got.y.dtype == torch.float64
    assert int(got.num_steps) == int(ref.num_steps) == 11
    _same_y(got.y, ref.y)


@pytest.mark.parametrize("case", ["0-d", "2-D", "complex"])
def test_rk_adaptive_any_state(case):
    """Adaptive rk_solve on a 0-d, a 2-D and a complex y0: tpukk's shape,
    dtype, status and step count, y within 1e-9 of max|y|."""
    if case == "0-d":
        y0, fj, ft = 1.5, (lambda t, y: -2.0 * y), (lambda t, y: -2.0 * y)
    elif case == "2-D":
        y0 = np.arange(1.0, 7.0).reshape(2, 3)
        fj = lambda t, y: -jnp.sin(y) * (1.0 + t)
        ft = lambda t, y: -torch.sin(y) * (1.0 + t)
    else:
        y0 = np.array([1.0 + 0.5j, 2.0 - 1.0j])
        fj, ft = (lambda t, y: -2j * y), (lambda t, y: -2j * y)
    ref = jo.rk_solve(fj, y0, 0.0, 1.0)
    got = to.rk_solve(ft, y0, 0.0, 1.0, device=CPU)
    assert tuple(got.y.shape) == tuple(np.shape(ref.y))
    assert str(got.y.dtype).replace("torch.", "") == str(np.asarray(ref.y).dtype)
    assert int(got.status) == int(ref.status) == 0
    assert int(got.num_steps) == int(ref.num_steps)
    _same_y(got.y, ref.y)
