"""PyTorch port's solvers vs the JAX package's, in float64 on the CPU.

Newton, successive approximation and Anderson acceleration through
``wc_ratio_discrete`` reach the JAX fixed point to 1e-10 on log w;
BiCGStab and the chunked-sync
``_iterate`` loop reproduce JAX's iterates and iteration counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.solvers.fixed_point import _iterate as jax_iterate
from sdfs_via_autodiff_tpu.solvers.krylov import (
    bicgstab_mixed as jax_bicgstab)
from sdfs_via_autodiff_tpu_torch.solvers import fixed_point as fp
from sdfs_via_autodiff_tpu_torch.solvers.krylov import SYNC_EVERY

SHAPES = (10, 10, 10, 10)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_newton_matches_jax_fixed_point():
    want = J.wc_ratio_discrete(J.SSY(), SHAPES, tol=1e-12)
    got = P.wc_ratio_discrete(P.SSY(), SHAPES, tol=1e-12, device="cpu")
    # The outer iteration counts may differ (7 vs 9 here): BiCGStab
    # amplifies 1e-15 matvec rounding differences into 1e-5 differences
    # of the inexact inner solution; with the JAX matvec on both sides the
    # inner iterates agree (test_bicgstab_matches_jax).
    assert got.converged and bool(want.converged)
    np.testing.assert_allclose(torch.log(got.w_star).numpy(),
                               np.log(np.asarray(want.w_star)),
                               rtol=0, atol=1e-10)


def test_successive_approx_matches_jax_fixed_point():
    # beta = 0.9 contracts at ~0.9 per step: a few hundred SA iterations.
    want = J.wc_ratio_discrete(J.SSY(beta=0.9), SHAPES, algorithm="sa",
                               tol=1e-12)
    got = P.wc_ratio_discrete(P.SSY(beta=0.9), SHAPES, algorithm="sa",
                              tol=1e-12, device="cpu")
    assert got.converged and bool(want.converged)
    assert got.result.iterations == int(want.result.iterations)
    np.testing.assert_allclose(torch.log(got.w_star).numpy(),
                               np.log(np.asarray(want.w_star)),
                               rtol=0, atol=1e-10)


def test_anderson_matches_jax_fixed_point():
    # Both reach the float64 fixed point; AA trajectories differ at the
    # rounding level, so the iteration counts may differ.
    want = J.wc_ratio_discrete(J.SSY(), SHAPES, tol=1e-12)
    got = P.wc_ratio_discrete(P.SSY(), SHAPES, algorithm="anderson",
                              tol=1e-13, device="cpu")
    assert got.converged and got.result.residual <= 1e-13
    np.testing.assert_allclose(torch.log(got.w_star).numpy(),
                               np.log(np.asarray(want.w_star)),
                               rtol=0, atol=1e-10)


def test_bicgstab_matches_jax():
    rng = np.random.default_rng(3)
    n = 60
    M = rng.standard_normal((n, n))
    A = np.eye(n) - 0.9 * M / np.abs(np.linalg.eigvals(M)).max()
    b = rng.standard_normal(n)
    x_j, it_j = jax_bicgstab(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                             atol=1e-11, maxiter=50)
    At = torch.as_tensor(A)
    x_p, it_p = P.bicgstab_mixed(lambda v: At @ v, torch.as_tensor(b),
                                 atol=1e-11, maxiter=50)
    assert it_p == int(it_j)
    assert it_p % SYNC_EVERY != 0          # stops inside a chunk
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(A @ x_p.numpy(), b, rtol=0, atol=1e-9)


def _both_iterates(step_np, x0, **kw):
    want = jax_iterate(lambda x: step_np(x, jnp), jnp.asarray(x0), 1e-12,
                       10_000, **kw)
    got = fp._iterate(lambda x, running: step_np(x, torch),
                      torch.as_tensor(x0), 1e-12, 10_000, **kw)
    return got, want


def test_chunked_iterate_stall_matches_jax():
    # A two-cycle never improves: the stall guard stops it after
    # stall_iters non-improving steps (13: inside a chunk).
    got, want = _both_iterates(lambda x, xp: -x, np.linspace(1.0, 2.0, 5),
                               stall_iters=13)
    assert got.iterations == int(want.iterations) == 14
    assert got.residual == float(want.residual)
    assert not got.converged and not bool(want.converged)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))


def test_chunked_iterate_nan_step_matches_jax():
    # x <- log(x) from 1e5 reaches a negative iterate after four steps;
    # the fifth is NaN: the loop stops there and keeps the last finite
    # iterate and its error.
    got, want = _both_iterates(lambda x, xp: xp.log(x),
                               np.array([1e5, 2e5, 3e5]))
    assert got.iterations == int(want.iterations) == 5
    assert got.iterations % SYNC_EVERY != 0
    assert np.isfinite(got.residual) and got.residual == float(want.residual)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    assert not got.converged


def test_solver_api():
    T = lambda x: 0.5 * x + 1.0
    x0 = torch.zeros(4, dtype=torch.float64)
    assert P.solve(T, x0, method="sa", tol=1e-12).converged
    np.testing.assert_allclose(P.solver(T, x0, algorithm="newton",
                                        verbose=False).numpy(), 2.0)
    res = P.solve(T, x0, method="anderson", tol=1e-12)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), 2.0, rtol=0, atol=1e-11)
    # method="gd" (L-BFGS) is ported: it converges to the fixed point.
    res = P.solve(T, x0, method="gd", tol=1e-8)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), 2.0, rtol=0, atol=1e-7)
    np.testing.assert_allclose(P.solver(T, x0, algorithm="gd").numpy(), 2.0,
                               rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="unknown method"):
        P.solve(T, x0, method="bfgs")
    with pytest.warns(UserWarning, match="Falling back"):
        np.testing.assert_allclose(P.solver(T, x0, algorithm="bfgs",
                                            verbose=False).numpy(), 2.0)


def _scripted_krylov(monkeypatch, steps):
    """Newton's inner solves return ``steps[k](rhs)`` at their k-th call
    (the last one from then on)."""
    calls = []

    def krylov(matvec, rhs, **kw):
        calls.append(rhs)
        return steps[min(len(calls), len(steps)) - 1](rhs), 1
    monkeypatch.setattr(fp, "bicgstab_mixed", krylov)


def test_newton_safeguard_weighs_the_recent_residuals(monkeypatch):
    """T(x) = x/2 + 1 from 0 (g(x) = 1 - x/2): a first step to 1.9 leaves
    g = 0.05; a candidate at 0.8 (g = 0.6, 12x the current residual but
    under 10x the first's) is taken, not replaced by a plain step; exact
    Newton then ends it.  A step of zero is replaced by a plain one."""
    _scripted_krylov(monkeypatch, [lambda r: torch.full_like(r, -1.9),
                                   lambda r: torch.full_like(r, 1.1),
                                   lambda r: -2.0 * r])
    T = lambda x: 0.5 * x + 1.0
    res = fp.newton_solver(T, torch.zeros(4, dtype=torch.float64),
                           tol=1e-10, trace_len=8)
    steps = res.error_trace[:res.iterations].tolist()
    assert steps[:3] == pytest.approx([1.9, 1.1, 1.2])
    assert res.converged and res.iterations == 4 and steps[3] == 0.0
    torch.testing.assert_close(res.x, torch.full((4,), 2.0,
                                                 dtype=torch.float64))


def test_newton_safeguard_replaces_a_zero_step(monkeypatch):
    """An inner solve that broke down (a zero step) takes the plain step
    T(x): the solve goes on to the fixed point instead of stopping on a
    step of zero far from it."""
    _scripted_krylov(monkeypatch, [torch.zeros_like])
    T = lambda x: 0.5 * x + 1.0
    res = fp.newton_solver(T, torch.zeros(4, dtype=torch.float64),
                           tol=1e-10)
    assert res.converged and res.iterations > 30
    torch.testing.assert_close(res.x, torch.full((4,), 2.0,
                                                 dtype=torch.float64))
