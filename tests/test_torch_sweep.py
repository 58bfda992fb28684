"""Calibration sweeps: the port's ``drivers.wc_ratio_sweep`` against the
JAX package's, on the CPU in float64, mirroring JAX's
``tests/test_continuous_ssy.py:203-238``.

The port solves the members one after another where JAX vmaps them
under one compile; each member runs the same algorithm from the same
start on its own grids and operator, so member by member the two agree
to 1e-10 on log w* (Newton at tol 1e-9: each stops on a step below tol
after quadratic convergence; SA at tol 1e-8 stops on the same step
rule with the same rounding up to the last iterate, 1e-9).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P

SIZES = (6, 6, 6, 8)
GCY_SIZES = (3, 3, 3, 3, 4, 3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _members(fam, changes):
    return [dataclasses.replace(fam(), **c) for c in changes]


SSY_CHANGES = [{}, {"gamma": 7.5}, {"psi": 1.5}]


def test_ssy_sweep_matches_jax_and_individual_solves():
    w, res, grids = P.wc_ratio_sweep(_members(P.SSY, SSY_CHANGES), SIZES,
                                     quad_degree=3, tol=1e-9, device="cpu")
    wj, rj, gj = J.wc_ratio_sweep(_members(J.SSY, SSY_CHANGES), SIZES,
                                  quad_degree=3, tol=1e-9)
    assert tuple(w.shape) == (3,) + SIZES
    assert res.x.shape == w.shape and res.iterations.shape == (3,)
    assert res.residual.shape == (3,) and res.converged.shape == (3,)
    assert bool(res.converged.all()) and bool(jnp.all(rj.converged))
    np.testing.assert_allclose(torch.log(w).numpy(), np.log(np.asarray(wj)),
                               rtol=0, atol=1e-10)
    for d, (g, want) in enumerate(zip(grids, gj)):
        assert tuple(g.shape) == (3, SIZES[d])
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0,
                                   atol=4 * np.spacing(np.abs(want).max()))
    for i, m in enumerate(_members(P.SSY, SSY_CHANGES)):
        sol = P.wc_ratio_continuous(m, SIZES, quad_degree=3, tol=1e-9,
                                    interp="pre", space="log", device="cpu")
        assert float((w[i] - sol.w_star).abs().max()) < 1e-6
    assert "converged=[True, True, True]" in repr(res)


def test_gcy_sweep_matches_jax():
    changes = [{}, {"gamma": 12.0}]
    w, res, _ = P.wc_ratio_sweep(_members(P.GCY, changes), GCY_SIZES,
                                 quad_degree=3, tol=1e-8,
                                 algorithm="successive_approx",
                                 max_iter=20000, device="cpu")
    wj, rj, _ = J.wc_ratio_sweep(_members(J.GCY, changes), GCY_SIZES,
                                 quad_degree=3, tol=1e-8,
                                 algorithm="successive_approx",
                                 max_iter=20000)
    assert bool(res.converged.all())
    assert res.iterations.tolist() == np.asarray(rj.iterations).tolist()
    np.testing.assert_allclose(torch.log(w).numpy(), np.log(np.asarray(wj)),
                               rtol=0, atol=1e-9)
    sol = P.wc_ratio_continuous(P.GCY(), GCY_SIZES, quad_degree=3, tol=1e-8,
                                interp="pre", space="log", device="cpu")
    # SA at tol 1e-8 on the log iterate: the fixed-point amplification
    # 1/(1-rate) and w ~ 40 put the w agreement at ~1e-5 (JAX's test).
    assert float((w[0] - sol.w_star).abs().max()) < 5e-5


@pytest.mark.parametrize("kind", ["shared", "per_member"])
def test_sweep_w_init(kind):
    members = _members(P.SSY, [{}, {"gamma": 7.5}])
    shape = (3, 3, 3, 4)
    w0 = torch.full(shape, 500.0, dtype=torch.float64)
    if kind == "per_member":
        w0 = torch.stack([w0, 1.2 * w0])
    w, res, _ = P.wc_ratio_sweep(members, shape, quad_degree=3, tol=1e-9,
                                 w_init=w0, space="w", device="cpu")
    wj, rj, _ = J.wc_ratio_sweep(_members(J.SSY, [{}, {"gamma": 7.5}]),
                                 shape, quad_degree=3, tol=1e-9,
                                 w_init=jnp.asarray(w0.numpy()), space="w")
    assert bool(res.converged.all())
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-10)


def test_sweep_argument_checks():
    with pytest.raises(ValueError, match="empty sweep"):
        P.wc_ratio_sweep([], (4, 4, 4, 4), device="cpu")
    with pytest.raises(ValueError, match="one model family"):
        P.wc_ratio_sweep([P.SSY(), P.GCY()], (4, 4, 4, 4), device="cpu")
    with pytest.raises(ValueError, match="unknown space"):
        P.wc_ratio_sweep([P.SSY()], (4, 4, 4, 4), space="ell", device="cpu")
    with pytest.raises(ValueError, match="4 entries"):
        P.wc_ratio_sweep([P.SSY()], (4, 4, 4), device="cpu")
    with pytest.raises(ValueError, match="6 entries"):
        P.wc_ratio_sweep([P.GCY()], (4, 4, 4, 4), device="cpu")
    with pytest.raises(ValueError, match="matches neither"):
        P.wc_ratio_sweep([P.SSY(), P.SSY()], (3, 3, 3, 4),
                         w_init=torch.ones(3, 3, 3, 4, 3), device="cpu")
