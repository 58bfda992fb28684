"""Pricing and calibration in the port vs the JAX package, in float64
on the CPU.

``expected_sdf``/``risk_free_rate`` agree with JAX's on the same w*
grid values to rtol 1e-10; ``one_step_moments_differentiable`` on the
same numpy draws agrees to 1e-10 in value and rtol 1e-6 in gradient;
``calibrate_moments`` recovers SSY's beta from 0.9985 within 5e-6
(JAX's ``test_recovers_perturbed_beta``); a risk-free-rate gradient
through the implicit solve matches JAX's and central differences.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.ops.interp import lin_interp as jax_interp
from sdfs_via_autodiff_tpu_torch.operators.continuous_common import mc_draws
from sdfs_via_autodiff_tpu_torch.ops.interp import lin_interp

SIZES = (4, 4, 4, 5)
VALUE_RTOL = 1e-10
GRAD_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(family, seed=0):
    """(port model, JAX model, grids as numpy, positive w values)."""
    rng = np.random.default_rng(seed)
    if family == "ssy":
        pm, jm, sizes = P.SSY(), J.SSY(), SIZES
        grids = P.build_grid_ssy(pm, *sizes)
    else:
        pm, jm, sizes = P.GCY(), J.GCY(), (3, 3, 3, 3, 4, 3)
        grids = P.build_grid_gcy(pm, *sizes)
    grids = tuple(g.numpy() for g in grids)
    return pm, jm, grids, 600.0 + 50.0 * rng.uniform(size=sizes)


def _jax_wstar(w, grids):
    wj, gj = jnp.asarray(w), tuple(jnp.asarray(g) for g in grids)
    dim = len(grids)
    return lambda x: jax_interp(x.reshape(dim, -1), wj, gj).reshape(
        x.shape[1:] if x.ndim > 1 else ())


@pytest.mark.parametrize("family", ["ssy", "gcy"])
def test_pricing_matches_jax_on_the_same_field(family):
    pm, jm, grids, w = _field(family)
    fp = P.construct_wstar_callable(w, grids, device="cpu")
    fj = _jax_wstar(w, grids)
    degree = 3
    rng = np.random.default_rng(1)
    points = [np.zeros(len(grids))] + [
        np.array([g[0] + (g[-1] - g[0]) * u for g, u in
                  zip(grids, rng.uniform(0.1, 0.9, len(grids)))])
        for _ in range(3)]
    for port_fn, jax_fn in ((P.expected_sdf, J.sdf.expected_sdf),
                            (P.risk_free_rate, J.sdf.risk_free_rate)):
        fn_p = port_fn(pm, fp, degree, device="cpu")
        fn_j = jax_fn(jm, fj, degree)
        for x in points:
            np.testing.assert_allclose(float(fn_p(torch.as_tensor(x))),
                                       float(fn_j(jnp.asarray(x))),
                                       rtol=VALUE_RTOL)
    alias = P.risk_free_rate_ssy if family == "ssy" else P.risk_free_rate_gcy
    jalias = J.risk_free_rate_ssy if family == "ssy" else J.risk_free_rate_gcy
    np.testing.assert_allclose(
        float(alias(pm, fp, device="cpu")(torch.zeros(len(grids),
                                                       dtype=torch.float64))),
        float(jalias(jm, fj)(jnp.zeros(len(grids)))), rtol=VALUE_RTOL)


def test_expected_sdf_differentiates_in_w():
    pm, _, grids, w = _field("ssy")
    wt = torch.as_tensor(w).requires_grad_(True)
    gt = tuple(torch.as_tensor(g) for g in grids)
    f = lambda x: lin_interp(x.reshape(4, -1), wt, gt).reshape(
        x.shape[1:] if x.ndim > 1 else ())
    val = P.expected_sdf(pm, f, 3, device="cpu")(torch.zeros(4,
                                                             dtype=torch.float64))
    g = torch.autograd.grad(val, wt)[0]
    wj = jnp.asarray(w)
    gj = jax.grad(lambda v: J.sdf.expected_sdf(
        J.SSY(), _jax_wstar(v, grids), 3)(jnp.zeros(4)))(wj)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=GRAD_RTOL,
                               atol=1e-300)


def test_one_step_moments_match_jax_on_the_same_draws():
    pm, jm, grids, w = _field("ssy")
    draws = np.random.default_rng(2).standard_normal((4, 4000))
    over = {"rho": 0.98, "phi_z": pm.phi_z * 1.1}
    wt = torch.as_tensor(w).requires_grad_(True)
    ot = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
          for k, v in over.items()}
    mu, sd = P.one_step_moments_differentiable(pm, grids, wt, draws,
                                               overrides=ot)
    muj, sdj = J.one_step_moments_differentiable(
        jm, tuple(jnp.asarray(g) for g in grids), jnp.asarray(w),
        jnp.asarray(draws), overrides={k: jnp.asarray(v)
                                       for k, v in over.items()})
    np.testing.assert_allclose(float(mu), float(muj), rtol=VALUE_RTOL)
    np.testing.assert_allclose(float(sd), float(sdj), rtol=VALUE_RTOL)
    grads = torch.autograd.grad(mu + sd, [wt, *ot.values()])

    def jloss(v, o):
        a, b = J.one_step_moments_differentiable(
            jm, tuple(jnp.asarray(g) for g in grids), v, jnp.asarray(draws),
            overrides=o)
        return a + b

    gw, go = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(w), {k: jnp.asarray(v) for k, v in over.items()})
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gw),
                               rtol=GRAD_RTOL, atol=1e-14)
    for k, g in zip(ot, grads[1:]):
        np.testing.assert_allclose(float(g), float(go[k]), rtol=GRAD_RTOL)


def test_recovers_perturbed_beta():
    truth = P.SSY()
    wc_fn, p0 = P.wc_ratio_differentiable(truth, SIZES, fields=("beta",),
                                          quad_degree=3, tol=1e-10,
                                          device="cpu")
    draws = mc_draws(4, 8000, 1234)       # calibrate_moments' own draws
    mu, _ = P.one_step_moments_differentiable(truth, wc_fn.grids, wc_fn(p0),
                                              draws)
    start = dataclasses.replace(truth, beta=0.9985)
    cal, info = P.calibrate_moments(start, SIZES, {"mean": float(mu)},
                                    fields=("beta",), quad_degree=3,
                                    tol=1e-10, num_draws=8000, max_steps=10,
                                    device="cpu")
    assert info["converged"]
    np.testing.assert_allclose(cal.beta, truth.beta, rtol=0, atol=5e-6)


def test_validation_errors():
    for targets, kw, match in (({"median": 1.0}, {}, "unknown target"),
                               ({}, {}, "empty targets"),
                               ({"mean": 1.0, "std": 1.0},
                                dict(fields=("beta",)), "need >="),
                               ({"mean": 1.0},
                                dict(fields=("beta",), kind="discrete"),
                                "continuous")):
        with pytest.raises(ValueError, match=match):
            J.calibrate_moments(J.SSY(), SIZES, targets, **kw)
        with pytest.raises(ValueError, match=match):
            P.calibrate_moments(P.SSY(), SIZES, targets, device="cpu", **kw)


def test_risk_free_rate_gradient_composes_through_pricing():
    # gamma -> implicit solve -> w* interpolation -> SDF quadrature -> r_f.
    model = P.SSY()
    wc_fn, p0 = P.wc_ratio_differentiable(model, SIZES, fields=("gamma",),
                                          quad_degree=3, tol=1e-10,
                                          device="cpu")
    grids = wc_fn.grids

    def rf(p):
        w_grid = wc_fn(p)
        m = dataclasses.replace(model, gamma=p["gamma"])
        w_func = lambda x: lin_interp(x.reshape(4, -1), w_grid,
                                      grids).reshape(
                                          x.shape[1:] if x.ndim > 1 else ())
        return P.risk_free_rate_ssy(m, w_func, degree=3, device="cpu")(
            torch.zeros(4, dtype=torch.float64))

    g = torch.func.grad(rf)(p0)["gamma"]
    eps = 1e-5
    g0 = float(p0["gamma"])
    fd = (float(rf({"gamma": torch.tensor(g0 + eps, dtype=torch.float64)}))
          - float(rf({"gamma": torch.tensor(g0 - eps, dtype=torch.float64)}))
          ) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), fd, rtol=2e-4)

    wc_j, pj = J.wc_ratio_differentiable(J.SSY(), SIZES, fields=("gamma",),
                                         quad_degree=3, tol=1e-10)
    gj_grids = tuple(jnp.asarray(g_.numpy()) for g_ in grids)

    def rf_j(p):
        w_grid = wc_j(p)
        m = dataclasses.replace(J.SSY(), gamma=p["gamma"])
        w_func = lambda x: jax_interp(x.reshape(4, -1), w_grid,
                                      gj_grids).reshape(
                                          x.shape[1:] if x.ndim > 1 else ())
        return J.risk_free_rate_ssy(m, w_func, degree=3)(jnp.zeros(4))

    np.testing.assert_allclose(float(g), float(jax.grad(rf_j)(pj)["gamma"]),
                               rtol=GRAD_RTOL)
