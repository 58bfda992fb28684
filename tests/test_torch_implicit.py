"""Implicit differentiation in the port vs the JAX package, in float64
on the CPU.

``implicit_fixed_point`` (an ``autograd.Function``: both
``torch.autograd.grad`` and ``torch.func.grad`` reach it) gives the
gradient of JAX's ``jax.grad`` on the same problems to rtol 1e-6 and of
central differences to rtol 2e-4 (the bars of JAX's
``tests/test_implicit.py``); ``implicit_sensitivity`` gives the same
directional derivative as the gradient; ``wc_ratio_differentiable``
does so for both kinds on SSY and raises as JAX's on invalid fields.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.solvers import implicit_fixed_point as jax_ifp

SIZES = (4, 4, 4, 4)
JAX_RTOL = 1e-6
FD_RTOL = 2e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tanh_problem():
    """T(p, x) = alpha * tanh(x + s) + mu in both packages."""
    s = np.linspace(-1.0, 1.0, 8)
    st, sj = torch.as_tensor(s), jnp.asarray(s)
    return (lambda p, x: p["alpha"] * torch.tanh(x + st) + p["mu"],
            lambda p, x: p["alpha"] * jnp.tanh(x + sj) + p["mu"])


@pytest.mark.parametrize("api", ["autograd", "func"])
def test_linear_analytic_gradient(api):
    # T(p, x) = 0.5 x + c a  =>  x* = 2 c a ; loss = sum(x*^2) = 4 c^2 |a|^2.
    a = torch.linspace(1.0, 2.0, 16, dtype=torch.float64)
    T = lambda p, x: 0.5 * x + p["c"] * a
    loss = lambda p: torch.sum(P.implicit_fixed_point(
        T, p, torch.zeros_like(a), method="successive_approx",
        tol=1e-13) ** 2)
    c = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    if api == "autograd":
        g = torch.autograd.grad(loss({"c": c}), c)[0]
    else:
        g = torch.func.grad(loss)({"c": c.detach()})["c"]
    np.testing.assert_allclose(float(g), 8.0 * 1.3 * float(torch.sum(a ** 2)),
                               rtol=1e-9)


def test_nonlinear_gradient_matches_jax_and_fd():
    Tp, Tj = _tanh_problem()
    x0p, x0j = torch.zeros(8, dtype=torch.float64), jnp.zeros(8)

    def loss_p(p):
        return torch.mean(P.implicit_fixed_point(
            Tp, p, x0p, method="successive_approx", tol=1e-13) ** 3)

    p0 = {"alpha": torch.tensor(0.6, dtype=torch.float64),
          "mu": torch.tensor(0.2, dtype=torch.float64)}
    g = torch.func.grad(loss_p)(p0)
    gj = jax.grad(lambda p: jnp.mean(jax_ifp(
        Tj, p, x0j, method="successive_approx", tol=1e-13) ** 3))(
            {"alpha": jnp.asarray(0.6), "mu": jnp.asarray(0.2)})
    eps = 1e-6
    for k in ("alpha", "mu"):
        np.testing.assert_allclose(float(g[k]), float(gj[k]), rtol=JAX_RTOL)
        up = {**p0, k: p0[k] + eps}
        dn = {**p0, k: p0[k] - eps}
        fd = (float(loss_p(up)) - float(loss_p(dn))) / (2 * eps)
        np.testing.assert_allclose(float(g[k]), fd, rtol=1e-6)


def test_forward_reverse_consistency():
    Tp, _ = _tanh_problem()
    x0 = torch.zeros(8, dtype=torch.float64)
    p0 = {"alpha": torch.tensor(0.6, dtype=torch.float64),
          "mu": torch.tensor(0.2, dtype=torch.float64)}
    g = torch.func.grad(lambda p: torch.mean(P.implicit_fixed_point(
        Tp, p, x0, method="successive_approx", tol=1e-13) ** 3))(p0)
    x_star = P.implicit_fixed_point(Tp, p0, x0, method="successive_approx",
                                    tol=1e-13)
    dp = {"alpha": 0.7, "mu": -0.3}
    dx = P.implicit_sensitivity(Tp, p0, dp, x_star, rtol=1e-12)
    directional = float(torch.sum(3 * x_star ** 2 * dx)) / x_star.numel()
    expected = float(g["alpha"]) * 0.7 + float(g["mu"]) * -0.3
    np.testing.assert_allclose(directional, expected, rtol=1e-8)


def _ssy_loss(kind, fields, degree=3):
    """(port loss, JAX loss, p0 floats) of mean(log w*) for SSY."""
    kw = dict(fields=fields, kind=kind, tol=1e-11)
    if kind == "continuous":
        kw["quad_degree"] = degree
    wc_p, p0 = P.wc_ratio_differentiable(P.SSY(), SIZES, device="cpu", **kw)
    wc_j, _ = J.wc_ratio_differentiable(J.SSY(), SIZES, **kw)
    return (lambda p: torch.mean(torch.log(wc_p(p))),
            lambda p: jnp.mean(jnp.log(wc_j(p))),
            {k: float(v) for k, v in p0.items()})


def _check_gradient(kind, fields, eps):
    loss_p, loss_j, p0 = _ssy_loss(kind, fields)
    pt = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
          for k, v in p0.items()}
    g = dict(zip(pt, torch.autograd.grad(loss_p(pt), list(pt.values()))))
    gj = jax.grad(loss_j)({k: jnp.asarray(v) for k, v in p0.items()})
    for k in fields:
        np.testing.assert_allclose(float(g[k]), float(gj[k]), rtol=JAX_RTOL)
        at = lambda v: float(loss_p({**{n: torch.tensor(x, dtype=torch.float64)
                                        for n, x in p0.items()},
                                     k: torch.tensor(v, dtype=torch.float64)}))
        fd = (at(p0[k] + eps[k]) - at(p0[k] - eps[k])) / (2 * eps[k])
        np.testing.assert_allclose(float(g[k]), fd, rtol=FD_RTOL)


def test_continuous_gradient_matches_jax_and_fd():
    _check_gradient("continuous", ("beta", "gamma"),
                    {"beta": 1e-7, "gamma": 1e-5})


def test_discrete_preference_gradient_matches_jax_and_fd():
    _check_gradient("discrete", ("gamma", "mu_c"),
                    {"gamma": 1e-5, "mu_c": 1e-7})


def test_sensitivity_matches_gradient_direction():
    from sdfs_via_autodiff_tpu_torch.operators.continuous_ssy import (
        _factored_T)
    model = P.SSY()
    wc_fn, p0 = P.wc_ratio_differentiable(model, SIZES, fields=("beta",),
                                          quad_degree=3, tol=1e-11,
                                          device="cpu")
    g = torch.func.grad(lambda p: torch.mean(torch.log(wc_fn(p))))(p0)
    grids = P.build_grid_ssy(model, *SIZES, num_std_devs=3.2)

    def T_of_p(p, x):
        import dataclasses
        m = dataclasses.replace(model, beta=p["beta"])
        return _factored_T(m, grids, 3, "log", torch.float64, None,
                           device="cpu")(x)

    x_star = torch.log(wc_fn(p0))
    dx = P.implicit_sensitivity(T_of_p, p0, {"beta": 1.0}, x_star,
                                rtol=1e-10)
    np.testing.assert_allclose(float(torch.mean(dx)), float(g["beta"]),
                               rtol=JAX_RTOL)


@pytest.mark.parametrize("kwargs,match", [
    (dict(fields=("nope",)), "unknown model fields"),
    (dict(fields=("rho_z",), kind="discrete"), "preference fields"),
    (dict(kind="sparse"), "unknown kind"),
    (dict(space="v"), "unknown space"),
])
def test_invalid_fields_raise_as_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        J.wc_ratio_differentiable(J.SSY(), SIZES, **kwargs)
    with pytest.raises(ValueError, match=match):
        P.wc_ratio_differentiable(P.SSY(), SIZES, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="grid_sizes"):
        P.wc_ratio_differentiable(P.GCY(), SIZES, device="cpu")


def test_adjoint_stagnation_warns():
    # A stagnated adjoint Krylov solve must not return a wrong gradient
    # silently, and a converged one stays quiet.
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    M = torch.as_tensor(Q @ np.diag(np.linspace(0.2, 0.999, 40)) @ Q.T)
    T = lambda p, x: M @ x + p

    def grad_with(mi):
        p = torch.ones(40, dtype=torch.float64, requires_grad=True)
        x = P.implicit_fixed_point(T, p, torch.zeros(40, dtype=torch.float64),
                                   tol=1e-13, adjoint_maxiter=mi)
        return torch.autograd.grad(x.sum(), p)[0]

    with pytest.warns(UserWarning, match="stagnated"):
        grad_with(3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        grad_with(300)
