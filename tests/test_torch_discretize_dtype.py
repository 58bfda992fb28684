"""The discretizers' ``dtype``: the port against the JAX package.

``discretize_ssy(model, shapes, dtype, method=...)`` and
``discretize_gcy`` take the storage dtype in the JAX package's position
(the third argument; ``method`` is a keyword).  The float32 tests are
the JAX package's own (``tests/test_discrete_ssy.py:137-179``,
``tests/test_discrete_gcy.py:104-130``) with its tolerances: 1e-3
relative on w* and 1e-4 absolute on one application against float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model, shapes", [
    ("ssy", (4, 4, 4, 6)), ("gcy", (4, 3, 3, 2, 3, 2))])
@pytest.mark.parametrize("method", ["rouwenhorst", "tauchen"])
def test_dtype_is_the_third_argument_as_in_jax(model, shapes, method):
    jd = getattr(J, f"discretize_{model}")
    pd = getattr(P, f"discretize_{model}")
    jm, pm = getattr(J, model.upper())(), getattr(P, model.upper())()
    want = jd(jm, shapes, jnp.float32, method=method)
    got = pd(pm, shapes, torch.float32, method=method)
    assert got.z_P.dtype == torch.float32
    for name in ("z_states", "z_P", "h_c_Q", "h_lam_states",
                 "sigma_z_states"):
        a = getattr(got, name)
        assert a.dtype == torch.float32, name
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(want, name)))
    # The default stays float64, and method stays a keyword.
    assert pd(pm, shapes, method=method).z_P.dtype == torch.float64


def test_normalized_f32_wide_grid_stays_finite():
    model = P.SSY()
    disc32 = P.discretize_ssy(model, (4, 4, 4, 48), torch.float32)
    T_norm = P.T_ssy_factory(model, disc32, space="log",
                             baseline="loglinear", dtype=torch.float32,
                             device="cpu")
    ell = T_norm.baseline_log_w
    for _ in range(30):
        ell = T_norm(ell)
    assert bool(torch.isfinite(ell).all())
    disc64 = P.discretize_ssy(model, (4, 4, 4, 48))
    T64 = P.T_ssy_factory(model, disc64, space="log", device="cpu")
    ref = P.solve(T64, T_norm.baseline_log_w.double(), method="newton",
                  tol=1e-11)
    res = P.solve(T_norm, ell, method="newton", tol=3e-5)
    assert res.converged
    w, w_ref = torch.exp(res.x.double()), torch.exp(ref.x)
    assert float(((w - w_ref).abs() / w_ref).max()) < 1e-3


def test_normalized_f32_full_width_rouwenhorst_ladder():
    model = P.SSY()
    disc = P.discretize_ssy(model, (3, 3, 3, 256), torch.float32)
    T32 = P.T_ssy_factory(model, disc, space="log", baseline="loglinear",
                          dtype=torch.float32, device="cpu")
    x0 = T32.baseline_log_w.float()
    y = T32(x0)
    assert bool(torch.isfinite(y).all())
    disc64 = P.discretize_ssy(model, (3, 3, 3, 256))
    T64 = P.T_ssy_factory(model, disc64, space="log", baseline="loglinear",
                          device="cpu")
    assert float((y.double() - T64(x0.double())).abs().max()) < 1e-4


def test_gcy_normalized_f32_wide_grid_stays_finite():
    model = P.GCY()
    disc = P.discretize_gcy(model, (40, 3, 3, 3, 3, 3), torch.float32)
    T = P.T_gcy_factory(model, disc, space="log", baseline="loglinear",
                        dtype=torch.float32, device="cpu")
    ell = T.baseline_log_w
    for _ in range(25):
        ell = T(ell)
    assert bool(torch.isfinite(ell).all())


def test_gcy_normalized_f32_wide_ladder_first_app_and_f64_agreement():
    # The fold's separable-ladder check takes its tolerance from the
    # storage dtype, so a float32 discretization passes it, as in JAX.
    model = P.GCY()
    shapes = (32, 8, 8, 3, 4, 4)
    disc = P.discretize_gcy(model, shapes, torch.float32)
    T32 = P.T_gcy_factory(model, disc, space="log", baseline="loglinear",
                          dtype=torch.float32, device="cpu")
    x0 = T32.baseline_log_w.float()
    y = T32(x0)
    assert bool(torch.isfinite(y).all())
    T64 = P.T_gcy_factory(model, P.discretize_gcy(model, shapes),
                          space="log", baseline="loglinear", device="cpu")
    assert float((y.double() - T64(x0.double())).abs().max()) < 1e-4
    ops = P.two_phase_operands_gcy(model, disc, "loglinear")
    assert ops.has_sub
