"""PyTorch port vs the JAX package: discrete GCY host algebra in float64.

Same inputs (numpy, seeded) through both packages; tolerance 1e-12 abs
(float64 evaluation of the same contraction chains, summed in another
order), exact equality for the model's parameters and the log-linear
coefficients (the same numpy code on the same numbers).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.operators.discrete_gcy import (
    _gcy_factors as jax_gcy_factors)
from sdfs_via_autodiff_tpu.operators.discrete_gcy import (
    gcy_loglinear_parts as jax_loglinear_parts)
from sdfs_via_autodiff_tpu.operators.two_phase import (
    two_phase_operands_gcy as jax_operands_gcy)
from sdfs_via_autodiff_tpu_torch.operators.discrete_gcy import _gcy_factors

SHAPES = [(3, 2, 4, 2, 3, 2), (4, 3, 3, 2, 3, 2)]
METHODS = ["rouwenhorst", "tauchen"]
ATOL = 1e-12


def _ell(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return np.log(800.0) + 0.05 * rng.standard_normal(shapes)


def _both(shapes, method):
    jm, pm = J.GCY(), P.GCY()
    return (jm, J.discretize_gcy(jm, shapes, method=method),
            pm, P.discretize_gcy(pm, shapes, method=method))


def _close(got, want, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL,
                               err_msg=name)


def test_gcy_parameters_and_loglinear_coefficients_equal_jax():
    jm, pm = J.GCY(), P.GCY()
    assert dataclasses.asdict(pm) == dataclasses.asdict(jm)
    assert pm.theta == jm.theta and pm.params == jm.params
    jco = J.models.gcy.gcy_loglinear_factory(jm).coefficients
    pco = P.gcy_loglinear_factory(pm).coefficients
    assert pco == jco
    x = np.stack([np.full(5, v) for v in (0.1, -0.2, 0.3, 0.05, 1e-3,
                                          -2e-3)])
    np.testing.assert_array_equal(P.gcy_loglinear_factory(pm)(x),
                                  J.models.gcy.gcy_loglinear_factory(jm)(x))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shapes", SHAPES)
def test_discretize_gcy_matches_jax(shapes, method):
    _, jd, _, pd = _both(shapes, method)
    assert pd.shapes == tuple(jd.shapes)
    for f in dataclasses.fields(jd):
        if f.name == "shapes":
            continue
        got = getattr(pd, f.name)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        _close(got, getattr(jd, f.name), f.name)
    _close(pd.z_Q, jd.z_Q, "z_Q")
    _close(pd.z_pi_Q, jd.z_pi_Q, "z_pi_Q")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shapes", SHAPES)
def test_gcy_factors_dense_H_and_loglinear_parts_match_jax(shapes, method):
    jm, jd, pm, pd = _both(shapes, method)
    for name, got, want in zip(("B_lam", "A2", "A3"), _gcy_factors(pm, pd),
                               jax_gcy_factors(jm, jd)):
        _close(got, want, name)
    _close(P.dense_H_gcy(pm, pd, device="cpu"), J.dense_H_gcy(jm, jd))
    jp, pp = jax_loglinear_parts(jm, jd), P.gcy_loglinear_parts(pm, pd)
    assert set(pp) == set(jp) and pp["co"] == jp["co"]
    for k in sorted(set(jp) - {"co"}):
        _close(pp[k], jp[k], k)
    # The tiled solve's start, formed from the separable terms where it
    # runs, is the parts' ell0 cast, bit for bit; the tiled view's range
    # guard reads the same span as the whole field gives.
    start = P.operators.discrete_gcy.gcy_loglinear_start(pm, pd,
                                                         device="cpu")
    assert torch.equal(start, torch.as_tensor(pp["ell0"],
                                              dtype=torch.float32))
    ell0 = pp["ell0"]
    span = (ell0.max(axis=(0, 1, 2, 4)) - ell0.min(axis=(0, 1, 2, 4))).max()
    assert P.operators.discrete_gcy.gcy_loglinear_column_span(pm, pd) == \
        pytest.approx(span, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("space", ["w", "log"])
@pytest.mark.parametrize("shapes", SHAPES)
def test_T_gcy_factory_matches_jax(shapes, space):
    jm, jd, pm, pd = _both(shapes, "rouwenhorst")
    jT = J.T_gcy_factory(jm, jd, space=space)
    pT = P.T_gcy_factory(pm, pd, space=space, device="cpu")
    x = _ell(shapes)
    if space == "w":
        x = np.exp(x)
    want = np.asarray(jT(jnp.asarray(x)))
    got = pT(torch.as_tensor(x))
    assert got.dtype == torch.float64
    # w-space values sit near 800, where one float64 ulp is 1.1e-13.
    _close(got, want)


def test_dense_H_agrees_with_factored_operator():
    m = P.GCY()
    shapes = SHAPES[0]
    d = P.discretize_gcy(m, shapes)
    H = P.dense_H_gcy(m, d, device="cpu")
    w = torch.as_tensor(np.exp(_ell(shapes, seed=3)))
    T = P.T_gcy_factory(m, d, space="w", device="cpu")
    dense = 1.0 + m.beta * (H @ (w.reshape(-1) ** m.theta)) ** (1 / m.theta)
    np.testing.assert_allclose(T(w).reshape(-1).numpy(), dense.numpy(),
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shapes", SHAPES)
def test_two_phase_operands_gcy_match_jax(shapes, method):
    jm, jd, pm, pd = _both(shapes, method)
    jops = jax_operands_gcy(jm, jd)
    pops = P.two_phase_operands_gcy(pm, pd)
    assert pops.shapes == tuple(jops.shapes) and pops.is_plain
    for f in dataclasses.fields(jops):
        want = getattr(jops, f.name)
        if isinstance(want, np.ndarray):
            _close(getattr(pops, f.name), want, f.name)
    assert (pops.theta, pops.beta) == (jops.theta, jops.beta)
    assert pops.perm == tuple(jops.perm)
    assert pops.inv_perm == tuple(jops.inv_perm)
    assert pops.state_shapes == tuple(jops.state_shapes)
    # The view round trip of a natural-layout field.
    ell = _ell(shapes)
    view = ell.transpose(pops.perm)
    assert view.reshape(pops.shapes).shape == pops.shapes
    np.testing.assert_array_equal(view.transpose(pops.inv_perm), ell)


def test_gcy_model_and_operands_cross_whole():
    jm = J.GCY(gamma=12.0, rho_pipi=0.98)
    pm = P.model_from_fields(dataclasses.asdict(jm))
    assert isinstance(pm, P.GCY)
    assert dataclasses.asdict(pm) == dataclasses.asdict(jm)
    assert isinstance(P.model_from_fields(dataclasses.asdict(J.SSY())),
                      P.SSY)
    jops = jax_operands_gcy(jm, J.discretize_gcy(jm, SHAPES[1]))
    pops = P.operands_from_numpy({**dataclasses.asdict(jops),
                                  "perm": jops.perm,
                                  "inv_perm": jops.inv_perm,
                                  "state_shapes": jops.state_shapes})
    assert pops.perm == tuple(jops.perm)
    assert pops.inv_perm == tuple(jops.inv_perm)
    assert pops.state_shapes == tuple(jops.state_shapes)
    for f in dataclasses.fields(jops):
        a, b = getattr(jops, f.name), getattr(pops, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_normalized_gcy_tier_raises_not_implemented():
    # Ported (tests/test_torch_normalized_two_phase.py holds it against
    # JAX): the normalized operator is the same function as the plain
    # one, and its operand set carries the rank-2 lazy factors.
    m = P.GCY()
    d = P.discretize_gcy(m, SHAPES[0])
    T = P.T_gcy_factory(m, d, space="log", baseline="loglinear",
                        device="cpu")
    x = T.baseline_log_w + 0.01
    want = P.T_gcy_factory(m, d, space="log", device="cpu")(x)
    assert float((T(x) - want).abs().max()) <= 1e-12
    ops = P.two_phase_operands_gcy(m, d, baseline="loglinear")
    assert ops.c1_batched and ops.lazy_c1[1].shape[0] == 2


@pytest.mark.parametrize("shapes,warns", [((32, 8, 16, 2, 8, 2), False),
                                          ((48, 8, 16, 2, 8, 2), True)])
def test_f32_span_warning_matches_jax(shapes, warns):
    import warnings

    def caught(build):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            build()
        return [str(x.message) for x in w if "exp range" in str(x.message)]

    jm, jd, pm, pd = _both(shapes, "rouwenhorst")
    got = caught(lambda: P.two_phase_operands_gcy(pm, pd))
    want = caught(lambda: jax_operands_gcy(jm, jd))
    assert bool(got) == bool(want) == warns
    if warns:
        # Same span figure (theta * span ~ 91 at (48, 8, 16, 2, 8, 2)).
        assert got[0].split("~")[1].split()[0] == want[0].split("~")[1].split()[0]
