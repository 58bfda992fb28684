"""PyTorch port vs the JAX package: discrete SSY operator in float64.

Same inputs (numpy, seeded) through both packages; tolerance 1e-12 abs
(float64 evaluation of the same contraction chain, summed in another
order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.ops.contract import lse_matmul as jax_lse_matmul
from sdfs_via_autodiff_tpu_torch.ops.contract import lse_matmul

SHAPES = [(3, 3, 3, 4), (4, 5, 6, 7), (8, 8, 8, 8)]
ATOL = 1e-12


def _ell(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return np.log(800.0) + 0.05 * rng.standard_normal(shapes)


@pytest.mark.parametrize("method", ["rouwenhorst", "tauchen"])
@pytest.mark.parametrize("shapes", SHAPES)
def test_discretize_ssy_matches_jax(shapes, method):
    jd = J.discretize_ssy(J.SSY(), shapes, method=method)
    pd = P.discretize_ssy(P.SSY(), shapes, method=method)
    assert pd.shapes == tuple(jd.shapes)
    for f in dataclasses.fields(jd):
        if f.name == "shapes":
            continue
        got = getattr(pd, f.name)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jd, f.name)),
                                   rtol=0, atol=ATOL, err_msg=f.name)


@pytest.mark.parametrize("space", ["w", "log"])
@pytest.mark.parametrize("shapes", SHAPES)
def test_T_ssy_factory_matches_jax(shapes, space):
    jm, pm = J.SSY(), P.SSY()
    jT = J.T_ssy_factory(jm, J.discretize_ssy(jm, shapes), space=space)
    pT = P.T_ssy_factory(pm, P.discretize_ssy(pm, shapes), space=space,
                         device="cpu")
    x = _ell(shapes)
    if space == "w":
        x = np.exp(x)
    want = np.asarray(jT(jnp.asarray(x)))
    got = pT(torch.as_tensor(x))
    assert got.dtype == torch.float64
    # w-space values sit near 800, where one float64 ulp is 1.1e-13.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shapes", SHAPES)
def test_dense_H_ssy_matches_jax(shapes):
    jm, pm = J.SSY(), P.SSY()
    want = np.asarray(J.dense_H_ssy(jm, J.discretize_ssy(jm, shapes)))
    got = P.dense_H_ssy(pm, P.discretize_ssy(pm, shapes), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_dense_H_agrees_with_factored_operator():
    m = P.SSY()
    d = P.discretize_ssy(m, (3, 3, 3, 4))
    H = P.dense_H_ssy(m, d, device="cpu")
    w = torch.as_tensor(np.exp(_ell((3, 3, 3, 4), seed=3)))
    T = P.T_ssy_factory(m, d, space="w", device="cpu")
    dense = 1.0 + m.beta * (H @ (w.reshape(-1) ** m.theta)) ** (1 / m.theta)
    np.testing.assert_allclose(T(w).reshape(-1).numpy(), dense.numpy(),
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("subs,axis", [("lm,mkij->lkij", 0),
                                       ("jm,lkim->lkij", 3)])
def test_lse_matmul_matches_jax(subs, axis):
    rng = np.random.default_rng(7)
    v = -30.0 * rng.random((4, 5, 6, 7))
    n = v.shape[axis]
    M = rng.random((n, n)) * np.exp(-40 * rng.random((n, n)))
    want = np.asarray(jax_lse_matmul(jnp.asarray(M), jnp.asarray(v), subs,
                                     axis))
    got = lse_matmul(torch.as_tensor(M), torch.as_tensor(v), subs, axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
