"""Implicit differentiation from a DTensor start: the port against
itself on one device and against the JAX package.

JAX's ``test_implicit_gradient_on_sharded_iterate``: d mean(x*) / d beta
for the continuous SSY operator (8, 8, 6, 6), quadrature degree 3,
float64 log space, with ``implicit_fixed_point`` started from a sharded
iterate.  One spawn of four gloo ranks (``torch_ranks.gspmd_implicit``)
runs it on a 2x2 and a 4x1 mesh, with ``implicit_sensitivity`` at the
DTensor fixed point.  The gradient is a plain tensor on every rank, the
fixed point and the sensitivity DTensors with the start's placements.

Tolerances: the gradient within 1e-8 relative of the single-device one
(JAX's own), and within 1e-6 relative of ``jax.grad`` of the JAX
package's (``tests/test_torch_implicit.py``); the sensitivity within
1e-8 relative of the single-device one (both solved to rtol 1e-10).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sdfs_via_autodiff_tpu as J
import torch_ranks as tr


@pytest.fixture(scope="module")
def ranks():
    return tr.spawn("gspmd_implicit", 4)


def _jax_gradient():
    from sdfs_via_autodiff_tpu.operators.continuous_ssy import _factored_T
    from sdfs_via_autodiff_tpu.solvers import implicit_fixed_point
    model = J.SSY()
    grids = J.build_grid_ssy(model, 8, 8, 6, 6)

    def T_of_p(p, x):
        return _factored_T(dataclasses.replace(model, beta=p["beta"]),
                           grids, 3, "log", jnp.float64, None)(x)

    x0 = jnp.full((8, 8, 6, 6), jnp.log(800.0))
    loss = lambda p: jnp.mean(implicit_fixed_point(T_of_p, p, x0,
                                                   method="newton",
                                                   tol=1e-10))
    return float(jax.grad(loss)({"beta": jnp.asarray(model.beta)})["beta"])


@pytest.mark.parametrize("label", sorted(tr.GSPMD_MESHES))
def test_implicit_gradient_on_a_dtensor_matches_the_single_device_one(
        ranks, label):
    for r in ranks:
        res = r[label]
        assert res["grad_is_plain"]
        assert res["x_is_dtensor"] and res["x_placements_kept"]
        np.testing.assert_allclose(res["grad"], r["ref_grad"], rtol=1e-8)


@pytest.mark.parametrize("label", sorted(tr.GSPMD_MESHES))
def test_implicit_gradient_on_a_dtensor_matches_jax(ranks, label):
    np.testing.assert_allclose(ranks[0][label]["grad"], _jax_gradient(),
                               rtol=1e-6)


@pytest.mark.parametrize("label", sorted(tr.GSPMD_MESHES))
def test_implicit_sensitivity_on_a_dtensor(ranks, label):
    for r in ranks:
        res = r[label]
        assert res["sens_placements_kept"]
        assert res["sens_max_rel"] <= 1e-8
