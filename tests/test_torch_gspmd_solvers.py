"""The solvers from a DTensor start with the single-device operators:
the port against itself on one device and against the JAX package.

One spawn of four gloo ranks (``torch_ranks.gspmd_solvers``) runs each
solve of ``torch_ranks.GSPMD_SOLVES`` (JAX's ``tests/test_sharding.py``
solves and sizes) from a DTensor start on a 2x2 and a 4x1 mesh, and from
the plain start.  Every rank takes the same steps, and the result's
``x`` is a DTensor with the start's (sharded) placements.

Tolerances.  JAX holds its GSPMD Newton solve to 1e-12 of the
single-device one and Anderson to 1e-10; XLA partitions the same
computation with nearly the same rounding.  The port's sharded
contractions sum in another order, and these solves are not determined
that finely: on one device, a start moved by one ulp moves the Newton
fixed point at tol 1e-10 by 6.5e-12 and Anderson's end state at tol 1e-9
by 3.4e-7 (torch 2.13; ``test_one_ulp_moves_the_single_device_solves``
checks that this spread exceeds JAX's bounds); under torch 2.11 the 4x1
Newton solve lands 1.7e-11 from the single-device one.  So two Newton fixed
points are held to the sum of their sup-norm residuals over 1 - beta
(each lies within its residual over 1 - beta of the fixed point, beta
bounding the operator's contraction), Anderson to 2 tol beta / (1 -
beta) (the bound of ``tests/test_torch_parallel_solvers.py``).
The same bound holds the w-space Newton solve, whose tangent on the
DTensor is the derivative of a VJP (no hand linearization in w space),
to the single-device one and to JAX's.
De Groot's Newton solve meets JAX's 1e-12, and the SA loop 1e-13.
Against the JAX package's single-device solves: 1e-10 for the Newton
fixed point (``tests/test_torch_solvers.py``), the Anderson bound above,
and 1e-9 for de Groot (``tests/test_torch_degroot.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sdfs_via_autodiff_tpu as J
import torch_ranks as tr

RUNS = [(case, label) for case, spec in tr.GSPMD_SOLVES.items()
        for label in spec.get("meshes", tr.GSPMD_MESHES)]


@pytest.fixture(scope="module")
def ranks():
    return tr.spawn("gspmd_solvers", 4)


def _anderson_bound():
    beta = J.SSY().beta
    return 2 * tr.GSPMD_SOLVES["anderson"]["opts"]["tol"] * beta / (1 - beta)


def _jax_solve(case):
    spec = tr.GSPMD_SOLVES[case]
    kind, shapes = spec["op"]
    m = J.SSY()
    disc = J.discretize_ssy(m, shapes)
    if kind == "ssy":
        T = J.T_ssy_factory(m, disc, space="log")
        x0 = jnp.full(shapes, jnp.log(800.0))
    elif kind == "ssy_w":
        T = J.T_ssy_factory(m, disc, space="w")
        x0 = jnp.full(shapes, 800.0)
    else:
        from sdfs_via_autodiff_tpu.operators.degroot import T_degroot_factory
        T = T_degroot_factory(m, disc, space="log", h=0.99)
        x0 = jnp.full(shapes, m.theta * float(np.log((1 - m.beta) * 800.0)))
    res = J.solve(T, x0, method=spec["method"], **spec["opts"])
    assert bool(res.converged)
    if kind == "ssy_w":
        return np.asarray(res.x), float(res.residual)
    return np.asarray(res.x)


@pytest.mark.parametrize("case, label", RUNS)
def test_every_rank_takes_the_same_steps(ranks, case, label):
    first = ranks[0][(case, label)]
    assert first["is_dtensor"] and first["placements_kept"]
    assert first["sharded"]
    for r in ranks[1:]:
        for key in ("iterations", "converged", "residual"):
            assert r[(case, label)][key] == first[key], key


def _newton_bound(res):
    return (res["residual"] + res["ref_residual"]) / (1 - J.SSY().beta)


@pytest.mark.parametrize("case, label", [("newton", "2x2"),
                                         ("newton", "4x1"),
                                         ("newton_gmres", "2x2"),
                                         ("newton_w", "2x2"),
                                         ("newton_w", "4x1")])
def test_newton_on_a_dtensor_matches_the_single_device_solve(ranks, case,
                                                            label):
    res = ranks[0][(case, label)]
    assert res["converged"] and res["ref_converged"]
    assert res["max_abs_vs_single"] <= _newton_bound(res)


@pytest.mark.parametrize("case, jax_bound", [("newton", 1e-12),
                                             ("anderson", 1e-10)])
def test_one_ulp_moves_the_single_device_solves(ranks, case, jax_bound):
    # Why the bounds above are not JAX's: on one device, a start one ulp
    # away already moves the result further than JAX's bound.
    assert ranks[0][(case, "ulp_spread")] > jax_bound


@pytest.mark.parametrize("case", ["newton", "newton_gmres"])
def test_newton_on_a_dtensor_matches_jax(ranks, case):
    want = _jax_solve("newton")
    for label in tr.GSPMD_SOLVES[case].get("meshes", tr.GSPMD_MESHES):
        np.testing.assert_allclose(ranks[0][(case, label)]["x"], want,
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("label", sorted(tr.GSPMD_MESHES))
def test_w_space_newton_on_a_dtensor_matches_jax(ranks, label):
    # The tangent is the derivative of a VJP here (no hand linearization
    # in w space); the two fixed points are held to the sum of their
    # residuals over 1 - beta.
    want, want_residual = _jax_solve("newton_w")
    res = ranks[0][("newton_w", label)]
    bound = (res["residual"] + want_residual) / (1 - J.SSY().beta)
    np.testing.assert_allclose(res["x"], want, rtol=0, atol=bound)


@pytest.mark.parametrize("label", sorted(tr.GSPMD_MESHES))
def test_anderson_on_a_dtensor_matches_the_single_device_solve(ranks,
                                                              label):
    res = ranks[0][("anderson", label)]
    assert res["converged"] and res["ref_converged"]
    assert res["max_abs_vs_single"] <= _anderson_bound()


def test_anderson_on_a_dtensor_matches_jax(ranks):
    want = _jax_solve("newton")           # the fixed point
    for label in tr.GSPMD_MESHES:
        np.testing.assert_allclose(ranks[0][("anderson", label)]["x"], want,
                                   rtol=0, atol=_anderson_bound())


@pytest.mark.parametrize("label", sorted(tr.GSPMD_MESHES))
def test_successive_approx_on_a_dtensor_matches_the_single_device_loop(
        ranks, label):
    res = ranks[0][("sa", label)]
    assert res["iterations"] == res["ref_iterations"] == 24
    assert res["max_abs_vs_single"] <= 1e-13
    assert res["trace_max_abs"] <= 1e-13


@pytest.mark.parametrize("label", sorted(tr.GSPMD_MESHES))
def test_degroot_newton_on_a_dtensor_matches_single_device_and_jax(ranks,
                                                                  label):
    res = ranks[0][("degroot_newton", label)]
    assert res["converged"] and res["ref_converged"]
    assert res["max_abs_vs_single"] <= 1e-12
    np.testing.assert_allclose(res["x"], _jax_solve("degroot_newton"),
                               rtol=0, atol=1e-9)
