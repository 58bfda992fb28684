"""The solvers on sharded iterates: the port against the JAX package.

One spawn of four gloo ranks (``torch_ranks.solver_cases``) runs each
solve of ``torch_ranks.SOLVES`` from a DTensor start through a sharded
operator, and the same solve through the port's single-device
operator; the tests read its results.  Every rank must take the same
steps (the loops all-reduce what their decisions read), and the
result's ``x`` is a DTensor with the operator's placements.

Tolerances: the float64 Newton fixed points within 1e-9 of the JAX
package's single-device solves (``tests/test_sharding.py:221-240``;
1e-10 for the h_lam-sharded SSY operator, ``:266-283``); Anderson's end
state within 2*tol*beta/(1 - beta) of the single-device one (its Gram
sums run in another order, so the iterates part); the streamed SA loop
bitwise the single-device one; the streamed float32 Newton solve within
2e-4 of the float64 fixed point (``:405-444``); the sharded operators'
derivatives within 1e-13 (float64) and 1e-5 relative (float32, sums in
another order; 3.3e-6 measured) of the single-device twins'.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sdfs_via_autodiff_tpu as J
import torch_ranks as tr


@pytest.fixture(scope="module")
def ranks():
    return tr.spawn("solver_cases", 4)


def _jax_fixed_point(shapes):
    model = J.SSY()
    T = J.T_ssy_factory(model, J.discretize_ssy(model, shapes), space="log")
    res = J.solve(T, jnp.full(shapes, jnp.log(800.0)), method="newton",
                  tol=1e-11)
    assert bool(res.converged)
    return np.asarray(res.x)


@pytest.mark.parametrize("case", sorted(tr.SOLVES))
def test_every_rank_takes_the_same_steps(ranks, case):
    first = ranks[0][case]
    assert first["placements"] == first["input_sharding"]
    for r in ranks[1:]:
        for key in ("iterations", "converged", "residual"):
            assert r[case][key] == first[key], key


@pytest.mark.parametrize("case, atol", [("newton_two_phase_2x2", 1e-9),
                                        ("newton_two_phase_4x1", 1e-9),
                                        ("gmres_two_phase_2x2", 1e-9),
                                        ("newton_tssy_4x1", 1e-10),
                                        ("newton_tssy_2x2", 1e-10)])
def test_float64_newton_matches_jax(ranks, case, atol):
    res = ranks[0][case]
    assert res["converged"]
    want = _jax_fixed_point(tr.SOLVES[case]["recipe"][1])
    np.testing.assert_allclose(res["x"], want, rtol=0, atol=atol)
    assert res["max_abs_vs_single"] <= atol


def test_anderson_matches_the_single_device_solve(ranks):
    res = ranks[0]["anderson_two_phase_2x2"]
    tol = tr.SOLVES["anderson_two_phase_2x2"]["opts"]["tol"]
    beta = J.SSY().beta
    assert res["converged"] and res["ref_converged"]
    assert res["max_abs_vs_single"] <= 2 * tol * beta / (1 - beta)


@pytest.mark.parametrize("case", ["sa_streamed_2x2", "anderson_streamed_4x1"])
def test_streamed_loops_are_the_single_device_loops(ranks, case):
    # The operator is bitwise the single-device one and max-reductions
    # are exact, so the loop is too (Anderson's float64 Gram matrix at
    # this size as well).
    res = ranks[0][case]
    assert res["equal_to_single"]
    assert res["iterations"] == res["ref_iterations"]
    assert res.get("trace_equal", True)


def test_streamed_newton_reaches_the_float64_fixed_point(ranks):
    res = ranks[0]["newton_streamed_2x2"]
    assert res["converged"]
    want = _jax_fixed_point(tr.STREAMED_SHAPES)
    np.testing.assert_allclose(res["x"], want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("name, bound", [("jvp_two_phase", 1e-13),
                                         ("vjp_two_phase", 1e-13),
                                         ("jvp_streamed_rel", 1e-5),
                                         ("vjp_streamed_rel", 1e-5),
                                         ("lin_streamed_rel", 1e-5)])
def test_sharded_derivatives_match_the_single_device_twins(ranks, name,
                                                           bound):
    for r in ranks:
        assert r["derivatives"][name] <= bound


@pytest.mark.parametrize("method", ["sa", "newton", "anderson"])
def test_a_nan_on_one_rank_stops_every_rank(ranks, method):
    for r in ranks:
        converged, single_converged = r["nan_shard"][method]
        assert not single_converged
        assert not converged


def test_sharded_sup_carries_a_nan_from_any_rank(ranks):
    for r in ranks:
        for at in range(len(ranks)):
            assert r["nan_shard"][f"sup_nan_on_rank_{at}"], at


def test_sharding_demo_runs_on_two_ranks():
    results = tr.spawn("sharding_demo", 2)
    for r in results:
        assert all(r["converged"])
        assert r["diffs"]["ssy"] <= 1e-9
        assert r["diffs"]["two_phase"] <= 1e-9
        assert r["diffs"]["streamed"] == 0.0
        assert r["iterations"] == results[0]["iterations"]
