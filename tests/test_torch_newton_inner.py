"""The port's Newton inner solvers, ``tangent_T`` and ``gd`` vs the JAX
package's, in float64 on the CPU.

Newton with ``inner`` = "bicgstab", "gmres" and "dense" reaches JAX's
fixed point (same ``inner``) to 1e-10 on an affine map and on the SSY
log operator at (6,6,6,6); with the float32 operator as ``tangent_T``
the float64 residual falls to 1e-12 and the fixed point agrees with
JAX's float64-tangent solve to 1e-10 (the bars of JAX's
``test_newton_tangent_T_iterative_refinement``).  ``gd`` (L-BFGS) holds
JAX's fixed point on the affine map to 1e-6 (JAX's
``test_gradient_solver``) and reaches its tolerance on SSY.  The GMRES
of the port keeps ``jax.scipy.sparse.linalg.gmres``'s contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.solvers import gradient_solver as jax_gd
from sdfs_via_autodiff_tpu.solvers import newton_solver as jax_newton

A = np.array([[0.5, 0.2], [0.1, 0.6]])
B = np.array([1.0, 2.0])
SSY_SHAPES = (6, 6, 6, 6)
FIXED_POINT_ATOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(name, dtype=torch.float64):
    """(port T, JAX T, port x0, JAX x0) of the named problem."""
    if name == "affine":
        At, Bt = (torch.as_tensor(a, dtype=dtype) for a in (A, B))
        Aj, Bj = jnp.asarray(A), jnp.asarray(B)
        jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
        return (lambda x: At @ x + Bt,
                lambda x: Aj.astype(jdtype) @ x + Bj.astype(jdtype),
                torch.zeros(2, dtype=dtype), jnp.zeros(2, jdtype))
    disc_p = P.discretize_ssy(P.SSY(), SSY_SHAPES)
    disc_j = J.discretize_ssy(J.SSY(), SSY_SHAPES)
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    x0 = np.full(SSY_SHAPES, np.log(800.0))
    return (P.T_ssy_factory(P.SSY(), disc_p, space="log", dtype=dtype,
                            device="cpu"),
            J.T_ssy_factory(J.SSY(), disc_j, space="log", dtype=jdtype),
            torch.as_tensor(x0, dtype=dtype), jnp.asarray(x0, jdtype))


@pytest.mark.parametrize("problem", ["affine", "ssy"])
@pytest.mark.parametrize("inner", ["bicgstab", "gmres", "dense"])
def test_newton_inner_variants_match_jax(problem, inner):
    Tp, Tj, xp, xj = _problem(problem)
    got = P.newton_solver(Tp, xp, tol=1e-12, inner=inner)
    want = jax_newton(Tj, xj, tol=1e-12, inner=inner)
    assert got.converged and bool(want.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=FIXED_POINT_ATOL)


@pytest.mark.parametrize("problem", ["affine", "ssy"])
def test_tangent_T_refinement_reaches_f64(problem):
    # The float64 operator gives the residual and the safeguard, the
    # float32 one the Krylov matvecs: the refinement still reaches float64
    # accuracy and JAX's float64-tangent fixed point.
    T64, Tj, x64, xj = _problem(problem)
    T32 = _problem(problem, torch.float32)[0]
    got = P.solve(T64, x64, method="newton", tol=1e-12, tangent_T=T32)
    want = jax_newton(Tj, xj, tol=1e-12)
    assert got.converged and got.residual <= 1e-12
    assert got.x.dtype == torch.float64
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=FIXED_POINT_ATOL)


def test_tangent_T_linearizes_the_twin_in_float32():
    # The Krylov matvecs go through tangent_T.twin at x in float32; T
    # itself (the kernels, on the card) is only applied.
    Tp, _, x0, _ = _problem("ssy")
    seen = []

    def kernel(y):
        seen.append(("kernel", y.dtype))
        return Tp(y.double()).float()

    def twin(y):
        seen.append(("twin", y.dtype))
        return _problem("ssy", torch.float32)[0](y)

    kernel.twin = twin
    res = P.newton_solver(Tp, x0, tol=1e-12, tangent_T=kernel, max_iter=2)
    assert res.x.dtype == torch.float64
    assert ("twin", torch.float32) in seen and not any(
        k == "kernel" for k, _ in seen)


def test_dense_safeguard_from_hostile_start():
    # As JAX's test_newton_dense_safeguard_from_hostile_start: a far start
    # whose raw Newton step leaves the domain converges through the
    # plain-step fallback.
    disc = P.discretize_ssy(P.SSY(), (3, 3, 3, 3))
    T = P.T_ssy_factory(P.SSY(), disc, device="cpu")
    res = P.solve(T, torch.full((3, 3, 3, 3), 2.0, dtype=torch.float64),
                  method="newton", inner="dense", tol=1e-11)
    assert res.converged and bool(torch.isfinite(res.x).all())


def test_unknown_inner_raises_as_jax():
    Tp, Tj, xp, xj = _problem("affine")
    with pytest.raises(ValueError, match="unknown inner"):
        P.newton_solver(Tp, xp, inner="cg")
    with pytest.raises(ValueError, match="unknown inner"):
        jax_newton(Tj, xj, inner="cg")


def test_dense_refuses_tangent_T_where_jax_ignores_it():
    # A known defect of the JAX package: inner="dense" ignores tangent_T
    # without a word.  The port refuses the combination.
    Tp, Tj, xp, xj = _problem("affine")
    T32p, T32j = (_problem("affine", torch.float32)[i] for i in (0, 1))
    want = jax_newton(Tj, xj, tol=1e-12, inner="dense", tangent_T=T32j)
    assert bool(want.converged)
    with pytest.raises(ValueError, match="tangent_T"):
        P.newton_solver(Tp, xp, tol=1e-12, inner="dense", tangent_T=T32p)


@pytest.mark.parametrize("restart,maxiter", [(20, None), (5, 1), (5, 3)])
def test_gmres_keeps_jax_scipy_contract(restart, maxiter):
    # Same Krylov spaces, same least-squares corrections: after the same
    # number of restart cycles the iterates agree.
    rng = np.random.default_rng(0)
    n = 40
    M = rng.standard_normal((n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    b = rng.standard_normal(n)
    Mt, Mj = torch.as_tensor(M), jnp.asarray(M)
    got, _ = P.gmres(lambda v: Mt @ v, torch.as_tensor(b), tol=1e-12,
                     restart=restart, maxiter=maxiter)
    want, _ = jax.scipy.sparse.linalg.gmres(lambda v: Mj @ v,
                                            jnp.asarray(b), tol=1e-12,
                                            restart=restart, maxiter=maxiter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)
    if maxiter is None:
        assert np.linalg.norm(M @ got.numpy() - b) <= 1e-12 * np.linalg.norm(b)


def test_gmres_keeps_float32_vectors_and_stops_at_atol():
    rng = np.random.default_rng(1)
    n = 64
    M = torch.as_tensor(rng.standard_normal((n, n)) / (2.0 * np.sqrt(n))
                        + np.eye(n), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    x, steps = P.gmres(lambda v: M @ v, b, atol=1e-3, tol=0.0)
    assert x.dtype == torch.float32 and steps > 0
    assert float(torch.linalg.vector_norm(M @ x - b)) <= 1e-3
    x, steps = P.gmres(lambda v: M @ v, b,
                       atol=torch.tensor(float("inf"), dtype=torch.float64))
    assert steps == 0 and not bool(x.any())


def test_gradient_solver_matches_jax_on_the_affine_map():
    Tp, Tj, xp, xj = _problem("affine")
    got = P.gradient_solver(Tp, xp, tol=1e-6, max_iter=500)
    want = jax_gd(Tj, xj, tol=1e-6, max_iter=500)
    assert got.converged and bool(want.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-6)
    true_r = float(torch.amax(torch.abs(Tp(got.x) - got.x)))
    np.testing.assert_allclose(true_r, got.residual, rtol=1e-10)


def test_gradient_solver_reaches_tol_on_ssy():
    disc = P.discretize_ssy(P.SSY(), (4, 4, 4, 6))
    T = P.T_ssy_factory(P.SSY(), disc, space="log", device="cpu")
    x0 = torch.full((4, 4, 4, 6), np.log(800.0), dtype=torch.float64)
    res = P.solve(T, x0, method="gd", tol=1e-4)
    assert res.converged and res.residual <= 1e-4
    assert res.residual == float(torch.amax(torch.abs(T(res.x) - res.x)))


def test_solver_registry_has_gd():
    assert P.solvers.SOLVERS["gd"] is P.gradient_solver
    assert set(P.solvers.SOLVERS) == set(J.solvers.SOLVERS)
    T = lambda x: 0.5 * x + 1.0
    x0 = torch.zeros(3, dtype=torch.float64)
    # The shim calls gd without ``verbose``, as JAX's does.
    np.testing.assert_allclose(P.solver(T, x0, algorithm="gd").numpy(), 2.0,
                               rtol=0, atol=1e-4)
