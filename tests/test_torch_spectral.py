"""The spectral existence checks: the port's ``utils/spectral.py``
against the JAX package's, on the CPU in float64.

``power_iteration`` reads its stop condition once every SYNC_EVERY
iterations but reports the eigenvalue and count of the first iteration
that met it, so both equal JAX's ``lax.while_loop`` exactly on the same
operator (the same float64 sums, 1e-14 relative on the eigenvalue, the
count equal).  ``existence_check`` is held to JAX's and to a dense
eigenvalue (JAX's own tests' 1e-7), ``stability_decomposition`` to
JAX's (1e-10) and to its direct form (1e-8, JAX's), the closed forms
exactly, and the Monte Carlo exponent on JAX's damped calibration to
the decomposition and the Gaussian closed form within that test's
tolerances (1e-5 and 2e-6: Monte Carlo and O(1/T) error; the port's
draws are its own generator's, not JAX's stream).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.utils import spectral as JS
from sdfs_via_autodiff_tpu_torch.utils import spectral as PS

EIG_RTOL = 1e-14           # the same float64 power iteration
DENSE_RTOL = 1e-7          # power iteration at tol 1e-10 vs eigvals
ALG_ATOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,tol,max_iter", [(7, 1e-10, 5000),
                                            (30, 1e-13, 5000),
                                            (12, 0.0, 20)])
def test_power_iteration_matches_jax(n, tol, max_iter):
    # A random nonnegative matrix: the eigenvalue and the iteration count
    # of the first iteration that met the stop rule, or max_iter.
    rng = np.random.default_rng(n)
    A = rng.uniform(size=(n, n)) ** 4
    lam_j, it_j = jax.jit(lambda: JS.power_iteration(
        lambda v: jnp.asarray(A) @ v, (n,), tol=tol, max_iter=max_iter))()
    At = torch.as_tensor(A)
    lam_p, it_p = PS.power_iteration(lambda v: At @ v, (n,), tol=tol,
                                     max_iter=max_iter, device="cpu")
    assert isinstance(lam_p, float) and isinstance(it_p, int)
    assert it_p == int(it_j)
    np.testing.assert_allclose(lam_p, float(lam_j), rtol=EIG_RTOL)
    if max_iter < 100:
        assert it_p == max_iter


def test_power_iteration_stops_on_nan():
    # JAX's loop runs while |d| > tol |lam|: a NaN stops it at once.
    lam, it = PS.power_iteration(lambda v: v * float("nan"), (3,),
                                 device="cpu")
    assert math.isnan(lam) and it == 1


@pytest.mark.parametrize("shapes", [(4, 4, 4, 6), (5, 4, 3, 4)])
def test_existence_check_discrete_ssy(shapes):
    # tests/test_discrete_ssy.py:182: against a dense eigenvalue.
    jd = J.discretize_ssy(J.SSY(), shapes)
    pd = P.discretize_ssy(P.SSY(), shapes)
    rj = JS.existence_check(J.SSY(), jd)
    rp = PS.existence_check(P.SSY(), pd, device="cpu")
    assert rp.iterations == rj.iterations
    np.testing.assert_allclose(rp.spectral_radius, rj.spectral_radius,
                               rtol=EIG_RTOL)
    np.testing.assert_allclose(rp.stability_exponent, rj.stability_exponent,
                               rtol=EIG_RTOL)
    H = P.dense_H_ssy(P.SSY(), pd, device="cpu").numpy()
    r_dense = float(np.max(np.abs(np.linalg.eigvals(H))))
    np.testing.assert_allclose(rp.spectral_radius, r_dense, rtol=DENSE_RTOL)
    assert rp.exists_unique and rp.stability_exponent < 1
    assert "exists_unique=True" in repr(rp)


def test_existence_check_discrete_gcy():
    # tests/test_discrete_gcy.py:133.
    shapes = (3, 3, 2, 2, 3, 2)
    jd = J.discretize_gcy(J.GCY(), shapes)
    pd = P.discretize_gcy(P.GCY(), shapes)
    rj = JS.existence_check(J.GCY(), jd)
    rp = PS.existence_check(P.GCY(), pd, device="cpu")
    assert rp.iterations == rj.iterations
    np.testing.assert_allclose(rp.spectral_radius, rj.spectral_radius,
                               rtol=EIG_RTOL)
    H = P.dense_H_gcy(P.GCY(), pd, device="cpu").numpy()
    r_dense = float(np.max(np.abs(np.linalg.eigvals(H))))
    np.testing.assert_allclose(rp.spectral_radius, r_dense, rtol=DENSE_RTOL)
    assert rp.exists_unique


@pytest.mark.parametrize("family,sizes", [("ssy", (6, 6, 6, 6)),
                                          ("gcy", (3, 3, 2, 2, 3, 2))])
def test_existence_check_continuous(family, sizes):
    # tests/test_continuous_ssy.py:173: theta < 0, so existence needs
    # r(H) > 1 here; the port's factored chain is JAX's to rounding.
    jm, pm = (J.SSY(), P.SSY()) if family == "ssy" else (J.GCY(), P.GCY())
    jb, pb = ((J.build_grid_ssy, P.build_grid_ssy) if family == "ssy"
              else (J.build_grid_gcy, P.build_grid_gcy))
    rj = JS.existence_check(jm, grids=jb(jm, *sizes), quad_degree=3)
    rp = PS.existence_check(pm, grids=pb(pm, *sizes), quad_degree=3,
                            device="cpu")
    assert rp.iterations == rj.iterations
    np.testing.assert_allclose(rp.spectral_radius, rj.spectral_radius,
                               rtol=1e-12)
    assert rp.exists_unique and 0 < rp.spectral_radius
    assert rp.stability_exponent < 1


def test_existence_check_argument_checks():
    pd = P.discretize_ssy(P.SSY(), (3, 3, 3, 3))
    with pytest.raises(ValueError, match="exactly one"):
        PS.existence_check(P.SSY(), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        PS.existence_check(P.SSY(), pd, grids=(), device="cpu")
    with pytest.raises(TypeError, match="unsupported model"):
        PS.existence_check(object(), pd, device="cpu")


@pytest.mark.parametrize("family", ["ssy", "gcy"])
def test_stability_decomposition_matches_jax(family):
    # tests/test_discrete_ssy.py: S = ln beta + S_lambda + (1-1/psi) S_c
    # is exact on the chain (H = B_lam (x) M_c).
    if family == "ssy":
        shapes, jm, pm = (4, 4, 4, 6), J.SSY(), P.SSY()
        jd, pd = J.discretize_ssy(jm, shapes), P.discretize_ssy(pm, shapes)
    else:
        shapes, jm, pm = (3, 3, 2, 2, 3, 2), J.GCY(), P.GCY()
        jd, pd = J.discretize_gcy(jm, shapes), P.discretize_gcy(pm, shapes)
    dj = JS.stability_decomposition(jm, jd)
    dp = PS.stability_decomposition(pm, pd, device="cpu")
    for k in ("S", "ln_beta", "S_lambda", "S_c", "coefficient", "S_direct"):
        np.testing.assert_allclose(getattr(dp, k), getattr(dj, k), rtol=0,
                                   atol=ALG_ATOL, err_msg=k)
    np.testing.assert_allclose(dp.S, dp.S_direct, atol=1e-8)
    assert dp.exists_unique == dj.exists_unique
    assert dp.ln_beta < 0
    np.testing.assert_allclose(dp.coefficient, 1 - 1 / pm.psi)


CLOSED = [
    ("transient", dict(beta=0.999, gamma=8.89, psi=1.97, mu_c=0.0016,
                       sigma_c=0.0035, s_lam=4e-5, rho_lam=0.959)),
    ("constant_vol", dict(beta=0.999, gamma=8.89, psi=1.97, mu_c=0.0016,
                          sigma_c=0.0035, sigma=2e-4, rho=0.9, s_lam=4e-5,
                          rho_lam=0.959)),
    ("constant_vol", dict(beta=0.9987, gamma=13.01, psi=1.5, mu_c=0.0015,
                          sigma_c=0.0037, sigma=0.0, rho=0.5, s_lam=4e-4,
                          rho_lam=0.95)),
]


@pytest.mark.parametrize("name,kw", CLOSED)
def test_closed_forms_equal_jax(name, kw):
    fj = getattr(JS, f"stability_exponent_{name}")(**kw)
    fp = getattr(PS, f"stability_exponent_{name}")(**kw)
    assert dataclasses.asdict(fp) == dataclasses.asdict(fj)


def test_closed_forms_match_chain():
    # tests/test_discrete_ssy.py: the companion paper's closed forms on
    # degenerate damped calibrations where the chain converges to the
    # Gaussian formulas.
    base = dict(s_lam=4e-5, rho_lam=P.SSY().rho_lam)
    m_tr = dataclasses.replace(P.SSY(), s_lam=4e-5, s_c=0.0, s_z=0.0,
                               phi_z=0.0)
    cf = PS.stability_exponent_transient(
        beta=m_tr.beta, gamma=m_tr.gamma, psi=m_tr.psi, mu_c=m_tr.mu_c,
        sigma_c=m_tr.phi_c, **base)
    dec = PS.stability_decomposition(
        m_tr, P.discretize_ssy(m_tr, (8, 1, 1, 1)), device="cpu")
    np.testing.assert_allclose(dec.S_c, cf.S_c, atol=1e-12)
    np.testing.assert_allclose(dec.S_lambda, cf.S_lambda, atol=1e-8)
    np.testing.assert_allclose(dec.S, cf.S, atol=1e-8)
    assert cf.exists_unique == dec.exists_unique
    m_cv = dataclasses.replace(P.SSY(), s_lam=4e-5, s_c=0.0, s_z=0.0,
                               phi_z=2e-4, rho=0.9)
    cf_cv = PS.stability_exponent_constant_vol(
        beta=m_cv.beta, gamma=m_cv.gamma, psi=m_cv.psi, mu_c=m_cv.mu_c,
        sigma_c=m_cv.phi_c, sigma=m_cv.phi_z, rho=m_cv.rho, **base)
    dec_cv = PS.stability_decomposition(
        m_cv, P.discretize_ssy(m_cv, (8, 1, 1, 12)), device="cpu")
    np.testing.assert_allclose(dec_cv.S_c, cf_cv.S_c, atol=1e-7)
    np.testing.assert_allclose(dec_cv.S, cf_cv.S, atol=1e-7)


def test_stability_exponent_mc_triple_crosscheck():
    # tests/test_discrete_ssy.py:314-333: on a damped calibration three
    # routes agree: the chain decomposition, the path Monte Carlo
    # estimator and the Gaussian long-run formula for S_lambda.
    m = dataclasses.replace(P.SSY(), s_lam=4e-5, s_z=math.sqrt(0.0039) / 10,
                            s_c=math.sqrt(0.0096) / 10, phi_z=1e-5)
    dec = PS.stability_decomposition(m, P.discretize_ssy(m, (8, 8, 8, 12)),
                                     device="cpu")
    mc = PS.stability_exponent_mc(m, T=10_000, N=2_000, seed=0,
                                  device="cpu")
    S_lam_exact = m.theta / 2 * m.s_lam ** 2 / (1 - m.rho_lam) ** 2
    np.testing.assert_allclose(dec.S_lambda, S_lam_exact, atol=1e-8)
    np.testing.assert_allclose(mc["S"], dec.S, atol=1e-5)
    np.testing.assert_allclose(mc["S_lambda"], S_lam_exact, atol=2e-6)
    assert (mc["T"], mc["N"]) == (10_000, 2_000)


def test_stability_exponent_mc_chunks_and_seed():
    # T off the chunk size (a last partial chunk), a GCY model, and the
    # seed: the same seed gives the same estimate, another seed another.
    m = P.GCY()
    a = PS.stability_exponent_mc(m, T=PS.MC_CHUNK + 7, N=50, seed=3,
                                 device="cpu")
    b = PS.stability_exponent_mc(m, T=PS.MC_CHUNK + 7, N=50, seed=3,
                                 device="cpu")
    c = PS.stability_exponent_mc(m, T=PS.MC_CHUNK + 7, N=50, seed=4,
                                 device="cpu")
    assert a == b and a["S"] != c["S"]
    assert all(math.isfinite(a[k]) for k in ("S", "S_lambda", "S_c"))
