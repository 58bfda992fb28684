"""The de Groot specification: the port's ``operators/degroot.py`` and
``drivers.degroot_fixed_point`` against the JAX package's, on the CPU
in float64, mirroring JAX's ``tests/test_degroot.py``.

Tolerances: the operators agree with JAX's on the same inputs to 1e-12
relative (the same float64 chain; (.)^theta with theta ~ -16 and -36
amplifies rounding by |theta|) and with the dense oracle to 1e-10
(JAX's); the log tier agrees with the w tier to 1e-11 (JAX's); solved
fixed points agree with JAX's to 1e-9 on ln g (each Newton solve stops
on a step below tol; the tolerance carries the fixed-point
amplification of the last step); the closed-form h = 1 mapping holds to
1e-8 (JAX's).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.operators import degroot as JD
from sdfs_via_autodiff_tpu_torch.operators import degroot as PD
from sdfs_via_autodiff_tpu_torch.utils.checkpoint import load_solution

SHAPES = (4, 3, 5, 6)
OP_RTOL = 1e-12
ORACLE_RTOL = 1e-10
SOLVE_ATOL = 1e-9


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return (P.SSY(), P.discretize_ssy(P.SSY(), SHAPES),
            J.discretize_ssy(J.SSY(), SHAPES))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _dense_K_ssy(model, disc):
    """Dense K~ oracle: Kron of plain transition factors x A2 A3 tilt."""
    from sdfs_via_autodiff_tpu_torch.operators.discrete_ssy import (
        _ssy_factors)
    _, A2, A3 = (a.numpy() for a in _ssy_factors(model, disc))
    K = np.einsum("lL,kK,iI,jJ->lkijLKIJ", disc.h_lam_Q.numpy(),
                  disc.h_c_Q.numpy(), disc.h_z_Q.numpy(), disc.z_P.numpy())
    K = K * A2[None, :, None, None, None, None, None, None] \
        * A3[None, None, :, :, None, None, None, None]
    n = int(np.prod(disc.shapes))
    return K.reshape(n, n)


@pytest.mark.parametrize("h", [None, 0.99])
def test_operator_matches_dense_oracle_and_jax(setup, h):
    model, pd, jd = setup
    rng = np.random.default_rng(0)
    g = np.exp(rng.standard_normal(SHAPES))
    T = PD.T_degroot_factory(model, pd, h=h, device="cpu")
    got = T(_t(g)).numpy()
    theta, beta = model.theta, model.beta
    hb = (1.0 if h is None else h) * beta
    k = (_dense_K_ssy(model, pd) @ g.reshape(-1)).reshape(SHAPES)
    np.testing.assert_allclose(got, (1 - hb + hb * k ** (1 / theta)) ** theta,
                               rtol=ORACLE_RTOL)
    Tj = JD.T_degroot_factory(J.SSY(), jd, h=h)
    np.testing.assert_allclose(got, np.asarray(Tj(jnp.asarray(g))),
                               rtol=OP_RTOL)


def test_h1_no_lambda_maps_to_standard_fixed_point():
    # At h == 1 with no preference shocks g* = ((1-beta) w*)^theta.
    model = dataclasses.replace(P.SSY(), s_lam=0.0)
    disc = P.discretize_ssy(model, SHAPES)
    w_star = P.solve(P.T_ssy_factory(model, disc, device="cpu"),
                     torch.full(SHAPES, 800.0, dtype=torch.float64),
                     method="newton", tol=1e-11).x
    T = PD.T_degroot_factory(model, disc, device="cpu")
    g0 = torch.full(SHAPES, float(((1 - model.beta) * 800.0) ** model.theta),
                    dtype=torch.float64)
    res = P.solve(T, g0, method="newton", tol=1e-13)
    assert res.converged
    expected = ((1 - model.beta) * w_star) ** model.theta
    np.testing.assert_allclose(res.x.numpy(), expected.numpy(), rtol=1e-8)


def test_log_space_consistent_and_matches_jax(setup):
    model, pd, jd = setup
    rng = np.random.default_rng(1)
    g = np.exp(rng.standard_normal(SHAPES)) * 1e-3
    T = PD.T_degroot_factory(model, pd, device="cpu")
    T_log = PD.T_degroot_factory(model, pd, space="log", device="cpu")
    out = T_log(_t(np.log(g))).numpy()
    np.testing.assert_allclose(np.exp(out), T(_t(g)).numpy(), rtol=1e-11)
    Tj = JD.T_degroot_factory(J.SSY(), jd, space="log")
    np.testing.assert_allclose(out, np.asarray(Tj(jnp.log(g))), rtol=0,
                               atol=OP_RTOL * np.abs(out).max())


def test_monotone(setup):
    model, pd, _ = setup
    T = PD.T_degroot_factory(model, pd, device="cpu")
    g = _t(np.exp(np.random.default_rng(2).standard_normal(SHAPES)))
    assert bool((T(g + 0.5) >= T(g) - 1e-14).all())


def test_state_dependent_discount_solves(setup):
    model, pd, jd = setup
    # a_t rises with z (procyclical patience), values in (0, 1/beta).
    z = pd.z_states.numpy()
    z_dev = z - z.mean()
    h = 1.0 + 40.0 * z_dev[None, None, :, :] / (1 + abs(40.0 * z_dev.max()))
    h = np.clip(np.broadcast_to(h, SHAPES), 0.9, 1.0004)
    T = PD.T_degroot_factory(model, pd, h=torch.as_tensor(h), device="cpu")
    rep = PD.existence_check_degroot(model, pd, h=h, device="cpu")
    rep_j = JD.existence_check_degroot(J.SSY(), jd, h=jnp.asarray(h))
    assert rep.exists_unique and rep.iterations == rep_j.iterations
    np.testing.assert_allclose(rep.S_alt, rep_j.S_alt, rtol=1e-12)
    g0 = torch.full(SHAPES, float((0.001 * 800.0) ** model.theta),
                    dtype=torch.float64)
    res = P.solve(T, g0, method="newton", tol=1e-12)
    assert res.converged
    np.testing.assert_allclose(T(res.x).numpy(), res.x.numpy(), atol=1e-11)
    Tj = JD.T_degroot_factory(J.SSY(), jd, h=jnp.asarray(h))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(J.solve(
        Tj, jnp.asarray(g0.numpy()), method="newton", tol=1e-12).x),
        rtol=SOLVE_ATOL)


@pytest.mark.parametrize("h", [1.0 / P.SSY().beta, 0.0, -0.5,
                               np.array([0.5, 1.2])])
def test_h_validation(setup, h):
    model, pd, _ = setup
    if isinstance(h, np.ndarray):
        h = np.broadcast_to(h, SHAPES[:-1] + (2,))
        h = np.concatenate([h, np.full(SHAPES[:-1] + (4,), 0.9)], axis=-1)
    with pytest.raises(ValueError, match="1/beta"):
        PD.T_degroot_factory(model, pd, h=h, device="cpu")


def test_transcendentals_accepts_accurate_only(setup):
    model, pd, _ = setup
    PD.T_degroot_factory(model, pd, transcendentals="accurate", device="cpu")
    for bad in ("fast", "poly"):
        with pytest.raises(ValueError, match="only 'accurate'"):
            PD.T_degroot_factory(model, pd, transcendentals=bad,
                                 device="cpu")
    grids = P.build_grid_ssy(model, 3, 3, 3, 3)
    with pytest.raises(ValueError, match="only 'accurate'"):
        PD.T_degroot_continuous_factory(model, grids, quad_degree=3,
                                        transcendentals="fast", device="cpu")


@pytest.mark.parametrize("h", [None, 0.97])
def test_existence_report_matches_jax(setup, h):
    model, pd, jd = setup
    rep = PD.existence_check_degroot(model, pd, h=h, device="cpu")
    rj = JD.existence_check_degroot(J.SSY(), jd, h=h)
    assert rep.exists_unique and rep.iterations == rj.iterations
    np.testing.assert_allclose(rep.spectral_radius, rj.spectral_radius,
                               rtol=1e-14)
    np.testing.assert_allclose(rep.S_alt, rj.S_alt, rtol=1e-12)
    expected = float(np.log(model.beta) + np.log(1.0 if h is None else h)
                     + np.log(rep.spectral_radius) / model.theta)
    np.testing.assert_allclose(rep.S_alt, expected, rtol=1e-12)
    with pytest.raises(ValueError, match="exactly one"):
        PD.existence_check_degroot(model, device="cpu")


def test_gcy_degroot_smoke():
    shapes = (3, 3, 3, 3, 3, 3)
    model = P.GCY()
    disc = P.discretize_gcy(model, shapes)
    rep = PD.existence_check_degroot(model, disc, device="cpu")
    rj = JD.existence_check_degroot(J.GCY(), J.discretize_gcy(J.GCY(),
                                                              shapes))
    assert rep.exists_unique
    np.testing.assert_allclose(rep.spectral_radius, rj.spectral_radius,
                               rtol=1e-14)
    T = PD.T_degroot_factory(model, disc, device="cpu")
    g0 = torch.full(shapes, float(((1 - model.beta) * 800.0) ** model.theta),
                    dtype=torch.float64)
    res = P.solve(T, g0, method="newton", tol=1e-12)
    assert res.converged
    np.testing.assert_allclose(T(res.x).numpy(), res.x.numpy(), atol=1e-11)


def test_log_tier_f32_per_axis_lse():
    # The per-axis LSE chain keeps the float32 log tier exact in
    # structure at ln g ~ 110 (the GCY h = 1 scale): float32 agrees with
    # float64 to ~float32 eps relative (JAX's 2e-6).
    model = P.GCY()
    sizes = (3, 3, 3, 3, 4, 3)
    g64 = P.build_grid_gcy(model, *sizes)
    T64 = PD.T_degroot_continuous_factory(model, g64, quad_degree=3,
                                          space="log", device="cpu")
    T32 = PD.T_degroot_continuous_factory(model, g64, quad_degree=3,
                                          space="log", dtype=torch.float32,
                                          device="cpu")
    ell = 110.0 + np.random.default_rng(0).standard_normal(sizes)
    out64 = T64(_t(ell)).numpy()
    out32 = T32(_t(ell).float()).numpy()
    assert out32.dtype == np.float32
    np.testing.assert_allclose(out32, out64, rtol=2e-6)
    Tj = JD.T_degroot_continuous_factory(J.GCY(), J.build_grid_gcy(
        J.GCY(), *sizes), quad_degree=3, space="log")
    np.testing.assert_allclose(out64, np.asarray(Tj(jnp.asarray(ell))),
                               rtol=OP_RTOL)


def test_degroot_driver_matches_jax():
    # Both kinds through the two-stage log-tier recipe (SA to 1e-6, then
    # Newton), the solution in ln g, against JAX's driver.
    model = P.SSY()
    sol = P.degroot_fixed_point(model, (4, 3, 4, 5), kind="discrete",
                                tol=1e-11, device="cpu")
    ref = J.degroot_fixed_point(J.SSY(), (4, 3, 4, 5), kind="discrete",
                                tol=1e-11)
    assert sol.converged and sol.space == "log" and sol.grids is None
    np.testing.assert_allclose(sol.log_g_star.numpy(),
                               np.asarray(ref.log_g_star), rtol=0,
                               atol=SOLVE_ATOL)
    lo, hi = float(sol.log_g_star.min()), float(sol.log_g_star.max())
    assert model.theta * np.log(0.003 * 2000) < lo <= hi \
        < model.theta * np.log(0.0005 * 200)
    sol_c = P.degroot_fixed_point(model, (4, 4, 4, 5), kind="continuous",
                                  quad_degree=3, h=0.98, tol=1e-11,
                                  device="cpu")
    ref_c = J.degroot_fixed_point(J.SSY(), (4, 4, 4, 5), kind="continuous",
                                  quad_degree=3, h=0.98, tol=1e-11)
    assert sol_c.converged and len(sol_c.grids) == 4
    assert bool(torch.isfinite(sol_c.g_star).all())
    np.testing.assert_allclose(sol_c.log_g_star.numpy(),
                               np.asarray(ref_c.log_g_star), rtol=0,
                               atol=SOLVE_ATOL)
    with pytest.raises(ValueError, match="kind must be"):
        P.degroot_fixed_point(model, (3, 3, 3, 3), kind="sparse",
                              device="cpu")


def test_degroot_w_space_driver():
    # space="w" solves in g directly from the mapped start (no SA stage).
    sol = P.degroot_fixed_point(P.SSY(), (3, 3, 3, 3), space="w", h=0.97,
                                tol=1e-12, device="cpu")
    ref = J.degroot_fixed_point(J.SSY(), (3, 3, 3, 3), space="w", h=0.97,
                                tol=1e-12)
    assert sol.converged and sol.space == "w"
    np.testing.assert_allclose(sol.log_g_star.numpy(),
                               np.asarray(ref.log_g_star), rtol=0,
                               atol=SOLVE_ATOL)


def test_degroot_checkpoint_roundtrip(tmp_path):
    from sdfs_via_autodiff_tpu.utils.checkpoint import load_solution as jload
    path = str(tmp_path / "degroot.npz")
    sol = P.degroot_fixed_point(P.SSY(), (3, 3, 3, 3), tol=1e-10, h=0.99,
                                checkpoint_path=path, device="cpu")
    for ckpt in (load_solution(path), jload(path)):
        assert ckpt.meta["spec"] == "degroot"
        assert ckpt.meta["field"] == "log_g" and ckpt.meta["h"] == 0.99
        assert ckpt.meta["shapes"] == [3, 3, 3, 3] and ckpt.grids == ()
        np.testing.assert_array_equal(ckpt.w_star, sol.log_g_star.numpy())


def test_continuous_matches_dense_oracle_and_jax():
    from sdfs_via_autodiff_tpu_torch.operators.continuous_ssy import (
        _factored_arrays_ssy)
    model = P.SSY()
    sizes = (4, 3, 4, 5)
    grids = P.build_grid_ssy(model, *sizes)
    arrs = _factored_arrays_ssy(model, grids, 3, None, tilt_lambda=False)
    kappa = np.exp(arrs["log_A2"].numpy()[:, None]
                   + arrs["log_A3"].numpy()[None, :])
    K = np.einsum("lL,kK,iI,ijJ->lkijLKIJ", arrs["P_lam"].numpy(),
                  arrs["P_c"].numpy(), arrs["P_hz"].numpy(),
                  arrs["P_z"].numpy())
    K = K * kappa[None, :, None, :, None, None, None, None]
    n = int(np.prod(sizes))
    T = PD.T_degroot_continuous_factory(model, grids, quad_degree=3,
                                        device="cpu")
    g = np.exp(np.random.default_rng(3).standard_normal(sizes))
    theta, beta = model.theta, model.beta
    k = (K.reshape(n, n) @ g.reshape(-1)).reshape(sizes)
    got = T(_t(g)).numpy()
    np.testing.assert_allclose(got, (1 - beta + beta * k ** (1 / theta))
                               ** theta, rtol=ORACLE_RTOL)
    Tj = JD.T_degroot_continuous_factory(
        J.SSY(), J.build_grid_ssy(J.SSY(), *sizes), quad_degree=3)
    np.testing.assert_allclose(got, np.asarray(Tj(jnp.asarray(g))),
                               rtol=OP_RTOL)


def test_continuous_log_space_and_solve():
    model = P.SSY()
    sizes = (5, 5, 5, 6)
    grids = P.build_grid_ssy(model, *sizes)
    T = PD.T_degroot_continuous_factory(model, grids, quad_degree=3,
                                        device="cpu")
    T_log = PD.T_degroot_continuous_factory(model, grids, quad_degree=3,
                                            space="log", device="cpu")
    g = _t(np.exp(np.random.default_rng(4).standard_normal(sizes)) * 1e-3)
    np.testing.assert_allclose(torch.exp(T_log(torch.log(g))).numpy(),
                               T(g).numpy(), rtol=1e-11)
    # At h == 1 the continuous existence margin is razor-thin: solve with
    # a discount margin (JAX's test).
    T_h = PD.T_degroot_continuous_factory(model, grids, quad_degree=3,
                                          h=0.98, device="cpu")
    g0 = torch.full(sizes, float(((1 - model.beta) * 800.0) ** model.theta),
                    dtype=torch.float64)
    res = P.solve(T_h, g0, method="newton", tol=1e-12)
    assert res.converged
    np.testing.assert_allclose(T_h(res.x).numpy(), res.x.numpy(),
                               atol=1e-11)


def test_continuous_gcy_matches_dense_oracle_and_jax():
    # The conditioned chain: P_zpi rides current (h_zpi=y, z_pi=b), P_z
    # rides current (h_z=i, z=j, z_pi=b).
    from sdfs_via_autodiff_tpu_torch.operators.continuous_gcy import (
        _factored_arrays_gcy)
    model = P.GCY()
    sizes = (2, 2, 2, 2, 3, 2)
    grids = P.build_grid_gcy(model, *sizes)
    arrs = _factored_arrays_gcy(model, grids, 3, None, tilt_lambda=False)
    kappa = np.exp(arrs["log_A2"].numpy()[:, None]
                   + arrs["log_A3"].numpy()[None, :])
    K = np.einsum("lL,kK,iI,yY,ybB,ijbJ->lkiyjbLKIYJB",
                  *(arrs[k].numpy() for k in ("P_lam", "P_c", "P_hz",
                                              "P_hzpi", "P_zpi", "P_z")))
    K = K * kappa[None, :, None, None, :, None,
                  None, None, None, None, None, None]
    n = int(np.prod(sizes))
    T = PD.T_degroot_continuous_factory(model, grids, quad_degree=3,
                                        device="cpu")
    g = np.exp(np.random.default_rng(5).standard_normal(sizes))
    theta, beta = model.theta, model.beta
    k = (K.reshape(n, n) @ g.reshape(-1)).reshape(sizes)
    got = T(_t(g)).numpy()
    np.testing.assert_allclose(got, (1 - beta + beta * k ** (1 / theta))
                               ** theta, rtol=ORACLE_RTOL)
    Tj = JD.T_degroot_continuous_factory(
        J.GCY(), J.build_grid_gcy(J.GCY(), *sizes), quad_degree=3)
    np.testing.assert_allclose(got, np.asarray(Tj(jnp.asarray(g))),
                               rtol=OP_RTOL)


def test_continuous_gcy_degroot_smoke():
    # At h == 1 the GCY fixed point lives at g ~ e^97..e^124: the log
    # tier, SA to 1e-6 then Newton, all in ln g.
    model = P.GCY()
    sizes = (3, 3, 3, 3, 4, 3)
    grids = P.build_grid_gcy(model, *sizes)
    T_log = PD.T_degroot_continuous_factory(model, grids, quad_degree=3,
                                            space="log", device="cpu")
    ell0 = torch.full(sizes, float(model.theta * np.log(
        (1 - model.beta) * 800.0)), dtype=torch.float64)
    pre = P.solve(T_log, ell0, method="successive_approx", tol=1e-6,
                  max_iter=5000)
    assert pre.converged
    res = P.solve(T_log, pre.x, method="newton", tol=1e-12)
    assert res.converged
    np.testing.assert_allclose(T_log(res.x).numpy(), res.x.numpy(),
                               atol=1e-11)
    assert 90.0 < float(res.x.min()) < float(res.x.max()) < 130.0
