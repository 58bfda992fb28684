"""Continuous-SSY host algebra and operator of the PyTorch port vs the JAX
package, in float64 on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Grids agree to a few ulp (XLA's compiled ``jnp.linspace`` fuses and
reassociates its products, so single points round apart); everything
built from the same grids — expectation matrices, the factored operator
in w space, log space and with the log-linear baseline folded — agrees
to 1e-12 (relative in w space, where values are ~700).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.operators import continuous_common as jcc
from sdfs_via_autodiff_tpu.operators import continuous_ssy as jcs
from sdfs_via_autodiff_tpu.ops.grids import build_grid_gcy as jax_grid_gcy
from sdfs_via_autodiff_tpu.ops.grids import build_grid_ssy as jax_grid_ssy
from sdfs_via_autodiff_tpu.ops.quadrature import gauss_hermite_normal
from sdfs_via_autodiff_tpu_torch.operators import continuous_common as pcc
from sdfs_via_autodiff_tpu_torch.operators import continuous_ssy as pcs

SIZES = [(4, 4, 4, 5), (6, 6, 6, 8)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(sizes):
    """JAX's float64 grids and the same numbers as port tensors."""
    g = jax_grid_ssy(J.SSY(), *sizes)
    return g, P.grids_from_numpy([np.asarray(x) for x in g])


def _ulp_close(got, want, ulps=4):
    """Equal to ``ulps`` units in the last place of the largest |want|,
    in want's dtype."""
    tol = ulps * float(np.spacing(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("sizes", SIZES + [(20, 20, 20, 20), (1, 3, 2, 7)])
def test_ssy_grids_match_jax(sizes):
    for got, want in zip(P.build_grid_ssy(P.SSY(), *sizes),
                         jax_grid_ssy(J.SSY(), *sizes)):
        assert got.dtype == torch.float64
        _ulp_close(got.numpy(), want)
    # float32 grids: the rounded float64 grid; JAX computes in float32,
    # within a few float32 ulp of the grid's end points.
    for got, want in zip(P.build_grid_ssy(P.SSY(), *sizes,
                                          dtype=torch.float32),
                         jax_grid_ssy(J.SSY(), *sizes, dtype=jnp.float32)):
        assert got.dtype == torch.float32
        _ulp_close(got.numpy(), np.asarray(want, np.float32))


def test_gcy_grids_and_mesh_match_jax():
    got = P.build_grid_gcy(P.GCY(), 4, 3, 3, 3, 4, 3)
    want = jax_grid_gcy(J.GCY(), 4, 3, 3, 3, 4, 3)
    for g, w in zip(got, want):
        _ulp_close(g.numpy(), w)
    mesh = P.ops.flatten_mesh(got[:3])
    assert tuple(mesh.shape) == (4 * 3 * 3, 3)
    np.testing.assert_array_equal(mesh[5].numpy(),
                                  [got[0][0], got[1][1], got[2][2]])


def test_hat_basis_matches_jax():
    rng = np.random.default_rng(0)
    grid = np.linspace(-1.0, 2.0, 7)
    points = rng.uniform(-1.5, 2.5, (3, 11))         # out of range clamps
    want = np.asarray(jcc.hat_basis(jnp.asarray(grid), jnp.asarray(points)))
    got = pcc.hat_basis(torch.as_tensor(grid), torch.as_tensor(points))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=0, atol=1e-15)


@pytest.mark.parametrize("sizes", SIZES)
def test_expectation_matrices_match_jax(sizes):
    jg, pg = _grids(sizes)
    want = jcs._factored_arrays_ssy(J.SSY(), jg, 5)
    got = pcs._factored_arrays_ssy(P.SSY(), pg, 5)
    for k in ("P_lam", "P_c", "P_hz", "P_z", "log_A2", "log_A3"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12, atol=1e-300, err_msg=k)
    # expectation_matrix itself on a batched mean and array scale.
    eta, omega = (np.asarray(a) for a in gauss_hermite_normal(5))
    rng = np.random.default_rng(1)
    mean = rng.uniform(-0.1, 0.1, (3, len(jg[3])))
    scale = rng.uniform(0.01, 0.05, (3, 1))
    w = jcc.expectation_matrix(jg[3], jnp.asarray(mean), jnp.asarray(scale),
                               jnp.asarray(eta), jnp.asarray(omega))
    p = pcc.expectation_matrix(pg[3], torch.as_tensor(mean),
                               torch.as_tensor(scale), torch.as_tensor(eta),
                               torch.as_tensor(omega))
    np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=0, atol=1e-12)


def test_normalize_and_profiles_match_jax():
    rng = np.random.default_rng(2)
    Pm = rng.uniform(0.0, 1.0, (3, 5, 5))
    nxt, cur = rng.standard_normal(5), rng.standard_normal((3, 5))
    np.testing.assert_allclose(
        pcc.normalize_expectation_matrix(torch.as_tensor(Pm), nxt, cur, -16.0),
        jcc.normalize_expectation_matrix(Pm, nxt, cur, -16.0), rtol=1e-12)
    field = rng.standard_normal((3, 4, 5))
    c_p, prof_p = pcc.additive_profiles(torch.as_tensor(field))
    c_j, prof_j = jcc.additive_profiles(field)
    assert c_p == c_j
    for a, b in zip(prof_p, prof_j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("space,baseline", [("w", None), ("log", None),
                                            ("log", "loglinear")])
@pytest.mark.parametrize("sizes", SIZES)
def test_T_ssy_continuous_matches_jax(sizes, space, baseline):
    jg, pg = _grids(sizes)
    rng = np.random.default_rng(3)
    ell = np.log(700.0) + 0.05 * rng.standard_normal(sizes)
    x = np.exp(ell) if space == "w" else ell
    T_j = jcs.T_ssy_continuous_factory(J.SSY(), jg, space=space,
                                       baseline=baseline)
    T_p = P.T_ssy_continuous_factory(P.SSY(), pg, space=space,
                                     baseline=baseline, device="cpu")
    want = np.asarray(T_j(jnp.asarray(x)))
    got = T_p(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12 if space == "w" else 0,
                               atol=0 if space == "w" else 1e-12)
    if baseline:
        np.testing.assert_allclose(T_p.baseline_log_w.numpy(),
                                   np.asarray(T_j.baseline_log_w), rtol=0,
                                   atol=1e-12)


def test_profile_baseline_and_next_state_match_jax():
    jg, pg = _grids((4, 4, 4, 5))
    rng = np.random.default_rng(4)
    const, profs = jcc.additive_profiles(
        np.log(700.0) + 0.05 * rng.standard_normal((4, 4, 4, 5)))
    ell = np.log(700.0) + 0.05 * rng.standard_normal((4, 4, 4, 5))
    T_j = jcs.T_ssy_continuous_factory(J.SSY(), jg, space="log",
                                       baseline=(const, profs))
    T_p = P.T_ssy_continuous_factory(P.SSY(), pg, space="log",
                                     baseline=(const, profs), device="cpu")
    np.testing.assert_allclose(T_p(torch.as_tensor(ell)).numpy(),
                               np.asarray(T_j(jnp.asarray(ell))), rtol=0,
                               atol=1e-12)
    x, shocks = rng.standard_normal((4, 6)) * 0.01, rng.standard_normal((4, 6))
    np.testing.assert_allclose(
        pcs.next_state_ssy(P.SSY(), torch.as_tensor(x),
                           torch.as_tensor(shocks)).numpy(),
        np.asarray(jcs.next_state_ssy(J.SSY(), jnp.asarray(x),
                                      jnp.asarray(shocks))),
        rtol=0, atol=1e-15)


def test_f32_range_warning():
    g = P.build_grid_ssy(P.SSY(), 4, 4, 4, 5, num_std_devs=9.0)
    with pytest.warns(UserWarning, match="exponential range"):
        P.T_ssy_continuous_factory(P.SSY(), g, space="log",
                                   dtype=torch.float32, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        P.T_ssy_continuous_factory(P.SSY(), P.build_grid_ssy(
            P.SSY(), 4, 4, 4, 5), space="log", dtype=torch.float32,
            device="cpu")


def test_wc_ratio_continuous_newton_matches_jax():
    sizes = (5, 5, 5, 6)
    want = J.wc_ratio_continuous(J.SSY(), sizes, tol=1e-12)
    got = P.wc_ratio_continuous(P.SSY(), sizes, tol=1e-12, device="cpu")
    assert got.converged and bool(want.converged)
    assert got.w_star.dtype == torch.float64 and len(got.grids) == 4
    np.testing.assert_allclose(torch.log(got.w_star).numpy(),
                               np.log(np.asarray(want.w_star)), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("kwargs,match", [
    ({"kernel": "tiled"}, "items 6"),
    # baseline="coarse" is ported; an unported option beside it raises
    # before its coarse float64 solve runs.
    ({"baseline": "coarse", "polish": True}, "item 6"),
    ({"polish": True}, "item 6"),
    ({"checkpoint_path": "w.npz"}, "item 10"),
])
def test_later_slices_raise_not_implemented(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        P.wc_ratio_continuous(P.SSY(), (3, 3, 3, 4), device="cpu", **kwargs)


def test_continuous_gcy_and_other_paths_raise():
    # Continuous GCY, its Monte Carlo and node-chain paths are ported
    # (tests/test_torch_continuous_gcy.py and test_torch_post_interp.py);
    # polish is not.
    with pytest.raises(NotImplementedError, match="item 6"):
        P.wc_ratio_continuous(P.GCY(), (3,) * 6, method="monte_carlo",
                              polish=True, device="cpu")
    with pytest.raises(TypeError, match="unsupported model"):
        P.wc_ratio_continuous(object(), (3, 3, 3, 4), device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        P.wc_ratio_continuous(P.SSY(), (3, 3, 3, 4), kernel="fused",
                              device="cpu")
    g = P.build_grid_ssy(P.SSY(), 3, 3, 3, 4)
    for kw, exc, match in ((dict(engine="node_chain"), ValueError,
                            "requires interp"),
                           (dict(interp="post", space="log",
                                 baseline="loglinear"),
                            ValueError, "requires quadrature"),
                           (dict(method="mc"), ValueError, "unknown method"),
                           (dict(space="v"), ValueError, "unknown space"),
                           (dict(baseline="x"), ValueError,
                            "unknown baseline"),
                           (dict(baseline="loglinear", space="w"),
                            ValueError, "requires quadrature")):
        with pytest.raises(exc, match=match):
            P.T_ssy_continuous_factory(P.SSY(), g, device="cpu", **kw)
