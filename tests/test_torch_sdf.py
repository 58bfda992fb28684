"""SDF pipeline of the PyTorch port vs the JAX package, on the CPU.

``construct_wstar_callable``, ``one_step_w_moments``, ``sdf_factory``
and the simulated state paths, fed the same solved field and the same
states (JAX's own draws, handed over as numpy, for the one-step moments);
then the reference's published one-step moment anchors through the port
(JAX ``tests/test_reference_anchors.py``: 0.1% on the mean, 0.5% on the
standard deviation, with the port's own generator).  Tolerances: 1e-12
relative for float64 functions of the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.operators import continuous_gcy as jcg
from sdfs_via_autodiff_tpu.operators import continuous_ssy as jcs
from sdfs_via_autodiff_tpu.sdf import simulate as jsim
from sdfs_via_autodiff_tpu_torch.operators import continuous_gcy as pcg
from sdfs_via_autodiff_tpu_torch.operators import continuous_ssy as pcs

SIZES = (4, 4, 4, 6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run many small ops: one intra-op thread keeps them
    fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved():
    """The JAX package's float64 solve at SIZES, and the same field and
    grids as port tensors."""
    sol = J.wc_ratio_continuous(J.SSY(), SIZES, algorithm="newton",
                                tol=1e-9, interp="pre")
    assert bool(sol.converged)
    w, grids = P.solution_from_numpy(np.asarray(sol.w_star),
                                     [np.asarray(g) for g in sol.grids])
    return sol, w, grids


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


def test_wstar_callable_matches_jax(solved, tmp_path):
    sol, w, grids = solved
    fj = J.construct_wstar_callable(sol.w_star, sol.grids)
    fp = P.construct_wstar_callable(w, grids, device="cpu")
    # Exact at grid points; one point gives a 0-d result.
    x = np.asarray([float(g[1]) for g in sol.grids])
    assert fp(x).ndim == 0
    _close(fp(x), w[1, 1, 1, 1])
    rng = np.random.default_rng(0)
    xs = (np.asarray([float(g[0]) for g in sol.grids])[:, None]
          + rng.uniform(-0.1, 1.1, (4, 200))
          * np.asarray([float(g[-1] - g[0]) for g in sol.grids])[:, None])
    _close(fp(torch.as_tensor(xs)), fj(jnp.asarray(xs)))
    # From a checkpoint file alone: the same interpolant.
    path = str(tmp_path / "w.npz")
    P.save_solution(path, P.SSY(), grids, w)
    ff = P.construct_wstar_callable(datafile=path, device="cpu")
    _close(ff(torch.as_tensor(xs)), fp(torch.as_tensor(xs)), rtol=0)
    with pytest.raises(ValueError, match="provide"):
        P.construct_wstar_callable(w, None, device="cpu")


def test_wstar_callable_ignores_datafile_beside_the_arrays(solved, tmp_path):
    # As in the JAX package, a datafile given beside the arrays is not
    # read: both return the arrays' interpolant.
    sol, w, grids = solved
    path = str(tmp_path / "absent.npz")
    fj = J.construct_wstar_callable(sol.w_star, sol.grids, datafile=path)
    fp = P.construct_wstar_callable(w, grids, datafile=path, device="cpu")
    xs = np.random.default_rng(3).uniform(-0.5, 0.5, (4, 100)) * np.asarray(
        [float(g[-1]) for g in sol.grids])[:, None]
    _close(fp(torch.as_tensor(xs)), fj(jnp.asarray(xs)))
    _close(fp(torch.as_tensor(xs)),
           P.construct_wstar_callable(w, grids, device="cpu")(xs))


def test_one_step_moments_match_jax_on_the_same_states(solved):
    sol, w, grids = solved
    n = 20_000
    # JAX's own draws (PRNGKey(1234), as its one_step_w_moments makes
    # them), handed to the port: the same states on both sides.
    draws = np.asarray(jax.random.normal(jax.random.PRNGKey(1234),
                                         (4, n)))
    fj = J.construct_wstar_callable(sol.w_star, sol.grids)
    want = J.one_step_w_moments(J.SSY(), fj, num_draws=n, seed=1234)
    fp = P.construct_wstar_callable(w, grids, device="cpu")
    got = P.one_step_w_moments(P.SSY(), fp, draws=draws, device="cpu")
    _close(got, want)
    # The port's generator: other draws, the same distribution.
    mean, sd = P.one_step_w_moments(P.SSY(), fp, num_draws=n, device="cpu")
    assert abs(mean - want[0]) < 5 * want[1] / np.sqrt(n)
    assert abs(sd - want[1]) / want[1] < 0.05
    assert P.one_step_w_moments(P.SSY(), fp, num_draws=n,
                                device="cpu") == (mean, sd)


@pytest.mark.parametrize("gcy", [False, True])
def test_sdf_matches_jax_on_the_same_transitions(solved, gcy):
    rng = np.random.default_rng(1)
    if gcy:
        sizes = (3, 3, 2, 2, 3, 2)
        jm, pm = J.GCY(), P.GCY()
        jg = J.build_grid_gcy(jm, *sizes)
        w64 = 300.0 * np.exp(0.05 * rng.standard_normal(sizes))
        jstep, pstep = jcg.next_state_gcy, pcg.next_state_gcy
        jf, pf = J.sdf_factory_gcy, P.sdf_factory_gcy
    else:
        sol = solved[0]
        jm, pm, jg = J.SSY(), P.SSY(), sol.grids
        w64 = np.asarray(sol.w_star)
        jstep, pstep = jcs.next_state_ssy, pcs.next_state_ssy
        jf, pf = J.sdf_factory_ssy, P.sdf_factory_ssy
    dim = len(jg)
    x = 0.5 * np.asarray([float(g[-1]) for g in jg])[:, None] * rng.uniform(
        -1, 1, (dim, 50))
    eps = rng.standard_normal((dim, 50))
    xi = rng.standard_normal(50)
    x_next = np.asarray(jstep(jm, jnp.asarray(x), jnp.asarray(eps)))
    np.testing.assert_allclose(
        pstep(pm, torch.as_tensor(x), torch.as_tensor(eps)).numpy(), x_next,
        rtol=1e-14, atol=1e-17)
    fj = J.construct_wstar_callable(jnp.asarray(w64), jg)
    pw, pg = P.solution_from_numpy(w64, [np.asarray(g) for g in jg])
    fp = P.construct_wstar_callable(pw, pg, device="cpu")
    want = np.asarray(jf(jm, fj)(jnp.asarray(x), jnp.asarray(x_next),
                                 jnp.asarray(xi)))
    got = pf(pm, fp)(x, x_next, xi)
    assert bool(torch.all(got > 0)) and bool(torch.isfinite(got).all())
    _close(got, want)
    _close(P.sdf_factory(pm, fp)(x, x_next, xi), want)
    with pytest.raises(TypeError, match="unsupported model"):
        P.sdf_factory(object(), fp)


@pytest.mark.parametrize("gcy", [False, True])
def test_simulated_path_equals_the_step_by_step_recursion(gcy):
    # The path equals n calls of next_state on the same shocks from x0
    # (up to rounding).
    model = P.GCY() if gcy else P.SSY()
    dim = 6 if gcy else 4
    step = pcg.next_state_gcy if gcy else pcs.next_state_ssy
    n = 1_000
    eps = np.random.default_rng(2).standard_normal((n, dim))
    x0 = 0.01 * np.arange(1, dim + 1)
    path = P.simulate_states(model, n, x0=x0, shocks=eps, device="cpu")
    assert tuple(path.shape) == (dim, n)
    x = torch.as_tensor(x0)
    want = []
    for t in range(n):
        x = step(model, x, torch.as_tensor(eps[t]))
        want.append(x)
    want = torch.stack(want, dim=1).numpy()
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_allclose(path.numpy() / scale, want / scale, rtol=0,
                               atol=1e-12)
    # The generator's path: seeded and stationary-looking.
    a = P.simulate_states(model, 5_000, seed=7, device="cpu")
    assert torch.equal(a, P.simulate_states(model, 5_000, seed=7,
                                            device="cpu"))
    assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize("gcy", [False, True])
def test_simulated_path_and_moments_match_jax_on_the_same_shocks(solved, gcy):
    # JAX's own shocks (PRNGKey(seed), as its simulate_states draws them)
    # handed to the port: the same path, and the same moments along it.
    n, burn, seed = 3_000, 500, 5
    if gcy:
        jm, pm = J.GCY(), P.GCY()
        sizes = (3, 3, 2, 2, 3, 2)
        jg = J.build_grid_gcy(jm, *sizes)
        w64 = 300.0 * np.exp(0.05 * np.random.default_rng(4).standard_normal(
            sizes))
    else:
        jm, pm = J.SSY(), P.SSY()
        jg, w64 = solved[0].grids, np.asarray(solved[0].w_star)
    dim = len(jg)
    shocks = np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), (n + burn, dim, 1),
        dtype=jnp.float64))[:, :, 0]
    want = np.asarray(jsim.simulate_states(jm, n + burn, seed=seed))
    got = P.simulate_states(pm, n + burn, shocks=shocks, device="cpu")
    assert tuple(got.shape) == want.shape == (dim, n + burn)
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=1e-12)
    fj = J.construct_wstar_callable(jnp.asarray(w64), jg)
    pw, pg = P.solution_from_numpy(w64, [np.asarray(g) for g in jg])
    fp = P.construct_wstar_callable(pw, pg, device="cpu")
    _close(P.simulated_w_moments(pm, fp, n, burn_in=burn, shocks=shocks,
                                 device="cpu"),
           jsim.simulated_w_moments(jm, fj, n, seed=seed, burn_in=burn))


def test_simulated_moments_agree_with_jax_in_distribution(solved):
    sol, w, grids = solved
    fj = J.construct_wstar_callable(sol.w_star, sol.grids)
    fp = P.construct_wstar_callable(w, grids, device="cpu")
    want = jsim.simulated_w_moments(J.SSY(), fj, num_steps=40_000)
    got = P.simulated_w_moments(P.SSY(), fp, num_steps=40_000, device="cpu")
    # Different generators: the persistent states make a 40k path's
    # moments noisy: 5% on the mean and 50% on the standard deviation,
    # far outside either's rounding.
    assert abs(got[0] - want[0]) / want[0] < 0.05
    assert abs(got[1] - want[1]) / want[1] < 0.5


def _anchor(interp, std, anchor):
    model = P.SSY()
    sol = P.wc_ratio_continuous(model, (15, 15, 15, 15), algorithm="newton",
                                tol=1e-9, interp=interp, quad_degree=5,
                                num_std_devs=std, device="cpu")
    assert sol.converged
    f = P.construct_wstar_callable(sol.w_star, sol.grids, device="cpu")
    mean, stdev = P.one_step_w_moments(model, f, num_draws=1_000_000,
                                       device="cpu")
    assert abs(mean - anchor[0]) / anchor[0] < 1e-3
    assert abs(stdev - anchor[1]) / anchor[1] < 5e-3


@pytest.mark.parametrize("std,anchor", [
    (3.2, (670.75128139, 6.60051464)),
    (2.5, (983.28449407, 8.76520362)),
])
def test_ssy_one_step_moment_anchors(std, anchor):
    _anchor("pre", std, anchor)


@pytest.mark.slow
@pytest.mark.parametrize("std,anchor", [
    # The "interpolate ln(w)" rows: the solve runs interp="loglin"; the
    # moments interpolate the solved w linearly, as the reference does.
    (2.5, (1077.95676508, 9.61219993)),
    (3.2, (865.00929848, 8.35713019)),
])
def test_ssy_loglin_interp_moment_anchors(std, anchor):
    _anchor("loglin", std, anchor)
