"""Checkpoints: the port's ``utils/checkpoint.py`` against the JAX
package's, on the CPU in float64.

Each package reads the other's files (``w_star``, grids, model
parameters and meta, exactly: the format is the same ``.npz``); both
port drivers write ``checkpoint_path`` with the JAX drivers' meta (the
values within 1e-10 of JAX's solve, the same float64 algebra); and
``construct_wstar_callable(datafile=)`` agrees with JAX's on the same
file to 1e-12 (one multilinear interpolation of the same numbers).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.utils import checkpoint as JC
from sdfs_via_autodiff_tpu_torch.utils import checkpoint as PC

SHAPES = (4, 4, 4, 6)
SIZES = (6, 6, 6, 6)
SOLVE_TOL = 1e-10          # the two packages' float64 fixed points
INTERP_ATOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    """Two loaded checkpoints hold the same entries."""
    assert (a.version, a.model_name, a.model_params, a.meta) == (
        b.version, b.model_name, b.model_params, b.meta)
    assert len(a.grids) == len(b.grids)
    for ga, gb in zip(a.grids, b.grids):
        assert ga.dtype == gb.dtype
        np.testing.assert_array_equal(ga, gb)
    assert a.w_star.dtype == b.w_star.dtype
    np.testing.assert_array_equal(a.w_star, b.w_star)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_load(tmp_path, writer):
    # The same arrays, model and meta written by one package read back
    # identically by both, grids and w* in their dtypes.
    rng = np.random.default_rng(0)
    model = dataclasses.replace(J.SSY(), gamma=9.5)
    grids = tuple(np.sort(rng.standard_normal(n)) for n in SIZES)
    w = np.exp(6 + 0.1 * rng.standard_normal(SIZES))
    meta = dict(kind="continuous", tol=1e-9, shapes=list(SIZES))
    path = str(tmp_path / "c.npz")
    if writer == "jax":
        JC.save_solution(path, model, tuple(map(jnp.asarray, grids)),
                         jnp.asarray(w), meta=meta)
    else:
        PC.save_solution(path, P.SSY(**dataclasses.asdict(model)),
                         tuple(map(torch.as_tensor, grids)),
                         torch.as_tensor(w), meta=meta)
    got_j, got_p = JC.load_solution(path), PC.load_solution(path)
    _same(got_j, got_p)
    assert got_p.model_name == "SSY" and got_p.model_params["gamma"] == 9.5
    assert got_p.meta == meta
    np.testing.assert_array_equal(got_p.w_star, w)
    for g, want in zip(got_p.grids_torch(device="cpu"), grids):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), want)


def test_newer_version_refused(tmp_path):
    path = str(tmp_path / "v.npz")
    PC.save_solution(path, P.SSY(), (), torch.ones(3))
    with np.load(path) as data:
        payload = dict(data)
    payload["version"] = np.int64(PC.CHECKPOINT_VERSION + 1)
    np.savez_compressed(path, **payload)
    for load in (PC.load_solution, JC.load_solution):
        with pytest.raises(ValueError, match="newer than supported"):
            load(path)


def _meta_close(got, want):
    """Meta equal key for key; iterations and residual are each
    package's own solve's (within SOLVE_TOL for the residual)."""
    assert set(got) == set(want)
    for k in got:
        if k == "residual":
            assert got[k] <= SOLVE_TOL and want[k] <= SOLVE_TOL
        elif k != "iterations":
            assert got[k] == want[k], k


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(space="w"),
    dict(polish=True, dtype="float32"),
])
def test_discrete_checkpoint_path_matches_jax(tmp_path, kwargs):
    jkw, pkw = dict(kwargs), dict(kwargs)
    if "dtype" in kwargs:
        jkw["dtype"], pkw["dtype"] = jnp.float32, torch.float32
    jp, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    J.wc_ratio_discrete(J.SSY(), SHAPES, tol=SOLVE_TOL, checkpoint_path=jp,
                        **jkw)
    sol = P.wc_ratio_discrete(P.SSY(), SHAPES, tol=SOLVE_TOL,
                              checkpoint_path=pp, device="cpu", **pkw)
    cj, cp = JC.load_solution(jp), PC.load_solution(pp)
    assert cp.grids == () and cp.model_params == cj.model_params
    _meta_close(cp.meta, cj.meta)
    np.testing.assert_array_equal(cp.w_star, sol.w_star.numpy())
    np.testing.assert_allclose(np.log(cp.w_star), np.log(cj.w_star),
                               rtol=0, atol=SOLVE_TOL)


def test_discrete_tiled_checkpoint_meta(tmp_path):
    # The tiled tier writes kernel="tiled" (JAX drivers.py:274-281); the
    # float32 tiled solves are held to their own tiers elsewhere, so here
    # only the meta and the stored w* are compared (three Newton steps).
    path = str(tmp_path / "t.npz")
    sol = P.wc_ratio_discrete(P.SSY(), (4, 8, 6, 64), kernel="tiled",
                              discretization="tauchen", tol=2e-5,
                              max_iter=3, checkpoint_path=path,
                              device="cpu")
    ck = JC.load_solution(path)
    assert sol.result.iterations == 3
    assert ck.meta == dict(kind="discrete", shapes=[4, 8, 6, 64],
                           algorithm="newton", tol=2e-5, space="log",
                           kernel="tiled",
                           iterations=sol.result.iterations,
                           residual=sol.result.residual)
    assert ck.w_star.dtype == np.float32
    np.testing.assert_array_equal(ck.w_star, sol.w_star.numpy())


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(algorithm="anderson", interp="post", quad_degree=3),
    dict(polish=True, dtype="float32"),
])
def test_continuous_checkpoint_path_matches_jax(tmp_path, kwargs):
    jkw, pkw = dict(kwargs), dict(kwargs)
    if "dtype" in kwargs:
        jkw["dtype"], pkw["dtype"] = jnp.float32, torch.float32
    jp, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    J.wc_ratio_continuous(J.SSY(), SIZES, tol=SOLVE_TOL, checkpoint_path=jp,
                          **jkw)
    sol = P.wc_ratio_continuous(P.SSY(), SIZES, tol=SOLVE_TOL,
                                checkpoint_path=pp, device="cpu", **pkw)
    cj, cp = JC.load_solution(jp), PC.load_solution(pp)
    _meta_close(cp.meta, cj.meta)
    assert len(cp.grids) == 4
    for gp, gj, gs in zip(cp.grids, cj.grids, sol.grids):
        assert gp.dtype == gj.dtype == np.float64
        np.testing.assert_array_equal(gp, gs.numpy())
        np.testing.assert_allclose(gp, gj, rtol=0, atol=4 * np.spacing(
            np.abs(gj).max()))
    # The anderson stop is a step size: each package's w* is within tol
    # of the fixed point, times the contraction's 1/(1 - rate).
    atol = SOLVE_TOL if kwargs.get("algorithm") != "anderson" else 1e-6
    np.testing.assert_allclose(np.log(cp.w_star), np.log(cj.w_star),
                               rtol=0, atol=atol)


def test_continuous_tiled_checkpoint_meta(tmp_path):
    path = str(tmp_path / "t.npz")
    sol = P.wc_ratio_continuous(P.SSY(), (4, 8, 6, 64), kernel="tiled",
                                baseline="loglinear", tol=2e-5,
                                checkpoint_path=path, device="cpu")
    ck = JC.load_solution(path)
    assert ck.meta == dict(kind="continuous", method="quadrature",
                           interp="pre", quad_degree=5, num_std_devs=3.2,
                           algorithm="newton", tol=2e-5, space="log",
                           kernel="tiled",
                           iterations=sol.result.iterations,
                           residual=sol.result.residual)
    assert all(g.dtype == np.float32 for g in ck.grids)
    np.testing.assert_array_equal(ck.w_star, sol.w_star.numpy())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wstar_datafile_matches_jax(tmp_path, writer):
    path = str(tmp_path / "w.npz")
    if writer == "jax":
        J.wc_ratio_continuous(J.SSY(), SIZES, tol=SOLVE_TOL,
                              checkpoint_path=path)
    else:
        P.wc_ratio_continuous(P.SSY(), SIZES, tol=SOLVE_TOL,
                              checkpoint_path=path, device="cpu")
    fj = J.construct_wstar_callable(datafile=path)
    fp = P.construct_wstar_callable(datafile=path, device="cpu")
    ck = PC.load_solution(path)
    rng = np.random.default_rng(1)
    lo = np.array([g[0] for g in ck.grids])
    hi = np.array([g[-1] for g in ck.grids])
    xs = lo[:, None] + (hi - lo)[:, None] * rng.uniform(-0.1, 1.1, (4, 300))
    got = fp(torch.as_tensor(xs))
    assert got.dtype == torch.float64 and got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), np.asarray(fj(jnp.asarray(xs))),
                               rtol=0, atol=INTERP_ATOL * np.abs(
                                   ck.w_star).max())
    # One state gives a 0-d result; grid points give the stored values.
    x = np.array([g[2] for g in ck.grids])
    assert fp(x).ndim == 0
    np.testing.assert_allclose(float(fp(x)), ck.w_star[2, 2, 2, 2],
                               rtol=1e-15)


def test_meta_is_json(tmp_path):
    # meta travels as a JSON string: what one package writes the other's
    # json reads as the same dict.
    path = str(tmp_path / "m.npz")
    meta = dict(spec="degroot", h=[0.5, 0.99], shapes=[2, 3], tol=1e-9)
    PC.save_solution(path, P.GCY(), (), torch.zeros(2, 3), meta=meta)
    with np.load(path) as data:
        assert json.loads(str(data["meta"])) == meta
        assert json.loads(str(data["model_params"])) == dataclasses.asdict(
            J.GCY())
