"""Continuous GCY of the PyTorch port vs the JAX package, on the CPU.

The factored quadrature + pre operator (w and log space, with no
baseline, the log-linear one and a coarse-solve profile one), the
two-phase pair operand set, the eager twin, the coarse additive baseline
and the driver, all in float64 from the same grids.  Tolerances: 1e-12
for operators, operand sets and the twin; 1e-9 for the coarse baseline
(two float64 Newton solves to tol 1e-9 whose fixed points agree to
~1e-11); 1e-10 relative for the driver's w*.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu import drivers as jdrivers
from sdfs_via_autodiff_tpu.operators.continuous_common import (
    additive_profiles as jax_additive_profiles)
from sdfs_via_autodiff_tpu.operators.continuous_gcy import (
    T_gcy_continuous_factory as jax_T_gcy_continuous, next_state_gcy as
    jax_next_state_gcy)
from sdfs_via_autodiff_tpu.operators.two_phase import (
    make_xla_two_phase_T, two_phase_operands_gcy_continuous as
    jax_operands_gcy_continuous)
from sdfs_via_autodiff_tpu.ops.grids import build_grid_gcy as jax_grid_gcy
from sdfs_via_autodiff_tpu_torch import drivers as pdrivers

SIZES = [(3, 3, 3, 3, 4, 3), (4, 3, 3, 2, 5, 3)]
RAGGED = (5, 3, 3, 2, 40, 3)     # the JAX streamed tier declines n_z = 40
ATOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(sizes):
    jg = jax_grid_gcy(J.GCY(), *sizes)
    return jg, P.grids_from_numpy([np.asarray(g) for g in jg])


def _profiles(sizes, seed=0):
    """A (const, six profiles) baseline of the right shapes."""
    rng = np.random.default_rng(seed)
    return (6.5, [0.01 * rng.standard_normal(n) for n in sizes])


def _baseline(kind, sizes):
    return {"none": None, "loglinear": "loglinear",
            "profiles": _profiles(sizes)}[kind]


def _field(sizes, seed=1):
    rng = np.random.default_rng(seed)
    return np.log(700.0) + 0.05 * rng.standard_normal(sizes)


def test_next_state_matches_jax():
    rng = np.random.default_rng(2)
    x, shocks = rng.standard_normal((6, 7)), rng.standard_normal((6, 7))
    want = np.asarray(jax_next_state_gcy(J.GCY(), jnp.asarray(x),
                                         jnp.asarray(shocks)))
    got = P.operators.next_state_gcy(P.GCY(), torch.as_tensor(x),
                                     torch.as_tensor(shocks))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("space,baseline", [
    ("w", "none"), ("log", "none"), ("log", "loglinear"),
    ("log", "profiles")])
@pytest.mark.parametrize("sizes", SIZES)
def test_factored_operator_matches_jax(sizes, space, baseline):
    jg, pg = _grids(sizes)
    spec = _baseline(baseline, sizes)
    jT = jax_T_gcy_continuous(J.GCY(), jg, space=space, baseline=spec,
                              jit=False)
    pT = P.T_gcy_continuous_factory(P.GCY(), pg, space=space, baseline=spec,
                                    device="cpu")
    ell = _field(sizes)
    x = np.exp(ell) if space == "w" else ell
    got = pT(torch.as_tensor(x))
    want = np.asarray(jT(jnp.asarray(x)))
    assert got.dtype == torch.float64 and tuple(got.shape) == sizes
    scale = 1000.0 if space == "w" else 1.0      # w ~ 700: relative 1e-12
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL * scale)
    if spec is not None:
        np.testing.assert_allclose(pT.baseline_log_w.numpy(),
                                   np.asarray(jT.baseline_log_w), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("baseline", ["none", "loglinear", "profiles"])
def test_pair_operands_match_jax(baseline):
    sizes = SIZES[1]
    jg, pg = _grids(sizes)
    spec = _baseline(baseline, sizes)
    jops = jax_operands_gcy_continuous(J.GCY(), jg, 5, spec)
    pops = P.two_phase_operands_gcy_continuous(P.GCY(), pg, 5, spec)
    assert pops.shapes == tuple(jops.shapes)
    assert pops.is_pair and pops.c2_batched and not pops.is_plain
    assert pops.W_c2 is None                  # no placeholder
    assert pops.pair_shapes == tuple(jops.pair_shapes)
    assert pops.perm == tuple(jops.perm)
    assert pops.inv_perm == tuple(jops.inv_perm)
    assert pops.state_shapes == tuple(jops.state_shapes)
    for a, b in zip(pops.pair_c2, jops.pair_c2):
        np.testing.assert_allclose(a, np.asarray(b), rtol=ATOL, atol=0)
    for f in dataclasses.fields(jops):
        want = getattr(jops, f.name)
        if f.name == "W_c2" or not isinstance(want, np.ndarray):
            continue
        np.testing.assert_allclose(getattr(pops, f.name), want, rtol=ATOL,
                                   atol=ATOL, err_msg=f.name)
    assert (pops.sub_row is None) == (spec is None)
    assert (pops.theta, pops.beta) == (float(jops.theta), float(jops.beta))


@pytest.mark.parametrize("sizes", [(8, 3, 2, 4, 8, 2), RAGGED])
def test_eager_twin_matches_jax_xla_twin_f64(sizes):
    jg, pg = _grids(sizes)
    jops = jax_operands_gcy_continuous(J.GCY(), jg, 5, "loglinear")
    pops = P.two_phase_operands_gcy_continuous(P.GCY(), pg, 5, "loglinear")
    ell = np.asarray(jops.baseline_log_w) + 0.05 * np.random.default_rng(
        3).standard_normal(jops.shapes)
    want = np.asarray(make_xla_two_phase_T(jops, jnp.float64)(
        jnp.asarray(ell)))
    got = P.make_eager_two_phase_T(pops, torch.float64, device="cpu")(
        torch.as_tensor(ell))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_eager_twin_equals_factored_chain():
    # The twin on the view is the factored operator on the natural layout.
    sizes = SIZES[0]
    _, pg = _grids(sizes)
    pops = P.two_phase_operands_gcy_continuous(P.GCY(), pg, 5, "loglinear")
    T64 = P.T_gcy_continuous_factory(P.GCY(), pg, space="log",
                                     baseline="loglinear", device="cpu")
    ell = torch.as_tensor(_field(sizes, 4))
    twin = P.make_eager_two_phase_T(pops, torch.float64, device="cpu")
    view = twin(ell.permute(pops.perm).reshape(pops.shapes))
    got = view.reshape([sizes[p] for p in pops.perm]).permute(pops.inv_perm)
    np.testing.assert_allclose(got.numpy(), T64(ell).numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("model,sizes", [("gcy", (4, 3, 3, 3, 4, 3)),
                                         ("ssy", (4, 4, 6, 7))])
def test_coarse_additive_baseline_matches_jax(model, sizes):
    # The SSY grid is cut to 5 points per axis for the coarse solve.
    jm, pm = (J.GCY(), P.GCY()) if model == "gcy" else (J.SSY(), P.SSY())
    const_j, profs_j = jdrivers._coarse_additive_baseline(
        jm, sizes, num_std_devs=3.2, quad_degree=5, dtype=jnp.float64)
    const_p, profs_p = pdrivers._coarse_additive_baseline(
        pm, sizes, num_std_devs=3.2, quad_degree=5,
        dtype=torch.float64, device="cpu")
    assert abs(const_p - float(const_j)) <= 1e-9
    assert len(profs_p) == len(sizes)
    for a, b in zip(profs_p, profs_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-9)
    # The fit itself is the JAX package's.
    ell = _field(sizes, 5)
    c_j, p_j = jax_additive_profiles(jnp.asarray(ell))
    c_p, p_p = P.operators.additive_profiles(torch.as_tensor(ell))
    assert abs(c_p - float(c_j)) <= ATOL
    for a, b in zip(p_p, p_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("model,kernel", [("ssy", "xla"), ("ssy", "tiled"),
                                          ("gcy", "xla"), ("gcy", "tiled")])
def test_default_algorithm_resolution(model, kernel):
    jm = J.SSY() if model == "ssy" else J.GCY()
    pm = P.SSY() if model == "ssy" else P.GCY()
    want = jdrivers._default_algorithm(jm, kernel)
    assert pdrivers._default_algorithm(pm, kernel) == want
    assert want == ("sa" if (model, kernel) == ("gcy", "tiled")
                    else "newton")


def test_wc_ratio_continuous_gcy_newton_matches_jax():
    sizes = (3, 3, 3, 3, 4, 3)
    want = J.wc_ratio_continuous(J.GCY(), sizes, algorithm="newton",
                                 tol=1e-9, quad_degree=3)
    got = P.wc_ratio_continuous(P.GCY(), sizes, algorithm="newton",
                                tol=1e-9, quad_degree=3, device="cpu")
    assert got.converged and bool(want.converged)
    assert got.w_star.dtype == torch.float64 and len(got.grids) == 6
    w = np.asarray(want.w_star)
    np.testing.assert_allclose(got.w_star.numpy(), w, rtol=1e-10, atol=0)


@pytest.mark.parametrize("kwargs", [{"method": "monte_carlo"},
                                    {"interp": "post"}, {"interp": "loglin"},
                                    {"kernel": "tiled", "interp": "post"}])
def test_node_chain_and_mc_raise_item_8(kwargs):
    with pytest.raises(NotImplementedError, match="item 8"):
        P.wc_ratio_continuous(P.GCY(), (3,) * 6, device="cpu", **kwargs)


def test_factory_rejects_unported_engines():
    _, pg = _grids(SIZES[0])
    for kw, exc, match in ((dict(engine="gather"), NotImplementedError,
                            "gather"),
                           (dict(interp="loglin", space="log"),
                            NotImplementedError, "item 8"),
                           (dict(baseline="x", space="log"), ValueError,
                            "unknown baseline"),
                           (dict(baseline="loglinear", space="w"),
                            ValueError, "requires quadrature")):
        with pytest.raises(exc, match=match):
            P.T_gcy_continuous_factory(P.GCY(), pg, device="cpu", **kw)
