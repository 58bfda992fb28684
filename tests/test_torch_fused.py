"""Fused two-matmul tier of the PyTorch port vs the JAX package, on the CPU.

The port's kernels (one application, the SA loop, the Anderson loop)
run their plain PyTorch versions here; the JAX kernels run in Pallas
interpret mode.  Inputs are made with numpy from a seed.  Tolerances:

* two-matmul operand sets, float64: 1e-12;
* one application, float32: 5e-6 abs (the JAX package's own bound);
  its tangent 1e-4 (against the float64 operator's, as JAX's test);
* SA: 50 capped steps agree to 1e-4 (50 steps of ~1e-6 rounding);
  Anderson trajectories depart at the rounding level, so its 50 capped
  steps are held to the cap and finiteness, and its end state to the
  fixed point;
* w of the SA and Anderson end states at tol 1e-6 against the float64
  Newton solution within the JAX tests' bounds (2.0 for SA, 1.0 for
  Anderson, w ~ 800).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.kernels import anderson_kernel as jak
from sdfs_via_autodiff_tpu.kernels import fused_discrete as jfd
from sdfs_via_autodiff_tpu.kernels import solver_kernel as jsk
from sdfs_via_autodiff_tpu.operators.continuous_ssy import (
    T_ssy_continuous_factory as jax_T_continuous)
from sdfs_via_autodiff_tpu.ops.grids import build_grid_ssy as jax_grid_ssy
from sdfs_via_autodiff_tpu_torch.kernels import anderson_kernel as ak
from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
from sdfs_via_autodiff_tpu_torch.kernels import solver_kernel as sk

SSY_SHAPES = (8, 8, 6, 6)           # tests/test_kernels.py's shapes
CONT_SIZES = (6, 6, 6, 8)
GCY_SHAPES = (4, 3, 3, 3, 3, 3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain loops run thousands of small ops: one intra-op thread
    keeps them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name):
    """(JAX args, port args, shapes, JAX model, port model)."""
    if name == "ssy":
        jm, pm = J.SSY(), P.SSY()
        return ((jm, J.discretize_ssy(jm, SSY_SHAPES)),
                (pm, P.discretize_ssy(pm, SSY_SHAPES)), SSY_SHAPES, jm, pm)
    if name == "continuous":
        jm, pm = J.SSY(), P.SSY()
        jg = jax_grid_ssy(jm, *CONT_SIZES)
        pg = P.grids_from_numpy([np.asarray(g) for g in jg])
        return (jm, jg), (pm, pg), CONT_SIZES, jm, pm
    jm, pm = J.GCY(), P.GCY()
    return ((jm, J.discretize_gcy(jm, GCY_SHAPES)),
            (pm, P.discretize_gcy(pm, GCY_SHAPES)), GCY_SHAPES, jm, pm)


_OPERAND_SETS = {"ssy": (jfd.kron_operands_ssy, fd.kron_operands_ssy),
             "continuous": (jfd.kron_operands_ssy_continuous,
                            fd.kron_operands_ssy_continuous),
             "gcy": (jfd.kron_operands_gcy, fd.kron_operands_gcy)}
_FUSED_T = {"ssy": (jfd.make_fused_T_log_ssy, P.make_fused_T_log_ssy),
            "continuous": (jfd.make_fused_T_log_ssy_continuous,
                           P.make_fused_T_log_ssy_continuous),
            "gcy": (jfd.make_fused_T_log_gcy, P.make_fused_T_log_gcy)}
_T64 = {"ssy": lambda jm, a: J.T_ssy_factory(jm, a, space="log"),
        "continuous": lambda jm, a: jax_T_continuous(jm, a, space="log"),
        "gcy": lambda jm, a: J.T_gcy_factory(jm, a, space="log")}


def _field(shapes, seed, center=800.0):
    rng = np.random.default_rng(seed)
    return np.log(center) + 0.05 * rng.standard_normal(shapes)


@pytest.mark.parametrize("name", ["ssy", "continuous", "gcy"])
def test_kron_operands_match_jax(name):
    (jm, ja), (pm, pa), _, _, _ = _case(name)
    jb, pb = _OPERAND_SETS[name]
    extra = (5,) if name == "continuous" else ()
    want = jb(jm, ja, *extra, dtype=jnp.float64)
    got = pb(pm, pa, *extra, dtype=torch.float64)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-300)


@pytest.mark.parametrize("name", ["ssy", "continuous", "gcy"])
def test_fused_T_matches_jax_interpret(name):
    (jm, ja), (pm, pa), shapes, _, _ = _case(name)
    jf, pf = _FUSED_T[name]
    ell = _field(shapes, 5, 500.0 if name == "gcy" else 800.0)
    want = np.asarray(jf(jm, ja, interpret=True)(
        jnp.asarray(ell, jnp.float32)), np.float64)
    before = dict(P.FUSED_LAUNCHES)
    T = pf(pm, pa, device="cpu")
    got = T(torch.as_tensor(ell, dtype=torch.float32))
    assert P.FUSED_LAUNCHES == before          # plain version on the CPU
    assert got.dtype == torch.float32 and tuple(got.shape) == shapes
    assert float(np.abs(got.double().numpy() - want).max()) < 5e-6
    # ... and the float64 operator.
    ref = np.asarray(_T64[name](jm, ja)(jnp.asarray(ell)))
    assert float(np.abs(got.double().numpy() - ref).max()) < 5e-6


def test_fused_T_jvp_and_gradient():
    (jm, ja), (pm, pa), shapes, _, _ = _case("ssy")
    rng = np.random.default_rng(6)
    ell = _field(shapes, 6)
    v = rng.standard_normal(shapes)
    _, jv64 = jax.jvp(_T64["ssy"](jm, ja), (jnp.asarray(ell),),
                      (jnp.asarray(v),))
    T = P.make_fused_T_log_ssy(pm, pa, device="cpu")
    x = torch.as_tensor(ell, dtype=torch.float32)
    out, jv32 = torch.func.jvp(T, (x,), (torch.as_tensor(
        v, dtype=torch.float32),))
    torch.testing.assert_close(out, T(x), rtol=0, atol=0)
    assert float(np.abs(np.asarray(jv64) - jv32.double().numpy()).max()) < 1e-4
    xg = torch.full(shapes, float(np.log(800.0)), requires_grad=True)
    (g,) = torch.autograd.grad(T(xg).sum(), xg)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_fused_newton_solve_through_T():
    (jm, ja), (pm, pa), shapes, _, _ = _case("ssy")
    ref = J.solve(_T64["ssy"](jm, ja), jnp.full(shapes, jnp.log(800.0)),
                  method="newton", tol=1e-11)
    T = P.make_fused_T_log_ssy(pm, pa, device="cpu")
    res = P.solve(T, torch.full(shapes, float(np.log(800.0))),
                  method="newton", tol=2e-5)
    assert res.converged
    w_diff = np.abs(np.exp(res.x.double().numpy())
                    - np.exp(np.asarray(ref.x))).max()
    assert w_diff < 1.0


def _operands(name):
    (jm, ja), (pm, pa), shapes, _, _ = _case(name)
    jb, pb = _OPERAND_SETS[name]
    extra = (5,) if name == "continuous" else ()
    jops = jb(jm, ja, *extra, dtype=jnp.float32)
    pops = P.kron_operands_from_numpy([np.asarray(a) for a in jops])
    pops = tuple(a.float() for a in pops)
    R, C = jops[2].shape
    return jm, jops, pops, (R, C)


@pytest.mark.parametrize("name", ["ssy", "continuous"])
def test_fused_sa_cap_matches_jax(name):
    jm, jops, pops, (R, C) = _operands(name)
    f = jsk.make_fused_solver_from_operands(*jops, jm.theta, jm.beta, (R, C),
                                            R, C, interpret=True)
    x0 = np.full((R, C), np.log(800.0), np.float32)
    e_j, i_j, r_j = f(jnp.asarray(x0), 0.0, 50)
    e_p, i_p, r_p = sk.fused_sa(torch.as_tensor(x0), *pops, None, jm.theta,
                                jm.beta, 0.0, 50)
    assert int(i_p) == int(i_j) == 50
    assert float(np.abs(np.asarray(e_j) - e_p.numpy()).max()) <= 1e-4
    assert abs(float(r_p) - float(r_j)) <= 1e-6


@pytest.mark.parametrize("name", ["ssy", "continuous"])
def test_fused_anderson_cap_matches_jax(name):
    # Anderson trajectories depart at the rounding level: the cap and
    # finiteness here, the end state in test_fused_solvers_reach_f64_newton.
    jm, jops, pops, (R, C) = _operands(name)
    f = jak.make_fused_anderson_from_operands(*jops, jm.theta, jm.beta,
                                              (R, C), R, C, interpret=True)
    x0 = np.full((R, C), np.log(800.0), np.float32)
    e_j, i_j, _ = f(jnp.asarray(x0), 0.0, 50)
    e_p, i_p, _ = ak.fused_anderson(torch.as_tensor(x0), *pops, None,
                                    jm.theta, jm.beta, 0.0, 50)
    assert int(i_p) == int(i_j) == 50
    assert bool(torch.isfinite(e_p).all()) and np.isfinite(e_j).all()


@pytest.mark.parametrize("name", ["ssy", "continuous"])
def test_fused_anderson_iterates_match_jax(name):
    # 20 steps (7 mixes) with ridge 0.1: the normal equations are well
    # conditioned there, so float32 rounding stays at ~1e-5 and the
    # iterates agree within 1e-4.
    jm, jops, pops, (R, C) = _operands(name)
    f = jak.make_fused_anderson_from_operands(*jops, jm.theta, jm.beta,
                                              (R, C), R, C, ridge=0.1,
                                              interpret=True)
    x0 = np.full((R, C), np.log(800.0), np.float32)
    e_j, i_j, _ = f(jnp.asarray(x0), -1.0, 20)
    e_p, i_p, _ = ak.fused_anderson(torch.as_tensor(x0), *pops, None,
                                    jm.theta, jm.beta, -1.0, 20, ridge=0.1)
    assert int(i_p) == int(i_j) == 20
    assert float(np.abs(np.asarray(e_j) - e_p.numpy()).max()) <= 1e-4


def test_fused_anderson_falls_back_to_T():
    # A NaN ridge makes every combination NaN: each step falls back to
    # T(x), so the loop is successive approximation, bit for bit.
    jm, jops, pops, (R, C) = _operands("continuous")
    x0 = torch.full((R, C), float(np.log(800.0)))
    e_a, i_a, _ = ak.fused_anderson(x0, *pops, None, jm.theta, jm.beta, -1.0,
                                    20, ridge=float("nan"))
    e_s, _, _ = sk.fused_sa(x0, *pops, None, jm.theta, jm.beta, -1.0, 20)
    assert int(i_a) == 20
    torch.testing.assert_close(e_a, e_s, rtol=0, atol=0)


_SOLVERS = {"ssy": (sk.make_fused_solver_ssy, ak.make_fused_anderson_ssy),
            "continuous": (sk.make_fused_solver_ssy_continuous,
                           ak.make_fused_anderson_ssy_continuous)}


@pytest.mark.parametrize("name", ["ssy", "continuous"])
def test_fused_solvers_reach_f64_newton(name):
    (jm, ja), (pm, pa), shapes, _, _ = _case(name)
    ref = J.solve(_T64[name](jm, ja), jnp.full(shapes, jnp.log(800.0)),
                  method="newton", tol=1e-11)
    x0 = torch.full(shapes, float(np.log(800.0)))
    make_sa, make_aa = _SOLVERS[name]
    # SA contracts at ~beta: more than 100 iterations; Anderson far fewer
    # than SA's O(10^4) (counts near the float32 floor vary with rounding).
    for make, bound, max_iter, iter_ok in (
            (make_sa, 2.0, 100_000, lambda n: n > 100),
            (make_aa, 1.0, 8000, lambda n: n < 5000)):
        ell, iters, err = make(pm, pa, device="cpu")(x0, 1e-6, max_iter)
        assert float(err) <= 1e-6 and iter_ok(int(iters))
        assert tuple(ell.shape) == shapes
        w_diff = np.abs(np.exp(ell.double().numpy())
                        - np.exp(np.asarray(ref.x))).max()
        assert w_diff < bound, (make.__name__, w_diff)


def test_anderson_weights_solve_the_ridge_system():
    rng = np.random.default_rng(7)
    m = 5
    X = torch.as_tensor(rng.standard_normal((m, 6, 7)), dtype=torch.float32)
    F = X + 1e-3 * torch.as_tensor(rng.standard_normal((m, 6, 7)),
                                   dtype=torch.float32)
    alpha = ak._aa_weights(X, F, m, 1e-6)
    G = (F - X).reshape(m, -1).double().numpy()
    A = G @ G.T
    A += 1e-6 * max(np.trace(A) / m, 1e-30) * np.eye(m)
    c = np.linalg.solve(A, np.ones(m))
    np.testing.assert_allclose(alpha, c / c.sum(), rtol=1e-3, atol=1e-4)
    assert abs(float(alpha.sum(dtype=np.float64)) - 1.0) < 1e-5


@pytest.mark.parametrize("algorithm", ["fused_sa", "fused_anderson"])
def test_wc_ratio_continuous_fused_matches_jax(algorithm):
    sizes = (5, 5, 5, 6)
    want = J.wc_ratio_continuous(J.SSY(), sizes, algorithm=algorithm,
                                 tol=2e-6, interpret=True)
    got = P.wc_ratio_continuous(P.SSY(), sizes, algorithm=algorithm,
                                tol=2e-6, device="cpu")
    assert got.converged and bool(want.converged)
    assert got.w_star.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in got.grids)
    np.testing.assert_allclose(got.w_star.double().numpy(),
                               np.asarray(want.w_star, np.float64), rtol=1e-3)
    with pytest.warns(UserWarning, match="iteration floor"):
        P.wc_ratio_continuous(P.SSY(), (3, 3, 3, 4), algorithm=algorithm,
                              tol=1e-7, max_iter=3, device="cpu")


def test_size_guard():
    m = P.SSY()
    disc = P.discretize_ssy(m, (40, 40, 40, 40))
    with pytest.raises(ValueError, match="L2"):
        P.make_fused_T_log_ssy(m, disc, device="cpu")
    with pytest.raises(ValueError, match="L2"):
        P.make_fused_solver_ssy(m, disc, device="cpu")
    with pytest.raises(ValueError, match="L2"):
        P.make_fused_anderson_ssy(m, disc, device="cpu")
    with pytest.raises(ValueError, match="history"):
        P.make_fused_anderson_ssy(m, P.discretize_ssy(m, (3, 3, 3, 4)),
                                  history=9, device="cpu")


def test_interop_operands_drive_the_port():
    jm, jops, pops, (R, C) = _operands("ssy")
    rng = np.random.default_rng(8)
    ell = (np.log(800.0) + 0.05 * rng.standard_normal((R, C))).astype(
        np.float32)
    T_j = jfd.make_xla_T_from_operands(*jops, jm.theta, jm.beta, (R, C), R, C)
    T_p = P.make_fused_T_from_operands(*pops, jm.theta, jm.beta, (R, C), R, C,
                                       device="cpu")
    assert float(np.abs(np.asarray(T_j(jnp.asarray(ell)))
                        - T_p(torch.as_tensor(ell)).numpy()).max()) < 5e-6
    twin = P.make_xla_T_from_operands(*pops, jm.theta, jm.beta, (R, C), R, C,
                                      device="cpu")
    torch.testing.assert_close(twin(torch.as_tensor(ell)),
                               T_p(torch.as_tensor(ell)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="float32 tier"):
        P.make_fused_T_from_operands(*pops, jm.theta, jm.beta, (R, C), R, C,
                                     dtype=torch.float64, device="cpu")


# ------------------------------------------------- continuous GCY, fused

GCY_CONT_SIZES = (4, 3, 3, 3, 4, 3)


def _gcy_cont_grids():
    from sdfs_via_autodiff_tpu.ops.grids import build_grid_gcy
    jg = build_grid_gcy(J.GCY(), *GCY_CONT_SIZES)
    return jg, P.grids_from_numpy([np.asarray(g) for g in jg])


@pytest.mark.parametrize("baseline", [None, "loglinear"])
def test_kron_operands_gcy_continuous_match_jax(baseline):
    jg, pg = _gcy_cont_grids()
    want = jfd.kron_operands_gcy_continuous(J.GCY(), jg, 5, baseline,
                                            dtype=jnp.float64)
    got = P.kron_operands_gcy_continuous(P.GCY(), pg, 5, baseline,
                                         dtype=torch.float64)
    assert len(got) == len(want) == 7
    assert got[3:6] == (tuple(want[3]), want[4], want[5])
    assert (got[6] is None) == (want[6] is None) == (baseline is None)
    for g, w in zip(got[:3] + got[6:], want[:3] + want[6:]):
        if w is None:
            continue
        assert g.dtype == torch.float64 and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)
    # The JAX seven-tuple crosses over as the port's.
    crossed = P.kron_operands_from_numpy(want)
    assert crossed[3:6] == got[3:6]
    torch.testing.assert_close(crossed[0], got[0], rtol=1e-12, atol=0)


@pytest.mark.parametrize("algorithm", ["sa", "anderson"])
def test_fused_gcy_continuous_solvers_converge_with_coarse_baseline(
        algorithm):
    # JAX tests/test_kernels.py's recipe: the additive profiles of the
    # float64 Newton solution fold into the operands; SA and Anderson then
    # converge at tol 1e-6 from the baseline.
    _, pg = _gcy_cont_grids()
    m = P.GCY()
    T64 = P.T_gcy_continuous_factory(m, pg, space="log", device="cpu")
    ref = P.solve(T64, torch.full(GCY_CONT_SIZES, float(np.log(500.0)),
                                  dtype=torch.float64),
                  method="newton", tol=1e-11)
    baseline = P.operators.additive_profiles(ref.x)
    make = (P.make_fused_solver_gcy_continuous if algorithm == "sa"
            else P.make_fused_anderson_gcy_continuous)
    before = dict(P.FUSED_LAUNCHES)
    fsolve = make(m, pg, degree=5, baseline=baseline, device="cpu")
    ell, iters, err = fsolve(fsolve.baseline_log_w, 1e-6, 100_000)
    assert P.FUSED_LAUNCHES == before          # plain version on the CPU
    assert float(err) <= 1e-6 and bool(torch.isfinite(ell).all())
    w_diff = float((torch.exp(ell.double()) - torch.exp(ref.x)).abs().max())
    assert w_diff < 2.0


@pytest.mark.parametrize("algorithm", ["fused_sa", "fused_anderson"])
def test_wc_ratio_continuous_fused_gcy_coarse(algorithm):
    sizes = (4, 3, 3, 3, 4, 3)
    got = P.wc_ratio_continuous(P.GCY(), sizes, algorithm=algorithm,
                                baseline="coarse", tol=3.04e-5, device="cpu")
    assert got.converged and got.w_star.dtype == torch.float32
    T64 = P.T_gcy_continuous_factory(
        P.GCY(), tuple(g.double() for g in got.grids), space="log",
        device="cpu")
    ell = torch.log(got.w_star.double())
    assert float((T64(ell) - ell).abs().max()) <= 5e-5


def test_fused_T_gcy_continuous_matches_f64():
    jg, pg = _gcy_cont_grids()
    m = P.GCY()
    T = P.make_fused_T_log_gcy_continuous(m, pg, device="cpu")
    T64 = P.T_gcy_continuous_factory(m, pg, space="log",
                                     baseline="loglinear", device="cpu")
    rng = np.random.default_rng(9)
    ell = T.baseline_log_w + 0.05 * torch.as_tensor(
        rng.standard_normal(GCY_CONT_SIZES), dtype=torch.float32)
    got = T(ell)
    assert tuple(got.shape) == GCY_CONT_SIZES
    np.testing.assert_allclose(got.double().numpy(),
                               T64(ell.double()).numpy(), rtol=0, atol=5e-6)
