"""Tiled continuous SSY (interp="pre") of the port vs the JAX package.

The operand set, the eager twin, the passes of the streamed kernels'
batched configuration (pass B's c1-only branch with and without the
folded baseline, the batched pass C) and the operator, the driver and the
grid continuation.  The JAX Pallas kernels run in interpret mode on the
CPU at HIGHEST precision with the accurate transcendentals, as the JAX
package's own tests run them; the port's plain versions (what its
dispatchers run for CPU tensors) take the same numpy inputs.

Tolerances: 1e-12 on the float64 operand fields and twins; 5e-6 abs on
log-domain float32 outputs near log(800), plus one float32 rounding of
the value for pass B's lse midway field (theta*log(800) ~ -107, one ulp
7.6e-6); 5e-6 relative on its fast-mode linear field; 5e-5 in log w for a
float32 solve against the float64 one (the f32 tier's residual bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.drivers import prolong_w as jax_prolong_w
from sdfs_via_autodiff_tpu.kernels.streamed_two_phase import (
    blockdiag_z, build_b_call, build_c_call)
from sdfs_via_autodiff_tpu.kernels.streamed_two_phase import (
    make_streamed_T_log as jax_make_streamed_T_log)
from sdfs_via_autodiff_tpu.operators.two_phase import (
    make_xla_two_phase_T, two_phase_operands_ssy as jax_operands_ssy,
    two_phase_operands_ssy_continuous as jax_operands_ssy_continuous)
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st

SHAPES = (4, 8, 6, 64)
ATOL = 5e-6
EPS32 = float(np.finfo(np.float32).eps)
HIGHEST = jax.lax.Precision.HIGHEST
TILED_TOL = 2e-5            # the f32 Newton tolerance of the cell
F32_SOLVE_ATOL = 5e-5       # f32 solve vs f64 solve, log w


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Solver loops run many small ops, and module fixtures compute torch
    results: one intra-op thread keeps them fast and reproducible when
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


def _sets(sizes, degree=5, baseline=None):
    """JAX grids and operand set, the same grids as port tensors, the
    JAX set crossed over and the port's own set."""
    jg = J.build_grid_ssy(J.SSY(), *sizes)
    pg = P.grids_from_numpy([np.asarray(g) for g in jg])
    jops = jax_operands_ssy_continuous(J.SSY(), jg, degree, baseline)
    crossed = P.operands_from_numpy(dataclasses.asdict(jops))
    pops = P.two_phase_operands_ssy_continuous(P.SSY(), pg, degree, baseline)
    return jg, pg, jops, crossed, pops


@pytest.fixture(scope="module", params=[None, "loglinear"],
                ids=["plain", "loglinear"])
def sets(request):
    return (request.param,) + _sets(SHAPES, baseline=request.param)


def _ell(jops, seed=0):
    """A view field near the solve's iterates: log(800) plus noise, or
    the folded baseline plus noise."""
    rng = np.random.default_rng(seed)
    if jops.baseline_log_w is None:
        return np.log(800.0) + 0.05 * rng.standard_normal(jops.shapes)
    return np.asarray(jops.baseline_log_w) + 0.02 * rng.standard_normal(
        jops.shapes)


# ------------------------------------------------------------ operand set

def test_operand_set_matches_jax(sets):
    baseline, _, _, jops, crossed, pops = sets
    assert pops.c2_batched and not pops.c1_batched and not pops.is_pair
    assert pops.has_sub == (baseline is not None)
    assert pops.shapes == crossed.shapes == SHAPES
    assert (pops.theta, pops.beta) == (crossed.theta, crossed.beta)
    for f in ("W_r1", "W_r2", "W_c1", "W_c2", "add_row", "add_col",
              "sub_row", "sub_col", "baseline_log_w"):
        want = getattr(crossed, f)
        got = getattr(pops, f)
        if want is None:
            assert got is None, f
            continue
        assert got.shape == want.shape, f
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                   err_msg=f)
    assert P.streamed_config(pops) == "batched"


# -------------------------------------------------------------- eager twin

@pytest.mark.parametrize("baseline", [None, "loglinear"])
@pytest.mark.parametrize("sizes", [(4, 5, 6, 7), SHAPES])
def test_eager_twin_matches_jax_xla_twin_and_f64_operator(sizes, baseline):
    _, pg, jops, crossed, pops = _sets(sizes, baseline=baseline)
    ell = _ell(jops, seed=1)
    want = np.asarray(make_xla_two_phase_T(jops, jnp.float64)(
        jnp.asarray(ell)))
    twin = P.make_eager_two_phase_T(pops, torch.float64, device="cpu")
    got = twin(torch.as_tensor(ell)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    T64 = P.T_ssy_continuous_factory(P.SSY(), pg, space="log",
                                     baseline=baseline, device="cpu")
    np.testing.assert_allclose(got, T64(torch.as_tensor(ell)).numpy(),
                               rtol=1e-12, atol=0)


def test_twin_still_rejects_batched_c1_and_mid_col(sets):
    # Batched c1 factors and mid_col are ported (the normalized tiers,
    # tests/test_torch_normalized_two_phase.py): a zero mid_col and a c1
    # factor batched into identical slices leave the twin as it was.
    pops = sets[-1]
    ell = torch.as_tensor(_ell(pops, seed=2))
    want = P.make_eager_two_phase_T(pops, torch.float64, device="cpu")(ell)
    for ops in (dataclasses.replace(pops, mid_col=np.zeros((6, 64))),
                dataclasses.replace(pops, W_c1=np.broadcast_to(
                    pops.W_c1, (64, 6, 6)))):
        got = P.make_eager_two_phase_T(ops, torch.float64, device="cpu")(ell)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13,
                                   atol=0)


# ---------------------------------------------------------------- pass B

def _pass_b(jops, mode, c2_here):
    """JAX's pass B (interpret mode) and the port's plain pass B on the
    same float32 field."""
    L, K, I, J_ = jops.shapes
    R = L * K
    ell = _f32(_ell(jops)).reshape(R, I, J_)
    has_sub = jops.sub_row is not None
    call, _ = build_b_call(R_rows=R, I=I, J=J_, theta=float(jops.theta),
                           prec=HIGHEST, trx="accurate", mode=mode,
                           has_sub=has_sub, c2_here=c2_here,
                           dtype=jnp.float32, interpret=True)
    args = [jnp.asarray(ell), jnp.asarray(_f32(jops.W_c1))]
    W_c2t = None
    if c2_here:
        args.append(jnp.asarray(_f32(jops.W_c2)))
        W_c2t = _t(np.asarray(jops.W_c2).T)
    sub = (None, None)
    if has_sub:
        sub_row = _f32(np.asarray(jops.sub_row).reshape(R, 1))
        args += [jnp.asarray(sub_row), jnp.asarray(_f32(jops.sub_col))]
        sub = (_t(sub_row[:, 0]), _t(jops.sub_col))
    want = call(*args)
    got = st.pass_b_plain(_t(ell), _t(jops.W_c1), W_c2t, float(jops.theta),
                          mode, *sub)
    return got, want


def _assert_pass_b_close(got, want, mode):
    if mode == "fast":
        (mid, s), (mid_j, s_j) = got, want
        np.testing.assert_allclose(mid.numpy(), np.asarray(mid_j), rtol=5e-6,
                                   atol=0)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=0,
                                   atol=ATOL)
    else:
        want = np.asarray(want)
        lim = ATOL + EPS32 * np.abs(want)
        assert np.all(np.abs(got.numpy() - want) <= lim)


@pytest.mark.parametrize("mode", ["fast", "lse"])
def test_pass_b_c1_only_plain_matches_pallas_kernel(sets, mode):
    jops = sets[3]
    got, want = _pass_b(jops, mode, c2_here=False)
    _assert_pass_b_close(got, want, mode)


@pytest.mark.parametrize("mode", ["fast", "lse"])
def test_pass_b_shared_c2_with_sub_matches_pallas_kernel(mode):
    # B1's has_sub branch with a shared c2 factor: a discrete-SSY set with
    # a synthetic folded baseline near theta*log(800).
    jm = J.SSY()
    jops = jax_operands_ssy(jm, J.discretize_ssy(jm, SHAPES))
    L, K, I, J_ = SHAPES
    rng = np.random.default_rng(7)
    th = float(jops.theta)
    jops = dataclasses.replace(
        jops, sub_row=th * (3.0 + 0.1 * rng.standard_normal((L, K))),
        sub_col=th * (np.log(800.0) - 3.0
                      + 0.1 * rng.standard_normal((I, J_))))
    got, want = _pass_b(jops, mode, c2_here=True)
    _assert_pass_b_close(got, want, mode)


def test_sub_arguments_come_in_pairs():
    x = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="both sub_row and sub_col"):
        st.pass_b(x, torch.eye(3), None, -16.0, "lse",
                  sub_row=torch.zeros(2))


# ---------------------------------------------------------------- pass C

@pytest.mark.parametrize("mode", ["fast", "lse"])
def test_pass_c_batched_plain_matches_pallas_kernel(sets, mode):
    _, _, _, jops, _, pops = sets
    L, K, I, J_ = jops.shapes
    R, C = L * K, I * J_
    b, _ = _pass_b(jops, mode, c2_here=False)     # realistic midway input
    th, be = float(jops.theta), float(jops.beta)
    call, TC = build_c_call(shapes=jops.shapes, C_cols=C, theta=th, beta=be,
                            prec=HIGHEST, trx="accurate", mode=mode,
                            c2_batched=True, dtype=jnp.float32,
                            interpret=True)
    Z = jnp.asarray(_f32(blockdiag_z(np.asarray(jops.W_c2), TC)))
    add_col = _f32(jops.add_col).reshape(C)
    rows = [jnp.asarray(_f32(jops.W_r1)), jnp.asarray(_f32(jops.W_r2)),
            jnp.asarray(_f32(jops.add_row)),
            jnp.asarray(add_col.reshape(1, C))]
    W_c2t = _t(np.swapaxes(pops.W_c2, 1, 2))
    common = (W_c2t, _t(jops.W_r1), _t(jops.W_r2), _t(jops.add_row),
              _t(add_col), th, be)
    if mode == "fast":
        mid, s = b
        mid = mid.reshape(R, C)
        S = torch.amax(s).reshape(1)
        scale = torch.exp(s - S)
        want = call(jnp.asarray(mid.numpy()), jnp.asarray(scale.numpy()), Z,
                    *rows, jnp.asarray(S.numpy()))
        got = st.pass_c_batched_plain(mid, scale, S, *common, "fast")
    else:
        mid = b.reshape(R, C)
        want = call(jnp.asarray(mid.numpy()), Z, *rows)
        got = st.pass_c_batched_plain(mid, None, None, *common, "lse")
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


# -------------------------------------------------------------- operator

@pytest.mark.parametrize("mode", ["fast", "lse"])
def test_operator_matches_jax_kernels_and_f64(sets, mode):
    baseline, _, pg, jops, _, pops = sets
    ell = _ell(jops, seed=3)
    jT = jax_make_streamed_T_log(jops, mode=mode, precision="highest",
                                 interpret=True)
    want = np.asarray(jT(jnp.asarray(ell, jnp.float32)), np.float64)
    T = P.make_streamed_T_log(pops, mode=mode, device="cpu")
    assert (T.engine, T.mode) == ("streamed", mode)
    got = T(torch.as_tensor(ell, dtype=torch.float32)).double().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    T64 = P.T_ssy_continuous_factory(P.SSY(), pg, space="log",
                                     baseline=baseline, device="cpu")
    np.testing.assert_allclose(got, T64(torch.as_tensor(ell)).numpy(),
                               rtol=0, atol=ATOL)


def test_auto_mode_and_tiled_wrapper(sets):
    baseline, _, pg, _, _, pops = sets
    T = P.make_tiled_T_log_ssy_continuous(P.SSY(), pg, baseline=baseline,
                                          device="cpu")
    assert T.engine == "streamed"
    assert T.mode == ("fast" if baseline is None else "lse")
    assert hasattr(T, "baseline_log_w") == (baseline is not None)
    with pytest.raises(ValueError, match="TPU-only"):
        P.make_tiled_T_log_ssy_continuous(P.SSY(), pg, device="cpu",
                                          precision="3x")


def test_jvp_rides_the_twin_and_cpu_runs_plain(sets):
    _, _, _, jops, _, pops = sets
    before = dict(st.LAUNCHES)
    T = P.make_streamed_T_log(pops, device="cpu")
    ell = torch.as_tensor(_ell(jops, seed=4), dtype=torch.float32)
    v = 0.01 * torch.ones_like(ell)
    out, got = torch.func.jvp(T, (ell,), (v,))
    want = torch.func.jvp(T.twin, (ell,), (v,))[1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.numpy(), T(ell).numpy())
    assert st.LAUNCHES == before


def test_ragged_set_matches_f64():
    # I and J off every tile multiple; R = 15.
    _, pg, jops, _, pops = _sets((3, 5, 7, 40), baseline="loglinear")
    assert P.streamed_config(pops) == "batched"
    ell = _ell(jops, seed=5)
    T64 = P.T_ssy_continuous_factory(P.SSY(), pg, space="log",
                                     baseline="loglinear", device="cpu")
    for mode in ("fast", "lse"):
        T = P.make_streamed_T_log(pops, mode=mode, device="cpu")
        np.testing.assert_allclose(
            T(torch.as_tensor(ell, dtype=torch.float32)).double().numpy(),
            T64(torch.as_tensor(ell)).numpy(), rtol=0, atol=ATOL)


def test_shared_c2_with_sub_runs_full_against_the_twin():
    # A discrete-SSY set with a synthetic folded baseline: the full
    # configuration, lse by default, against its float64 twin.
    m = P.SSY()
    ops = P.two_phase_operands_ssy(m, P.discretize_ssy(m, SHAPES))
    L, K, I, J_ = SHAPES
    rng = np.random.default_rng(8)
    ops = dataclasses.replace(
        ops, sub_row=ops.theta * 0.1 * rng.standard_normal((L, K)),
        sub_col=ops.theta * (np.log(800.0)
                             + 0.1 * rng.standard_normal((I, J_))))
    assert P.streamed_config(ops) == "full"
    ell = np.log(800.0) + 0.05 * rng.standard_normal(SHAPES)
    want = P.make_eager_two_phase_T(ops, torch.float64, device="cpu")(
        torch.as_tensor(ell)).numpy()
    for mode in ("auto", "fast"):
        T = P.make_streamed_T_log(ops, mode=mode, device="cpu")
        assert T.mode == ("lse" if mode == "auto" else "fast")
        np.testing.assert_allclose(
            T(torch.as_tensor(ell, dtype=torch.float32)).double().numpy(),
            want, rtol=0, atol=ATOL)


# ------------------------------------------------------------ the driver

@pytest.fixture(scope="module")
def jax_solution():
    sol = J.wc_ratio_continuous(J.SSY(), SHAPES, algorithm="newton",
                                tol=1e-10, interp="pre")
    assert bool(sol.converged)
    return np.log(np.asarray(sol.w_star))


@pytest.mark.parametrize("baseline", [None, "loglinear", "coarse"])
def test_tiled_driver_matches_jax_f64_solve(jax_solution, baseline):
    before = dict(st.LAUNCHES)
    sol = P.wc_ratio_continuous(P.SSY(), SHAPES, kernel="tiled",
                                baseline=baseline, tol=TILED_TOL,
                                device="cpu")
    assert sol.converged and sol.w_star.dtype == torch.float32
    assert [g.dtype for g in sol.grids] == [torch.float32] * 4
    np.testing.assert_allclose(torch.log(sol.w_star.double()).numpy(),
                               jax_solution, rtol=0, atol=F32_SOLVE_ATOL)
    assert st.LAUNCHES == before        # CPU tensors: the plain versions


def test_prolong_w_matches_jax():
    coarse = J.build_grid_ssy(J.SSY(), 5, 5, 5, 5)
    fine = J.build_grid_ssy(J.SSY(), 9, 8, 9, 7)
    w = np.exp(np.arange(5 ** 4, dtype=np.float64).reshape(5, 5, 5, 5)
               * 1e-4 + 6.0)
    want = np.asarray(jax_prolong_w(jnp.asarray(w), coarse, fine))
    got = P.prolong_w(torch.as_tensor(w), P.grids_from_numpy(
        [np.asarray(g) for g in coarse]), P.grids_from_numpy(
        [np.asarray(g) for g in fine]))
    assert got.dtype == torch.float64 and tuple(got.shape) == (9, 8, 9, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_grid_continuation_matches_jax():
    schedule = [(5, 5, 5, 6), (10, 10, 10, 12)]
    want = J.wc_ratio_continuation(J.SSY(), schedule, algorithm="newton",
                                   tol=1e-9, interp="pre")
    got = P.wc_ratio_continuation(P.SSY(), schedule, algorithm="newton",
                                  tol=1e-9, interp="pre", device="cpu")
    assert got.converged and bool(want.converged)
    np.testing.assert_allclose(torch.log(got.w_star).numpy(),
                               np.log(np.asarray(want.w_star)), rtol=0,
                               atol=1e-9)
    cold = P.wc_ratio_continuous(P.SSY(), schedule[-1], tol=1e-9,
                                 device="cpu")
    assert got.result.iterations <= cold.result.iterations
    with pytest.raises(ValueError, match="empty grid schedule"):
        P.wc_ratio_continuation(P.SSY(), [], device="cpu")
