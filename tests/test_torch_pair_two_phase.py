"""The continuous-GCY pair passes and operator vs the JAX package.

The JAX Pallas kernels run in interpret mode on the CPU at HIGHEST
precision, as the JAX package's own tests run them (about 5 s an
application, so each is called once per module); the port's plain
versions (what its dispatchers run for CPU tensors) take the same numpy
inputs.  The operand set is that of JAX's ``TestContinuousGCYPair``: GCY
at (8, 3, 2, 4, 128, 2), view (3, 8, 8, 256), log-linear baseline.
Tolerances: 5e-6 abs on log-domain outputs, plus one float32 rounding
of the value for pass B's midway field (theta*ell ~ -240 less the folded
baseline: O(1) values, after one fused multiply-add in both packages;
a separately rounded product would add ~1.5e-5).  The float32
operator is held to the float64 factored chain at 5e-6 (the discrete
paths' class; the JAX package holds its bf16-split kernel to 5e-5), its
tangent to the twin's at 1e-6, and a Newton solve through it to the
float64 fixed point at 5e-4 (JAX's ``test_solve_through_pair_kernel``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.kernels.streamed_two_phase import (
    _deferred_b_config, _pair_config, _streamed_config,
    build_b_call_deferred, build_c_call_pair,
    pair_device_operands as jax_pair_device_operands)
from sdfs_via_autodiff_tpu.operators.two_phase import (
    make_xla_two_phase_T, two_phase_operands_gcy_continuous as
    jax_operands_gcy_continuous)
from sdfs_via_autodiff_tpu.ops.grids import build_grid_gcy as jax_grid_gcy
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st

GSHAPES = (8, 3, 2, 4, 128, 2)     # (h_lam, h_c, h_z, h_zpi, z, z_pi)
RAGGED = (5, 3, 3, 2, 40, 3)       # the JAX streamed tier declines n_z % 128
ATOL = 5e-6
EPS32 = float(np.finfo(np.float32).eps)
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


def _cross(jops):
    """The JAX set as the port's (its attributes as fields)."""
    return P.operands_from_numpy({
        **dataclasses.asdict(jops), "perm": jops.perm,
        "inv_perm": jops.inv_perm, "state_shapes": jops.state_shapes,
        "pair_c2": jops.pair_c2, "pair_shapes": jops.pair_shapes})


def _sets(sizes, baseline="loglinear"):
    jg = jax_grid_gcy(J.GCY(), *sizes)
    pg = P.grids_from_numpy([np.asarray(g) for g in jg])
    jops = jax_operands_gcy_continuous(J.GCY(), jg, 5, baseline)
    return jg, pg, jops, _cross(jops)


@pytest.fixture(scope="module")
def operands():
    return _sets(GSHAPES)


@pytest.fixture(scope="module")
def midway(operands):
    """Pass B with the folded baseline, both packages, one view field
    near the baseline (the solve's iterates stay there)."""
    _, _, jops, _ = operands
    L, K, I, J_ = jops.shapes
    R = L * K
    rng = np.random.default_rng(5)
    ell = _f32(np.asarray(jops.baseline_log_w)
               + 0.05 * rng.standard_normal(jops.shapes)).reshape(R, I, J_)
    TB, TJ = _deferred_b_config(jops.shapes)
    call, _ = build_b_call_deferred(
        R_rows=R, I=I, J=J_, TB=TB, TJ=TJ, theta=float(jops.theta),
        prec=HIGHEST, trx="accurate", has_sub=True, dtype=jnp.float32,
        interpret=True)
    sub_row = _f32(np.asarray(jops.sub_row).reshape(R, 1))
    want = np.asarray(call(jnp.asarray(ell), jnp.asarray(_f32(jops.W_c1)),
                           jnp.asarray(sub_row),
                           jnp.asarray(_f32(jops.sub_col))))
    got = st.pass_b_deferred_plain(_t(ell), _t(np.asarray(jops.W_c1).T),
                                   float(jops.theta), _t(sub_row[:, 0]),
                                   _t(jops.sub_col))
    return got, want


@pytest.fixture(scope="module")
def pair_pass_c(operands, midway):
    """Pass C of both packages on the port's midway field."""
    _, _, jops, pops = operands
    L, K, I, J_ = jops.shapes
    R, C = L * K, I * J_
    mid = midway[0].reshape(R, C)
    th, be = float(jops.theta), float(jops.beta)
    call, _ = build_c_call_pair(
        shapes=jops.shapes, pair_shapes=jops.pair_shapes, C_cols=C,
        g=_pair_config(jops)["g"], theta=th, beta=be, prec=HIGHEST,
        trx="accurate", dtype=jnp.float32, interpret=True)
    PzpiS, PzT = jax_pair_device_operands(
        jops, lambda a: jnp.asarray(a, jnp.float32))
    add_col = _f32(jops.add_col).reshape(C)
    want = np.asarray(call(jnp.asarray(mid.numpy()), PzpiS, PzT,
                           jnp.asarray(_f32(jops.W_r1)),
                           jnp.asarray(_f32(jops.W_r2)),
                           jnp.asarray(_f32(jops.add_row)),
                           jnp.asarray(add_col.reshape(1, C))))
    P_zpi, PzT_p = st.pair_device_operands(pops, device="cpu")
    got = st.pass_c_pair_plain(mid, P_zpi, PzT_p, _t(jops.W_r1),
                               _t(jops.W_r2), _t(jops.add_row), _t(add_col),
                               th, be)
    return got, want


def test_both_packages_choose_the_pair_configuration(operands):
    _, _, jops, pops = operands
    assert _streamed_config(jops)["kind"] == "pair"
    assert P.streamed_config(pops) == "pair"
    assert pops.W_c2 is None and pops.is_pair and pops.has_sub


def test_pass_b_deferred_sub_plain_matches_pallas_kernel(midway):
    got, want = midway
    assert got.shape == want.shape
    lim = ATOL + EPS32 * np.abs(want)
    assert np.all(np.abs(got.numpy() - want) <= lim)


def test_pass_c_pair_plain_matches_pallas_kernel(pair_pass_c):
    got, want = pair_pass_c
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_pair_layout_is_the_jax_transpose(operands):
    _, _, jops, pops = operands
    P_zpi, PzT = st.pair_device_operands(pops, torch.float64, device="cpu")
    _, jPzT = jax_pair_device_operands(jops, lambda a: np.asarray(a))
    np.testing.assert_array_equal(PzT.numpy(), jPzT)
    np.testing.assert_array_equal(P_zpi.numpy(), jops.pair_c2[1])


def test_tiled_operator_matches_f64_factored_chain():
    _, pg, _, _ = _sets(GSHAPES)
    m = P.GCY()
    T = P.make_tiled_T_log_gcy_continuous(m, pg, baseline="loglinear",
                                          device="cpu")
    assert (T.engine, T.mode) == ("streamed-pair", "lse")
    T64 = P.T_gcy_continuous_factory(m, pg, space="log",
                                     baseline="loglinear", device="cpu")
    np.testing.assert_allclose(T.baseline_log_w.double().numpy(),
                               T64.baseline_log_w.numpy(), rtol=0,
                               atol=EPS32 * 10)
    rng = np.random.default_rng(2)
    ell = (T.baseline_log_w
           + 0.05 * torch.as_tensor(rng.standard_normal(GSHAPES),
                                    dtype=torch.float32))
    got = T(ell)
    assert got.dtype == torch.float32 and tuple(got.shape) == GSHAPES
    np.testing.assert_allclose(got.double().numpy(),
                               T64(ell.double()).numpy(), rtol=0, atol=ATOL)
    # The view operator and the twin on the natural layout.
    view_shape = T.to_view(ell).shape
    view = T.view_T(T.to_view(ell).reshape(3, 8, 8, 256))
    np.testing.assert_array_equal(
        T.from_view(view.reshape(view_shape)).numpy(), got.numpy())
    np.testing.assert_allclose(T.twin(ell).numpy(), got.numpy(), rtol=0,
                               atol=ATOL)


def test_jvp_matches_the_twin():
    _, pg, _, _ = _sets(GSHAPES)
    T = P.make_tiled_T_log_gcy_continuous(P.GCY(), pg, baseline="loglinear",
                                          device="cpu")
    ell = T.baseline_log_w.clone()
    v = 0.01 * torch.ones_like(ell)
    out, got = torch.func.jvp(T, (ell,), (v,))
    want = torch.func.jvp(T.twin, (ell,), (v,))[1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.numpy(), T(ell).numpy())


def test_newton_through_the_pair_operator():
    # The float32 recipe: a coarse-fit additive baseline (the log-linear
    # closed form leaves theta * residual span ~ 95 here).
    _, pg, _, _ = _sets(GSHAPES)
    m = P.GCY()
    T64 = P.T_gcy_continuous_factory(m, pg, space="log",
                                     baseline="loglinear", device="cpu")
    res64 = P.solve(T64, T64.baseline_log_w, method="newton", tol=1e-10)
    assert res64.converged
    baseline = P.operators.additive_profiles(res64.x)
    T = P.make_tiled_T_log_gcy_continuous(m, pg, baseline=baseline,
                                          device="cpu")
    res = P.solve(T, T.baseline_log_w, method="newton", tol=2e-4,
                  max_iter=8)
    assert res.converged
    np.testing.assert_allclose(res.x.double().numpy(), res64.x.numpy(),
                               rtol=0, atol=5e-4)


def test_ragged_set_matches_jax_f64_twin():
    _, pg, jops, pops = _sets(RAGGED)
    assert _streamed_config(jops) is None          # JAX: n_z % 128
    assert P.streamed_config(pops) == "pair"
    T = P.make_tiled_T_log_gcy_continuous(P.GCY(), pg, baseline="loglinear",
                                          device="cpu")
    rng = np.random.default_rng(4)
    view = (np.asarray(jops.baseline_log_w)
            + 0.05 * rng.standard_normal(jops.shapes))
    want = np.asarray(make_xla_two_phase_T(jops, jnp.float64)(
        jnp.asarray(view)))
    got = T.view_T(torch.as_tensor(view, dtype=torch.float32))
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=ATOL)


def test_cpu_tensors_run_the_plain_pair_versions(operands):
    _, _, jops, pops = operands
    before = dict(st.LAUNCHES)
    T = P.make_streamed_T_log(pops, device="cpu")
    assert (T.engine, T.mode) == ("streamed-pair", "lse")
    out = T(torch.as_tensor(np.asarray(jops.baseline_log_w),
                            dtype=torch.float32))
    assert bool(torch.isfinite(out).all())
    assert st.LAUNCHES == before


def test_fast_mode_rejected_on_pair_sets(operands):
    _, _, _, pops = operands
    with pytest.raises(ValueError, match="LSE only"):
        P.make_streamed_T_log(pops, mode="fast", device="cpu")


def test_sub_arguments_come_in_pairs():
    x = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="both sub_row and sub_col"):
        st.pass_b_deferred(x, torch.eye(3), -36.0, sub_row=torch.zeros(2))


def test_pair_configuration_by_shared_memory(operands):
    _, _, _, pops = operands
    # (R, n_j) = (128, 128): the 18.9M grid's blocks fit (148 KB).
    assert st.pass_c_pair_smem_bytes(128, 16, 128) <= st.SMEM_LIMIT
    # A z axis of 512 points at 128 rows does not.
    assert st.pass_c_pair_smem_bytes(128, 16, 512) > st.SMEM_LIMIT
    wide = dataclasses.replace(pops, pair_shapes=(2, 4, 2, 512),
                               shapes=(16, 8, 8, 1024))
    assert P.streamed_config(wide) is None
    # Pair sets have no strip form (as in JAX): the tiled tier refuses.
    with pytest.raises(ValueError, match="pair"):
        P.make_tiled_T_log(wide, device="cpu")
    with_mid = dataclasses.replace(pops, mid_col=np.zeros((8, 256)))
    assert P.streamed_config(with_mid) is None


# Every continuous-GCY size the pair configuration covered before the
# cluster kernel: the GPU tests' sets and the chip smoke script's cells
# (its 18.9M and 4.2M grids, its small and ragged sets).  Sizes are
# (h_lam, h_c, h_z, h_zpi, z, z_pi).
PAIR_SIZES = [(8, 3, 2, 4, 128, 2), (5, 3, 3, 2, 40, 3), (4, 5, 3, 3, 33, 2),
              (8, 8, 8, 8, 128, 8), (16, 8, 12, 12, 128, 8),
              (5, 3, 2, 2, 40, 12)]


@pytest.mark.parametrize("sizes", PAIR_SIZES)
def test_pair_sets_stay_pair(operands, sizes):
    # The view (h_c, h_lam, h_z*h_zpi, z_pi*z) and pair shapes of each
    # size on the module's set (the configuration reads only those).
    _, _, _, pops = operands
    view = (sizes[1], sizes[0], sizes[2] * sizes[3], sizes[5] * sizes[4])
    pair = (sizes[2], sizes[3], sizes[5], sizes[4])
    assert P.streamed_config(dataclasses.replace(
        pops, shapes=view, pair_shapes=pair)) == "pair"
    if sizes == GSHAPES:
        assert pops.shapes == view and pops.pair_shapes == pair


@pytest.mark.parametrize("n_b", [1, 2, 3, 8, 9, 12, 16, 17, 40])
def test_pair_cluster_gives_every_slab_and_row_one_owner(n_b):
    cs = st.pair_cluster_size(n_b)
    assert cs == min(n_b, 8)
    owners = sorted(b for rank in range(cs) for b in st.pair_groups(rank, n_b))
    assert owners == list(range(n_b))
    for rank in range(cs):
        # Group b is rank b % cs's, in round b // cs.
        assert all(b % cs == rank for b in st.pair_groups(rank, n_b))
    for R in (1, 2, 7, 15, 24, 128):
        rows = [r for rank in range(cs) for r in st.pair_rows(rank, R, n_b)]
        assert rows == list(range(R))
        for r in range(R):
            assert r in st.pair_rows(st.pair_row_owner(r, R, n_b), R, n_b)
        # The round's staging area (cs groups of the largest row chunk)
        # fits in the product's u and K-tiles, (R + 32) rows of n_j.
        assert cs * -(-R // cs) <= R + 32
