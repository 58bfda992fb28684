"""CUDA kernels of the PyTorch port vs their plain versions, on the card.

Marked ``gpu``: every test skips without a CUDA device.  This file
imports neither JAX nor the JAX package, so on a GPU machine without JAX
it runs with ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu_kernels.py``.  Tolerances as in
``test_torch_streamed_two_phase.py``, ``test_torch_deferred_two_phase.py``,
``test_torch_pair_two_phase.py``, ``test_torch_batched_two_phase.py``,
``test_torch_fused.py``, ``test_torch_post_interp.py`` and
``test_torch_strip_two_phase.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu_torch.kernels import anderson_kernel as ak
from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
from sdfs_via_autodiff_tpu_torch.kernels import post_interp_kernel as pk
from sdfs_via_autodiff_tpu_torch.kernels import solver_kernel as sk
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st
from sdfs_via_autodiff_tpu_torch.kernels import tangent_two_phase as ktp
from sdfs_via_autodiff_tpu_torch.kernels import tiled_two_phase as tt
from sdfs_via_autodiff_tpu_torch.ops.tangent import Tape

pytestmark = pytest.mark.gpu

ATOL = 5e-6
EPS32 = float(np.finfo(np.float32).eps)
# Ragged cases too: J not a multiple of 4 (J < 256 and J >= 256), I not
# a multiple of the c1 pass's 8-row tiles (I = 56 with J = 42 among
# them), steps of several field rows with a partial last one, and the
# SSY cell (32, 32, 32, 384).
CASES = [((4, 8, 6, 64), "rouwenhorst"), ((56, 56, 56, 64), "rouwenhorst"),
         ((8, 16, 32, 384), "tauchen"), ((4, 6, 10, 30), "tauchen"),
         ((2, 4, 12, 258), "tauchen"), ((3, 5, 56, 42), "tauchen"),
         ((32, 32, 32, 384), "tauchen")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _setup(shapes, method, dev):
    m = P.SSY()
    ops = P.two_phase_operands_ssy(m, P.discretize_ssy(m, shapes,
                                                       method=method))
    L, K, I, J = shapes
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=dev, dtype=torch.float32)
    rng = np.random.default_rng(0)
    ell = cast(np.log(800.0) + 0.05 * rng.standard_normal((L * K, I, J)))
    return ops, ell, cast


@pytest.mark.parametrize("mode", ["fast", "lse"])
@pytest.mark.parametrize("shapes,method", CASES)
def test_pass_b_kernel_matches_plain(cuda, shapes, method, mode):
    ops, ell, cast = _setup(shapes, method, cuda)
    args = (cast(ops.W_c1), cast(np.asarray(ops.W_c2).T), float(ops.theta),
            mode)
    before = st.LAUNCHES["pass_b"]
    got = st.pass_b(ell, *args)
    assert st.LAUNCHES["pass_b"] == before + 1
    want = st.pass_b_plain(ell, *args)
    if mode == "fast":
        rel = ((got[0] - want[0]).abs() / want[0].abs()).max()
        assert float(rel) <= 5e-6
        assert float((got[1] - want[1]).abs().max()) <= ATOL
    else:
        lim = ATOL + EPS32 * want.abs()
        assert bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("mode", ["fast", "lse"])
@pytest.mark.parametrize("shapes,method", CASES)
def test_pass_c_kernel_matches_plain(cuda, shapes, method, mode):
    ops, ell, cast = _setup(shapes, method, cuda)
    L, K, I, J = shapes
    R, C = L * K, I * J
    b = st.pass_b_plain(ell, cast(ops.W_c1), cast(np.asarray(ops.W_c2).T),
                        float(ops.theta), mode)
    if mode == "fast":
        mid, s = b
        S = s.max().reshape(1)
        scale = torch.exp(s - S)
    else:
        mid, scale, S = b, None, None
    args = (mid.reshape(R, C), scale, S, cast(ops.W_r1), cast(ops.W_r2),
            cast(ops.add_row), cast(ops.add_col.reshape(C)),
            float(ops.theta), float(ops.beta), mode)
    got = st.pass_c(*args)
    want = st.pass_c_plain(*args)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


# Deferred passes on GCY operand sets, natural shapes (z, z_pi, h_z, h_c,
# h_zpi, h_lam) -> view (L, K, I, J): ragged (2, 3, 30, 30) and
# (2, 4, 56, 258), the JAX test's (4, 8, 240, 128), the 25.2M-point
# grid's (12, 16, 512, 256) and (12, 24, 240, 128), whose 288 rows take
# a cluster of 2 blocks in the deferred pass C.
DEFERRED_CASES = [(15, 2, 5, 2, 6, 3), (7, 8, 43, 2, 6, 4),
                  (30, 8, 16, 4, 8, 8), (32, 16, 16, 12, 16, 16),
                  (30, 8, 16, 12, 8, 24)]


def _gcy_setup(shapes, dev):
    m = P.GCY()
    ops = P.two_phase_operands_gcy(m, P.discretize_gcy(m, shapes,
                                                       method="tauchen"))
    L, K, I, J = ops.shapes
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=dev, dtype=torch.float32)
    rng = np.random.default_rng(0)
    ell = cast(np.log(800.0) + 0.05 * rng.standard_normal((L * K, I, J)))
    return ops, ell, cast


@pytest.mark.parametrize("shapes", DEFERRED_CASES)
def test_pass_b_deferred_kernel_matches_plain(cuda, shapes):
    ops, ell, cast = _gcy_setup(shapes, cuda)
    args = (cast(np.asarray(ops.W_c1).T), float(ops.theta))
    before = st.LAUNCHES["pass_b_deferred"]
    got = st.pass_b_deferred(ell, *args)
    assert st.LAUNCHES["pass_b_deferred"] == before + 1
    want = st.pass_b_deferred_plain(ell, *args)
    # Midway values near theta*log(800) ~ -241: one f32 rounding beside
    # the 5e-6.
    lim = ATOL + EPS32 * want.abs()
    assert bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("shapes", DEFERRED_CASES)
def test_pass_c_deferred_kernel_matches_plain(cuda, shapes):
    ops, ell, cast = _gcy_setup(shapes, cuda)
    L, K, I, J = ops.shapes
    R, C = L * K, I * J
    mid = st.pass_b_deferred_plain(ell, cast(np.asarray(ops.W_c1).T),
                                   float(ops.theta)).reshape(R, C)
    args = (mid, cast(np.asarray(ops.W_c2).T), cast(ops.W_r1),
            cast(ops.W_r2), cast(ops.add_row), cast(ops.add_col.reshape(C)),
            float(ops.theta), float(ops.beta))
    before = st.LAUNCHES["pass_c_deferred"]
    got = st.pass_c_deferred(*args)
    assert st.LAUNCHES["pass_c_deferred"] == before + 1
    want = st.pass_c_deferred_plain(*args)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


def test_gcy_deferred_operator_matches_f64(cuda):
    m = P.GCY()
    shapes = (30, 8, 16, 4, 8, 8)
    d = P.discretize_gcy(m, shapes)
    T = P.make_tiled_T_log_gcy(m, d, device=cuda)
    assert T.engine == "streamed-deferred"
    rng = np.random.default_rng(6)
    ell = torch.as_tensor(np.log(800.0) + 0.05 * rng.standard_normal(shapes),
                          device=cuda)
    want = P.T_gcy_factory(m, d, space="log", device=cuda)(ell)
    assert float((T(ell.float()).double() - want).abs().max()) <= ATOL


# Continuous-GCY pair sets, log-linear baseline: the JAX test's
# (8, 3, 2, 4, 128, 2), a ragged (5, 3, 3, 2, 40, 3) (n_j = 40: 16-byte
# copies, R = 15 rows), an odd (4, 5, 3, 3, 33, 2) (n_j = 33: the scalar
# loads and 4-byte copies) and the 4.2M-point (8, 8, 8, 8, 128, 8).
PAIR_CASES = [(8, 3, 2, 4, 128, 2), (5, 3, 3, 2, 40, 3),
              (4, 5, 3, 3, 33, 2), (8, 8, 8, 8, 128, 8)]
# n_b = 12 z_pi points, above the cluster limit of 8: two rounds, with
# R = 15 rows over 8 cluster ranks.
PAIR_WIDE = (5, 3, 2, 2, 40, 12)


def _pair_setup(sizes, dev):
    m = P.GCY()
    ops = P.two_phase_operands_gcy_continuous(
        m, P.build_grid_gcy(m, *sizes), 5, "loglinear")
    L, K, I, J = ops.shapes
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=dev, dtype=torch.float32)
    rng = np.random.default_rng(0)
    ell = cast(ops.baseline_log_w
               + 0.05 * rng.standard_normal(ops.shapes)).reshape(L * K, I, J)
    return ops, ell, cast


@pytest.mark.parametrize("sizes", PAIR_CASES)
@pytest.mark.parametrize("with_sub", [True, False])
def test_pass_b_deferred_sub_kernel_matches_plain(cuda, sizes, with_sub):
    ops, ell, cast = _pair_setup(sizes, cuda)
    L, K, I, J = ops.shapes
    sub = ((cast(np.asarray(ops.sub_row).reshape(L * K)), cast(ops.sub_col))
           if with_sub else (None, None))
    args = (cast(np.asarray(ops.W_c1).T), float(ops.theta)) + sub
    before = st.LAUNCHES["pass_b_deferred"]
    got = st.pass_b_deferred(ell, *args)
    assert st.LAUNCHES["pass_b_deferred"] == before + 1
    want = st.pass_b_deferred_plain(ell, *args)
    lim = ATOL + EPS32 * want.abs()
    assert bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("sizes", PAIR_CASES + [PAIR_WIDE])
def test_pass_c_pair_kernel_matches_plain(cuda, sizes):
    ops, ell, cast = _pair_setup(sizes, cuda)
    L, K, I, J = ops.shapes
    R, C = L * K, I * J
    mid = st.pass_b_deferred_plain(
        ell, cast(np.asarray(ops.W_c1).T), float(ops.theta),
        cast(np.asarray(ops.sub_row).reshape(R)),
        cast(ops.sub_col)).reshape(R, C)
    P_zpi, PzT = st.pair_device_operands(ops, device=cuda)
    args = (mid, P_zpi, PzT, cast(ops.W_r1), cast(ops.W_r2),
            cast(ops.add_row), cast(ops.add_col.reshape(C)),
            float(ops.theta), float(ops.beta))
    before = st.LAUNCHES["pass_c_pair"]
    got = st.pass_c_pair(*args)
    assert st.LAUNCHES["pass_c_pair"] == before + 1
    want = st.pass_c_pair_plain(*args)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


def test_gcy_continuous_pair_operator_matches_f64(cuda):
    m = P.GCY()
    sizes = (8, 3, 2, 4, 128, 2)
    grids = P.build_grid_gcy(m, *sizes)
    T = P.make_tiled_T_log_gcy_continuous(m, grids, baseline="loglinear",
                                          device=cuda)
    assert T.engine == "streamed-pair"
    rng = np.random.default_rng(6)
    ell = T.baseline_log_w.double() + 0.05 * torch.as_tensor(
        rng.standard_normal(sizes), device=cuda)
    want = P.T_gcy_continuous_factory(m, grids, space="log",
                                      baseline="loglinear",
                                      device=cuda)(ell)
    assert float((T(ell.float()).double() - want).abs().max()) <= ATOL


# Continuous-SSY sets (c2 batched over the current h_z): the JAX test's
# (4, 8, 6, 64), a ragged (3, 5, 7, 40), (20, 20, 20, 20) and a ragged
# (31, 29, 5, 42) whose batched pass C runs a cluster of 2 (k-slabs of
# 15 and 14, l-slabs of 16 and 15, J % 4 != 0), with and without the
# log-linear baseline.
BATCHED_CASES = [(4, 8, 6, 64), (3, 5, 7, 40), (20, 20, 20, 20),
                 (31, 29, 5, 42)]


def _batched_setup(sizes, baseline, dev):
    m = P.SSY()
    ops = P.two_phase_operands_ssy_continuous(
        m, P.build_grid_ssy(m, *sizes), 5, baseline)
    L, K, I, J = sizes
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=dev, dtype=torch.float32)
    rng = np.random.default_rng(0)
    ell = (np.log(800.0) + 0.05 * rng.standard_normal(sizes)
           if baseline is None
           else ops.baseline_log_w + 0.02 * rng.standard_normal(sizes))
    sub = ((cast(np.asarray(ops.sub_row).reshape(L * K)), cast(ops.sub_col))
           if baseline else (None, None))
    return ops, cast(ell).reshape(L * K, I, J), cast, sub


@pytest.mark.parametrize("mode", ["fast", "lse"])
@pytest.mark.parametrize("baseline", [None, "loglinear"])
@pytest.mark.parametrize("sizes", BATCHED_CASES)
def test_pass_b_c1_kernel_matches_plain(cuda, sizes, baseline, mode):
    ops, ell, cast, sub = _batched_setup(sizes, baseline, cuda)
    args = (cast(ops.W_c1), None, float(ops.theta), mode) + sub
    key = "pass_b_c1" if baseline is None else "pass_b_c1_sub"
    before = st.LAUNCHES[key]
    got = st.pass_b(ell, *args)
    assert st.LAUNCHES[key] == before + 1
    want = st.pass_b_plain(ell, *args)
    if mode == "fast":
        rel = ((got[0] - want[0]).abs() / want[0].abs()).max()
        assert float(rel) <= 5e-6
        assert float((got[1] - want[1]).abs().max()) <= ATOL
    else:
        lim = ATOL + EPS32 * want.abs()
        assert bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("mode", ["fast", "lse"])
@pytest.mark.parametrize("shapes,method", CASES[:2])
def test_pass_b_shared_c2_with_sub_matches_plain(cuda, shapes, method,
                                                 mode):
    ops, ell, cast = _setup(shapes, method, cuda)
    L, K, I, J = shapes
    rng = np.random.default_rng(1)
    th = float(ops.theta)
    sub = (cast(th * (3.0 + 0.1 * rng.standard_normal(L * K))),
           cast(th * (np.log(800.0) - 3.0
                      + 0.1 * rng.standard_normal((I, J)))))
    args = (cast(ops.W_c1), cast(np.asarray(ops.W_c2).T), th, mode) + sub
    before = st.LAUNCHES["pass_b"]
    got = st.pass_b(ell, *args)
    assert st.LAUNCHES["pass_b"] == before + 1
    want = st.pass_b_plain(ell, *args)
    if mode == "fast":
        rel = ((got[0] - want[0]).abs() / want[0].abs()).max()
        assert float(rel) <= 5e-6
        assert float((got[1] - want[1]).abs().max()) <= ATOL
    else:
        lim = ATOL + EPS32 * want.abs()
        assert bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("mode", ["fast", "lse"])
@pytest.mark.parametrize("baseline", [None, "loglinear"])
@pytest.mark.parametrize("sizes", BATCHED_CASES)
def test_pass_c_batched_kernel_matches_plain(cuda, sizes, baseline, mode):
    ops, ell, cast, sub = _batched_setup(sizes, baseline, cuda)
    L, K, I, J = sizes
    R, C = L * K, I * J
    b = st.pass_b_plain(ell, cast(ops.W_c1), None, float(ops.theta), mode,
                        *sub)
    scale = S = None
    if mode == "fast":
        b, s = b
        S = s.max().reshape(1)
        scale = torch.exp(s - S)
    args = (b.reshape(R, C), scale, S, cast(np.swapaxes(ops.W_c2, 1, 2)),
            cast(ops.W_r1), cast(ops.W_r2), cast(ops.add_row),
            cast(ops.add_col.reshape(C)), float(ops.theta), float(ops.beta),
            mode)
    key = "pass_c_batched" if mode == "fast" else "pass_c_batched_lse"
    before = st.LAUNCHES[key]
    got = st.pass_c_batched(*args)
    assert st.LAUNCHES[key] == before + 1
    want = st.pass_c_batched_plain(*args)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("baseline", [None, "loglinear"])
def test_ssy_continuous_tiled_operator_matches_f64(cuda, baseline):
    m = P.SSY()
    sizes = (4, 8, 6, 64)
    grids = P.build_grid_ssy(m, *sizes)
    T64 = P.T_ssy_continuous_factory(m, grids, space="log",
                                     baseline=baseline, device=cuda)
    rng = np.random.default_rng(6)
    ell = (np.log(800.0) if baseline is None
           else T64.baseline_log_w.cpu().numpy()) + 0.02 * (
        rng.standard_normal(sizes))
    ell = torch.as_tensor(ell, device=cuda)
    for mode in ("fast", "lse"):
        T = P.make_tiled_T_log_ssy_continuous(m, grids, baseline=baseline,
                                              mode=mode, device=cuda)
        assert T.engine == "streamed"
        assert float((T(ell.float()).double() - T64(ell)).abs().max()) <= ATOL


def test_uncovered_sets_raise_on_the_card(cuda):
    rng = np.random.default_rng(0)
    W = lambda n: rng.random((n, n))
    wide = P.TwoPhaseOperands(
        shapes=(2, 2, 2048, 64), W_r1=W(2), W_r2=W(2), W_c1=W(2048),
        W_c2=W(64), add_row=np.zeros((2, 2)), add_col=np.zeros((2048, 64)),
        theta=-36.0, beta=0.9987)
    # The streamed kernels do not cover it; the strip kernels run it.
    T = P.make_tiled_T_log(wide, device=cuda)
    x = torch.full((2, 2, 2048, 64), np.log(800.0), device=cuda)
    assert T.engine == "strip"
    assert float((T(x) - T.twin(x)).abs().max()) <= ATOL
    ell = torch.zeros((4, 2048, 64), device=cuda)
    with pytest.raises(ValueError, match="exceeds shared memory"):
        st.pass_b_deferred(ell, torch.zeros((2048, 2048), device=cuda),
                           -36.0)


def test_eager_twin_refuses_tf32(cuda):
    m = P.SSY()
    T = P.make_tiled_T_log_ssy(m, P.discretize_ssy(m, (4, 8, 6, 64)),
                               device=cuda)
    x = torch.full((4, 8, 6, 64), 6.7, device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full-FP32"):
            T.twin(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert bool(torch.isfinite(T.twin(x)).all())


# Pass B's variants on the normalized SSY set (Tauchen, conjugated to
# shared factors, the folded baseline): lse with the fold and a shared
# c2, with a seeded mid_col, and c1 only (fast and lse) with the fold, at
# a ragged set (I = 56, J = 42) and the SSY cell.
@pytest.mark.parametrize("variant", ["fold", "mid", "c1_fast", "c1_lse"])
@pytest.mark.parametrize("shapes", [(3, 5, 56, 42), (32, 32, 32, 384)])
def test_pass_b_normalized_variants_match_plain(cuda, shapes, variant):
    import dataclasses
    m = P.SSY()
    ops = P.conjugate_to_shared(P.two_phase_operands_ssy(
        m, P.discretize_ssy(m, shapes, method="tauchen"), "loglinear"))
    rng = np.random.default_rng(2)
    if variant == "mid":
        ops = dataclasses.replace(
            ops, mid_col=0.05 * rng.standard_normal(shapes[2:]))
    L, K, I, J = shapes
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=cuda, dtype=torch.float32)
    ell = cast(ops.baseline_log_w + 0.02 * rng.standard_normal(
        shapes)).reshape(L * K, I, J)
    c2 = variant in ("fold", "mid")
    mode = "fast" if variant == "c1_fast" else "lse"
    args = (cast(ops.W_c1), cast(np.asarray(ops.W_c2).T) if c2 else None,
            float(ops.theta), mode,
            cast(np.asarray(ops.sub_row).reshape(-1)), cast(ops.sub_col),
            cast(ops.mid_col) if variant == "mid" else None)
    key = {"fold": "pass_b", "mid": "pass_b_mid"}.get(variant,
                                                      "pass_b_c1_sub")
    before = st.LAUNCHES[key]
    got = st.pass_b(ell, *args)
    assert st.LAUNCHES[key] == before + 1
    want = st.pass_b_plain(ell, *args)
    if mode == "fast":
        rel = ((got[0] - want[0]).abs() / want[0].abs()).max()
        assert float(rel) <= 5e-6
        assert float((got[1] - want[1]).abs().max()) <= ATOL
    else:
        assert bool(((got - want).abs() <= ATOL + EPS32 * want.abs()).all())


# Pass B's c1-pass layouts on seeded synthetic operands (row-stochastic
# factors, a field near log(800)): several rows a step with a partial
# last one (13, 37), W_c1^T resident beside two slabs (200, 20) and W_c1
# read from global memory beside one slab (512, 40), with and without c2.
@pytest.mark.parametrize("c2", [True, False])
@pytest.mark.parametrize("mode", ["fast", "lse"])
@pytest.mark.parametrize("R,I,J", [(9, 13, 37), (5, 200, 20), (3, 512, 40)])
def test_pass_b_c1_layouts_match_plain(cuda, R, I, J, mode, c2):
    rng = np.random.default_rng(R * I + J)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=cuda)
    W1, W2 = rng.random((I, I)), rng.random((J, J))
    W1 /= W1.sum(axis=1, keepdims=True)
    W2 /= W2.sum(axis=1, keepdims=True)
    ell = f32(np.log(800.0) + 0.05 * rng.standard_normal((R, I, J)))
    args = (f32(W1), f32(W2.T) if c2 else None, -16.0, mode)
    got = st.pass_b(ell, *args)
    want = st.pass_b_plain(ell, *args)
    if mode == "fast":
        rel = ((got[0] - want[0]).abs() / want[0].abs()).max()
        assert float(rel) <= 5e-6
        assert float((got[1] - want[1]).abs().max()) <= ATOL
    else:
        assert bool(((got - want).abs() <= ATOL + EPS32 * want.abs()).all())


@pytest.mark.parametrize("I,J", [(32, 384), (56, 64), (6, 64), (56, 42),
                                 (13, 37), (1, 1), (200, 20), (512, 40),
                                 (12, 258), (170, 170)])
def test_pass_b_layout_mirrors_the_launcher(cuda, I, J):
    want = st.pass_b_layout(I, J)
    got = (ctypes.c_int * 11)()
    assert st._lib().sdfs_pass_b_layout(I, J, got) == 1
    assert tuple(got) == want
    assert (st._lib().sdfs_pass_b_work_floats(100, I, J, 1)
            == st.pass_b_work_floats(100, I, J, True))
    assert st._lib().sdfs_pass_b_work_floats(100, I, J, 0) == 0


# Pass C with a shared c2 (the row kernel with the linear carry in lse
# mode) on seeded synthetic operands: the wide layout at the SSY cell's
# (32, 32) and a ragged (12, 16, 4099); the narrow one at (128, 48)
# (R = 6,144) and (80, 80).
@pytest.mark.parametrize("mode", ["fast", "lse"])
@pytest.mark.parametrize("L,K,C", [(32, 32, 12288), (12, 16, 4099),
                                   (128, 48, 1001), (80, 80, 68)])
def test_pass_c_row_layouts_match_plain(cuda, L, K, C, mode):
    mid, args = _row_operands(L, K, C, mode, cuda)
    wide = st.strip_row_layout(L, K)[5]
    assert wide == (L * K < 5800)
    before = dict(st.LAUNCHES), dict(tt.LAUNCHES)
    got = st.pass_c(mid, *args)
    assert st.LAUNCHES["pass_c"] == before[0]["pass_c"] + 1
    assert tt.LAUNCHES == before[1]
    want = st.pass_c_plain(mid, *args)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


def test_kernel_wrappers_validate_arguments(cuda):
    ops, ell, cast = _setup((4, 8, 6, 64), "rouwenhorst", cuda)
    W_c1, W_c2t = cast(ops.W_c1), cast(np.asarray(ops.W_c2).T)
    with pytest.raises(TypeError, match="float32"):
        st.pass_b(ell.double(), W_c1, W_c2t, float(ops.theta), "fast")
    with pytest.raises(ValueError, match="contiguous"):
        st.pass_b(ell.transpose(1, 2), W_c1, W_c2t.T, float(ops.theta),
                  "lse")
    with pytest.raises(ValueError, match="is on"):
        st.pass_b(ell, W_c1.cpu(), W_c2t, float(ops.theta), "fast")


# Strip tier (B9) and pass B's mid_col branch (B1): (model, shapes,
# method, baseline, lazy_bytes, mode) as in chip_smoke.py, ragged on
# purpose.  Plain GCY sets run lse only (their rows span beyond float32's
# exp range, outside fast mode's envelope).  The column phase's product
# tiles (tiled_two_phase.strip_col_layout) at their edges: shared factors
# folded into N (P and N ragged on 128 x 128 at (3,5,67,130); n2 % 4 != 0
# at (4,5,6,7)), dense-batched ones on 128 x 128 and 32 x 256
# ((3,4,70,9)), lazy rank 1 on 64 x 192 ((3,4,37,70)) and on 64 x 256
# with R = 260 rows over two column tiles ((20,13,5,70)), lazy rank 2 on
# 32 x 256 and 64 x 192 ((8,5,4,3,3,3): P = 40); M is never a multiple
# of the 16-deep chunks there.  (2,3,5,520): n2 beyond the lse shift's
# register-held 512 values.
STRIP_CASES = [
    (n, s_, m_, b, lb, mode)
    for n, s_, m_, b, lb in (
        ("ssy", (4, 5, 6, 7), "rouwenhorst", None, None),
        ("ssy", (4, 5, 6, 7), "rouwenhorst", "loglinear", None),
        ("ssy", (6, 5, 6, 16), "rouwenhorst", "loglinear", 0),
        ("gcy", (6, 5, 4, 3, 4, 3), "rouwenhorst", None, None),
        ("gcy", (6, 5, 4, 3, 4, 3), "tauchen", "loglinear", 0),
        ("ssy", (3, 4, 37, 70), "tauchen", "loglinear", 0),
        ("ssy", (3, 5, 67, 130), "rouwenhorst", None, None),
        ("ssy", (3, 4, 70, 9), "tauchen", "loglinear", None),
        ("ssy", (20, 13, 5, 70), "tauchen", "loglinear", 0),
        ("gcy", (8, 5, 4, 3, 3, 3), "tauchen", "loglinear", 0),
        ("ssy", (2, 3, 5, 520), "tauchen", "loglinear", 0))
    for mode in (("fast", "lse") if n == "ssy" or b else ("lse",))]


def _strip_set(name, shapes, method, baseline):
    if name == "ssy":
        m = P.SSY()
        return P.two_phase_operands_ssy(
            m, P.discretize_ssy(m, shapes, method=method), baseline)
    m = P.GCY()
    return P.two_phase_operands_gcy(
        m, P.discretize_gcy(m, shapes, method=method), baseline)


@pytest.mark.parametrize("name,shapes,method,baseline,lazy_bytes,mode",
                         STRIP_CASES)
def test_strip_kernels_match_plain(cuda, name, shapes, method, baseline,
                                   lazy_bytes, mode):
    ops = _strip_set(name, shapes, method, baseline)
    d = tt.strip_device_operands(
        ops, tt.LAZY_BYTES if lazy_bytes is None else lazy_bytes,
        device=cuda)
    L, K, n1, n2 = ops.shapes
    R, C = L * K, n1 * n2
    rng = np.random.default_rng(0)
    base = (np.log(800.0) if ops.baseline_log_w is None
            else ops.baseline_log_w)
    ell = torch.as_tensor(base + 0.02 * rng.standard_normal(ops.shapes),
                          dtype=torch.float32, device=cuda).reshape(R, n1, n2)
    th, be = float(ops.theta), float(ops.beta)
    col_args = (d["W_c1"], d["W_c2"], th, mode, d["sub_row"], d["sub_col"])
    key = "strip_col" + ("_fast" if mode == "fast" else "")
    before = tt.LAUNCHES[key]
    got = tt.strip_col(ell, *col_args)
    assert tt.LAUNCHES[key] == before + 1
    want = tt.strip_col_plain(ell, *col_args)
    scale = S = None
    if mode == "fast":
        (got, s_k), (want, s) = got, want
        assert float(((got - want).abs() / want.abs()).max()) <= 5e-6
        assert float((s_k - s).abs().max()) <= ATOL
        S = s.max().reshape(1)
        scale = torch.exp(s - S)
    else:
        assert bool(((got - want).abs()
                     <= ATOL + EPS32 * want.abs()).all())
    mid = want.reshape(R, C)
    row_args = (scale, S, d["W_r1"], d["W_r2"], d["add_row"], d["add_col"],
                th, be, mode)
    out = tt.strip_row(mid, *row_args)
    assert float((out - tt.strip_row_plain(mid, *row_args)).abs().max()) \
        <= ATOL


# (R, n1, n2, kind1, kind2) of the column phase: both cells (SSY
# (1024, 32, 384) normalized and plain, the GCY view (192, 512, 256)
# normalized and plain) and the STRIP_CASES sets' views.
STRIP_LAYOUTS = [(1024, 32, 384, "dense", "lazy"),
                 (1024, 32, 384, "shared", "shared"),
                 (192, 512, 256, "lazy", "lazy"),
                 (192, 512, 256, "shared", "shared"),
                 (15, 67, 130, "shared", "shared"),
                 (12, 70, 9, "dense", "dense"),
                 (260, 5, 70, "lazy", "lazy"),
                 (12, 37, 70, "lazy", "lazy"),
                 (9, 40, 12, "lazy", "lazy"),
                 (20, 6, 7, "shared", "dense")]


@pytest.mark.parametrize("R,n1,n2,kind1,kind2", STRIP_LAYOUTS)
def test_strip_col_layout_mirrors_the_launcher(cuda, R, n1, n2, kind1,
                                               kind2):
    want = tt.strip_col_layout(R, n1, n2, kind1, kind2)
    got = (ctypes.c_int * 12)()
    k = tt._FACTOR_KINDS
    assert tt._lib().sdfs_strip_col_layout(R, n1, n2, k[kind1], k[kind2],
                                           got) == 1
    assert (tuple(got[:6]), tuple(got[6:])) == (want["c1"], want["c2"])
    assert (tt._lib().sdfs_strip_col_work_floats(R, n1, n2)
            == tt.strip_col_work_floats(R, n1, n2))


@pytest.mark.parametrize("c2_here", [True, False])
@pytest.mark.parametrize("shapes", [(4, 8, 6, 64), (3, 4, 10, 30)])
def test_pass_b_mid_kernel_matches_plain(cuda, shapes, c2_here):
    import dataclasses
    m = P.SSY()
    conj = P.conjugate_to_shared(P.two_phase_operands_ssy(
        m, P.discretize_ssy(m, shapes, method="tauchen"), "loglinear"))
    rng = np.random.default_rng(1)
    ops = dataclasses.replace(
        conj, mid_col=0.05 * rng.standard_normal(shapes[2:]))
    L, K, I, J = shapes
    cast = lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float64)).to(device=cuda, dtype=torch.float32)
    ell = cast(ops.baseline_log_w + 0.02 * rng.standard_normal(shapes))
    args = (cast(ops.W_c1), cast(np.asarray(ops.W_c2).T) if c2_here else None,
            float(ops.theta), "lse", cast(np.asarray(ops.sub_row).reshape(-1)),
            cast(ops.sub_col), cast(ops.mid_col))
    e = ell.reshape(L * K, I, J)
    before = st.LAUNCHES["pass_b_mid"]
    got = st.pass_b(e, *args)
    assert st.LAUNCHES["pass_b_mid"] == before + 1
    want = st.pass_b_plain(e, *args)
    assert bool(((got - want).abs() <= ATOL + EPS32 * want.abs()).all())
    T = P.make_tiled_T_log(ops, device=cuda)
    T64 = P.make_eager_two_phase_T(ops, torch.float64, device=cuda)
    assert float((T(ell).double() - T64(ell.double())).abs().max()) <= ATOL


def test_strip_operator_matches_f64(cuda):
    m = P.SSY()
    d = P.discretize_ssy(m, (8, 16, 32, 384), method="tauchen")
    T64 = P.T_ssy_factory(m, d, space="log", baseline="loglinear",
                          device=cuda)
    x = T64.baseline_log_w + 0.02
    for engine in ("strip", "auto"):
        T = P.make_tiled_T_log_ssy(m, d, baseline="loglinear", engine=engine,
                                   device=cuda)
        assert T.engine == ("strip" if engine == "strip" else "streamed")
        assert float((T(x.float()).double() - T64(x)).abs().max()) <= ATOL


# Fused two-matmul operand sets (rows x columns): continuous SSY 25 x 30
# (one ragged tile), discrete SSY 64 x 36, discrete GCY 36 x 27 and
# continuous SSY 20^4, 400 x 400 (169 tiles).
FUSED_CASES = ["continuous-5556", "ssy-8866", "gcy-433333",
               "continuous-20"]


def _fused_setup(name, dev):
    kind, size = name.split("-")
    if kind == "continuous":
        m = P.SSY()
        sizes = (5, 5, 5, 6) if size == "5556" else (20, 20, 20, 20)
        ops = fd.kron_operands_ssy_continuous(
            m, P.build_grid_ssy(m, *sizes), 5, torch.float64)
    elif kind == "ssy":
        m = P.SSY()
        ops = fd.kron_operands_ssy(m, P.discretize_ssy(m, (8, 8, 6, 6)),
                                   torch.float64)
    else:
        m = P.GCY()
        ops = fd.kron_operands_gcy(m, P.discretize_gcy(m, (4, 3, 3, 3, 3, 3)),
                                   torch.float64)
    M1, M2T, kap = (a.to(device=dev, dtype=torch.float32).contiguous()
                    for a in ops)
    rng = np.random.default_rng(0)
    ell = torch.as_tensor(np.log(800.0) + 0.05 * rng.standard_normal(
        tuple(kap.shape)), dtype=torch.float32, device=dev)
    return m, (M1, M2T, kap), ell


@pytest.mark.parametrize("name", FUSED_CASES)
def test_fused_T_kernel_matches_plain(cuda, name):
    m, ops, ell = _fused_setup(name, cuda)
    before = fd.LAUNCHES["fused_T"]
    got = fd.fused_T(ell, *ops, None, m.theta, m.beta)
    assert fd.LAUNCHES["fused_T"] == before + 1
    want = fd.fused_T_plain(ell, *ops, None, m.theta, m.beta)
    assert float((got - want).abs().max()) <= ATOL
    # With a baseline subtraction operand.
    sub = 0.01 * m.theta * torch.ones_like(ell)
    got = fd.fused_T(ell, *ops, sub, m.theta, m.beta)
    want = fd.fused_T_plain(ell, *ops, sub, m.theta, m.beta)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("name", FUSED_CASES)
def test_fused_sa_kernel_matches_plain(cuda, name):
    m, ops, ell = _fused_setup(name, cuda)
    before = fd.LAUNCHES["fused_sa"]
    e_k, i_k, r_k = sk.fused_sa(ell, *ops, None, m.theta, m.beta, 0.0, 50)
    assert fd.LAUNCHES["fused_sa"] == before + 1
    e_p, i_p, r_p = sk.fused_sa_plain(ell, *ops, None, m.theta, m.beta, 0.0,
                                      50)
    assert int(i_k) == int(i_p) == 50
    assert float((e_k - e_p).abs().max()) <= 1e-4
    # max_iter = 0 returns the input and an infinite error.
    e0, i0, r0 = sk.fused_sa(ell, *ops, None, m.theta, m.beta, 1e-5, 0)
    assert int(i0) == 0 and float(r0) == float("inf")
    torch.testing.assert_close(e0, ell, rtol=0, atol=0)


@pytest.mark.parametrize("name", FUSED_CASES)
def test_fused_anderson_kernel_matches_plain(cuda, name):
    m, ops, ell = _fused_setup(name, cuda)
    x0 = torch.zeros_like(ell) if name.startswith("continuous") else ell
    # Iterate by iterate: 20 steps (7 mixes), ridge 0.1 so that rounding
    # is not amplified by the normal equations (at 1e-6 a 1e-7 change of
    # the start moves the 10th iterate by ~4e-3), within 1e-4.
    before = fd.LAUNCHES["fused_anderson"]
    a_k, j_k, _ = ak.fused_anderson(x0, *ops, None, m.theta, m.beta, -1.0,
                                    20, ridge=0.1)
    assert fd.LAUNCHES["fused_anderson"] == before + 1
    a_p, j_p, _ = ak.fused_anderson_plain(x0, *ops, None, m.theta, m.beta,
                                          -1.0, 20, ridge=0.1)
    assert int(j_k) == int(j_p) == 20
    assert float((a_k - a_p).abs().max()) <= 1e-4
    # At tol 1e-5 with the default ridge: both converge, the kernel in at
    # most a tenth of the SA kernel's iterations from the same start.
    tol = 1e-5
    e_k, i_k, r_k = ak.fused_anderson(x0, *ops, None, m.theta, m.beta, tol,
                                      20_000)
    e_p, i_p, r_p = ak.fused_anderson_plain(x0, *ops, None, m.theta, m.beta,
                                            tol, 20_000)
    _, i_sa, _ = sk.fused_sa(x0, *ops, None, m.theta, m.beta, tol, 20_000)
    assert float(r_k) <= tol and float(r_p) <= tol
    assert int(i_k) <= 0.1 * int(i_sa)
    # End states: each within tol * beta / (1 - beta) of the fixed point.
    assert float((e_k - e_p).abs().max()) <= 2 * tol * m.beta / (1 - m.beta)
    # The kernel's end state is a fixed point of the plain operator.
    res = fd.fused_T_plain(e_k, *ops, None, m.theta, m.beta) - e_k
    assert float(res.abs().max()) <= 5e-5


@pytest.mark.parametrize("name", FUSED_CASES)
def test_fused_anderson_kernel_falls_back_to_T(cuda, name):
    # A NaN ridge makes every combination NaN: each step falls back to
    # T(x), so the Anderson kernel runs plain SA.
    m, ops, ell = _fused_setup(name, cuda)
    e_k, i_k, _ = ak.fused_anderson(ell, *ops, None, m.theta, m.beta, -1.0,
                                    20, ridge=float("nan"))
    e_p, _, _ = sk.fused_sa_plain(ell, *ops, None, m.theta, m.beta, -1.0, 20)
    assert int(i_k) == 20
    assert float((e_k - e_p).abs().max()) <= 1e-4


# The deferred pass B's two layouts on seeded synthetic operands (W_c1
# row-stochastic, theta of the GCY calibration's size): resident at I =
# 144 (the 18.9M-point view's) and I = 40, the tensor-core layout at I =
# 512 and at I not a multiple of 4, 8 or 16 (301, 250, 517, 1000); J
# ragged (not a multiple of the tile width, of 4 or of 2).
DEFB_SYNTH = [(3, 144, 200), (2, 144, 37), (4, 40, 70), (2, 512, 70),
              (1, 512, 37), (2, 301, 70), (3, 250, 130), (1, 517, 37),
              (1, 1000, 9), (2, 512, 256)]


@pytest.mark.parametrize("with_sub", [True, False])
@pytest.mark.parametrize("R,I,J", DEFB_SYNTH)
def test_pass_b_deferred_layouts_match_plain(cuda, R, I, J, with_sub):
    layout, bn, threads, smem = st.pass_b_deferred_layout(I, J)
    lay = (ctypes.c_int * 7)()
    lib = st._lib()
    assert lib.sdfs_pass_b_deferred_layout(I, J, lay) == 1
    mma = (st._MMA_BM, st._MMA_BK, st._MMA_STAGES)
    assert tuple(lay) == (int(layout == "mma"), bn, threads, smem) + (
        mma if layout == "mma" else (0, 0, 0))
    assert (lib.sdfs_pass_b_deferred_work_floats(R, I, J)
            == st.pass_b_deferred_work_floats(R, I, J))
    assert smem <= st.SMEM_LIMIT
    rng = np.random.default_rng(I + J)
    W = rng.random((I, I))
    W /= W.sum(axis=1, keepdims=True)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=cuda)
    theta = -36.0
    ell = f32(np.log(800.0) + 0.05 * rng.standard_normal((R, I, J)))
    sub = ((f32(theta * np.log(800.0) + 0.1 * rng.standard_normal(R)),
            f32(0.05 * rng.standard_normal((I, J))))
           if with_sub else (None, None))
    args = (f32(W.T), theta) + sub
    before = st.LAUNCHES["pass_b_deferred"]
    got = st.pass_b_deferred(ell, *args)
    assert st.LAUNCHES["pass_b_deferred"] == before + 1
    want = st.pass_b_deferred_plain(ell, *args)
    lim = ATOL + EPS32 * want.abs()
    assert bool(((got - want).abs() <= lim).all())


# The strip row phase on seeded synthetic operands (W_r1, W_r2
# row-stochastic; lse: log-domain midway values near theta*log(800);
# fast: a linear field with row scales exp(s - S)): L and K of 1, 12, 16
# and 32, C ragged (not a multiple of the tile, of 4, or below one tile);
# the narrow layout at (128, 48), (80, 80), L = 300 and (170, 170) (one
# slab).
ROW_SYNTH = [(32, 32, 12288), (12, 16, 4099), (16, 12, 1000), (1, 32, 130),
             (32, 1, 67), (1, 1, 9), (12, 32, 257), (16, 16, 66),
             (103, 41, 70), (128, 48, 1001), (80, 80, 68), (300, 2, 130),
             (170, 170, 5)]


def _row_operands(L, K, C, mode, dev):
    rng = np.random.default_rng(L * 1000 + K + C)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=dev)
    W1, W2 = rng.random((L, L)), rng.random((K, K))
    W1 /= W1.sum(axis=1, keepdims=True)
    W2 /= W2.sum(axis=1, keepdims=True)
    R = L * K
    theta, beta = -36.0, 0.9987
    scale = S = None
    if mode == "fast":
        mid = f32(np.exp(0.5 * rng.standard_normal((R, C))))
        s = theta * np.log(800.0) + 2.0 * rng.standard_normal((R, 1))
        S = f32(np.array([s.max()]))
        scale = f32(np.exp(s - s.max()))
    else:
        mid = f32(theta * np.log(800.0) + 3.0 * rng.standard_normal((R, C)))
    add_row = f32(10.0 + 0.1 * rng.standard_normal((L, K)))
    add_col = f32(0.1 * rng.standard_normal(C))
    return mid, (scale, S, f32(W1), f32(W2), add_row, add_col, theta, beta,
                 mode)


@pytest.mark.parametrize("mode", ["fast", "lse"])
@pytest.mark.parametrize("L,K,C", ROW_SYNTH)
def test_strip_row_kernel_matches_plain(cuda, L, K, C, mode):
    mid, args = _row_operands(L, K, C, mode, cuda)
    key = "strip_row" + ("_fast" if mode == "fast" else "")
    before = tt.LAUNCHES[key]
    got = tt.strip_row(mid, *args)
    assert tt.LAUNCHES[key] == before + 1
    want = tt.strip_row_plain(mid, *args)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("L,K", [(32, 32), (12, 16), (16, 12), (1, 32),
                                 (32, 1), (1, 1), (103, 41), (20, 13),
                                 (2, 2), (128, 48), (80, 80), (300, 2),
                                 (170, 170)])
def test_strip_row_layout_mirrors_the_launcher(cuda, L, K):
    want = tt.strip_row_layout(L, K)
    got = (ctypes.c_int * 6)()
    assert tt._lib().sdfs_strip_row_layout(L, K, got) == 1
    assert tuple(got) == want
    assert want[2] <= st.SMEM_LIMIT


# (L, K, J) of the deferred and batched pass C's layouts: the GCY view,
# the continuous-SSY cell (a cluster of 8), the 20^4 anchor, the sets
# above, and clusters of 2-7.
SLAB_LAYOUTS = [(12, 16, 256), (56, 56, 64), (20, 20, 20), (4, 8, 64),
                (3, 5, 40), (31, 29, 42), (12, 24, 128), (2, 3, 30),
                (2, 4, 258), (4, 8, 128), (40, 40, 64), (48, 30, 64),
                (64, 20, 33)]


@pytest.mark.parametrize("L,K,J", SLAB_LAYOUTS)
def test_pass_c_deferred_layout_mirrors_the_launcher(cuda, L, K, J):
    want = st.pass_c_deferred_layout(L, K, J)
    got = (ctypes.c_int * 5)()
    assert st._lib().sdfs_pass_c_deferred_layout(L, K, J, got) == 1
    assert tuple(got) == want[1:]


# The deferred and batched pass C on seeded synthetic operands
# (row-stochastic factors, log-domain midway values near theta*log(800)):
# clusters of 1-8 (k- and l-slabs that do not divide K and L), several
# column tiles, J % 4 != 0.
SLAB_SYNTH = [(9, 11, 3, 37), (12, 69, 2, 64), (48, 30, 2, 64),
              (23, 69, 2, 64), (30, 66, 2, 64), (35, 67, 2, 64),
              (67, 36, 2, 64), (31, 29, 3, 42), (40, 40, 2, 130),
              (8, 54, 2, 70)]


@pytest.mark.parametrize("mode", ["fast", "lse", "deferred"])
@pytest.mark.parametrize("L,K,I,J", SLAB_SYNTH)
def test_pass_c_slab_layouts_match_plain(cuda, L, K, I, J, mode):
    assert st.pass_c_deferred_layout(L, K, J) is not None
    rng = np.random.default_rng(L * K + J)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=cuda)

    def stochastic(n):
        W = rng.random((n, n))
        return W / W.sum(axis=1, keepdims=True)

    R, C = L * K, I * J
    theta, beta = -36.0, 0.9987
    a = theta * (np.log(800.0) + 0.05 * rng.standard_normal((R, C)))
    W_c2t = np.stack([stochastic(J).T for _ in range(I)])
    args = (f32(stochastic(L)), f32(stochastic(K)),
            f32(0.01 * rng.standard_normal((L, K))),
            f32(0.01 * rng.standard_normal(C)), theta, beta)
    if mode == "deferred":
        mid, w = f32(a), f32(W_c2t[0])
        before = st.LAUNCHES["pass_c_deferred"]
        got = st.pass_c_deferred(mid, w, *args)
        assert st.LAUNCHES["pass_c_deferred"] == before + 1
        want = st.pass_c_deferred_plain(mid, w, *args)
    else:
        scale = S = None
        mid = f32(a)
        if mode == "fast":
            s = a.max(axis=1, keepdims=True)
            mid, S = f32(np.exp(a - s)), f32(s.max().reshape(1))
            scale = f32(np.exp(s - s.max()))
        key = "pass_c_batched" if mode == "fast" else "pass_c_batched_lse"
        before = st.LAUNCHES[key]
        got = st.pass_c_batched(mid, scale, S, f32(W_c2t), *args, mode)
        assert st.LAUNCHES[key] == before + 1
        want = st.pass_c_batched_plain(mid, scale, S, f32(W_c2t), *args,
                                       mode)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


# The fused kernels' chunked layout: (675, 650), more tiles than SMs and
# operands beyond a block's shared memory.
FUSED_CHUNKED = (27, 25, 26, 25)


@pytest.mark.parametrize("sizes", [(5, 5, 5, 6), FUSED_CHUNKED])
def test_fused_kernels_layouts_match_plain(cuda, sizes):
    m = P.SSY()
    ops = tuple(a.to(device=cuda, dtype=torch.float32).contiguous()
                for a in fd.kron_operands_ssy_continuous(
                    m, P.build_grid_ssy(m, *sizes), 5, torch.float64))
    R, C = ops[2].shape
    lay = fd.fused_layout(R, C, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    tiling = np.zeros(5, dtype=np.int32)
    assert fd._lib().sdfs_fused_tiling(R, C, tiling.ctypes.data) == 0
    assert list(tiling[:4]) == [lay["bm"], int(lay["resident"]),
                                lay["n_tiles"], lay["smem"]]
    assert lay["resident"] == (sizes != FUSED_CHUNKED)
    rng = np.random.default_rng(3)
    ell = torch.as_tensor(np.log(800.0) + 0.05 * rng.standard_normal(
        (R, C)), dtype=torch.float32, device=cuda)
    th, be = m.theta, m.beta
    got = fd.fused_T(ell, *ops, None, th, be)
    assert float((got - fd.fused_T_plain(ell, *ops, None, th,
                                         be)).abs().max()) <= ATOL
    e_k, i_k, _ = sk.fused_sa(ell, *ops, None, th, be, 0.0, 50)
    e_p, i_p, _ = sk.fused_sa_plain(ell, *ops, None, th, be, 0.0, 50)
    assert int(i_k) == int(i_p) == 50
    assert float((e_k - e_p).abs().max()) <= 1e-4
    x0 = torch.zeros_like(ell)
    a_k, j_k, _ = ak.fused_anderson(x0, *ops, None, th, be, -1.0, 20,
                                    ridge=0.1)
    a_p, j_p, _ = ak.fused_anderson_plain(x0, *ops, None, th, be, -1.0, 20,
                                          ridge=0.1)
    assert int(j_k) == int(j_p) == 20
    assert float((a_k - a_p).abs().max()) <= 1e-4
    # max_iter = 0: the input back and an infinite error, both loops.
    for kern in (sk.fused_sa, ak.fused_anderson):
        e0, i0, r0 = kern(ell, *ops, None, th, be, 1e-5, 0)
        assert int(i0) == 0 and float(r0) == float("inf")
        torch.testing.assert_close(e0, ell, rtol=0, atol=0)


def test_fused_continuous_T_matches_f64(cuda):
    m = P.SSY()
    grids = P.build_grid_ssy(m, 20, 20, 20, 20)
    T = P.make_fused_T_log_ssy_continuous(m, grids, device=cuda)
    T64 = P.T_ssy_continuous_factory(m, grids, space="log", device=cuda)
    rng = np.random.default_rng(1)
    ell = torch.as_tensor(np.log(700.0) + 0.05 * rng.standard_normal(
        (20, 20, 20, 20)), device=cuda)
    assert float((T(ell.float()).double() - T64(ell)).abs().max()) <= ATOL


# The post-interp kernel (B8): ragged tiles (R, C not multiples of 64),
# degrees 2-5, both interpolation spaces.
POST_CASES = [((4, 5, 4, 5), 4), ((9, 7, 11, 13), 3), ((15, 15, 15, 15), 5),
              ((3, 3, 3, 4), 2), ((20, 20, 20, 20), 5), ((5, 4, 6, 3), 5),
              ((6, 5, 7, 9), 8)]


def _post_args(sizes, degree, interp, dev):
    # The arguments the operator hands the kernel on a noisy field.
    m = P.SSY()
    T = P.make_post_interp_kernel_T_ssy(m, P.build_grid_ssy(m, *sizes),
                                        degree, interp, device=dev)
    rng = np.random.default_rng(2)
    ell = torch.as_tensor(np.log(700.0) + 0.05 * rng.standard_normal(sizes),
                          device=dev).float()
    return T.kernel_args(ell)


@pytest.mark.parametrize("interp", ["post", "loglin"])
@pytest.mark.parametrize("sizes,degree", POST_CASES)
def test_post_interp_kernel_matches_plain(cuda, sizes, degree, interp):
    args = _post_args(sizes, degree, interp, cuda)
    before = pk.LAUNCHES["post_interp"]
    got = pk.post_interp(*args)
    assert pk.LAUNCHES["post_interp"] == before + 1
    want = pk.post_interp_gather_plain(*args)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL
    # The same function on the dense Kronecker stacks.
    m = P.SSY()
    ops = pk.post_interp_operands_ssy(m, P.build_grid_ssy(m, *sizes), degree)
    kron = pk.post_interp_plain(args[0], ops["Wr"].float().to(cuda),
                                ops["Wc"].float().to(cuda), *args[2:])
    assert float((got - kron).abs().max()) <= ATOL


@pytest.mark.parametrize("interp", ["post", "loglin"])
def test_post_interp_operator_matches_f64_node_chain(cuda, interp):
    m = P.SSY()
    sizes = (12, 12, 12, 12)
    grids = P.build_grid_ssy(m, *sizes)
    T = P.make_post_interp_kernel_T_ssy(m, grids, interp=interp, device=cuda)
    T64 = P.make_node_chain_T_ssy(m, grids, *P.ssy_quadrature_nodes(5),
                                  interp=interp, device=cuda)
    rng = np.random.default_rng(3)
    ell = torch.as_tensor(np.log(700.0) + 0.05 * rng.standard_normal(sizes),
                          device=cuda)
    assert float((T(ell.float()).double() - T64(ell)).abs().max()) <= 2e-5
    v = 0.01 * ell.float()
    _, dk = torch.func.jvp(T, (ell.float(),), (v,))
    _, d64 = torch.func.jvp(T64, (ell,), (v.double(),))
    assert float((dk.double() - d64).abs().max()) <= 2e-5


def test_post_interp_wrapper_validates_arguments(cuda):
    args = list(_post_args((4, 5, 4, 5), 3, "post", cuda))
    with pytest.raises(ValueError, match="shape"):
        pk.post_interp(args[0][:, :10].contiguous(), *args[1:])
    with pytest.raises(TypeError, match="float32"):
        pk.post_interp(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        pk.post_interp(args[0].T, *args[1:])
    corners = list(args[1])
    corners[0] = corners[0].long()
    with pytest.raises(TypeError, match="int32"):
        pk.post_interp(args[0], tuple(corners), *args[2:])


@pytest.mark.parametrize("model", [P.SSY(), P.GCY()])
def test_simulation_graphs_are_the_loop(cuda, model, monkeypatch):
    # The chunks replayed as CUDA graphs run the loop's kernels on the
    # same buffers: the path and the Monte Carlo exponent are bitwise the
    # plain loop's (full chunks and a partial last one).
    from sdfs_via_autodiff_tpu_torch.sdf.simulate import SIM_CHUNK
    from sdfs_via_autodiff_tpu_torch.utils import graphs as G
    from sdfs_via_autodiff_tpu_torch.utils.spectral import (
        MC_CHUNK, stability_exponent_mc)

    steps, T = 3 * SIM_CHUNK + 11, 3 * MC_CHUNK + 7
    graphs = P.simulate_states(model, steps, device=cuda)
    b = stability_exponent_mc(model, T=T, N=300, device=cuda)
    monkeypatch.setattr(G, "_ENABLED", False)
    loop = P.simulate_states(model, steps, device=cuda)
    a = stability_exponent_mc(model, T=T, N=300, device=cuda)
    assert graphs.is_cuda and torch.equal(graphs, loop)
    assert a == b


def _backward_cases(dev):
    """(label, operator) of each tiled configuration at small shapes."""
    m = P.SSY()
    d = P.discretize_ssy(m, (4, 4, 4, 6), method="tauchen")
    g = P.GCY()
    gg = P.build_grid_gcy(g, 8, 3, 2, 4, 128, 2)
    return [
        ("streamed", P.make_tiled_T_log_ssy(m, d, device=dev)),
        ("strip", P.make_tiled_T_log_ssy(m, d, device=dev, engine="strip")),
        ("deferred", P.make_tiled_T_log_ssy(
            m, P.discretize_ssy(m, (2, 8, 64, 512), method="tauchen"),
            device=dev)),
        ("batched", P.make_tiled_T_log_ssy_continuous(
            m, P.build_grid_ssy(m, 4, 5, 4, 8), 3, device=dev)),
        ("gcy", P.make_tiled_T_log_gcy(
            g, P.discretize_gcy(g, (4, 3, 3, 2, 3, 2), method="tauchen"),
            device=dev)),
        ("pair", P.make_tiled_T_log_gcy_continuous(
            g, gg, 5, baseline="loglinear", device=dev)),
    ]


# The fields of _backward_cases' operators without a folded baseline.
_BACKWARD_SHAPES = {"streamed": (4, 4, 4, 6), "strip": (4, 4, 4, 6),
                    "deferred": (2, 8, 64, 512), "batched": (4, 5, 4, 8),
                    "gcy": (4, 3, 3, 2, 3, 2)}


def test_tiled_backward_is_the_twins_vjp_on_the_card(cuda):
    # Reverse mode through the kernels' operators: the eager twin's
    # transpose at the same point, bitwise (the backward runs the twin).
    for label, T in _backward_cases(cuda):
        rng = np.random.default_rng(1)
        base = getattr(T, "baseline_log_w", None)
        if base is None:
            base = torch.full(_BACKWARD_SHAPES[label], 6.5, device=cuda)
        x = (base + 0.02 * torch.as_tensor(
            rng.standard_normal(tuple(base.shape)), device=cuda)).float()
        ct = torch.as_tensor(rng.standard_normal(tuple(x.shape)),
                             device=cuda, dtype=torch.float32)
        _, vjp = torch.func.vjp(T, x)
        (g,) = vjp(ct)
        _, vjp_t = torch.func.vjp(T.twin, x)
        (g_t,) = vjp_t(ct)
        assert torch.equal(g, g_t), label
        xr = x.clone().requires_grad_(True)
        (T(xr) * ct).sum().backward()
        assert torch.equal(xr.grad, g_t), label


@pytest.fixture
def nccl_world1(cuda):
    """A NCCL process group of world size 1 on the card, for one test."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    yield cuda
    dist.destroy_process_group()


def test_dtensor_newton_world1_nccl(nccl_world1):
    # A single-device operator on a DTensor iterate (parallel/gspmd.py):
    # the float64 Newton solve from a DTensor start on the card's 1 x 1
    # mesh against the plain start's, with the tangent taken as the
    # derivative of a VJP; the result keeps its placements.
    from sdfs_via_autodiff_tpu_torch import parallel as par
    dev = nccl_world1
    m = P.SSY()
    shapes = (8, 8, 4, 4)
    T = P.T_ssy_factory(m, P.discretize_ssy(m, shapes), space="log",
                        device=dev)
    x0 = torch.full(shapes, float(np.log(800.0)), dtype=torch.float64,
                    device=dev)
    mesh = par.make_mesh(device="cuda")
    xd = par.shard_grid_array(x0, mesh)
    assert torch.equal(T(xd).to_local(), T(x0))
    ref = P.solve(T, x0, method="newton", tol=1e-10)
    res = P.solve(T, xd, method="newton", tol=1e-10)
    assert res.converged and ref.converged
    assert par.is_dtensor(res.x) and res.x.placements == xd.placements
    assert res.iterations == ref.iterations
    assert float((res.x.to_local() - ref.x).abs().max()) <= 1e-11


@pytest.mark.parametrize("recipe", [("ssy", (8, 16, 32, 384), None),
                                    ("ssy", (8, 16, 32, 384), "loglinear"),
                                    ("gcy", (32, 16, 16, 2, 16, 2), None)])
def test_streamed_shard_factory_world1_nccl(nccl_world1, recipe):
    from sdfs_via_autodiff_tpu_torch import parallel as par
    dev = nccl_world1
    name, shapes, baseline = recipe
    if name == "ssy":
        m = P.SSY()
        ops = P.two_phase_operands_ssy(
            m, P.discretize_ssy(m, shapes, method="tauchen"), baseline)
    else:
        m = P.GCY()
        ops = P.two_phase_operands_gcy(
            m, P.discretize_gcy(m, shapes, method="tauchen"))
    mesh = par.make_mesh(device="cuda")
    T = par.streamed_shard_map_factory(ops, mesh)
    T1 = P.make_streamed_T_log(ops, device=dev)
    covered = P.streamed_coverable(ops)
    rng = np.random.default_rng(2)
    base = (np.asarray(covered.baseline_log_w)
            if covered.baseline_log_w is not None
            else np.full(covered.shapes, np.log(800.0)))
    x = torch.as_tensor(base + 0.05 * rng.standard_normal(covered.shapes),
                        device=dev, dtype=torch.float32)
    before = dict(st.LAUNCHES)
    y = T(x).to_local()
    assert sum(st.LAUNCHES.values()) - sum(before.values()) == 2
    y1 = T1(x)
    assert torch.equal(y, y1)
    # Newton's tangent through the sharded twin, as on one device.
    v = torch.as_tensor(rng.standard_normal(covered.shapes), device=dev,
                        dtype=torch.float32)
    _, dy = torch.func.jvp(T.local, (x,), (v,))
    _, dy1 = torch.func.jvp(T1, (x,), (v,))
    assert torch.equal(dy, dy1)


# ------------------------------------------------ the tangent passes (K2)

# Kernels vs the einsum replay of the same tape, relative to sup |v|:
# float32 sums of the same terms in other orders (split TF32 in the
# products), a few ulps of J |v| <= |v| apart.
TANGENT_RTOL = 2e-6
# (model, natural shapes, split): the SSY cell's rows reduced (full), a
# ragged J with its padded U rows (full), a c1 product with a partial
# 128-row tile (deferred), a GCY set at its small view (full, J = 9) and
# the GCY cell's view (12, 16, 512, 256) with its rows reduced (deferred).
TANGENT_CASES = [("ssy", (8, 16, 32, 384), "full"),
                 ("ssy", (4, 6, 10, 30), "full"),
                 ("ssy", (3, 5, 56, 42), "full"),
                 ("ssy", (2, 2, 64, 512), "deferred"),
                 ("gcy", (4, 3, 3, 2, 3, 2), "full"),
                 ("gcy", (32, 16, 16, 2, 16, 4), "deferred")]


def _tangent_operator(model, shapes, dev, noise=0.02):
    """A tiled operator of the model on ``dev`` and a seeded point near
    its iterates (SSY: log 800, GCY: the log-linear start), ``noise`` the
    scale of the seeded departure."""
    rng = np.random.default_rng(3)
    if model == "ssy":
        m = P.SSY()
        T = P.make_tiled_T_log_ssy(
            m, P.discretize_ssy(m, shapes, method="tauchen"), device=dev)
        base = np.full(shapes, np.log(800.0))
    else:
        m = P.GCY()
        disc = P.discretize_gcy(m, shapes, method="tauchen")
        T = P.make_tiled_T_log_gcy(m, disc, device=dev)
        base = np.asarray(P.gcy_loglinear_parts(m, disc)["ell0"])
    x = base + noise * rng.standard_normal(base.shape)
    return T, torch.as_tensor(x, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("model,shapes,split", TANGENT_CASES)
def test_tangent_passes_match_the_einsum_replay(cuda, model, shapes, split):
    T, x = _tangent_operator(model, shapes, cuda)
    tape = Tape()
    with torch.no_grad():
        T.twin.primal(x, tape)
    steps = [s for s in tape.finish() if isinstance(s, ktp.TwoPhaseTangent)]
    assert len(steps) == 1
    step = steps[0]
    assert step.split == split
    g = torch.Generator(device=cuda).manual_seed(4)
    v = torch.randn(step.shapes, generator=g, device=cuda)
    with torch.no_grad():
        before = dict(ktp.LAUNCHES)
        got = step(v)
        launched = {k: ktp.LAUNCHES[k] - before[k] for k in before}
        want = step.plain(v)
        got_m = step.minus_identity(v)
    assert launched == {"tangent_c1": int(split == "full"),
                        "tangent_c1_mma": int(split == "deferred"),
                        "tangent_c2": 1, "tangent_row": 1}
    scale = float(v.abs().max())
    assert float((got - want).abs().max()) <= TANGENT_RTOL * scale
    assert float((got_m - (want - v)).abs().max()) <= TANGENT_RTOL * scale


# A matvec's rounding moves BiCGStab's stopping iteration by a few in
# some Newton steps (SSY cell: 235 against 239 iterations in 6 steps; the
# reduced GCY view: 506 against 519 in 12), the outer count not at all.
KRYLOV_SHARE = 0.05


@pytest.mark.parametrize("model,shapes", [("ssy", (32, 32, 32, 384)),
                                          ("gcy", (32, 16, 16, 2, 16, 4))])
def test_newton_on_the_tangent_passes_counts_as_the_einsum_replay(
        cuda, model, shapes, monkeypatch):
    """One Newton solve with the passes and one with the einsum replay in
    their place: outer counts within 1, Krylov counts within 5%, the fixed
    points within ten tolerances."""
    from sdfs_via_autodiff_tpu_torch.solvers.fixed_point import newton_solver
    from sdfs_via_autodiff_tpu_torch.utils.profiling import recorded
    T, x0 = _tangent_operator(model, shapes, cuda, noise=0.0)
    tol = 2e-5 if model == "ssy" else 1.2 * P.f32_tol_floor(P.GCY().theta)

    def solve():
        with recorded() as recs:
            res = newton_solver(T, x0, tol=tol)
        total = lambda name: sum(r.count or 0 for r in recs if r.name == name)
        return res, total("sdfs.krylov"), total("sdfs.tangent.fused")

    res, krylov, fused = solve()
    monkeypatch.setattr(
        ktp.TwoPhaseTangent, "_cuda",
        lambda self, v, minus: self.plain(v) - v if minus else self.plain(v))
    before = dict(ktp.LAUNCHES)
    ref, krylov_ref, _ = solve()
    assert ktp.LAUNCHES == before              # the replay launched none
    assert res.converged and ref.converged
    assert fused >= krylov > 0
    assert abs(res.iterations - ref.iterations) <= 1
    assert abs(krylov - krylov_ref) <= KRYLOV_SHARE * krylov_ref
    assert float((res.x - ref.x).abs().max()) <= 10 * tol
