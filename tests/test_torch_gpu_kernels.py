"""CUDA kernels of the PyTorch port vs their plain versions, on the card.

Marked ``gpu``: every test skips without a CUDA device.  This file
imports neither JAX nor the JAX package, so on a GPU machine without JAX
it runs with ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu_kernels.py``.  Tolerances as in
``test_torch_streamed_two_phase.py``, ``test_torch_deferred_two_phase.py``,
``test_torch_pair_two_phase.py``, ``test_torch_fused.py`` and
``test_torch_post_interp.py``.
"""

import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu_torch.kernels import anderson_kernel as ak
from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
from sdfs_via_autodiff_tpu_torch.kernels import post_interp_kernel as pk
from sdfs_via_autodiff_tpu_torch.kernels import solver_kernel as sk
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st

pytestmark = pytest.mark.gpu

ATOL = 5e-6
EPS32 = float(np.finfo(np.float32).eps)
# Ragged cases too: J not a multiple of 4 on both of pass B's tile shapes
# (J < 256 and J >= 256), I not a multiple of the row tiles.
CASES = [((4, 8, 6, 64), "rouwenhorst"), ((56, 56, 56, 64), "rouwenhorst"),
         ((8, 16, 32, 384), "tauchen"), ((4, 6, 10, 30), "tauchen"),
         ((2, 4, 12, 258), "tauchen")]


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
# (2, 4, 56, 258), the JAX test's (4, 8, 240, 128) and the 25.2M-point
# grid's (12, 16, 512, 256).
DEFERRED_CASES = [(15, 2, 5, 2, 6, 3), (7, 8, 43, 2, 6, 4),
                  (30, 8, 16, 4, 8, 8), (32, 16, 16, 12, 16, 16)]


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


@pytest.mark.parametrize("sizes", PAIR_CASES)
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


def test_uncovered_sets_raise_on_the_card(cuda):
    rng = np.random.default_rng(0)
    W = lambda n: rng.random((n, n))
    wide = P.TwoPhaseOperands(
        shapes=(2, 2, 2048, 64), W_r1=W(2), W_r2=W(2), W_c1=W(2048),
        W_c2=W(64), add_row=np.zeros((2, 2)), add_col=np.zeros((2048, 64)),
        theta=-36.0, beta=0.9987)
    with pytest.raises(NotImplementedError, match="not covered"):
        P.make_tiled_T_log(wide, device=cuda)
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
              ((3, 3, 3, 4), 2)]


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
    want = pk.post_interp_plain(*args)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


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
