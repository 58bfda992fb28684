"""CUDA kernels of the PyTorch port vs their plain versions, on the card.

Marked ``gpu``: every test skips without a CUDA device.  This file
imports neither JAX nor the JAX package, so on a GPU machine without JAX
it runs with ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu_kernels.py``.  Tolerances as in
``test_torch_streamed_two_phase.py`` and
``test_torch_deferred_two_phase.py``.
"""

import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu_torch as P
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
