"""The port's main path end to end on the CPU, against the JAX package.

``wc_ratio_discrete(SSY(), (4,8,6,64), kernel="tiled", device="cpu")``
runs the float32 streamed operator (its plain PyTorch versions on CPU
tensors) under Newton and must reach the JAX float64 fixed point to
2e-4 on log w — the bound of the JAX package's own
``test_solve_through_streamed``.
"""

import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P

SHAPES = (4, 8, 6, 64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiled_newton_slice_matches_jax_f64():
    got = P.wc_ratio_discrete(P.SSY(), SHAPES, kernel="tiled", tol=2e-5,
                              device="cpu")
    assert got.converged
    assert got.w_star.dtype == torch.float32
    assert got.result.residual <= 2e-5
    want = J.wc_ratio_discrete(J.SSY(), SHAPES, tol=1e-11)
    np.testing.assert_allclose(torch.log(got.w_star).double().numpy(),
                               np.log(np.asarray(want.w_star)),
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("model,kwargs,match", [
    (P.SSY(), {"polish": True}, "polish"),
    (P.SSY(), {"baseline": "loglinear"}, "baseline"),
    (P.SSY(), {"checkpoint_path": "w.npz"}, "checkpoint_path"),
    (P.GCY(), {"baseline": "loglinear"}, "baseline"),
])
def test_later_slices_raise_not_implemented(model, kwargs, match, tmp_path):
    shapes = SHAPES if isinstance(model, P.SSY) else (4, 3, 3, 2, 3, 2)
    if match == "baseline":
        # Ported (the normalized tiers): the solve runs and converges.
        sol = P.wc_ratio_discrete(model, shapes, kernel="tiled",
                                  device="cpu", tol=3.04e-5, **kwargs)
        assert sol.converged and bool(torch.isfinite(sol.w_star).all())
        return
    if match == "polish":
        # Ported: the float32 tiled stage, then the float64 Newton polish
        # through the float32 operator's tangent, reaches tol 1e-7.
        sol = P.wc_ratio_discrete(model, shapes, kernel="tiled",
                                  device="cpu", tol=1e-7, **kwargs)
        assert sol.converged and sol.result.residual <= 1e-7
        assert sol.w_star.dtype == torch.float64
        return
    # Ported (checkpoints): the tiled solve writes its float32 w* with
    # the JAX driver's meta, kernel="tiled" among it.
    path = str(tmp_path / kwargs[match])
    sol = P.wc_ratio_discrete(model, shapes, kernel="tiled", device="cpu",
                              tol=2e-5, checkpoint_path=path)
    ckpt = P.load_solution(path)
    assert sol.converged and ckpt.meta["kernel"] == "tiled"
    assert ckpt.meta["iterations"] == sol.result.iterations
    np.testing.assert_array_equal(ckpt.w_star, sol.w_star.numpy())


def test_unsupported_model_and_options():
    class Other:
        theta = -10.0

    with pytest.raises(TypeError, match="unsupported model Other"):
        P.wc_ratio_discrete(Other(), SHAPES, device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        P.wc_ratio_discrete(P.SSY(), SHAPES, kernel="fused", device="cpu")
    with pytest.raises(ValueError, match="log space"):
        P.wc_ratio_discrete(P.SSY(), SHAPES, kernel="tiled", space="w",
                            device="cpu")
    with pytest.raises(ValueError, match="inner"):
        P.wc_ratio_discrete(P.SSY(), (3, 3, 3, 4), inner="lgmres",
                            device="cpu")
    # inner="gmres" is ported: it runs and converges.
    sol = P.wc_ratio_discrete(P.SSY(), (3, 3, 3, 4), inner="gmres",
                              tol=1e-10, device="cpu")
    assert sol.converged and sol.result.residual <= 1e-10


def test_f32_tol_floor_matches_jax_and_warns():
    for theta in (None, -16.0, -36.0, P.SSY().theta):
        assert P.f32_tol_floor(theta) == J.drivers.f32_tol_floor(theta)
    with pytest.warns(UserWarning, match="float32 iteration floor"):
        P.wc_ratio_discrete(P.SSY(), (3, 3, 3, 4), kernel="tiled",
                            tol=1e-6, max_iter=1, device="cpu")
