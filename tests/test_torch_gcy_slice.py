"""The port's GCY path end to end on the CPU, against the JAX package.

``wc_ratio_discrete(GCY(), (30,8,16,2,8,2), kernel="tiled",
device="cpu")`` runs the float32 streamed operator in its deferred
configuration (view (2, 2, 240, 128); the plain PyTorch versions of the
deferred passes on CPU tensors) under Newton from the log-linear warm
start, at tol 1.2 * f32_tol_floor(theta) ~ 3.0e-5.  It must converge and
reach the JAX float64 fixed point (``kernel="xla"``, tol 1e-11) within
5e-4 on log w: the f32 stopping tolerance amplified by the fixed-point
factor 1/(1 - rate) (the JAX package's own GCY tiled tests assert only
convergence).
"""

import numpy as np
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu_torch.utils.profiling import recorded

SHAPES = (30, 8, 16, 2, 8, 2)


def test_gcy_tiled_newton_slice_matches_jax_f64():
    m = P.GCY()
    tol = 1.2 * P.f32_tol_floor(m.theta)
    d = P.discretize_gcy(m, SHAPES)
    assert P.streamed_config(P.two_phase_operands_gcy(m, d)) == "deferred"
    with recorded() as recs:
        got = P.wc_ratio_discrete(m, SHAPES, kernel="tiled", tol=tol,
                                  device="cpu")
    inner = [r.count for r in recs if r.name == "sdfs.krylov"]
    assert got.converged
    # One BiCGStab count per Newton step, frozen chunk slots included.
    assert len(inner) >= got.result.iterations
    assert all(n > 0 for n in inner[:got.result.iterations])
    assert got.w_star.dtype == torch.float32
    assert tuple(got.w_star.shape) == SHAPES
    assert got.result.residual <= tol
    want = J.wc_ratio_discrete(J.GCY(), SHAPES, tol=1e-11)
    assert want.converged
    np.testing.assert_allclose(torch.log(got.w_star).double().numpy(),
                               np.log(np.asarray(want.w_star)),
                               rtol=0, atol=5e-4)


def test_gcy_xla_kernel_matches_jax_f64():
    shapes = (4, 3, 3, 2, 3, 2)
    got = P.wc_ratio_discrete(P.GCY(), shapes, tol=1e-11, device="cpu")
    assert got.converged and got.w_star.dtype == torch.float64
    want = J.wc_ratio_discrete(J.GCY(), shapes, tol=1e-11)
    np.testing.assert_allclose(got.w_star.numpy(), np.asarray(want.w_star),
                               rtol=1e-10, atol=0)
