"""Whole successive-approximation solve in one CUDA kernel launch.

PyTorch port of ``sdfs_via_autodiff_tpu/kernels/solver_kernel.py``.  At
beta ~ 0.999, successive approximation needs O(10^3-10^4) applications
of the fused two-matmul operator (:mod:`.fused_discrete`); run as
separate launches, each pays a launch and a host round trip for its
stop test.  The kernel ``sdfs_fused_solve`` in ``csrc/fused_two_matmul.cu``
(mode SA, replacing the TPU kernel ``_solver_kernel``) runs the entire
loop in one launch, with the sup-norm error, the tolerance / iteration
cap and the NaN stop evaluated on the card; it returns (ell*, iterations,
error) exactly like the JAX kernel.

:func:`fused_sa_plain` is the same loop in plain PyTorch (one host read
of the error per iteration), :func:`fused_sa` dispatches on the tensor's
device.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..config import resolve_device
from ..ops.dtensor import refuse
from ..models.ssy import SSY
from ..operators.discrete_ssy import SSYDiscretization
from .fused_discrete import (ALGO_SA, LAUNCHES, _device_operands,
                             check_working_set, fused_T_plain,
                             kron_operands_gcy, kron_operands_gcy_continuous,
                             kron_operands_ssy, kron_operands_ssy_continuous,
                             launch)

__all__ = ["fused_sa", "fused_sa_plain", "make_fused_solver_from_operands",
           "make_fused_solver_ssy", "make_fused_solver_ssy_continuous",
           "make_fused_solver_gcy", "make_fused_solver_gcy_continuous"]


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the kernels compare in float32)."""
    return float(np.float32(x))


def fused_sa_plain(ell0, M1, M2T, log_kap, sub, theta: float, beta: float,
                   tol: float, max_iter: int):
    """SA on the (rows, cols) field: ``ell <- T(ell)`` while err > tol,
    it < max_iter and err is not NaN, err = max |T(ell) - ell| (initially
    inf).  Returns (ell, iterations, err) as tensors on ell0's device."""
    tol = _f32(tol)
    ell, err, it = ell0, math.inf, 0
    while err > tol and it < max_iter and not math.isnan(err):
        new = fused_T_plain(ell, M1, M2T, log_kap, sub, theta, beta)
        err = float(torch.amax(torch.abs(new - ell)))
        ell, it = new, it + 1
    dev = ell0.device
    return (ell, torch.tensor(it, dtype=torch.int32, device=dev),
            torch.tensor(err, dtype=torch.float32, device=dev))


def fused_sa(ell0, M1, M2T, log_kap, sub, theta: float, beta: float,
             tol: float, max_iter: int):
    """The SA solve on the tensors' device: the plain version for CPU
    tensors, one launch of the CUDA kernel for CUDA tensors (same
    arguments and results as :func:`fused_sa_plain`)."""
    refuse(ell0, "fused_sa")
    if ell0.device.type == "cpu":
        return fused_sa_plain(ell0, M1, M2T, log_kap, sub, theta, beta, tol,
                              max_iter)
    if ell0.device.type == "cuda":
        out, iters, err = launch(ALGO_SA, ell0, M1, M2T, log_kap, sub, theta,
                                 beta, tol=tol, max_iter=max_iter)
        LAUNCHES["fused_sa"] += 1
        return out, iters[0], err[0]
    raise ValueError(f"no fused SA kernel for device {ell0.device}")


def make_fused_solver_from_operands(M1, M2T, log_kap, theta, beta, shapes,
                                    rows, cols, sub=None, *,
                                    device="cuda") -> Callable:
    """``solve(ell0, tol=1e-6, max_iter=100_000) -> (ell*, iters, err)``
    from prebuilt two-matmul operands (float32), on ``device``."""
    dev = resolve_device(device)
    shapes = tuple(shapes)
    check_working_set(shapes, rows, cols, 5 + (sub is not None), dev,
                      "the SA solve")
    M1, M2T, log_kap, sub = _device_operands(M1, M2T, log_kap, sub,
                                             torch.float32, dev)
    theta, beta = float(theta), float(beta)

    def solve_fused(ell0, tol=1e-6, max_iter=100_000):
        refuse(ell0, "fused_sa")
        ell_mat = torch.as_tensor(ell0).to(
            device=dev, dtype=torch.float32).reshape(rows, cols).contiguous()
        ell, iters, err = fused_sa(ell_mat, M1, M2T, log_kap, sub, theta,
                                   beta, tol, max_iter)
        return ell.reshape(shapes), iters, err

    return solve_fused


def make_fused_solver_ssy(model: SSY, disc: SSYDiscretization, *,
                          device="cuda") -> Callable:
    """Whole-solve kernel for the discrete SSY operator."""
    n_l, n_k, n_i, n_j = disc.shapes
    M1, M2T, log_kap = kron_operands_ssy(model, disc, torch.float64)
    return make_fused_solver_from_operands(
        M1, M2T, log_kap, model.theta, model.beta, disc.shapes,
        n_l * n_k, n_i * n_j, device=device)


def make_fused_solver_ssy_continuous(model: SSY, grids, degree: int = 5, *,
                                     device="cuda") -> Callable:
    """Whole-solve kernel for the continuous SSY operator (quadrature,
    pre-power interpolation)."""
    shapes = tuple(len(g) for g in grids)
    n_l, n_k, n_i, n_j = shapes
    M1, M2T, log_kap = kron_operands_ssy_continuous(model, grids, degree,
                                                    torch.float64)
    return make_fused_solver_from_operands(
        M1, M2T, log_kap, model.theta, model.beta, shapes,
        n_l * n_k, n_i * n_j, device=device)


def make_fused_solver_gcy(model, disc, *, device="cuda") -> Callable:
    """Whole-solve kernel for the discrete GCY operator."""
    n_a, n_b, n_c, n_d, n_e, n_l = disc.shapes
    M1, M2T, log_kap = kron_operands_gcy(model, disc, torch.float64)
    return make_fused_solver_from_operands(
        M1, M2T, log_kap, model.theta, model.beta, disc.shapes,
        n_a * n_b * n_c, n_d * n_e * n_l, device=device)


def _fused_gcy_continuous(make, model, grids, degree, baseline, *,
                          device, **kw) -> Callable:
    """A whole-solve factory ``make`` (SA or Anderson, from operands) over
    the continuous-GCY two-matmul operands, carrying
    ``solve.baseline_log_w`` (ell0, float32 on ``device``) when a
    baseline is folded."""
    (M1, M2T, kap, shapes, rows, cols,
     sub) = kron_operands_gcy_continuous(model, grids, degree, baseline,
                                         torch.float64)
    fsolve = make(M1, M2T, kap, model.theta, model.beta, shapes, rows, cols,
                  sub=sub, device=device, **kw)
    if sub is not None:
        fsolve.baseline_log_w = (sub / model.theta).reshape(shapes).to(
            device=resolve_device(device), dtype=torch.float32)
    return fsolve


def make_fused_solver_gcy_continuous(model, grids, degree: int = 5,
                                     baseline="loglinear", *,
                                     device="cuda") -> Callable:
    """Whole-solve SA kernel for the *continuous* GCY factored operator
    (quadrature, pre-power interpolation).  Baseline normalization
    defaults on: without it theta*(log-w range) ~ 200 overflows float32
    on these grids."""
    return _fused_gcy_continuous(make_fused_solver_from_operands, model,
                                 grids, degree, baseline, device=device)
