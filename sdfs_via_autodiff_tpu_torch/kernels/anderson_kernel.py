"""Whole Anderson-accelerated solve in one CUDA kernel launch.

PyTorch port of ``sdfs_via_autodiff_tpu/kernels/anderson_kernel.py``.
Type-II Anderson acceleration over the fused two-matmul operator
(:mod:`.fused_discrete`) converges in O(100-1000) iterations instead of
successive approximation's O(10^4).  The kernel ``sdfs_fused_solve`` in
``csrc/fused_two_matmul.cu`` (mode AA, replacing the TPU kernel
``_aa_kernel``) runs the whole loop in one launch: X/F history rings of
``history`` fields in global scratch, the m(m+1)/2 Gram sums in float32,
the ridge-regularized m x (m+1) normal equations solved by Gauss–Jordan,
mixing every ``mixing_frequency``-th step once ``it >= history``, and a
fall back to T(x) when the combination is not finite.

The order is the JAX kernel's: the error max |T(x) - x| is measured
before mixing, the ring slot and the mixing counter are carried
explicitly, and the ridge is scaled by max(trace/m, 1e-30).
:func:`fused_anderson_plain` is the same loop in plain PyTorch (the
small system in numpy float32 on the host); float32 trajectories of the
two depart at the rounding level (their Gram sums are reduced in other
orders), so they agree by end state, not by iterate.
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
from .fused_discrete import (ALGO_AA, LAUNCHES, MAX_HISTORY,
                             _device_operands, check_working_set,
                             fused_T_plain, kron_operands_ssy,
                             kron_operands_ssy_continuous, launch)
from .solver_kernel import _f32, _fused_gcy_continuous

__all__ = ["fused_anderson", "fused_anderson_plain",
           "make_fused_anderson_from_operands", "make_fused_anderson_ssy",
           "make_fused_anderson_ssy_continuous",
           "make_fused_anderson_gcy_continuous"]


def _aa_weights(X, F, m: int, ridge: float) -> np.ndarray:
    """alpha (m,) float32 from the ridge normal equations over the m
    stored pairs, in the JAX kernel's order of operations (float32)."""
    f32 = np.float32
    G = F - X
    vals = {}
    tr = f32(0.0)
    for p in range(m):
        for q in range(p + 1):
            v = f32(float(torch.sum(G[p] * G[q])))
            vals[(p, q)] = v
            if p == q:
                tr = f32(tr + v)
    M = np.zeros((m, m + 1), f32)
    M[:, m] = f32(1.0)
    for (p, q), v in vals.items():
        M[p, q] = f32(M[p, q] + v)
        if p != q:
            M[q, p] = f32(M[q, p] + v)
    ridge_term = f32(f32(ridge) * max(f32(tr / f32(m)), f32(1e-30)))
    for i in range(m):
        M[i, i] = f32(M[i, i] + ridge_term)
    for i in range(m):                       # Gauss–Jordan, no pivoting
        M[i] = M[i] / M[i, i]
        col = M[:, i].copy()
        col[i] = f32(0.0)
        M = M - col[:, None] * M[i][None, :]
    sol = M[:, m]
    return (sol / np.sum(sol, dtype=f32)).astype(f32)


def fused_anderson_plain(ell0, M1, M2T, log_kap, sub, theta: float,
                         beta: float, tol: float, max_iter: int, *,
                         history: int = 5, mixing_frequency: int = 2,
                         beta_aa: float = 1.0, ridge: float = 1e-6):
    """Type-II Anderson on the (rows, cols) field, the JAX kernel's loop:
    fx = T(x); err = max |fx - x|; X[slot] = x; F[slot] = fx; mix when
    it >= history and the mixing counter is 0, else x <- fx.  Returns
    (ell, iterations, err) as tensors on ell0's device."""
    m = history
    tol = _f32(tol)
    X = torch.zeros((m,) + tuple(ell0.shape), dtype=ell0.dtype,
                    device=ell0.device)
    F = torch.zeros_like(X)
    w_x, w_f = _f32(1.0 - beta_aa), _f32(beta_aa)
    ell, err, it, slot, mix_ctr = ell0, math.inf, 0, 0, 0
    while err > tol and it < max_iter and not math.isnan(err):
        fx = fused_T_plain(ell, M1, M2T, log_kap, sub, theta, beta)
        err = float(torch.amax(torch.abs(fx - ell)))
        X[slot] = ell
        F[slot] = fx
        if it >= m and mix_ctr == 0:
            alpha = _aa_weights(X, F, m, ridge)
            x_new = torch.zeros_like(fx)
            for p in range(m):
                x_new = x_new + float(alpha[p]) * (w_x * X[p] + w_f * F[p])
            ell = fx if not bool(torch.isfinite(x_new).all()) else x_new
        else:
            ell = fx
        slot = 0 if slot + 1 >= m else slot + 1
        mix_ctr = 0 if mix_ctr + 1 >= mixing_frequency else mix_ctr + 1
        it += 1
    dev = ell0.device
    return (ell, torch.tensor(it, dtype=torch.int32, device=dev),
            torch.tensor(err, dtype=torch.float32, device=dev))


def fused_anderson(ell0, M1, M2T, log_kap, sub, theta: float, beta: float,
                   tol: float, max_iter: int, *, history: int = 5,
                   mixing_frequency: int = 2, beta_aa: float = 1.0,
                   ridge: float = 1e-6):
    """The Anderson solve on the tensors' device: the plain version for
    CPU tensors, one launch of the CUDA kernel for CUDA tensors (same
    arguments and results as :func:`fused_anderson_plain`)."""
    if not 1 <= history <= MAX_HISTORY or mixing_frequency < 1:
        raise ValueError(f"history must be 1..{MAX_HISTORY} and "
                         "mixing_frequency >= 1")
    opts = dict(history=history, mixing_frequency=mixing_frequency,
                beta_aa=beta_aa, ridge=ridge)
    refuse(ell0, "fused_anderson")
    if ell0.device.type == "cpu":
        return fused_anderson_plain(ell0, M1, M2T, log_kap, sub, theta, beta,
                                    tol, max_iter, **opts)
    if ell0.device.type == "cuda":
        out, iters, err = launch(ALGO_AA, ell0, M1, M2T, log_kap, sub, theta,
                                 beta, tol=tol, max_iter=max_iter, **opts)
        LAUNCHES["fused_anderson"] += 1
        return out, iters[0], err[0]
    raise ValueError(f"no fused Anderson kernel for device {ell0.device}")


def make_fused_anderson_from_operands(M1, M2T, log_kap, theta, beta, shapes,
                                      rows, cols, *,
                                      history: int = 5,
                                      mixing_frequency: int = 2,
                                      beta_aa: float = 1.0,
                                      ridge: float = 1e-6,
                                      sub=None,
                                      device="cuda") -> Callable:
    """``solve(ell0, tol=1e-6, max_iter=100_000) -> (ell*, iters, err)``
    with Anderson acceleration (float32), on ``device``."""
    if not 1 <= history <= MAX_HISTORY or mixing_frequency < 1:
        raise ValueError(f"history must be 1..{MAX_HISTORY} and "
                         "mixing_frequency >= 1")
    dev = resolve_device(device)
    shapes = tuple(shapes)
    check_working_set(shapes, rows, cols,
                      5 + 2 * history + (sub is not None), dev,
                      f"the Anderson solve with history {history}")
    M1, M2T, log_kap, sub = _device_operands(M1, M2T, log_kap, sub,
                                             torch.float32, dev)
    theta, beta = float(theta), float(beta)
    opts = dict(history=history, mixing_frequency=mixing_frequency,
                beta_aa=beta_aa, ridge=ridge)

    def solve_fused(ell0, tol=1e-6, max_iter=100_000):
        refuse(ell0, "fused_anderson")
        ell_mat = torch.as_tensor(ell0).to(
            device=dev, dtype=torch.float32).reshape(rows, cols).contiguous()
        ell, iters, err = fused_anderson(ell_mat, M1, M2T, log_kap, sub,
                                         theta, beta, tol, max_iter, **opts)
        return ell.reshape(shapes), iters, err

    return solve_fused


def make_fused_anderson_ssy(model: SSY, disc: SSYDiscretization, *,
                            device="cuda", **kw) -> Callable:
    """In-kernel Anderson solve for the discrete SSY operator."""
    n_l, n_k, n_i, n_j = disc.shapes
    M1, M2T, log_kap = kron_operands_ssy(model, disc, torch.float64)
    return make_fused_anderson_from_operands(
        M1, M2T, log_kap, model.theta, model.beta, disc.shapes,
        n_l * n_k, n_i * n_j, device=device, **kw)


def make_fused_anderson_ssy_continuous(model: SSY, grids, degree: int = 5,
                                       *, device="cuda", **kw) -> Callable:
    """In-kernel Anderson solve for the continuous SSY operator
    (quadrature, pre-power interpolation)."""
    shapes = tuple(len(g) for g in grids)
    n_l, n_k, n_i, n_j = shapes
    M1, M2T, log_kap = kron_operands_ssy_continuous(model, grids, degree,
                                                    torch.float64)
    return make_fused_anderson_from_operands(
        M1, M2T, log_kap, model.theta, model.beta, shapes,
        n_l * n_k, n_i * n_j, device=device, **kw)


def make_fused_anderson_gcy_continuous(model, grids, degree: int = 5,
                                       baseline="loglinear", *,
                                       device="cuda", **kw) -> Callable:
    """In-kernel Anderson solve for the *continuous* GCY factored
    operator (baseline-normalized by default, as
    :func:`.solver_kernel.make_fused_solver_gcy_continuous`)."""
    return _fused_gcy_continuous(make_fused_anderson_from_operands, model,
                                 grids, degree, baseline, device=device,
                                 **kw)
