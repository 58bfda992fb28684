"""Shared machinery for the continuous-state Koopmans operators.

PyTorch port of the factored half of
``sdfs_via_autodiff_tpu/operators/continuous_common.py``.  When the power
is applied *before* interpolation (interpolating g = w^theta, the "pre"
interpolation space), the interpolant is linear in the grid values,

    interp(g)(x') = sum_k g[k] * prod_d b_{k_d}(x'_d),

and because each state dimension's successor x'_d is driven by its own
independent N(0,1) shock, the tensor-product quadrature expectation
factorizes into per-dimension *expectation matrices*

    P_d[i, k] = sum_q omega_q * b_k( mu_d(x_i) + sigma_d * eta_q ),

so E_x[interp(g)(x')] is a chain of per-axis contractions of g against
the P_d, the same structure as the discrete operator.  The pointwise
gather operator (``make_gather_T``, the oracle of the post/loglin
semantics) is not ported yet (ROADMAP queue A item 6).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.grids import flatten_mesh

__all__ = ["hat_basis", "expectation_matrix", "warn_if_f32_range_unsafe",
           "normalize_expectation_matrix", "additive_profiles"]


def additive_profiles(ell_field):
    """Fit an additive (ANOVA main-effects) model to a log-solution field.

    Returns ``(const, [profile_0, ..., profile_{d-1}])`` with
    ell ~ const + sum_d profile_d[i_d]; the profiles are mean-centered
    axis averages (numpy float64).  Fitted on a coarse float64 solve,
    these are the separable baselines for normalizing the continuous
    operators.
    """
    if isinstance(ell_field, torch.Tensor):
        ell_field = ell_field.detach().cpu().numpy()
    ell = np.asarray(ell_field, np.float64)
    const = float(ell.mean())
    profiles = []
    for d in range(ell.ndim):
        axes = tuple(a for a in range(ell.ndim) if a != d)
        profiles.append(ell.mean(axis=axes) - const)
    return const, profiles


def normalize_expectation_matrix(P, phi_next, phi_cur, theta):
    """Fold a separable baseline component into an expectation matrix.

    Returns P~[..., x, y] = P[..., x, y] * exp(theta*(phi_next[y] -
    phi_cur[..., x])) as numpy float64 (full exponent range), so the
    result is f32-castable wherever it is representable; entries whose
    true magnitude underflows f32 go to zero.
    """
    P64 = np.asarray(P, np.float64)
    with np.errstate(divide="ignore"):
        logP = np.log(P64)
    nxt = np.asarray(phi_next, np.float64)
    cur = np.asarray(phi_cur, np.float64)
    return np.exp(logP + theta * (nxt - cur[..., None]))


def warn_if_f32_range_unsafe(model, grids, loglinear_factory, dtype) -> None:
    """Warn when theta * (log-linear w range over the grid) exceeds what
    float32 exponentials can represent (~80): the log-space operator will
    overflow at such state-space spans."""
    if dtype != torch.float32:
        return
    try:
        ll = loglinear_factory(model)
        mesh = flatten_mesh([torch.as_tensor(g, dtype=torch.float64).cpu()
                             for g in grids])
        vals = ll(mesh.numpy().T)
        span = abs(model.theta) * float(np.max(vals) - np.min(vals))
    except Exception:
        return
    if span > 80.0:
        warnings.warn(
            f"theta * log-w range over this grid is ~{span:.0f}, beyond "
            "float32's exponential range (~80): the f32 log-space operator "
            "will overflow at the state-space corners. Use float64 "
            "or a smaller num_std_devs.", stacklevel=3)


def hat_basis(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Multilinear ("hat") basis weights of ``points`` on a uniform grid.

    Returns B with shape ``points.shape + (len(grid),)`` where
    ``B[..., k] = b_k(points)``; each row has at most two non-zeros summing
    to one.  Out-of-range points clamp to the edge.
    """
    n = grid.shape[0]
    if n == 1:
        return torch.ones(points.shape + (1,), dtype=points.dtype,
                          device=points.device)
    step = grid[1] - grid[0]
    c = (points - grid[0]) / step
    i0 = torch.clamp(torch.floor(c), 0, n - 2).to(torch.int64)
    t = torch.clamp(c - i0, 0.0, 1.0)
    k = torch.arange(n, device=points.device)
    lo = (k == i0[..., None]) * (1.0 - t[..., None])
    hi = (k == (i0 + 1)[..., None]) * t[..., None]
    return lo + hi


def expectation_matrix(grid: torch.Tensor,
                       mean: torch.Tensor,
                       scale,
                       nodes: torch.Tensor,
                       weights: torch.Tensor,
                       payoff: Optional[Callable] = None) -> torch.Tensor:
    """Per-dimension expectation matrix for x' = mean + scale * eta.

    ``mean`` has an arbitrary batch shape (conditioning states); ``scale``
    broadcasts against it.  Returns P of shape ``mean.shape + (len(grid),)``
    with

        P[..., k] = sum_q weights[q] * payoff(x'_q) * b_k(x'_q),

    where ``payoff`` (default 1) folds state-dependent factors such as the
    SSY/GCY ``exp(theta * h_lam')`` into the matrix.
    """
    scale = torch.as_tensor(scale, dtype=mean.dtype, device=mean.device)
    x_next = mean[..., None] + scale[..., None] * nodes               # (..., q)
    B = hat_basis(grid, x_next)                                      # (..., q, k)
    if payoff is not None:
        B = B * payoff(x_next)[..., None]
    return torch.einsum("q,...qk->...k", weights, B)
