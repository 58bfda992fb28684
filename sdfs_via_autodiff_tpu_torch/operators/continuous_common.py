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
gather operator :func:`make_gather_T` evaluates every interpolation
space the reference's way (a 2^d-corner gather per state and node): it
is the oracle the node-chain operators (:mod:`.post_interp`) are held
to.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..ops.grids import flatten_mesh
from ..ops.interp import (gather_corners, interp_corners, lin_interp,
                          uniform_grid_coords)
from ..ops.tangent import Linearization

__all__ = ["hat_basis", "hat_corners", "hat_from_corners",
           "expectation_matrix", "make_gather_T", "mc_draws",
           "warn_if_f32_range_unsafe", "normalize_expectation_matrix",
           "additive_profiles"]


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


def mc_draws(dim: int, size: int, seed: int) -> torch.Tensor:
    """``size`` joint N(0, 1) shock draws (dim, size), float64 on the CPU
    from a ``torch.Generator`` seeded with ``seed``: the same draws on
    every device.  (Not the JAX package's PRNG stream: the two packages'
    Monte Carlo operators agree in distribution, not draw by draw.)"""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((dim, size), generator=gen, dtype=torch.float64)


def hat_corners(grid: torch.Tensor, points: torch.Tensor):
    """The non-zeros of :func:`hat_basis`: the lower corner index i0
    (int64) and the upper corner's weight t of each point, so that
    ``B[..., i0] = 1 - t`` and ``B[..., i0 + 1] = t``.  A one-point grid
    gives i0 = 0, t = 0 (its single weight 1)."""
    n = grid.shape[0]
    if n == 1:
        return (torch.zeros(points.shape, dtype=torch.int64,
                            device=points.device), torch.zeros_like(points))
    step = grid[1] - grid[0]
    c = (points - grid[0]) / step
    i0 = torch.clamp(torch.floor(c), 0, n - 2).to(torch.int64)
    t = torch.clamp(c - i0, 0.0, 1.0)
    return i0, t


def hat_from_corners(i0: torch.Tensor, t: torch.Tensor,
                     n: int) -> torch.Tensor:
    """The dense hat-basis rows (``i0.shape + (n,)``) of the corners
    :func:`hat_corners` returns, by the same arithmetic as
    :func:`hat_basis`."""
    k = torch.arange(n, device=i0.device)
    lo = (k == i0[..., None]) * (1.0 - t[..., None])
    hi = (k == (i0 + 1)[..., None]) * t[..., None]
    return lo + hi


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
    return hat_from_corners(*hat_corners(grid, points), n)


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


def make_gather_T(next_state: Callable,
                  log_kappa: Callable,
                  grids,
                  shocks,
                  weights,
                  interp: str,
                  space: str,
                  batch_size,
                  beta: float,
                  theta: float,
                  *,
                  device="cuda") -> Callable:
    """Pointwise (corner-gather) continuous operator, model-agnostic.

    ``next_state(x, shocks)``: successor states of ``x`` (dim, B, 1) under
    ``shocks`` (dim, 1, Q), shape (dim, B, Q), with dimension 0 = h_lam
    (whose successor carries the exp(theta*h') payoff in both SSY and
    GCY).  ``log_kappa(x)``: log of the state-dependent constant at ``x``
    (dim, B).  ``weights`` None means equal Monte Carlo weights.  The
    operator runs on ``device`` in the grids' dtype, over batches of
    ``batch_size`` states (all at once when None; the state count must be
    a multiple of it).

    interp: "post" (reference semantics — interpolate w, then power),
    "pre" (interpolate w^theta), "loglin" (interpolate log w).
    space: "w" iterates on w; "log" iterates on ell = log w with
    shift-stabilized expectations.

    In log space ``T.linearize(x)`` is Newton's tangent, built once (as
    the node chains', ``operators/post_interp.py``): at fixed successors
    the interpolation is a linear map G of the field, so with the
    field's tangent F * dell (F = e^{theta ell - max} theta for "pre",
    e^{ell} for "post", 1 for "loglin") the tangent is
    sigma * sum_q W_q G(F * dell)_q.  W (states, Q), formed batch by
    batch, is w_q e^{pf_q} / E for "pre" (E the expectation),
    theta p_q / vals_q for "post" and theta p_q for "loglin" (p_q the
    softmax weights of the log-expectation), times the epilogue's sigma
    = q / ((1 + q) theta).  Its matvec gathers the stored corners: no
    exp, log or max.  It is single-device.
    """
    if interp not in ("post", "pre", "loglin"):
        raise ValueError(f"unknown interp {interp!r}")
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    dev = resolve_device(device)
    grids = tuple(torch.as_tensor(g).to(dev) for g in grids)
    dtype = grids[0].dtype
    dim = len(grids)
    shape = tuple(len(g) for g in grids)
    x_flat = flatten_mesh(grids)                              # (n, dim)
    n = x_flat.shape[0]
    if batch_size is None or batch_size >= n:
        batch_size = n
    elif n % batch_size:
        raise ValueError(f"state-space size {n} not divisible by "
                         f"batch_size {batch_size}")
    batches = x_flat.reshape(n // batch_size, batch_size, dim)
    shocks = torch.as_tensor(shocks).to(device=dev, dtype=dtype)
    if weights is not None:
        weights = torch.as_tensor(weights).to(device=dev, dtype=dtype)

    def reduce_rule(vals):                    # (B, Q) -> (B,)
        return vals.mean(dim=1) if weights is None else vals @ weights

    def successors(xb, field):
        """(next x' (dim, B, Q), interp of ``field`` at x' (B, Q))."""
        nxt = next_state(xb.T[:, :, None], shocks[:, None, :])
        vals = lin_interp(nxt.reshape(dim, -1), field, grids)
        return nxt, vals.reshape(nxt.shape[1:])

    if space == "w":
        def T(w):
            # The field transform (w^theta / log w) happens once, not per
            # batch.
            field = (w if interp == "post"
                     else w ** theta if interp == "pre" else torch.log(w))
            out = []
            for xb in batches:
                nxt, vals = successors(xb, field)
                if interp == "post":
                    vals = vals ** theta
                elif interp == "loglin":
                    vals = torch.exp(theta * vals)
                pf = torch.exp(theta * nxt[0])
                out.append(torch.exp(log_kappa(xb.T).to(dtype))
                           * reduce_rule(vals * pf))
            kg = torch.cat(out).reshape(shape)
            return 1.0 + beta * kg ** (1.0 / theta)
        return T

    log_kappa_flat = torch.cat([log_kappa(xb.T) for xb in batches]
                               ).reshape(shape).to(dtype)

    w_q = 1.0 / shocks.shape[1] if weights is None else weights

    def log_expect(a_vals):                   # (B, Q) -> (B,), e, sum
        mx = torch.amax(a_vals, dim=1, keepdim=True)
        e = torch.exp(a_vals - mx)
        den = reduce_rule(e)
        return mx[:, 0] + torch.log(den), e, den

    def primal(ell, tape=None):
        if interp == "pre":
            mx = torch.amax(theta * ell)
            field, shift = torch.exp(theta * ell - mx), mx
        elif interp == "post":
            field, shift = torch.exp(ell), 0.0
        else:
            field, shift = ell, 0.0
        out, factors, corners = [], [], []
        for xb in batches:
            nxt = next_state(xb.T[:, :, None], shocks[:, None, :])
            cb = interp_corners(shape, uniform_grid_coords(
                grids, nxt.reshape(dim, -1)))
            vals = gather_corners(field, cb).reshape(nxt.shape[1:])
            pf = theta * nxt[0]
            if interp == "pre":
                e = torch.exp(pf)
                den = reduce_rule(vals * e)
                out.append(torch.log(den))
            else:
                a = theta * (torch.log(vals) if interp == "post" else vals)
                lk, e, den = log_expect(a + pf)
                out.append(lk)
                e = theta * (e / vals if interp == "post" else e)
            if tape is not None:           # (B, Q) factor of the batch
                factors.append(e * w_q / den[:, None])
                corners.append(cb)
        log_kg = torch.cat(out).reshape(shape) + shift + log_kappa_flat
        qe = beta * torch.exp(log_kg / theta)
        if tape is not None:
            if interp != "loglin":
                tape.scale(theta * field if interp == "pre" else field)
            tape.linear(lambda t: torch.cat(
                [gather_corners(t, cb) for cb in corners]).reshape(n, -1))
            sigma = qe / ((1 + qe) * theta)
            tape.scale(torch.cat(factors) * sigma.reshape(n, 1))
            tape.linear(lambda t: t.sum(1).reshape(shape))
        return torch.log1p(qe)

    def T(ell):
        return primal(ell)

    T.linearize = lambda x: Linearization(primal, x)
    return T
