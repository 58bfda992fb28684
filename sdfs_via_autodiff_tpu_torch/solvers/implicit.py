"""Implicit differentiation through the fixed point (calibration gradients).

PyTorch port of ``solvers/implicit.py``.  ``x*(p)`` solves
``x = T(p, x)``; the implicit function theorem gives its parameter
sensitivity without differentiating a single solver iteration:

    forward  (I - A) dx = (dT/dp) dp,        A = dT/dx at x*,
    reverse  (I - A)^T u = g_bar,   p_bar = (dT/dp)^T u,

each one matrix-free linear solve with :func:`.krylov.bicgstab_mixed`,
whose matvec is a ``torch.func.jvp`` (forward) or ``torch.func.vjp``
(reverse) of the operator at the solved point.  A gradient of any scalar
functional of ``x*`` therefore costs one fixed-point solve plus one
adjoint Krylov solve, however many iterations the solver ran.

Conventions: ``T_of_p(p, x) -> x'`` is a parametric operator.  ``p`` is
a tensor, a tuple or list of tensors, or a dict of them (0-d tensors,
typically); everything ``T_of_p`` computes from ``p`` must stay in the
autograd graph (no ``float()``, ``.item()`` or numpy round trips).
``x0`` and the solver configuration are not differentiated.  The
reverse pass is a ``torch.autograd.Function`` with a separate
``setup_context``, so ``torch.autograd.grad``, ``backward`` and
``torch.func.grad``/``vjp`` all reach it.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch

from ..ops.dtensor import apply, is_dtensor
from ..parallel.gspmd import jvp_by_vjp, local_operator
from .api import solve
from .krylov import bicgstab_mixed
from .sharding import LOCAL, Reductions

__all__ = ["implicit_fixed_point", "implicit_sensitivity"]


def _flatten(p):
    """``p`` as (leaves, rebuild): a tuple of tensors and the function
    that turns such a tuple back into ``p``'s structure."""
    if isinstance(p, dict):
        keys = tuple(p)
        return tuple(p[k] for k in keys), lambda q: dict(zip(keys, q))
    if isinstance(p, (tuple, list)):
        kind = type(p)
        return tuple(p), lambda q: kind(q)
    return (p,), lambda q: q[0]


def _norm64(v):
    return torch.linalg.vector_norm(v.reshape(-1).to(torch.float64))


def _check_krylov_residual(matvec, x, b, atol, label, red=LOCAL):
    """Warn when a Krylov solve stagnated (true residual above 10x its
    target): with beta ~ 1 the system (I - A) is nearly singular and
    BiCGStab can exhaust its iterations far from tolerance, which would
    otherwise return a wrong derivative silently.  ``red`` sums the
    residual's norm over the shards of a sharded iterate."""
    r = b - matvec(x)
    rn = float((_norm64(r) if not red.sharded
                else torch.sqrt(red.dot64(r.reshape(-1), r.reshape(-1))))
               .detach())
    atol = float(torch.as_tensor(atol).detach())
    if rn > 10.0 * max(atol, 1e-300):
        warnings.warn(
            f"implicit {label} Krylov solve stagnated: |residual|={rn:.3e} "
            f"> 10x atol={atol:.3e}; derivatives may be inaccurate (raise "
            "adjoint_maxiter or relax adjoint_rtol)", stacklevel=3)


class _ImplicitFixedPoint(torch.autograd.Function):
    """x* = solve(T_of_p(p, .)) with the adjoint-solve backward."""

    @staticmethod
    def forward(T_of_p, rebuild, x0, cfg, *leaves):
        method, tol, _, _, solve_kwargs = cfg
        p = rebuild(leaves)
        with torch.no_grad():
            res = solve(lambda x: T_of_p(p, x), x0, method=method, tol=tol,
                        **solve_kwargs)
        return res.x.detach().clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        T_of_p, rebuild, _, cfg, *leaves = inputs
        ctx.T_of_p, ctx.rebuild, ctx.cfg = T_of_p, rebuild, cfg
        ctx.save_for_backward(output, *leaves)

    @staticmethod
    def backward(ctx, ct):
        x_star, *leaves = ctx.saved_tensors
        T_of_p, rebuild = ctx.T_of_p, ctx.rebuild
        _, _, rtol, maxiter, _ = ctx.cfg
        if is_dtensor(x_star):
            return (None, None, None, None) + _adjoint_on_dtensor(
                T_of_p, rebuild, tuple(leaves), x_star, ct, rtol, maxiter)
        p = rebuild(tuple(leaves))
        _, vjp_x = torch.func.vjp(lambda x: T_of_p(p, x), x_star)
        matvec = lambda u: u - vjp_x(u)[0]
        atol = rtol * _norm64(ct)
        u, _ = bicgstab_mixed(matvec, ct, atol=atol, maxiter=maxiter)
        _check_krylov_residual(matvec, u, ct, atol, "adjoint")
        _, vjp_p = torch.func.vjp(
            lambda *q: T_of_p(rebuild(q), x_star), *leaves)
        return (None, None, None, None) + tuple(vjp_p(u))


def _local_parts(T_of_p, p, x_star):
    """The local form of ``x -> T_of_p(p, x)`` at the DTensor ``x_star``
    (``parallel.gspmd.local_operator``), its reductions and the local
    shard of ``x_star``."""
    op = local_operator(lambda x: T_of_p(p, x), x_star)
    return op, Reductions(op.reduce_axis.group), op.to_local(x_star)


def _adjoint_on_dtensor(T_of_p, rebuild, leaves, x_star, ct, rtol, maxiter):
    """The reverse pass at a DTensor fixed point: the adjoint BiCGStab
    solve on this rank's shard (dot products over the distinct shards),
    its VJP matvecs one backward each of a graph built once, then
    ``(dT/dp)^T u`` by a backward through the operator on the DTensor,
    whose lifted constants return the parameters' gradients as plain
    tensors (the same on every rank)."""
    op, red, xl = _local_parts(T_of_p, rebuild(leaves), x_star)
    ctl = op.to_local(ct)
    with torch.enable_grad():
        xg = xl.detach().requires_grad_(True)
        y = op.local(xg)
    matvec = lambda u: u - torch.autograd.grad(y, xg, u,
                                               retain_graph=True)[0]
    atol = rtol * torch.sqrt(red.dot64(ctl.reshape(-1), ctl.reshape(-1)))
    u, _ = bicgstab_mixed(matvec, ctl, atol=atol, maxiter=maxiter, red=red)
    _check_krylov_residual(matvec, u, ctl, atol, "adjoint", red)
    with torch.enable_grad():
        qs = tuple(q.detach().requires_grad_(True) for q in leaves)
        out = apply(lambda x: T_of_p(rebuild(qs), x), x_star)
        grads = torch.autograd.grad(out, qs, op.from_local(u),
                                    allow_unused=True)
    return tuple(torch.zeros_like(q) if g is None else g
                 for g, q in zip(grads, leaves))


def implicit_fixed_point(T_of_p: Callable, p, x0, *,
                         method: str = "newton",
                         tol: float = 1e-7,
                         adjoint_rtol: float = 1e-8,
                         adjoint_maxiter: int = 200,
                         **solve_kwargs):
    """Solve ``x = T_of_p(p, x)`` and return ``x*`` as a differentiable
    function of ``p`` (reverse mode).

    The forward pass runs the ordinary solver (:func:`.api.solve` with
    ``method``/``tol``/``solve_kwargs``, outside the graph); the backward
    pass solves the adjoint equation ``(I - A)^T u = g_bar`` with
    :func:`.krylov.bicgstab_mixed` (``adjoint_rtol`` relative to
    ``||g_bar||_2``, ``adjoint_maxiter`` iterations, a warning when it
    stagnates) and returns ``p_bar = (dT/dp)^T u``.

    The gradient error is O(solver residual) + O(adjoint residual).
    ``x0`` receives no gradient; grids and quadrature closed over by
    ``T_of_p`` are held fixed (sensitivities of the collocation values).

    A DTensor ``x0`` solves on its shards (``solvers/sharding.py``) and
    returns a DTensor with its placements; the adjoint solve runs on the
    shards too, and the gradient is a plain tensor on every rank.
    """
    leaves, rebuild = _flatten(p)
    cfg = (method, tol, adjoint_rtol, adjoint_maxiter, solve_kwargs)
    return _ImplicitFixedPoint.apply(T_of_p, rebuild, x0, cfg, *leaves)


def implicit_sensitivity(T_of_p: Callable, p, dp, x_star, *,
                         rtol: float = 1e-8,
                         maxiter: int = 200):
    """Directional (forward-mode) sensitivity ``dx = (dx*/dp) dp`` at an
    already-solved fixed point ``x_star``.

    Solves ``(I - A) dx = (dT/dp) dp`` matrix-free, the matvec a
    ``torch.func.jvp`` of the operator in ``x``: one Krylov solve per
    direction.  ``dp`` has ``p``'s structure.  At a DTensor ``x_star``
    both tangents are derivatives of VJPs (forward mode does not run on
    a DTensor), the solve runs on the shards and ``dx`` is a DTensor
    with ``x_star``'s placements.
    """
    leaves, rebuild = _flatten(p)
    dleaves = tuple(torch.as_tensor(d, dtype=q.dtype, device=q.device)
                    for d, q in zip(_flatten(dp)[0], leaves))
    x_star = x_star.detach()
    if is_dtensor(x_star):
        return _sensitivity_on_dtensor(T_of_p, p, rebuild, leaves, dleaves,
                                       x_star, rtol, maxiter)
    b = torch.func.jvp(lambda *q: T_of_p(rebuild(q), x_star),
                       tuple(leaves), dleaves)[1]
    matvec = lambda v: v - torch.func.jvp(lambda x: T_of_p(p, x),
                                          (x_star,), (v,))[1]
    atol = rtol * _norm64(b)
    dx, _ = bicgstab_mixed(matvec, b, atol=atol, maxiter=maxiter)
    _check_krylov_residual(matvec, dx, b, atol, "tangent")
    return dx


def _sensitivity_on_dtensor(T_of_p, p, rebuild, leaves, dleaves, x_star,
                            rtol, maxiter):
    """:func:`implicit_sensitivity` at a DTensor ``x_star``."""
    b = jvp_by_vjp(lambda *q: apply(lambda x: T_of_p(rebuild(q), x),
                                    x_star), leaves, dleaves)
    op, red, xl = _local_parts(T_of_p, p, x_star)
    bl = op.to_local(b)
    j_minus_i = op.local_twin.linearize(xl)
    matvec = lambda v: -j_minus_i(v)
    atol = rtol * torch.sqrt(red.dot64(bl.reshape(-1), bl.reshape(-1)))
    dx, _ = bicgstab_mixed(matvec, bl, atol=atol, maxiter=maxiter, red=red)
    _check_krylov_residual(matvec, dx, bl, atol, "tangent", red)
    return op.from_local(dx)
