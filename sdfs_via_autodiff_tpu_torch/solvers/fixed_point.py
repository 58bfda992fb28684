"""Successive approximation and Newton–Kantorovich fixed-point solvers.

PyTorch port of ``solvers/fixed_point.py``.  The JAX package runs each
solve as one device ``lax.while_loop``.  Here the loop is Python, and it
reads its stop condition on the host once every
:data:`~.krylov.SYNC_EVERY` iterations; inside a chunk each iteration
evaluates the condition on the device and ``torch.where`` freezes the
state once it fails, so the returned iterate, iteration count and
residual equal those of a check after every iteration.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..ops.dtensor import is_dtensor
from ..utils.profiling import spanned
from .krylov import SYNC_EVERY, bicgstab_mixed, gmres, host_read
from .result import SolveResult
from .sharding import LOCAL, Reductions, solve_parts, tangent_matvec

DEFAULT_TOL = 1e-7
DEFAULT_MAX_ITER = 1_000_000

__all__ = ["successive_approx", "newton_solver", "DEFAULT_TOL",
           "DEFAULT_MAX_ITER"]


STALL_ITERS = 200     # consecutive non-improving iterations before giving up
STALL_RTOL = 1e-5     # relative residual decrease that counts as progress
NONMONOTONE = 4       # Newton's safeguard: iterates whose residuals it weighs


def _iterate(step: Callable, x0, tol, max_iter, *, verbose=False,
             trace_len: int = 0, stall_iters: int = STALL_ITERS,
             final_residual: Optional[Callable] = None,
             red: Reductions = LOCAL,
             wrap: Callable = lambda x: x) -> SolveResult:
    """Run ``x <- step(x, running)`` until sup-norm convergence.

    ``running`` is a 0-d device bool: False for the iterations a chunk
    runs after the stop condition failed, whose results are discarded —
    a step may use it to skip work.  The loop stops on convergence, at
    ``max_iter``, on a NON-FINITE step (keeping the last finite iterate
    and its error), and on a residual plateau: ``stall_iters``
    consecutive iterations without a relative improvement of at least
    ``STALL_RTOL`` over the best residual seen.  ``final_residual``
    replaces the step size as the reported residual (Newton: the true
    fixed-point residual).

    ``trace_len`` > 0 records each iteration's step size in
    ``SolveResult.error_trace``, a (trace_len,) tensor on the iterate's
    device padded with NaN (iterations past the end overwrite its last
    entry, as in the JAX package).  It is written by index on the device
    and never read inside the loop.

    ``red`` takes the loop's sup-norms (over every shard of a sharded
    iterate, ``solvers/sharding.py``); ``wrap`` maps the final iterate
    to the result's ``x``.
    """
    dtype, dev = x0.dtype, x0.device
    # Filled on the device: a copy of a host scalar would wait for it.
    big = torch.full((), math.inf, dtype=dtype, device=dev)
    tol_t = torch.full((), tol, dtype=dtype, device=dev)
    x, err, best = x0, big, big
    it = torch.zeros((), dtype=torch.int64, device=dev)
    since = torch.zeros((), dtype=torch.int64, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)
    trace = slots = None
    if trace_len:
        trace = torch.full((trace_len,), math.nan, dtype=dtype, device=dev)
        slots = torch.arange(trace_len, device=dev)

    def cond():
        return ((err > tol_t) & (it < max_iter) & alive
                & (since < stall_iters))

    while host_read(bool, cond()):             # one host read per chunk
        if verbose:
            print(f"iter = {host_read(int, it)}, "
                  f"error = {host_read(float, err)}")
        for _ in range(SYNC_EVERY):
            run = cond()
            x_new = step(x, run)
            err_new = red.sup(x_new - x)
            ok = torch.isfinite(err_new)
            improved = err_new < best * (1.0 - STALL_RTOL)
            keep = run & ok
            if trace is not None:
                at = run & (slots == torch.clamp(it, max=trace_len - 1))
                trace = torch.where(at, err_new, trace)
            x = torch.where(keep, x_new, x)
            err = torch.where(keep, err_new, err)
            since = torch.where(run, torch.where(ok & improved, 0, since + 1),
                                since)
            best = torch.where(keep, torch.minimum(best, err_new), best)
            alive = torch.where(run, ok, alive)
            it = it + run.to(torch.int64)
    if final_residual is not None:
        # The loop's error is the STEP size; for composite steps (Newton)
        # a degenerate inner solve can return a zero step far from the
        # solution, so report the actual fixed-point residual instead.
        err = final_residual(x)
    converged = host_read(bool, (err <= tol_t) & ~torch.isnan(err))
    return SolveResult(x=wrap(x), iterations=host_read(int, it),
                       residual=host_read(float, err), converged=converged,
                       error_trace=trace)


def successive_approx(T: Callable,
                      x0,
                      tol: float = DEFAULT_TOL,
                      max_iter: int = DEFAULT_MAX_ITER,
                      *,
                      verbose: bool = False,
                      trace_len: int = 0,
                      stall_iters: int = STALL_ITERS) -> SolveResult:
    """Successive approximation x <- T(x) to a sup-norm fixed point, with
    the residual plateau guard and the optional residual trace (see
    :func:`_iterate`).  A DTensor ``x0`` runs on the local shard
    (``solvers/sharding.py``)."""
    op, _, x0, red, wrap, _ = solve_parts(T, x0)
    return _iterate(lambda x, running: op(x), x0, tol, max_iter,
                    verbose=verbose, trace_len=trace_len,
                    stall_iters=stall_iters, red=red, wrap=wrap)


def newton_solver(T: Callable,
                  x0,
                  tol: float = DEFAULT_TOL,
                  max_iter: int = DEFAULT_MAX_ITER,
                  *,
                  inner: str = "bicgstab",
                  inner_tol: float = 1e-4,
                  inner_maxiter: Optional[int] = 50,
                  safeguard: bool = True,
                  tangent_T: Optional[Callable] = None,
                  verbose: bool = False,
                  trace_len: int = 0,
                  stall_iters: int = 30) -> SolveResult:
    """Newton–Kantorovich iteration for a fixed point of T.

    Iterates ``q(x) = x - J(x)^{-1} g(x)`` for ``g(x) = T(x) - x``.
    ``g(x)`` comes from ``T`` (the kernels, for the tiled tier); the
    linearization comes from ``T.twin`` when ``T`` has one (the eager
    evaluator of the same math — what the JAX package's custom JVP
    routes ``jax.linearize`` to), else from ``T``.

    ``inner``: "bicgstab" (:func:`.krylov.bicgstab_mixed`: iterate-dtype
    vectors, float64 scalars) or "gmres" (:func:`.krylov.gmres`,
    restarted, ``inner_maxiter`` restart cycles), both matrix-free with
    matvecs ``v -> J(x) v`` (:func:`.sharding.tangent_matvec`: the
    operator's hand linearization, built once per Newton step, or else
    ``torch.func.jvp`` per matvec); or "dense":
    ``torch.func.jacfwd`` of the flat residual and ``torch.linalg.solve``
    (small grids; ``inner_tol`` and ``inner_maxiter`` do not apply, and
    a ``tangent_T`` raises ``ValueError``).  Another name raises
    ``ValueError``.

    The Krylov tolerance is *relative* to ||g(x)|| (an inexact-Newton
    forcing term): with an absolute tolerance, any iterate with ||g(x)||
    below it makes the zero vector an acceptable Krylov solution and the
    outer loop reports convergence at a spurious point.
    ``inner_maxiter=None`` means ``10 * x0.numel()``.

    ``tangent_T`` (mixed-precision iterative refinement): a float32 twin
    of ``T`` on the same field, e.g. the tiled kernels' operator.  The
    Krylov matvecs then linearize ``tangent_T.twin`` (or ``tangent_T``)
    at ``x`` in float32 against the float32 right-hand side
    ``g(x)``, while the residual ``g(x)`` and the safeguard stay on
    ``T``: each outer step contracts by about the float32 solve's
    relative error, so the solve still reaches ``T``'s precision.

    ``safeguard=True`` rejects a Newton candidate whose residual is
    non-finite or more than 10x the largest residual of the last
    :data:`NONMONOTONE` iterates (this one included: Grippo, Lampariello
    and Lucidi's non-monotone rule), or whose step is zero (an inner
    solve that broke down), in favour of a plain fixed-point step T(x)
    (free — g(x) is already computed).  Against the current residual
    alone, a strongly nonlinear operator (GCY's theta = -36) can reject
    the right Newton direction step after step while plain steps crawl;
    a zero step would end the loop far from the fixed point.  With
    ``safeguard=False`` a non-finite candidate poisons the iterate so the
    outer NaN guard stops with ``converged=False``.

    ``trace_len`` records each outer step's size (see :func:`_iterate`).

    Each step is a ``sdfs.newton.step`` span (``utils/profiling.py``);
    its Krylov solve's ``sdfs.krylov`` span counts the inner iterations
    (BiCGStab iterations, GMRES Arnoldi steps; 0 for the frozen steps
    that end a chunk after the stop condition failed).

    A DTensor ``x0`` runs on the local shard, with every norm and dot
    product all-reduced (``solvers/sharding.py``): a sharded operator
    (``parallel/shard_ops.py``) linearizes ``T.local_twin``, any other
    operator runs on the DTensor (``parallel/gspmd.py``) and is
    linearized there by its own linearization or else by the derivative
    of its VJP; ``inner`` "dense" and ``tangent_T`` raise ``ValueError``
    there.
    """
    if inner not in ("bicgstab", "gmres", "dense"):
        raise ValueError(f"unknown inner solver {inner!r}")
    if inner == "dense" and tangent_T is not None:
        # The JAX package ignores tangent_T here without a word.
        raise ValueError("tangent_T applies to the Krylov inner solvers, "
                         "not inner='dense'")
    distributed = is_dtensor(x0)
    T, lin, x0, red, wrap, numel = solve_parts(T, x0)
    if distributed and (inner == "dense" or tangent_T is not None):
        raise ValueError("a Newton solve on a DTensor iterate takes the "
                         "Krylov inner solvers without tangent_T (the "
                         "dense Jacobian and the float32 tangent operator "
                         "are single-device)")
    g = lambda x: T(x) - x
    maxiter = inner_maxiter if inner_maxiter is not None else 10 * numel
    inf = torch.full((), math.inf, dtype=torch.float64, device=x0.device)

    # The residuals of the last NONMONOTONE iterates that ran, on the
    # device (no host read).
    recent = torch.zeros(NONMONOTONE, dtype=x0.dtype, device=x0.device)

    def accept(x, gx, step, running):
        """The safeguard: a plain step T(x) where the candidate x - step
        is bad."""
        nonlocal recent
        x_new = x - step
        bad = ~red.all_finite(gx) | ~red.all_finite(x_new)
        if safeguard:
            recent = torch.where(
                running, torch.cat([recent[1:], red.sup(gx).reshape(1)]),
                recent)
            g_cand = g(x_new)
            grew = red.sup(g_cand) > 10.0 * torch.amax(recent)
            bad = (bad | ~red.all_finite(g_cand) | grew
                   | ~(red.sup(step) > 0))
            return torch.where(bad, x + gx, x_new)
        return torch.where(bad, torch.full_like(x_new, math.nan), x_new)

    if inner == "dense":
        @spanned("sdfs.newton.step")
        def q(x, running):
            if not host_read(bool, running):    # a frozen step: unused
                return x
            gx = g(x)
            shape = x.shape
            gl = lambda v: (lin(v.reshape(shape))
                            - v.reshape(shape)).reshape(-1)
            J = torch.func.jacfwd(gl)(x.reshape(-1))
            step = torch.linalg.solve(J, gx.reshape(-1)).reshape(shape)
            return accept(x, gx, step, running)
    else:
        def krylov(mv, rhs, atol):
            if inner == "bicgstab":
                return bicgstab_mixed(mv, rhs, atol=atol, maxiter=maxiter,
                                      red=red)
            return gmres(mv, rhs, atol=atol, maxiter=maxiter, red=red)

        @spanned("sdfs.newton.step")
        def q(x, running):
            gx = g(x)
            if tangent_T is None:
                xt, rhs, tl = x, gx, lin
            else:
                xt, rhs = x.float(), gx.float()
                tl = getattr(tangent_T, "twin", tangent_T)
            # One linearization per Newton step, as JAX's jax.linearize:
            # an operator with a hand tangent-linear (``T.linearize``,
            # ops/tangent.py) runs its primal once, on the step's first
            # matvec, and each matvec replays the stored factors; the
            # factors go with jac_prod when the step ends.  Operators
            # without one take a torch.func.jvp per matvec.
            jac_prod = tangent_matvec(tl, xt)
            # A frozen step (after the stop condition failed inside a
            # chunk) skips the Krylov solve: atol = inf stops it before
            # any matvec.
            atol = torch.where(running, (inner_tol * red.norm(rhs)).to(
                torch.float64), inf)
            b, _ = krylov(jac_prod, rhs, atol)
            return accept(x, gx, b.to(x.dtype), running)

    return _iterate(q, x0, tol, max_iter, verbose=verbose,
                    trace_len=trace_len, stall_iters=stall_iters,
                    final_residual=lambda x: red.sup(g(x)), red=red,
                    wrap=wrap)
