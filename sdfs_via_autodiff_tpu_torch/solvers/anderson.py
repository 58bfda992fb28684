"""Anderson acceleration (port of ``solvers/anderson.py``).

A from-scratch Type-II AA, as in the JAX package:

* residual/iterate histories live in fixed-size ring buffers on the
  iterate's device;
* the constrained least-squares  min ||sum_i a_i g_i||, sum a_i = 1  is
  solved via ridge-regularized normal equations (an m x m solve);
* ``beta`` is the relaxation weight: x+ = (1-beta)*sum a_i x_i
  + beta*sum a_i f_i;
* ``mixing_frequency`` applies the AA combination only every k-th
  iteration, with plain fixed-point steps in between.

The JAX loop is one device ``lax.while_loop``.  Here the loop is Python
and reads its stop condition on the host once every
:data:`~.krylov.SYNC_EVERY` iterations, freezing the state with
``torch.where`` after the condition fails inside a chunk (as
``fixed_point._iterate`` does); whether a step mixes depends only on the
iteration count, which the host tracks.  The Gram matrix is one float64
product of the flattened history (the JAX package's pairwise Gram works
around a TPU float64-emulation memory blow-up that does not exist here).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .fixed_point import DEFAULT_TOL
from .krylov import SYNC_EVERY
from .result import SolveResult
from .sharding import solve_parts

__all__ = ["anderson_solver"]


def _solve_small_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a small SPD matrix by unrolled Gauss–Jordan with
    diagonal pivots (the ridge-regularized Gram system is tiny and
    positive definite)."""
    m = A.shape[0]
    M = torch.cat([A, b[:, None]], dim=1)
    idx = torch.arange(m, device=A.device)
    for i in range(m):
        M = M / torch.where(idx == i, M[i, i], torch.ones_like(M[i, i]))[:, None]
        row = M[i]
        elim = torch.where(idx[:, None] == i, torch.zeros_like(M[:, i:i + 1]),
                           M[:, i:i + 1])
        M = M - elim * row[None, :]
    return M[:, m]


def anderson_solver(T: Callable,
                    x0,
                    tol: float = DEFAULT_TOL,
                    max_iter: int = 10_000,
                    *,
                    history_size: int = 10,
                    mixing_frequency: int = 4,
                    beta: float = 8.0,
                    ridge: float = 1e-6,
                    warmup: int = 10,
                    verbose: bool = False) -> SolveResult:
    """Anderson-accelerated fixed point of T.

    Defaults mirror the reference configuration (history 10, mixing every
    4th step, beta 8, ridge 1e-6) plus ``warmup`` plain T iterations.  A
    residual-plateau guard (500 iterations without a 1e-5 relative
    improvement) stops f32 limit cycles.  The returned point is verified
    with one more application of T and replaced by the best recorded
    iterate when it is worse or not finite, so ``residual`` belongs to
    ``x``.  A DTensor ``x0`` runs on the local shard, with the
    sup-norms, the Gram matrix and the finiteness check all-reduced over
    the ranks holding distinct shards (``solvers/sharding.py``).
    """
    T, _, x0, red, wrap, _ = solve_parts(T, x0)
    m = history_size
    shape = tuple(x0.shape)
    dtype, dev = x0.dtype, x0.device
    gram_dtype = torch.float64
    X = torch.zeros((m,) + shape, dtype=dtype, device=dev)
    F = torch.zeros_like(X)
    big = torch.tensor(math.inf, dtype=dtype, device=dev)
    tol_t = torch.tensor(tol, dtype=dtype, device=dev)
    stall_iters, stall_rtol = 500, 1e-5

    def aa_combination(fx):
        """Solve the ridge normal equations over the m stored pairs."""
        G = (F - X).reshape(m, -1).to(gram_dtype)
        A = red.gram(G)                               # (m, m) Gram
        scale = torch.clamp(torch.trace(A) / m, min=1e-30)
        A = A + ridge * scale * torch.eye(m, dtype=gram_dtype, device=dev)
        c = _solve_small_spd(A, torch.ones(m, dtype=gram_dtype, device=dev))
        alpha = (c / torch.sum(c)).to(dtype)
        x_plus = ((1.0 - beta) * torch.tensordot(alpha, X, dims=1)
                  + beta * torch.tensordot(alpha, F, dims=1))
        bad = ~red.all_finite(x_plus)
        return torch.where(bad, fx, x_plus)

    x, x_best, err, best = x0, x0, big, big
    it = torch.zeros((), dtype=torch.int64, device=dev)
    since = torch.zeros((), dtype=torch.int64, device=dev)

    def cond():
        return ((err > tol_t) & (it < max_iter) & ~torch.isnan(err)
                & (since < stall_iters))

    k = 0                          # body calls: equals `it` while running
    while bool(cond()):                        # one host read per chunk
        if verbose:
            print(f"iter = {int(it)}, error = {float(err)}")
        for _ in range(SYNC_EVERY):
            run = cond()
            fx = T(x)
            err_new = red.sup(fx - x)
            x_best = torch.where(run & (err_new < best), x, x_best)
            slot = k % m
            X[slot] = torch.where(run, x, X[slot])
            F[slot] = torch.where(run, fx, F[slot])
            use_aa = k >= warmup and k >= m and k % mixing_frequency == 0
            x_next = aa_combination(fx) if use_aa else fx
            improved = err_new < best * (1.0 - stall_rtol)
            since = torch.where(run, torch.where(improved, 0, since + 1),
                                since)
            # A NaN error must not destroy the best-residual record.
            best = torch.where(run, torch.minimum(
                best, torch.where(torch.isnan(err_new), big, err_new)), best)
            x = torch.where(run, x_next, x)
            err = torch.where(run, err_new, err)
            it = it + run.to(torch.int64)
            k += 1
    # A NaN stop returns the best finite iterate rather than the poisoned
    # point; then verify the returned point (one more application) and
    # fall back to the best recorded iterate when it is worse.
    x = torch.where(torch.isnan(err), x_best, x)
    fr = red.sup(T(x) - x)
    use_best = torch.isnan(fr) | (fr > best)
    x = torch.where(use_best, x_best, x)
    err = torch.where(use_best, best, fr)
    converged = bool((err <= tol_t) & ~torch.isnan(err))
    return SolveResult(x=wrap(x), iterations=int(it), residual=float(err),
                       converged=converged)
