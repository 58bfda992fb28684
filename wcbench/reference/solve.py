"""Fixed-point solves of a :class:`.chain.KoopmansChain`.

Newton-Kantorovich with a BiCGStab inner solve (vectors in the chain's
dtype, dot products in float64) and successive approximation, each with
the stop rule the program's solvers use: the sup-norm of the last step.
"""

from __future__ import annotations

import math

import torch

__all__ = ["newton", "successive_approx", "sup"]


def sup(x: torch.Tensor) -> float:
    return float(x.abs().max())


def _dot(a, b) -> torch.Tensor:
    return torch.dot(a.reshape(-1).double(), b.reshape(-1).double())


def bicgstab(matvec, b, rtol: float, maxiter: int):
    """x with ||b - A x|| <= rtol ||b|| (A = ``matvec``), or after
    ``maxiter`` iterations."""
    x = torch.zeros_like(b)
    r = b.clone()
    r_hat = b.clone()
    target2 = (rtol * rtol) * float(_dot(b, b))
    rho = alpha = omega = 1.0
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    for _ in range(maxiter):
        if float(_dot(r, r)) <= target2:
            break
        rho_new = float(_dot(r_hat, r))
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = matvec(p)
        alpha = rho_new / float(_dot(r_hat, v))
        s = r - alpha * v
        if float(_dot(s, s)) <= target2:
            return x + alpha * p
        t = matvec(s)
        omega = float(_dot(t, s)) / float(_dot(t, t))
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
    return x


def newton(T, ell0: torch.Tensor, tol: float, *, inner_rtol: float = 1e-6,
           inner_maxiter: int = 500, max_iter: int = 50):
    """Newton steps ell <- ell + lam (I - J)^{-1} (T(ell) - ell) until a
    step of sup-norm at most ``tol``.  The step is halved (lam = 1, 1/2,
    ... 1/8) until the residual falls; where none does, ell <- T(ell).
    Returns (ell, steps, sup|T(ell) - ell|)."""
    ell = ell0.to(T.dtype)
    steps = 0
    while True:
        Tl, jvp = T.linearize(ell)
        g = Tl - ell
        res = sup(g)
        if not math.isfinite(res):
            raise FloatingPointError("reference Newton: non-finite residual")
        if steps >= max_iter:
            return ell, steps, res
        delta = bicgstab(lambda v: v - jvp(v), g, inner_rtol, inner_maxiter)
        del jvp
        cand = Tl
        for lam in (1.0, 0.5, 0.25, 0.125):
            trial = ell + lam * delta
            if sup(T(trial) - trial) < res:
                cand = trial
                break
        step = sup(cand - ell)
        ell = cand
        steps += 1
        if step <= tol:
            return ell, steps, sup(T(ell) - ell)


def successive_approx(T, ell0: torch.Tensor, tol: float, *,
                      max_iter: int = 1_000_000):
    """ell <- T(ell) until a step of sup-norm at most ``tol``; returns
    (ell after that step, iterations, that step)."""
    ell = ell0.to(T.dtype)
    for it in range(1, max_iter + 1):
        nxt = T(ell)
        step = sup(nxt - ell)
        ell = nxt
        if not math.isfinite(step):
            raise FloatingPointError("reference SA: non-finite step")
        if step <= tol:
            return ell, it, step
    return ell, max_iter, step
