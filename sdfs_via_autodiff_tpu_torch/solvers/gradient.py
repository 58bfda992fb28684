"""Gradient-based fixed-point solver (residual-norm minimization).

PyTorch port of ``solvers/gradient.py``: minimize ``||T(x) - x||^2`` by
L-BFGS and declare convergence on the sup-norm fixed-point residual, as
the other solvers do.  The JAX package runs optax's L-BFGS (memory 10,
zoom line search) in one device loop; here ``torch.optim.LBFGS`` with
the same memory and a strong-Wolfe line search takes one iteration per
outer step.  The two line searches differ, so the iterates and the
iteration counts differ; the fixed points agree.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.dtensor import is_dtensor
from .result import SolveResult

__all__ = ["gradient_solver"]


def gradient_solver(T: Callable,
                    x0,
                    tol: float = 1e-4,
                    max_iter: int = 1000) -> SolveResult:
    """Minimize the squared residual ||T(x) - x||^2 via L-BFGS.

    The loss and its gradient go through ``T.twin`` when ``T`` has one
    (the eager evaluator of a kernel operator), else through ``T``; the
    reported residual is ``T``'s.  ``tol``/``max_iter`` defaults follow
    the reference configuration.
    """
    if is_dtensor(x0):
        raise ValueError(
            "method='gd' takes a plain tensor: torch.optim.LBFGS keeps its "
            "history in flat views of the iterate, which a DTensor does "
            "not give; use newton, anderson or successive_approx")
    lin = getattr(T, "twin", T)
    x = x0.detach().clone().requires_grad_(True)
    # One L-BFGS iteration per step() call.  max_eval bounds the line
    # search at max_eval - 1 evaluations: its default (1.25 * max_iter)
    # would leave the strong-Wolfe search none at max_iter = 1.
    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=1, max_eval=26,
                            history_size=10, tolerance_grad=0.0,
                            tolerance_change=0.0,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        r = lin(x) - x
        loss = torch.sum(r * r)
        loss.backward()
        return loss

    def residual():
        with torch.no_grad():
            return float(torch.amax(torch.abs(T(x) - x)))

    err, it = float("inf"), 0
    while it < max_iter and err > tol and err == err:   # NaN stops
        opt.step(closure)
        err = residual()
        it += 1
    converged = err <= tol
    return SolveResult(x=x.detach(), iterations=it, residual=err,
                       converged=converged)
